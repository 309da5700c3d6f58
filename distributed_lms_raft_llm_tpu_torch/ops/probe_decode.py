"""Where the paged one-row decode step's attention spends its time, on the card.

Builds copies of `csrc/decode_attention.cu` whose CUDA-core body
(`attend_rows`, shared by the one-row kernel `decode_attention_kernel` and
the append kernel `decode_attention_append_kernel`) has thread 0 of each
block write `%globaltimer` stamps at its phases, and runs, at 16 slots x
12 heads of 64 (lengths spread over [1, width]) for each width given and
an int8 and a bf16 cache:

- the kernel the paged step ran before the append kernel (`decode_attention`
  with lengths, after the append in torch) and `decode_attention_append`,
  each timed by CUDA-graph replay and with each phase's end in
  microseconds from its block's start (min, median, 90th percentile, max
  over the blocks), the blocks' start spread and span;
- the append kernel built with its rows in grid order (`in_order`: no
  longest-first dispatch) and with `--threads` threads a block (csrc
  `kThreads`, which every kernel of that copy takes; the probe runs only
  the append kernel there), each patched in a copy, the same way;
- the step as the model runs it, in one graph over the 12 layers: the qkv
  product (the int8 matmul, M = 16) then the append kernel, as the model
  launches it (`dependent=True`: a programmatic dependent of a product
  that triggers at its start), launched plainly (`no_pdl`) and behind a
  product that does not trigger (`no_trigger`); the product then the old
  sequence (two `quantize_kv`, four row writes, the old kernel); the
  product alone:

    python -m distributed_lms_raft_llm_tpu_torch.ops.probe_decode \\
        [--widths 160 384 1024] [--threads 128] [--out F]

Phases: the copies issued (`copies`); the block barrier that publishes
the mbarriers (`barrier` in the append kernel, `barrier_old` in the old
one); the wait on the previous kernel returned (`waited`); the new K row
staged by thread 0 (`staged`, in the block that holds it); the first K
tile read (`first_k`); the key loop's end (`loop`); the new row folded in
(`folded`); the warps' states in shared memory (`stored`); the rows
written (`end`). A phase a kernel does not have is reported as None. The stamps cost a few instructions each; the shipped
kernels have none. Needs the card and `nvcc`; the builds go to
`build/torch_kernels/probe_decode/`, started together; the wrappers'
launch functions are swapped for the instrumented ones for a run and
restored after.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from . import attention, build, probe_window, quant_matmul, sweep_int8

SLOTS = probe_window.SLOTS
# (phase, anchor, stamped before it) in `attend_rows`, in order; each
# anchor must occur once there.
PHASES: Tuple[Tuple[str, str, bool], ...] = (
    ("start", "  const int grp = tid / kLpr;    // lane group: rows grp, "
     "grp + kGroups, ..\n", False),
    ("copies", "    for (int t = 0; t < stages && t < n_tiles; ++t) "
     "stage_tile(t);\n  }\n", False),
    ("barrier", "    // other warps do not wait for warps 0 and 1 to stage "
     "them.\n    __syncthreads();\n", False),
    ("waited", "    griddep_wait();\n  }\n", False),
    ("staged", "      if (lane == 0) mbar_arrive(new_bar);\n", False),
    ("barrier_old", "    __syncthreads();  // the barriers are initialised\n",
     False),
    ("first_k", "    mbar_wait(&bars[2 * st], parity);\n", False),
    ("loop", "  // The new row, from shared memory", True),
    ("folded", "  // Merge the lane groups of each warp", True),
    ("stored", "  // Row j's output: out[b, g*G + head, pos]", True),
    ("end", "  if (n_split == 1) return;\n  cluster_arrive_release();", True),
)
CLOCK = len(PHASES)
KERNEL_START = "__device__ __forceinline__ void attend_rows("
KERNEL_END = "#define DECODE_ATTENTION_PARAMS"
READER = "decode_probe_read"
THREADS_LINE = "constexpr int kThreads = 256;"
ORDER_LINE = "      return row_of_rank(lengths, B, blockIdx.z);"
TRIGGER_LINE = "  launch_dependents();\n"  # in int8_matmul.cu's dense kernels


def _patch(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f"probe patch point {old!r} not found {count}x")
    return src.replace(old, new)


def instrument(src: str, threads: int = 256, in_order: bool = False) -> str:
    """The decode-attention source with `attend_rows` stamped (see
    `probe_window.instrument`), blocks of `threads` threads, the append
    kernel's rows in grid order or longest first."""
    src = _patch(src, THREADS_LINE, f"constexpr int kThreads = {threads};")
    if in_order:
        src = _patch(src, ORDER_LINE, "      return (int)blockIdx.z;")
    return probe_window.instrument(src, PHASES, KERNEL_START, KERNEL_END,
                                   READER)


def no_trigger(src: str) -> str:
    """The int8 matmul source whose dense kernels do not trigger their
    programmatic dependents (they launch as the product ends)."""
    return _patch(src, TRIGGER_LINE, "", count=2)


def build_variants(variants: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Compile each named source text with the port's flags, all started
    together; returns name -> loaded library."""
    out = build.BUILD_DIR / "probe_decode"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in variants.items():
        src = out / f"{name}.cu"
        src.write_text(text)
        so = out / f"{name}.so"
        procs.append((name, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _bind_attention(lib: ctypes.CDLL):
    launch = lib.decode_attention_launch
    launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    append = lib.decode_attention_append_launch
    append.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
    append.restype = ctypes.c_int
    stream = torch._C._cuda_getCurrentRawStream
    return (launch, stream), (append, stream)


def _use(attention_lib=None, matmul_lib=None, warps=None) -> None:
    """Swap the wrappers' launch functions (None: the shipped ones)."""
    attention._bound = attention._append_bound = None
    if attention_lib is not None:
        attention._bound, attention._append_bound = _bind_attention(
            attention_lib)
    quant_matmul._bound = None
    if matmul_lib is not None:
        fn = matmul_lib.int8_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        quant_matmul._bound = (fn, torch._C._cuda_getCurrentRawStream)
    attention.WARPS = warps or 8
    attention._layouts.clear()
    quant_matmul._layouts.clear()


def _quantiles(values: List[float]) -> List[float]:
    v = sorted(values)
    return [v[int(q * (len(v) - 1))] for q in (0.0, 0.5, 0.9, 1.0)]


class Step:
    """One layer stack of the paged decode step's attention inputs: int8
    or bf16 cache [12, 16, 12, S, 64], lengths spread over [1, width], and
    the qkv product's int8 weights; `qkv(i)` runs layer i's product."""

    def __init__(self, width: int, int8: bool, seed: int):
        from ..models.common import quantize_kv

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.s, self.h, self.dh, self.n_layers = 16, 12, 64, 12
        shape = (self.n_layers, self.s, self.h, width, self.dh)
        kf = torch.randn(shape, generator=gen, device=dev)
        self.scales = {}
        if int8:
            (self.k, ks), (self.v, vs) = quantize_kv(kf), quantize_kv(kf)
            self.scales = dict(k_scale=ks, v_scale=vs)
        else:
            self.k = kf.to(torch.bfloat16)
            self.v = self.k.clone()
        del kf
        self.lengths = torch.randint(1, width + 1, (self.s,), generator=gen,
                                     device=dev).to(torch.int32)
        self.lengths[-1] = width
        self.x = torch.randn((self.s, 1, 768), generator=gen, device=dev).to(
            torch.bfloat16)
        self.wq, self.ws, self.wb, *_ = sweep_int8.int8_weights(
            "attn.wqkv", self.n_layers, seed)
        self.int8 = int8
        self.dependent = True  # launch the append kernel as the model does

    def qkv(self, i: int):
        y = quant_matmul.int8_matmul(self.x, self.wq[i % self.n_layers],
                                     self.ws[i % self.n_layers],
                                     self.wb[i % self.n_layers])
        hd = self.h * self.dh
        return [y[..., j * hd:(j + 1) * hd].reshape(
            self.s, 1, self.h, self.dh).transpose(1, 2) for j in range(3)]

    def old(self, i: int, q, k_new, v_new):
        """models/gpt2.py's route before the append kernel."""
        from ..models.common import quantize_kv
        from ..models.common import write_rows as _write_rows

        layer = i % self.n_layers
        rows = torch.arange(self.s, device=q.device)[:, None]
        slots = (self.lengths.long() - 1)[:, None]
        if self.int8:
            (k_w, k_s), (v_w, v_s) = quantize_kv(k_new), quantize_kv(v_new)
            news = [(self.k, k_w), (self.v, v_w),
                    (self.scales["k_scale"], k_s),
                    (self.scales["v_scale"], v_s)]
        else:
            news = [(self.k, k_new), (self.v, v_new)]
        for buf, val in news:
            _write_rows(buf, layer, rows, slots, val.transpose(1, 2), None)
        return attention.decode_attention(q, self.k, self.v, layer,
                                          lengths=self.lengths,
                                          **self.scales)

    def append(self, i: int, q, k_new, v_new):
        return attention.decode_attention_append(
            q, k_new, v_new, self.k, self.v, i % self.n_layers,
            lengths=self.lengths, **self.scales, dependent=self.dependent)


def stamps(read, n_blocks: int) -> Dict[str, object]:
    """The last launch's stamps, as phase quantiles."""
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (n_blocks * SLOTS))()
    if read(buf, n_blocks * SLOTS) != 0:
        raise RuntimeError("reading the probe's stamps failed")
    blocks = [list(buf[i * SLOTS:(i + 1) * SLOTS]) for i in range(n_blocks)]
    t0 = min(b[0] for b in blocks)
    end = len(PHASES) - 1
    out: Dict[str, object] = dict(
        blocks=n_blocks,
        start_spread_us=_quantiles([(b[0] - t0) / 1e3 for b in blocks]),
        span_us=(max(b[end] for b in blocks) - t0) / 1e3,
        sm_ghz=_quantiles([(b[CLOCK + 1] - b[CLOCK]) / max(b[end] - b[0], 1)
                           for b in blocks]))
    for i, (name, _, _) in enumerate(PHASES[1:], start=1):
        ends = [(b[i] - b[0]) / 1e3 for b in blocks if b[i] >= b[0]]
        out[f"{name}_us"] = _quantiles(ends) if ends else None
    return out


def probe_kernels(step: Step, read, old: bool = True) -> Dict[str, object]:
    """The append kernel (and the old kernel) alone: time by graph replay
    over the layers, then three more launches and the last one's stamps."""
    from .timing import time_graph_us

    q, k_new, v_new = step.qkv(0)
    torch.cuda.synchronize()
    out = {}
    kernels = [("append", lambda i: step.append(i, q, k_new, v_new))]
    if old:
        kernels.insert(0, ("old_kernel", lambda i: attention.decode_attention(
            q, step.k, step.v, i % step.n_layers, lengths=step.lengths,
            **step.scales)))
    for name, fn in kernels:
        rec = dict(kernel_us=time_graph_us(fn))
        for _ in range(3):  # the last launch's stamps, code and data warm
            fn(3)
        plan = attention.launch_plan(step.s, step.h, step.k.shape[3],
                                     step.dh, step.k.dtype,
                                     append=name == "append")
        rec.update(stamps(read, plan.blocks))
        out[name] = rec
    return out


def time_pairs(step: Step, read=None) -> Dict[str, object]:
    """µs a layer of the product and what follows it, in one graph; with
    `read`, the append kernel's stamps behind the product too (`waited`
    then says how long its blocks ran before the product ended)."""
    from .timing import time_graph_us

    def product(i):
        step.qkv(i)

    def with_append(i):
        step.append(i, *step.qkv(i))

    def with_old(i):
        step.old(i, *step.qkv(i))

    out: Dict[str, object] = dict(
        product_us=time_graph_us(product),
        product_append_us=time_graph_us(with_append),
        product_old_us=time_graph_us(with_old))
    if read is not None:
        for _ in range(3):
            with_append(3)
        out["append_behind_product"] = stamps(read, attention.launch_plan(
            step.s, step.h, step.k.shape[3], step.dh, step.k.dtype,
            append=True).blocks)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--widths", type=int, nargs="+",
                        default=[160, 384, 1024])
    parser.add_argument("--threads", type=int, nargs="*", default=[128],
                        help="other block sizes of the append kernel")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_decode: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = (build.CSRC / "decode_attention.cu").read_text()
    variants = {"shipped": instrument(src),
                "in_order": instrument(src, in_order=True),
                "no_trigger": no_trigger(
                    (build.CSRC / "int8_matmul.cu").read_text())}
    variants.update({f"threads{n}": instrument(src, n)
                     for n in args.threads})
    libs = build_variants(variants)
    records = []
    try:
        for width in args.widths:
            for int8 in (True, False):
                step = Step(width, int8, seed=width + int8)
                rec = dict(width=width, int8=int8)
                for name in ["shipped", "in_order"] + [
                        f"threads{n}" for n in args.threads]:
                    lib = libs[name]
                    read = getattr(lib, READER)
                    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
                    read.restype = ctypes.c_int
                    threads = int(name[7:]) if name[7:].isdigit() else 256
                    _use(lib, warps=threads // 32)
                    rec[name] = probe_kernels(step, read,
                                              old=name == "shipped")
                _use(libs["shipped"])
                rec["pairs"] = time_pairs(step, getattr(libs["shipped"],
                                                        READER))
                step.dependent = False
                rec["pairs_no_pdl"] = time_pairs(step)
                step.dependent = True
                _use(libs["shipped"], libs["no_trigger"])
                rec["pairs_no_trigger"] = time_pairs(step)
                records.append(rec)
                print("probe " + json.dumps(rec), flush=True)
                del step
    finally:
        _use()
    if args.out:
        Path(args.out).write_text(json.dumps({"card": card,
                                              "probe": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
