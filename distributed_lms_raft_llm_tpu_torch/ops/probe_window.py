"""Where the tensor-core verify-window kernel spends its time, on the card.

Builds a copy of `csrc/decode_attention.cu` whose window kernel
(`decode_attention_window_mma_kernel`) has thread 0 of each block write
`%globaltimer` stamps at its phases into a device array, runs the window
at 16 slots x 12 heads (bf16 q, T = 9) over the widths given, and prints,
for each, the kernel's time by CUDA-graph replay and each phase's end in
microseconds from its block's start (min, median, 90th percentile, max
over the blocks), with the SM clock from `clock64`:

    python -m distributed_lms_raft_llm_tpu_torch.ops.probe_window \\
        [--widths 32 167 384 640] [--out F]

Phases: the first tile's copy issued (`copy0`); the barrier that
publishes the mbarriers (`barrier`); the rest of the copies issued
(`copies`); the first K tile read (`first_k`); the key loop's end
(`loop`); the warps' states in shared memory (`stored`); the merged rows
written (`end`). The stamps cost a few instructions each; the shipped
kernel has none. Needs the card and `nvcc`. The instrumented build goes to
`build/torch_kernels/probe/`; the wrapper's launch function is swapped for
the instrumented one for the run and restored after.
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

from . import attention, build, sweep_attention

SLOTS = 16  # words a block: the phases' stamps, then clock64 at both ends
# (phase, source text it is stamped at) in the window kernel, in order;
# each anchor must occur once there. A phase marked "before" is stamped
# ahead of its anchor, the others right after it.
PHASES: Tuple[Tuple[str, str, bool], ...] = (
    ("start", "  const int n_kw = kWarps >> mt_bits;\n", False),
    ("copy0", "    if (first > 0) stage_keys(0, first);\n", False),
    ("barrier", "  __syncthreads();  // the barriers are initialised\n",
     False),
    ("copies", "      stage_tile(t);\n    }\n  }\n", False),
    ("first_k", "    if (kw < n_kb) mbar_wait(&bars[2 * st], parity);\n",
     False),
    ("loop", "  // The lane sums of l over the quad;", True),
    ("stored", "  // Row f (head f / W, window position f % W)", True),
    ("end", "  if (n_split == 1) return;\n  cluster_arrive_release();", True),
)
CLOCK = len(PHASES)  # clock64 at "start" in this slot, at "end" in the next
KERNEL_START = "decode_attention_window_mma_kernel("
KERNEL_END = "// ------------------------------------------------------------ the kernel\n"


def instrument(src: str, phases=PHASES, kernel_start: str = KERNEL_START,
               kernel_end: str = KERNEL_END,
               reader: str = "window_probe_read") -> str:
    """The kernel source with thread 0 of each block stamping every phase
    of `phases` (the first K tile: its first only) into
    `g_probe[block * SLOTS + phase]`, clock64 beside the first ("start")
    and the last ("end", after a block barrier), and an extern "C" reader
    `reader`. The anchors are looked for between `kernel_start` and
    `kernel_end` (by default the window kernel's). Raises if an anchor is
    missing or repeated there."""
    head, rest = src.split(kernel_start, 1)
    body, tail = rest.split(kernel_end, 1)
    clock = len(phases)
    for i, (name, anchor, before) in enumerate(phases):
        if body.count(anchor) != 1:
            raise ValueError(f"probe anchor of {name!r} not found once")
        when = "threadIdx.x == 0" + (" && t == 0" if name == "first_k" else "")
        stamp = f"  if ({when}) g_probe[probe_at + {i}] = probe_now();\n"
        if name == "start":
            stamp = ("  const long long probe_at = (long long)SLOTS * "
                     "(blockIdx.x + gridDim.x * (blockIdx.y + "
                     "(long long)gridDim.y * blockIdx.z));\n" + stamp +
                     f"  if ({when}) g_probe[probe_at + {clock}] = "
                     "clock64();\n")
        if name == "end":  # every warp has written its rows
            stamp = ("  __syncthreads();\n" + stamp +
                     f"  if ({when}) g_probe[probe_at + {clock + 1}] = "
                     "clock64();\n")
        k = body.index(anchor) + (0 if before else len(anchor))
        body = body[:k] + stamp + body[k:]
    prelude = (
        f"#define SLOTS {SLOTS}\n"
        "__device__ unsigned long long g_probe[65536 * SLOTS];\n"
        f"extern \"C\" int {reader}(void* host, int n) {{\n"
        "  return (int)cudaMemcpyFromSymbol(host, g_probe, (size_t)n * 8);\n"
        "}\n"
        "__device__ __forceinline__ unsigned long long probe_now() {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n"
        "}\n")
    return prelude + head + kernel_start + body + kernel_end + tail


def _bind(so: Path):
    lib = ctypes.CDLL(str(so))
    launch = lib.decode_attention_launch
    launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    read = lib.window_probe_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    return launch, read


def build_probe() -> Tuple[object, object, str]:
    """Compile the instrumented source (the same flags as the port's
    build); returns its launch and reader functions and the compiler's
    report."""
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "decode_attention_probe.cu"
    src.write_text(instrument((build.CSRC / "decode_attention.cu")
                              .read_text()))
    so = out / "decode_attention_probe.so"
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(so), str(src)], capture_output=True,
                          text=True)
    if done.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{done.stdout}"
                           f"{done.stderr}")
    return (*_bind(so), done.stdout + done.stderr)


def _quantiles(values: List[float]) -> List[float]:
    v = sorted(values)
    return [v[int(q * (len(v) - 1))] for q in (0.0, 0.5, 0.9, 1.0)]


def probe_width(width: int, int8: bool, read) -> Dict[str, object]:
    """The window at 16 slots, T = 9, `width` keys: timed (and checked
    against its plain version) by `sweep_attention.window_attention_case`,
    then launched three times more and the last launch's stamps read."""
    rec = sweep_attention.window_attention_case(
        s=16, width=width, t=9, int8=int8, seed=width + 9 + int8,
        time_plain=False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(width)
    s, h, t, dh = 16, 12, 9, 64
    q = torch.randn((s, t, h, dh), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    shape = (12, s, h, width, dh)
    extra = {}
    if int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        sc = torch.rand(shape[:4], generator=gen, device=dev) * 0.01
        extra = dict(k_scale=sc, v_scale=sc)
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.randint(1, width - t + 2, (s,), generator=gen,
                            device=dev).to(torch.int32)
    for _ in range(3):  # the last launch's stamps, its code and data warm
        attention.decode_attention(q, k, k, 3, lengths=lengths, **extra)
    torch.cuda.synchronize()
    n = s * h  # one block a (slot, head) at these widths
    buf = (ctypes.c_ulonglong * (n * SLOTS))()
    if read(buf, n * SLOTS) != 0:
        raise RuntimeError("reading the probe's stamps failed")
    blocks = [list(buf[i * SLOTS:(i + 1) * SLOTS]) for i in range(n)]
    t0 = min(b[0] for b in blocks)
    out = dict(width=width, int8=int8, kernel_us=rec["kernel_us"],
               bound_us=rec["bound_us"], blocks=n,
               start_spread_us=_quantiles([(b[0] - t0) / 1e3
                                           for b in blocks]),
               span_us=(max(b[len(PHASES) - 1] for b in blocks) - t0) / 1e3,
               sm_ghz=_quantiles([(b[CLOCK + 1] - b[CLOCK])
                                  / max(b[len(PHASES) - 1] - b[0], 1)
                                  for b in blocks]))
    for i, (name, _, _) in enumerate(PHASES[1:], start=1):
        out[f"{name}_us"] = _quantiles([(b[i] - b[0]) / 1e3 for b in blocks
                                        if b[i] >= b[0]])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--widths", type=int, nargs="+",
                        default=[32, 167, 384, 640])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_window: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    launch, read, _ = build_probe()
    shipped = attention._entry_point()
    attention._bound = (launch, shipped[1])
    attention._layouts.clear()
    records = []
    try:
        for width in args.widths:
            for int8 in (True, False):
                records.append(probe_width(width, int8, read))
                print("probe " + json.dumps(records[-1]), flush=True)
    finally:
        attention._bound = shipped
        attention._layouts.clear()
    if args.out:
        Path(args.out).write_text(json.dumps({"card": card,
                                              "probe": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
