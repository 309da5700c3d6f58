"""Where a decode call's device time goes, kernel by kernel and module by
module, and the paged engine's host dispatch gap.

    python -m distributed_lms_raft_llm_tpu_torch.tools.profile_decode
        [--batch 8] [--bf16] [--greedy] [--spec-tokens 8] [--out F]
        [--trace-dir D] [--model gpt2|tiny] [--device cuda|cpu]
        [--checkpoint F --vocab F --merges F] [--tp N --ep N]
    ... --megastep K [--chunk 16]

Device mode (the default) runs one bucketed `generate_ids` (a 64-token
prompt prefill, then decode to 128 new tokens; GPT-2 small, int8 weights
and KV unless `--bf16`) under `torch.profiler` and adds the device time up
by kernel name and count. Each kernel carries the module scope that
launched it: the model's blocks run inside `record_function` scopes
(`ModuleScopes`: the norms, the qkv / attention-output / MLP products,
the attention, the rest of a block, the embedding, the final norm and the
unembedding); a PyTorch kernel is credited to the innermost scope around
the ATen op it is linked to, and the port's own kernels (launched through
ctypes, linked to no op) in launch order to the scope their wrapper's
launch counter moved in. Kernels outside the model (sampling, masks,
copies) stand apart. The profiler on the card may lose kernel records, so
the record also gives the port's kernels it saw by route beside the
wrappers' launch counters over the same call, and the call's device span
from CUDA events beside the traced sum; a route whose records the trace
lost, launched in more than one scope, stands under `(unmatched)`. One
warm-up call runs under the profiler, discarded, before the measured one. `--device cpu` profiles the same
on the CPU with the leaf ATen ops standing for kernels (a smoke of the
tool: `--model tiny`).

Dispatch-gap mode (`--megastep K`) runs one workload (2 x batch random
prompts, 128 new tokens; 16 with `--model tiny`) through the paged engine
at K = 1 (the chunk loop) and at K-chunk megasteps, and reports host
dispatches per emitted token, dead-lane tokens, tokens/s and each
program's dispatch wall, under the same keys as the JAX package's
`scripts/profile_decode.py`.

`--checkpoint/--vocab/--merges` default to `data/gpt2-local/` (an empty
value: seeded random weights or the byte tokenizer). `--tp`/`--ep` above 1
run under torchrun, as the tutoring node does (rank 0 profiles, the other
ranks replay its calls); started alone they refuse. Writes one JSON file
(`--out`, default under `profiles/`) and prints a summary.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

REPO = Path(__file__).resolve().parents[2]
LOCAL = REPO / "data" / "gpt2-local"
SCOPE = "scope:"  # the prefix of ModuleScopes' record_function names
# The record_function ranges (ModuleScopes', the profiler's steps) that
# the trace also draws on the device's timeline: no kernels.
ANNOTATIONS = (SCOPE, "ProfilerStep#")
OUTSIDE = "(outside the model)"
UNMATCHED = "(unmatched)"  # a kernel the trace cannot tie to its launch
SPEC_PROMPT = (
    "You are an intelligent assistant. Answer the following question "
    "clearly and concisely.\nQuestion: Explain how leader election works "
    "in the Raft consensus algorithm and why a quorum is needed.\nAnswer:")


# --------------------------------------------------------- engines


def model_files(args) -> dict:
    """The engine's checkpoint and tokenizer files: the flags, else
    data/gpt2-local's for GPT-2 (tiny: none); an empty flag means none."""
    out = {}
    for key, flag, name in (("checkpoint", args.checkpoint,
                             "model.safetensors"),
                            ("vocab_path", args.vocab, "vocab.json"),
                            ("merges_path", args.merges, "merges.txt")):
        if flag is None and args.model != "tiny":
            flag = str(LOCAL / name)
        out[key] = flag or None
    return out


def engine_config(args, max_new: int, bucket: int, quant: bool):
    """The EngineConfig both modes build: float32 on the CPU, bf16 on
    the card."""
    import torch

    from ..engine import EngineConfig, SamplingParams

    sampling = (SamplingParams.greedy(max_new_tokens=max_new) if args.greedy
                else SamplingParams.reference_defaults(
                    max_new_tokens=max_new))
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    return EngineConfig(
        model=args.model, sampling=sampling,
        quant="int8" if quant else None, kv_quant=quant,
        spec_tokens=args.spec_tokens, length_buckets=(bucket,),
        batch_buckets=(args.batch,), tp=args.tp, ep=args.ep,
        device=args.device, dtype=dtype, param_dtype=dtype,
        **model_files(args))


def join_ranks(args) -> int:
    """This process' rank: 0 alone; under torchrun (tp x ep above 1) the
    group's, joined as the node joins it. Started alone with tp x ep above
    1 it refuses: the ranks are torchrun's to start."""
    if args.tp * args.ep == 1:
        return 0
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            f"--tp {args.tp} --ep {args.ep}: run under torchrun, one "
            f"process a rank (torchrun --nproc-per-node "
            f"{args.tp * args.ep} -m {__spec__.name} ...)")
    import torch

    from ..parallel import mesh

    if args.tp_backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    mesh.initialize_multihost(args.tp_backend)
    return int(os.environ["RANK"])


# ------------------------------------------------------ module scopes


class ModuleScopes:
    """Inside the block, GPT-2's forward runs each module inside a
    `record_function` scope named `SCOPE + module`: `embed`, then in each
    block `ln1`, `qkv`, `attention` (the cache append and attend),
    `attn_out`, `ln2`, `mlp_in`, `mlp_out` and `block` for the rest of it
    (residual adds, GELU, head splits), then `ln_f` and `unembed`. The
    module functions of `models/gpt2.py` are wrapped for the block and
    restored after it.

    Each scope's entry and exit also marks the port's launch counters by
    route (`marks`), so `launch_scopes()` names the scope of each of the
    port's kernel launches in launch order: those kernels are launched
    through ctypes, with no ATen op the trace could link them to."""

    NAMES = {"dense": ("qkv", "mlp_in"), "row_dense": ("attn_out", "mlp_out"),
             "layer_norm": ("ln1", "ln2")}

    def __init__(self):
        self._calls = threading.local()
        self.marks: List[Tuple[Dict[str, int], Optional[str]]] = []

    @contextlib.contextmanager
    def _scope(self, name):
        from torch.profiler import record_function

        self.marks.append((launch_counters(), name))
        try:
            with record_function(SCOPE + name):
                yield
        finally:
            self.marks.append((launch_counters(), None))

    def _wrap(self, fn, name):
        def scoped(*args, **kwargs):
            with self._scope(name):
                return fn(*args, **kwargs)
        return scoped

    def _in_block(self, fn, kind):
        calls, names = self._calls, self.NAMES[kind]

        def scoped(*args, **kwargs):
            n = getattr(calls, kind, None)
            if n is None:  # outside a block: the final norm
                name = "ln_f"
            else:
                name = names[min(n, len(names) - 1)]
                setattr(calls, kind, n + 1)
            with self._scope(name):
                return fn(*args, **kwargs)
        return scoped

    def _block(self, fn):
        calls = self._calls

        def scoped(*args, **kwargs):
            for kind in self.NAMES:
                setattr(calls, kind, 0)
            try:
                with self._scope("block"):
                    return fn(*args, **kwargs)
            finally:
                for kind in self.NAMES:
                    setattr(calls, kind, None)
        return scoped

    def launch_scopes(self, first: Dict[str, int], last: Dict[str, int]
                      ) -> Dict[str, List[str]]:
        """Route -> the scope of each of its launches between the counters
        `first` and `last` (`launch_counters()` at the window's ends), in
        launch order: the innermost scope open when it was launched."""
        out: Dict[str, List[str]] = {route: [] for route in last}
        at, stack = dict(first), []
        for counts, name in self.marks + [(last, None)]:
            scope = stack[-1] if stack else OUTSIDE
            for route in out:
                n = min(counts[route], last[route]) - at[route]
                if n > 0:
                    out[route] += [scope] * n
                    at[route] += n
            if name is not None:
                stack.append(name)
            elif stack:
                stack.pop()
        return out

    @contextlib.contextmanager
    def __call__(self):
        from ..models import common, gpt2

        saved = {name: getattr(gpt2, name) for name in (
            "apply_block", "dense", "row_dense", "layer_norm",
            "embed_lookup", "unembed")}
        call = common.CachedAttention.__call__
        gpt2.apply_block = self._block(saved["apply_block"])
        for kind in self.NAMES:
            setattr(gpt2, kind, self._in_block(saved[kind], kind))
        gpt2.embed_lookup = self._wrap(saved["embed_lookup"], "embed")
        gpt2.unembed = self._wrap(saved["unembed"], "unembed")
        common.CachedAttention.__call__ = self._wrap(call, "attention")
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(gpt2, name, fn)
            common.CachedAttention.__call__ = call


# ------------------------------------------------------- trace reading


def device_events(torch, prof) -> List[Tuple[str, float]]:
    """(name, µs) of every device event of a finished `torch.profiler`
    window, read from the raw trace (building the profiler's Python event
    tree costs minutes at a million kernels); ANNOTATIONS left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name(), ev.duration_ns() / 1e3)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda
            and not ev.name().startswith(ANNOTATIONS)]


class _Scopes:
    """The ModuleScopes intervals of a trace on the host's clock (one host
    thread runs the profiled call; `events` the host's), for the innermost
    scope around an instant."""

    def __init__(self, events):
        self.spans = sorted((ev.start_ns(), ev.end_ns(),
                             ev.name()[len(SCOPE):])
                            for ev in events if ev.name().startswith(SCOPE))
        self.starts = [s for s, _, _ in self.spans]
        self.reach, longest = [], 0
        for _, end, _ in self.spans:
            longest = max(longest, end)
            self.reach.append(longest)

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            if self.spans[i][1] >= t:  # the latest start that still holds t
                return self.spans[i][2]
            i -= 1
        return OUTSIDE


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call that launches a kernel."""
    return name.startswith("cu") and "Launch" in name


def _route_of(name: str) -> Optional[str]:
    """The `engine.graphs.ROUTES` route of one of the port's kernels by
    its device function name; None for any other kernel."""
    from ..engine.graphs import ROUTES

    return next((route for route, (_, fns) in ROUTES.items()
                 if any(f in name for f in fns)), None)


def port_kernel_scopes(traced: int, launched: List[str]
                       ) -> Tuple[List[str], str]:
    """(the scopes of a route's `traced` kernels in device order, how they
    were found) from the scope of each of its launches (`launched`, in
    launch order; one stream, so the two orders agree): in launch order
    where the trace holds every launch; the one scope of all the launches
    where they share one; else UNMATCHED for each, since the trace lost
    records and which ones is not known. A trace holding more kernels than
    the wrappers launched raises."""
    if traced > len(launched):
        raise ValueError(f"the trace holds {traced} kernels of a route its "
                         f"wrappers launched {len(launched)} times")
    if traced == len(launched):
        return launched, "launch_order"
    if len(set(launched)) == 1:
        return launched[:traced], "launch_scope"
    return [UNMATCHED] * traced, "unmatched"


def scoped_kernels(torch, prof, cuda: bool,
                   port_scopes: Dict[str, List[str]]):
    """((name, µs, module scope) of each kernel in the window, how each
    scope was found). On the card the port's kernels of each route take
    their scopes from `port_scopes` (`ModuleScopes.launch_scopes`) by
    `port_kernel_scopes`; any other kernel takes the innermost scope around
    the host op it is linked to (UNMATCHED without one). On the CPU the
    leaf ATen ops stand for kernels, each in the scope around it."""
    events = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    scopes = _Scopes([ev for ev in events if ev.device_type() == cpu])
    out, how = [], collections.Counter()
    if cuda:
        # Launch calls left out: a kernel links to the op that launched
        # it, not to its launch call.
        ops = {ev.correlation_id(): ev for ev in events
               if ev.device_type() == cpu and not _is_launch(ev.name())}
        kernels = sorted((ev for ev in events
                          if ev.device_type() == torch.autograd.DeviceType.CUDA
                          and not ev.name().startswith(ANNOTATIONS)),
                         key=lambda ev: ev.start_ns())
        scope, method = [], []
        routes: Dict[str, List[int]] = collections.defaultdict(list)
        for i, ev in enumerate(kernels):
            route = _route_of(ev.name())
            if route is not None:
                routes[route].append(i)
            op = ops.get(ev.linked_correlation_id())
            scope.append(UNMATCHED if op is None else (
                op.name()[len(SCOPE):] if op.name().startswith(SCOPE)
                else scopes.at(op.start_ns())))
            method.append("unmatched" if op is None else "linked_op")
        for route, idx in routes.items():
            found, kind = port_kernel_scopes(len(idx),
                                             port_scopes.get(route, []))
            for i, name in zip(idx, found):
                scope[i], method[i] = name, kind
        how.update(method)
        for ev, name in zip(kernels, scope):
            out.append((ev.name(), ev.duration_ns() / 1e3, name))
        return out, dict(how)
    aten = sorted((ev for ev in events if ev.device_type() == cpu
                   and ev.name().startswith("aten::")),
                  key=lambda ev: (ev.start_thread_id(), ev.start_ns()))
    for i, ev in enumerate(aten):
        nxt = aten[i + 1] if i + 1 < len(aten) else None
        if (nxt is not None and nxt.start_thread_id() == ev.start_thread_id()
                and nxt.start_ns() < ev.end_ns()):
            continue  # it calls another op: not a leaf
        out.append((ev.name(), ev.duration_ns() / 1e3,
                    scopes.at(ev.start_ns())))
        how["leaf_op"] += 1
    return out, dict(how)




def aggregate(kernels) -> Tuple[float, List[dict], Dict[str, float]]:
    """(total ms, rows by kernel name with their scopes, ms by scope),
    the rows by time."""
    per: Dict[str, list] = {}
    by_scope: Dict[str, float] = collections.Counter()
    for name, us, scope in kernels:
        row = per.setdefault(name, [0.0, 0, collections.Counter()])
        row[0] += us / 1e3
        row[1] += 1
        row[2][scope] += us / 1e3
        by_scope[scope] += us / 1e3
    rows = [{"op": name, "ms": ms, "count": n,
             "scopes": dict(scopes.most_common())}
            for name, (ms, n, scopes) in sorted(per.items(),
                                                key=lambda kv: -kv[1][0])]
    return (sum(r["ms"] for r in rows), rows,
            dict(sorted(by_scope.items(), key=lambda kv: -kv[1])))


def launch_counters() -> Dict[str, int]:
    """The kernel wrappers' launch counters, summed per route."""
    from ..engine.graphs import routes_of_counts
    from ..ops import attention, quant_matmul

    return routes_of_counts({**attention.launch_counts,
                             **quant_matmul.launch_counts})


def traced_vs_launched(kernels, before: Dict[str, int],
                       after: Dict[str, int]) -> dict:
    """The port's kernels the trace holds, by route, beside the launches
    the wrappers counted over the same window (`launch_counters()` at its
    ends): route -> [traced, launched]. A trace may hold fewer (lost
    records), never more."""
    from ..engine.graphs import routes_of_names

    names = collections.Counter(name for name, _, _ in kernels)
    traced = routes_of_names(dict(names))
    return {route: [traced[route], after[route] - before[route]]
            for route in after if traced[route] or after[route] - before[route]}


# ----------------------------------------------------------- device mode


def profile_generate(torch, engine, prompts) -> dict:
    """Where one device batch's time goes: `torch.profiler` over one
    `generate_ids` call. Device busy share = summed kernel time (one
    stream, so kernels do not overlap) over the wall time of the same call
    run without the profiler, whose host overhead would inflate the wall;
    kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    ids, mask, _ = engine.encode_prompts(prompts)
    engine.generate_ids(ids, mask)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.generate_ids(ids, mask)
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    steps0 = engine.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate_ids(ids, mask)
        torch.cuda.synchronize()
        profiled_wall_us = (time.monotonic() - t0) * 1e6
    by_name: dict = {}
    for name, us in device_events(torch, prof):
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for us, _ in by_name.values())

    def launches_of(part):
        return sum(n for name, (_, n) in by_name.items() if part in name)

    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "wall_us": wall_us,
        "profiled_wall_us": profiled_wall_us,
        "decode_steps": engine.decode_steps - steps0,
        "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "kernels_launched": sum(n for _, n in by_name.values()),
        "direct_copy_launches": launches_of("direct_copy_kernel"),
        "decode_attention_launches": launches_of("decode_attention"),
        "top": [{"name": name[:90], "us": us, "count": n}
                for name, (us, n) in top],
    }


def decode_workload(args, engine):
    """The device mode's batch: the spec prompt framed (speculation needs
    a real prompt: zeros would be drafted near perfectly), else a full
    bucket of token 0."""
    import numpy as np

    if args.spec_tokens:
        ids, mask, _ = engine.encode_prompts([SPEC_PROMPT] * args.batch)
        return ids, mask
    bucket = engine.config.length_buckets[0]
    return (np.zeros((args.batch, bucket), np.int32),
            np.ones((args.batch, bucket), bool))


def generate(engine, ids, mask):
    """`engine.generate_ids(ids, mask)` on every rank: under tp or ep rank
    0's call goes to the followers as one of the engine's own collective
    calls, which they replay."""
    with engine._spmd.call("generate_ids", ids, mask, collective=True):
        return engine.generate_ids(ids, mask)


def profile_device(args) -> dict:
    """Device mode (see the module docstring): its payload."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from ..engine import TutoringEngine

    tiny = args.model == "tiny"
    engine = TutoringEngine(engine_config(
        args, 16 if tiny else 128, 16 if tiny else 64,
        quant=not (args.bf16 or tiny)))
    if engine.axes.ranks.rank:
        engine.follow()
        return {}
    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ids, mask = decode_workload(args, engine)
    generate(engine, ids, mask)  # builds the kernels, warms the caches
    sync()
    t0 = time.monotonic()
    generate(engine, ids, mask)
    sync()
    wall_ms = (time.monotonic() - t0) * 1e3
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    span_ms = None
    module_scopes = ModuleScopes()
    # One warm-up call under the profiler first, traced and discarded (the
    # schedule's warmup step), so the measured window does not start cold.
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        generate(engine, ids, mask)
        sync()
        prof.step()
        before, steps0 = launch_counters(), engine.decode_steps
        with module_scopes():
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            t0 = time.monotonic()
            generate(engine, ids, mask)
            if cuda:
                end.record()
            sync()
            profiled_ms = (time.monotonic() - t0) * 1e3
        after = launch_counters()
        prof.step()
    if cuda:
        span_ms = start.elapsed_time(end)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir,
                                              "decode.trace.json"))
    engine.stop_followers()
    kernels, found_by = scoped_kernels(
        torch, prof, cuda, module_scopes.launch_scopes(before, after))
    total_ms, rows, by_scope = aggregate(kernels)
    label = label_of(args)
    return {
        "description": (
            f"Device-time breakdown of ONE generate_ids call "
            f"({ids.shape[1]}-token prompt prefill + decode to "
            f"{engine.config.sampling.max_new_tokens} tokens), "
            f"{args.model} batch {args.batch}, {label}, on "
            f"{engine.device.type}; kernels by name with the module scope "
            f"that launched them"
            + ("" if cuda else " (CPU: leaf ATen ops stand for kernels)")),
        "device": (torch.cuda.get_device_name(0) if cuda else "cpu"),
        "batch": args.batch, "bucket": int(ids.shape[1]),
        "decode_steps": engine.decode_steps - steps0,
        "total_device_ms": total_ms,
        "cuda_event_span_ms": span_ms,
        "wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
        "device_busy_share": (total_ms / wall_ms if cuda else None),
        "kernels": len(kernels),
        "scopes_ms": by_scope, "scope_found_by": found_by,
        "traced_vs_launched": traced_vs_launched(kernels, before, after),
        "ops_ms": rows[:80],
    }


def label_of(args) -> str:
    label = "bf16" if args.bf16 or args.model == "tiny" else "int8w_int8kv"
    if args.greedy:
        label += "_greedy"
    if args.spec_tokens:
        label += f"_spec{args.spec_tokens}"
    return label


# ----------------------------------------------------- dispatch-gap mode


def profile_megastep(args, params=None) -> dict:
    """Dispatch-gap mode (see the module docstring): its payload. `params`
    (a parameter tree) replaces each engine's seeded weights (the tests
    carry the JAX engine's across)."""
    import numpy as np

    from ..engine import PagedEngine

    tiny = args.model == "tiny"
    max_new = 16 if tiny else 128
    cfg = engine_config(args, max_new, 16 if tiny else 64,
                        quant=not (args.bf16 or tiny))

    def run(megastep: int) -> dict:
        # Re-seeded per run: the K=1 and K=args.megastep passes measure
        # the same workload.
        rng = np.random.default_rng(0)
        eng = PagedEngine(cfg, slots=args.batch, chunk=args.chunk,
                          megastep=megastep, megastep_max=megastep)
        if params is not None:
            eng.params = params
        if eng.axes.ranks.rank:
            eng.follow()
            return {}
        plen = 8 if tiny else 48
        prompts = [
            eng.tokenizer.decode(
                rng.integers(0, eng.tokenizer.vocab_size, plen).tolist())
            for _ in range(2 * args.batch)
        ]
        eng.warmup()
        eng.pop_dispatch_stats()
        eng.pop_program_times()
        t0 = time.monotonic()
        for p in prompts:
            eng.submit(p)
        eng.drain()
        wall = time.monotonic() - t0
        dispatches, tokens, dead, _stall_ms, _stalled = \
            eng.pop_dispatch_stats()
        per_prog: dict = {}
        for pname, _start, wall_s in eng.pop_program_times():
            n, tot = per_prog.get(pname, (0, 0.0))
            per_prog[pname] = (n + 1, tot + wall_s)
        eng.stop_followers()
        return {
            "megastep": megastep,
            "host_dispatches": dispatches,
            "emitted_tokens": tokens,
            "host_dispatches_per_token": (
                round(dispatches / tokens, 4) if tokens else None),
            "megastep_dead_lane_tokens": dead,
            "tokens_per_sec": round(tokens / wall, 1),
            "dispatch_wall_ms": {
                name: {"count": n, "mean_ms": round(tot / n * 1000, 2)}
                for name, (n, tot) in sorted(per_prog.items())
            },
        }

    before = run(1)
    after = run(args.megastep)
    return {
        "description": (
            "Host dispatch-gap profile of the paged engine: identical "
            f"workload (2x{args.batch} requests, {max_new} new tokens) "
            f"through the chunk loop (megastep=1) and through "
            f"{args.megastep}-chunk megasteps; host round trips per "
            "emitted token is the ratio the megastep attacks"),
        "chunk": args.chunk,
        "before": before,
        "after": after,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bf16", action="store_true",
                    help="profile the bf16 config instead of int8+int8kv")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-dir", default=None,
                    help="device mode: also export the chrome trace here")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="profile the speculative decode path (pair with "
                         "--greedy)")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--megastep", type=int, default=0,
                    help="dispatch-gap mode: the paged engine's host loop "
                         "at K-chunk megasteps against the chunk loop")
    ap.add_argument("--model", default="gpt2", choices=["gpt2", "tiny"],
                    help="tiny = the random-init test model (a CPU-speed "
                         "smoke of the tool)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="paged device chunk size (dispatch-gap mode)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ways (under torchrun)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel ways (MoE models only; under "
                         "torchrun)")
    ap.add_argument("--tp-backend", default="nccl", choices=["nccl", "gloo"],
                    help="collective backend of the ranks (gloo where they "
                         "share a card or run on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--checkpoint", default=None,
                    help="HF-layout .safetensors (default data/gpt2-local's; "
                         "'' = seeded random weights)")
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--merges", default=None)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rank = join_ranks(args)
    if args.megastep:
        payload = profile_megastep(args)
        name = (f"torch_megastep_dispatch_gap_k{args.megastep}_chunk"
                f"{args.chunk}_batch{args.batch}.json")
    else:
        payload = profile_device(args)
        name = f"torch_decode_{label_of(args)}_batch{args.batch}.json"
    if rank:
        return 0
    out = args.out or str(REPO / "profiles" / name)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(f"wrote {out}")
    if args.megastep:
        for row in (payload["before"], payload["after"]):
            print(f"  megastep={row['megastep']:<3} dispatches/token="
                  f"{row['host_dispatches_per_token']} "
                  f"tok/s={row['tokens_per_sec']} "
                  f"dead_lanes={row['megastep_dead_lane_tokens']}")
        return 0
    print(f"  total_device_ms={payload['total_device_ms']:.2f} "
          f"kernels={payload['kernels']}")
    for scope, ms in list(payload["scopes_ms"].items())[:8]:
        print(f"  {ms:9.2f} ms  {scope}")
    for row in payload["ops_ms"][:12]:
        top = next(iter(row["scopes"]), "")
        print(f"  {row['ms']:9.2f} ms x{row['count']:<6} {row['op'][:60]}"
              f"  [{top}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
