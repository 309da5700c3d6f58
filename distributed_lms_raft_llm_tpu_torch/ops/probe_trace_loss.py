"""How many kernel records `torch.profiler` loses on this card.

Launches a known number of kernels inside each profiler window, eagerly
(one `add_` at a time) and as replays of a captured graph of 500 `mul_`,
and counts the elementwise kernels the trace holds. A window whose count
falls short lost records: the trace is then a lower bound on what ran,
which is how `chip_smoke.py` reads its profiler windows.

    python -m distributed_lms_raft_llm_tpu_torch.ops.probe_trace_loss \\
        [--trials 8]

Prints one JSON line per window, then a summary line. Needs the card.
"""

from __future__ import annotations

import argparse
import json

import torch

GRAPH_NODES = 500


def _graph(x: torch.Tensor) -> torch.cuda.CUDAGraph:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.mul_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_NODES):
            x.mul_(1.0)
    torch.cuda.synchronize()
    return g


def window(x: torch.Tensor, g: torch.cuda.CUDAGraph, mode: str,
           n: int) -> dict:
    """One profiler window of `n` eager launches or `n` graph replays."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if mode == "eager":
                x.add_(1.0)
            else:
                g.replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    got = sum(1 for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == cuda
              and any(op in ev.name() for op in ("Add", "Mul", "add", "mul")))
    want = n if mode == "eager" else GRAPH_NODES * n
    return {"mode": mode, "launches": want, "traced": got,
            "lost": want - got}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=8)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_trace_loss: needs a CUDA device")
    x = torch.zeros(1024, device="cuda")
    g = _graph(x)
    rows = []
    sizes = [("eager", 3000), ("graph", 6)] * args.trials
    sizes += [("eager", 200_000), ("graph", 600)]
    for mode, n in sizes:
        rows.append(window(x, g, mode, n))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "windows": len(rows),
        "windows_short": sum(r["lost"] > 0 for r in rows),
        "records_launched": sum(r["launches"] for r in rows),
        "records_lost": sum(r["lost"] for r in rows),
        "windows_long": sum(r["traced"] > r["launches"] for r in rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
