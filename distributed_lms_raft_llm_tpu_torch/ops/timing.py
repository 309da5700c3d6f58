"""Device time of a kernel call on the card, for `chip_smoke.py` and
`ops/sweep_attention.py`. Both need a CUDA device; nothing runs at import.
"""

from __future__ import annotations

from typing import Callable

import torch


def time_graph_us(fn: Callable[[int], object], iters: int = 50) -> float:
    """Device time of one call of fn(i): `iters` calls captured in a CUDA
    graph, replayed between CUDA events (no host launch overhead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (3 * iters)


def time_eager_us(fn: Callable[[int], object], iters: int = 50) -> float:
    """Per-call time of eager calls, host launch overhead included."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters
