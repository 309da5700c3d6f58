"""CUDA graphs for the paged engine's chunk programs, with counted launches.

On the card a decode chunk is about 741 launches per model call times
`chunk` model calls; replaying it as one captured CUDA graph turns that into
one host call. `ChunkGraph` captures one program (a no-argument callable
over the engine's persistent state) after warming it eagerly on a side
stream, as PyTorch's graph documentation asks: the first launch of a kernel
layout validates it, sets the kernel's shared-memory ceiling and encodes
the int8 weights' tensor maps, none of which belongs in a graph.

The kernels' wrappers count launches in Python, where they launch. That
code runs while a graph is captured, not when it is replayed; so the counts
a capture adds are taken back out, kept with the graph, and added again at
every replay. The counters then say what the device launched: at capture
they are held against the graph's own kernel nodes, read back through the
driver and counted by function name (`kernel_nodes`), and a graph whose
nodes disagree with its counts raises.

Randomness: the program samples from an explicit `torch.Generator`, which
is registered with the graph, so each replay draws the next numbers of the
generator's stream (the numbers an eager call in its place would draw)
instead of repeating the captured ones.

Nothing here falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops import attention, quant_matmul

# The kernels' launch counters, by wrapper module.
_COUNTERS: Tuple[Dict[str, int], ...] = (attention.launch_counts,
                                         quant_matmul.launch_counts)

# Each route's launch counters and the kernel functions that carry it, by
# the names in `ops/csrc` (decode attention's three one-row variants are one
# kernel; the paged decode step's append variants another; its two window
# variants run the tensor-core window kernel for bf16 q and the CUDA-core
# one for float32 q; the MoE layer's expert products run kernels of their
# own names; bf16 int8 products from WGMMA_MIN_ROWS rows run the wgmma
# source's kernels; a device name may be mangled around them).
ROUTES: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "decode_attention": ((attention.KERNEL, attention.RAGGED,
                          attention.INT8KV), ("decode_attention_kernel",)),
    "decode_attention_append": ((attention.APPEND, attention.APPEND_INT8KV),
                                ("decode_attention_append_kernel",)),
    "decode_attention_window": ((attention.WINDOW, attention.WINDOW_INT8KV),
                                ("decode_attention_window_kernel",
                                 "decode_attention_window_mma_kernel")),
    "int8_matmul_mma": ((quant_matmul.MMA,), ("int8_mma_dense_kernel",)),
    "int8_matmul_mma_unembed": ((quant_matmul.MMA_UNEMBED,),
                                ("int8_mma_rows_kernel",)),
    "int8_matmul_fma": ((quant_matmul.FMA,), ("int8_matmul_dense_kernel",
                                               "int8_matmul_rows_kernel")),
    "int8_matmul_mma_experts": ((quant_matmul.MMA_EXPERTS,),
                                ("int8_mma_experts_kernel",)),
    "int8_matmul_fma_experts": ((quant_matmul.FMA_EXPERTS,),
                                ("int8_matmul_experts_kernel",)),
    "int8_matmul_wgmma": ((quant_matmul.WGMMA,), ("int8_wgmma_dense_kernel",)),
    "int8_matmul_wgmma_unembed": ((quant_matmul.WGMMA_UNEMBED,),
                                  ("int8_wgmma_rows_kernel",)),
    "int8_matmul_wgmma_experts": ((quant_matmul.WGMMA_EXPERTS,),
                                  ("int8_wgmma_experts_kernel",)),
}


def routes_of_counts(counts: Dict[str, int]) -> Dict[str, int]:
    """Launch counters (any of the wrappers' keys) summed per route."""
    return {route: sum(counts.get(k, 0) for k in keys)
            for route, (keys, _) in ROUTES.items()}


def routes_of_names(names: Dict[str, int]) -> Dict[str, int]:
    """Kernels counted by device function name, summed per route."""
    return {route: sum(n for name, n in names.items()
                       if any(f in name for f in fns))
            for route, (_, fns) in ROUTES.items()}


# Graphs captured in this process (a server captures only in warmup).
captures = 0


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in _COUNTERS]


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver API."""
    _fields_ = ([("func", ctypes.c_void_p)]
                + [(n, ctypes.c_uint) for n in (
                    "gridDimX", "gridDimY", "gridDimZ", "blockDimX",
                    "blockDimY", "blockDimZ", "sharedMemBytes")]
                + [(n, ctypes.c_void_p) for n in (
                    "kernelParams", "extra", "kern", "ctx")])


_driver: Optional[ctypes.CDLL] = None


def _cu(name: str, *args) -> None:
    """Call the driver API's `name`; a nonzero CUresult raises."""
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        for fn, argtypes in (
                ("cuGraphGetNodes", [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]),
                ("cuGraphGetEdges_v2", [ctypes.c_void_p] * 4
                 + [ctypes.POINTER(ctypes.c_size_t)]),
                ("cuGraphNodeGetType", [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int)]),
                ("cuGraphKernelNodeGetParams_v2",
                 [ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]),
                ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_void_p]),
                ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_void_p])):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _driver = lib
    rc = getattr(_driver, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUresult {rc}")


def kernel_nodes(graph: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """The kernel nodes of a captured graph (kept with `keep_graph=True`),
    counted by the function names the driver gives them: what one replay
    launches on the device, read from the graph itself."""
    handle = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    _cu("cuGraphGetNodes", handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _cu("cuGraphGetNodes", handle, nodes, ctypes.byref(n))
    out: Dict[str, int] = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _cu("cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        _cu("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(params))
        if params.func:
            _cu("cuFuncGetName", ctypes.byref(name), params.func)
        else:
            _cu("cuKernelGetName", ctypes.byref(name), params.kern)
        key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    return out


class _EdgeData(ctypes.Structure):
    """CUgraphEdgeData of the driver API."""
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


_PROGRAMMATIC = 1  # CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC


def programmatic_edges(graph: torch.cuda.CUDAGraph) -> int:
    """Edges of a captured graph (kept with `keep_graph=True`) of the
    programmatic type: what a launch with programmatic stream
    serialization became under capture (0 if capture dropped it)."""
    handle = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    _cu("cuGraphGetEdges_v2", handle, None, None, None, ctypes.byref(n))
    src = (ctypes.c_void_p * n.value)()
    dst = (ctypes.c_void_p * n.value)()
    data = (_EdgeData * n.value)()
    if n.value:
        _cu("cuGraphGetEdges_v2", handle, src, dst, data, ctypes.byref(n))
    return sum(1 for e in data[:n.value] if e.type == _PROGRAMMATIC)


class ChunkGraph:
    """One captured chunk program and its static outputs.

    `fn` reads and writes only tensors whose storage outlives the graph
    (the engine's persistent state planes and weights) and returns a tuple
    of fresh tensors, the graph's outputs: every replay rewrites them in
    place, so a caller copies them out before the next replay.
    `launches` holds the kernel launches one replay makes, by counter name.
    """

    def __init__(self, fn: Callable[[], Tuple[torch.Tensor, ...]],
                 generator: Optional[torch.Generator] = None,
                 warm_iters: int = 2):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warm_iters):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = _snapshot()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn()
        finally:
            after = _snapshot()
            for counts, was in zip(_COUNTERS, before):
                counts.update(was)
        self.launches: List[Dict[str, int]] = [
            {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}
            for a, b in zip(after, before)]
        self.graph.instantiate()
        global captures
        captures += 1
        self.kernels = kernel_nodes(self.graph)
        self.programmatic_edges = programmatic_edges(self.graph)
        counted = routes_of_counts(self.captured_launches())
        on_device = routes_of_names(self.kernels)
        if counted != on_device:
            raise RuntimeError(
                f"the launch counters captured {counted} but the graph's "
                f"kernel nodes are {on_device}")

    def replay(self) -> Tuple[torch.Tensor, ...]:
        """Launch the graph on the current stream, count its kernels, and
        return its static outputs."""
        self.graph.replay()
        for counts, delta in zip(_COUNTERS, self.launches):
            for name, n in delta.items():
                counts[name] += n
        return self.outputs

    def captured_launches(self) -> Dict[str, int]:
        """Kernel launches one replay makes, all counters merged."""
        out: Dict[str, int] = {}
        for delta in self.launches:
            out.update(delta)
        return out
