"""Pipeline parallelism: the stacked layer trunk sharded over the `pp` axis.

Port of `distributed_lms_raft_llm_tpu/parallel/pipeline.py`. The models'
layout (every per-layer weight stacked on a leading [L, ...] axis,
models/gpt2.py) makes a pipeline stage a contiguous slice of that axis:
stage s of pp holds layers [s L/pp, (s+1) L/pp). The schedule is JAX's
GPipe: the batch splits into `n_micro` microbatches, stage 0 injects
microbatch m, each stage runs its layers and sends the activation to the
next, and after n_micro + pp - 1 ticks the last stage holds every
microbatch's output, which is then broadcast to every stage (JAX's `psum`
of the last stage's outputs and the others' zeros, written the same way
here), so the caller gets a replicated tensor and the loss can run on any
stage.

JAX runs the ticks in lockstep under `shard_map`. With one process a rank
each stage runs its own microbatches in order, receiving from the stage
before and sending to the stage after (`ParallelAxis.recv` / `send`,
through host memory over gloo): the dependencies all point down the
pipeline, so a send blocked on its receiver cannot deadlock, and the
ticks fall out of the order of the hops.

The backward is GPipe's, all forwards then all backwards, which is what
JAX differentiates: `_Pipeline` is one `torch.autograd.Function` that
keeps each microbatch's graph through the stage (or, with a remat
`layer_fn`, only each layer's input), and runs the schedule in reverse.
The last stage takes the outputs' gradient, which every stage holds whole
(the loss downstream is replicated), and keeps its own; each stage
backpropagates a microbatch through its layers, sends the input's
gradient to the stage before and sums its layers' gradients over the
microbatches; stage 0's gradient of the input is broadcast back to every
stage (the input upstream, the embedding, is replicated too).

The result is the sequential loop over all L layers up to float rounding
(held against it and against the JAX package's in the tests); the win is
memory: each rank stores 1/pp of the trunk and of its optimizer moments.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, List, Tuple

import torch

from .mesh import Mesh, ParallelAxis

LayerFn = Callable[[Any, torch.Tensor], torch.Tensor]  # (layer_params, x) -> x

# The pipeline's calls since the caller last cleared it: "calls",
# "ticks" (n_micro + pp - 1 a call) and the wall seconds of the forward
# and backward schedules ("forward_s", "backward_s"). The hops themselves
# are `mesh.STATS`' "send" / "recv".
STATS: collections.Counter = collections.Counter()


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of a nested dict of tensors, keys in sorted order."""
    if isinstance(tree, dict):
        out: List[Tuple[str, torch.Tensor]] = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def _rebuild(paths: List[str], values) -> Any:
    tree: dict = {}
    for path, value in zip(paths, values):
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _layers(paths: List[str], leaves) -> List[Any]:
    """Each layer's parameter tree: views of the stacked leaves."""
    split = [torch.unbind(x) for x in leaves]
    return [_rebuild(paths, layer) for layer in zip(*split)]


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule over this stage's layers; see the module
    docstring. Inputs: the microbatched activations [n_micro, Bm, ...],
    then the stage's stacked parameter leaves."""

    @staticmethod
    def forward(ctx, xm, pp, layer_fn, paths, *leaves):
        t0 = time.perf_counter()
        s, n, n_micro = pp.rank, pp.size, xm.shape[0]
        local = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        out = torch.zeros_like(xm)
        records = []
        for m in range(n_micro):
            h = xm[m] if s == 0 else pp.recv(xm[m], s - 1)
            h = h.detach().requires_grad_(True)
            with torch.enable_grad():
                y = h
                for lp in _layers(paths, local):
                    y = layer_fn(lp, y)
            records.append((h, y))
            if s < n - 1:
                pp.send(y, s + 1)
            else:
                out[m] = y.detach()
        # The last stage's outputs on every stage: the sum of its outputs
        # and the other stages' zeros (JAX's psum), exact.
        out = pp.all_reduce(out)
        ctx.pp, ctx.records, ctx.local = pp, records, local
        STATS["calls"] += 1
        STATS["ticks"] += n_micro + n - 1
        STATS["forward_s"] += time.perf_counter() - t0
        return out

    @staticmethod
    def backward(ctx, g_out):
        t0 = time.perf_counter()
        pp, records, local = ctx.pp, ctx.records, ctx.local
        s, n = pp.rank, pp.size
        wanted = [p for p in local if p.requires_grad]
        sums: List[Any] = [None] * len(wanted)
        g_x = torch.zeros_like(g_out)
        for m, (h, y) in enumerate(records):
            # The last stage keeps its own (whole) gradient of the
            # broadcast outputs; the others' copies are the same numbers.
            gy = g_out[m] if s == n - 1 else pp.recv(y, s + 1)
            with torch.enable_grad():
                grads = torch.autograd.grad(y, [h] + wanted, gy,
                                            allow_unused=True)
            if s > 0:
                pp.send(grads[0], s - 1)
            else:
                g_x[m] = grads[0]
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    sums[i] = g if sums[i] is None else sums[i] + g
        ctx.records = None
        # Stage 0's gradient of the input on every stage.
        g_x = pp.all_reduce(g_x)
        it = iter(sums)
        out = [next(it) if p.requires_grad else None for p in local]
        out = [torch.zeros_like(p) if p.requires_grad and g is None else g
               for p, g in zip(local, out)]
        STATS["backward_s"] += time.perf_counter() - t0
        return (g_x, None, None, None, *out)


def pipeline_trunk(
    layer_fn: LayerFn,
    stacked_params: Any,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    n_micro: int,
    axis_name: str = "pp",
    stage_sliced: bool = False,
) -> torch.Tensor:
    """Apply L stacked layers to x [B, ...] with the layer axis split over
    the mesh's `axis_name` and the batch into `n_micro` microbatches.

    `layer_fn(layer_params, h) -> h` is one layer (e.g. a transformer
    block, with no collective of its own); `stacked_params` is a nested
    dict whose leaves lead with the layer axis: the whole L layers (this
    stage runs its contiguous L/pp, views of them), or with
    `stage_sliced` this stage's L/pp already (the sharded train state's).
    `x` is replicated over the axis; so is the result, exactly the
    sequential loop's up to float rounding. Gradients reach `x` and the
    stage's leaves (the whole leaves' other stages' rows get zeros).
    """
    pp: ParallelAxis = mesh.axis(axis_name)
    n_stages = pp.size
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    named = _leaves(stacked_params)
    local_layers = named[0][1].shape[0]
    layers = local_layers * n_stages if stage_sliced else local_layers
    if layers % n_stages:
        raise ValueError(
            f"{layers} stacked layers not divisible by the {axis_name} "
            f"axis size {n_stages}"
        )
    paths = [p for p, _ in named]
    leaves = [v for _, v in named]
    if not stage_sliced and n_stages > 1:
        per = layers // n_stages
        leaves = [v.narrow(0, pp.rank * per, per) for v in leaves]
    xm = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    if n_stages == 1:
        h = xm.reshape(x.shape)
        for lp in _layers(paths, leaves):
            h = layer_fn(lp, h)
        return h
    out = _Pipeline.apply(xm, pp, layer_fn, paths, *leaves)
    return out.reshape(x.shape)
