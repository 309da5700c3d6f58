"""The device mesh over a `torch.distributed` process group, and each
axis' collectives.

Port of `distributed_lms_raft_llm_tpu/parallel/mesh.py`. JAX runs one
controller over a `Mesh` of local chips and lets XLA insert the collectives
its partition specs imply, forward and backward. PyTorch's idiom is one
process a rank with explicit collectives, so here:

- `make_mesh` keeps the JAX package's axis order ("dp", "pp", "ep", "sp",
  "tp", tp the fastest-varying), its `-1` inference, its dp remainder and
  its error messages, over the ranks of the process group (one rank a
  device) instead of a device list; the mesh also names the device the
  rank computes on (the card unless the caller asks for the CPU);
- `initialize_multihost` joins the process group from torchrun's
  environment (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`) and is a
  no-op for one process, as the JAX one is; `init_process_group` joins
  one explicitly (the tests' `file://` rendezvous, the tutoring node's
  loopback);
- the backend is an argument and never chosen here: `nccl` where each rank
  has its own GPU, `gloo` where the caller asks for it (several ranks on
  one card, or the CPU);
- `ParallelAxis` holds one axis' collectives the models call. `Mesh.axis
  (name)` gives a rank any of its axes (dp, pp, ep, sp, tp): a
  `torch.distributed` subgroup over the ranks that share every other
  coordinate (the whole group where the axis spans it). `TensorParallel`
  is the class under its tp name. Each is the identity at size 1.

The collectives come in conjugate pairs, so that the trainer's backward is
the one XLA derives. The convention: *the gradient a rank holds for a leaf
is the gradient of JAX's one global loss with respect to that rank's copy
or shard of it*, where every rank of a model axis (tp, ep, pp) computes
the same replicated activations and counts them as one copy, and each rank
of a data axis (dp, sp) holds a copy of its own, whose gradients the
trainer sums. The pairs:

- "reduce" (`all_reduce`): all-reduce forward, identity backward; after a
  row-parallel product, the vocabulary-parallel embedding's sum, the ep
  combine, the loss' sum over the data axes;
- "copy" (`copy`): identity forward, all-reduce backward; on a replicated
  activation that enters a column-parallel product or this rank's
  experts;
- "gather" (`all_gather`): all-gather forward, this rank's slice backward,
  where the computation downstream is replicated (the logits' vocabulary
  blocks); `all_gather_rs` is the gather whose backward is a
  reduce-scatter, where each rank goes on with its own slice only (the
  expert layer's gather of the tokens over sp and dp);
- "rotate" (`rotate`): forward sends to the next rank and receives from
  the previous one, backward sends the gradient to the previous rank and
  receives from the next (the ring's K/V blocks);
- pp's point-to-point `send` / `recv`, which the pipeline's own backward
  (`parallel/pipeline.py`) pairs: the activation goes forward, its
  gradient comes back.

Under `torch.no_grad()` / `inference_mode`, or for a tensor that requires
no gradient, each pair runs exactly the collective serving runs, in place
where it ran in place. `torch.distributed.nn.functional.all_reduce` is not
used: its backward all-reduces the gradient, which multiplies the gradient
of a replicated loss by the axis size.

An engine's world is dp x tp x ep x sp ranks: dp takes the ranks that
tp x ep x sp leave over, as the JAX engines' ``"dp": -1`` takes the spare
devices, and each dp line of tp x ep x sp ranks holds the whole model
(its tp and ep slices) and computes the whole batch, as JAX replicates
over dp. `Mesh.tensor_parallel` refuses pp alone: the pipeline is the
trainer's, whose axes come from `Mesh.axis`.

`make_hybrid_mesh` lays the ranks of several hosts out as JAX's
`mesh_utils.create_hybrid_device_mesh` lays out its granules: a host is
one of torchrun's nodes (`LOCAL_WORLD_SIZE` contiguous ranks), laid out
row-major over the ici sizes, and the hosts tile the dcn grid. Such a
layout is not row-major in rank, so a `Mesh` carries its ranks in mesh
order (`layout`); every mesh `make_mesh` builds keeps rank order.

The mesh is this module's own small class, not `torch.distributed.
device_mesh`: a `DeviceMesh` pins each rank to the device of its index,
and the card phases run two ranks on one GPU.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

log = logging.getLogger(__name__)

AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "ep", "sp", "tp")
# Backends whose collectives a CUDA graph can capture.
CAPTURABLE_BACKENDS = ("nccl",)
# How long a collective may wait for its peers. A follower rank waits in a
# broadcast for the leader's next step for as long as the node is idle, so
# the default is long (torch's own is 10-30 minutes). A rank that fails
# does not leave its peers to wait this out: it aborts the group
# (`TensorParallel.abort`, from `spmd.Replica`).
DEFAULT_TIMEOUT = datetime.timedelta(days=7)
# What the point-to-point collectives did, since the caller last cleared
# it: "rotate" / "rotate_backward" count ring rotations forward (a remat
# recompute included) and backward; "send" / "recv" count pp hops and
# "send_s" / "recv_s" their wall seconds (staging through host memory
# included). Read by the card check's sp and pp phases.
STATS: collections.Counter = collections.Counter()


def mesh_sizes(axis_sizes: Optional[dict], n: int,
               axis_order: Tuple[str, ...] = AXIS_ORDER) -> Dict[str, int]:
    """Every axis' size over `n` ranks, by the JAX package's rules: at
    most one axis may be -1 (inferred), axes not mentioned get 1, and a
    remainder goes to dp when dp is unset."""
    sizes = dict(axis_sizes or {})
    unknown = [a for a in sizes if a not in axis_order]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; expected {axis_order}")
    infer = [a for a, s in sizes.items() if s == -1]
    if len(infer) > 1:
        raise ValueError("at most one axis size may be -1")
    known = math.prod(s for s in sizes.values() if s != -1)
    if infer:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[infer[0]] = n // known
    elif known != n:
        if "dp" not in sizes and n % known == 0:
            sizes["dp"] = n // known
        else:
            raise ValueError(f"axis sizes {sizes} do not multiply to {n} devices")
    return {a: sizes.get(a, 1) for a in axis_order}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks laid out over named axes, tp innermost (fastest-varying), as
    the JAX mesh lays out devices. `group` is the process group the ranks
    belong to (None for one rank)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0
    group: Any = None
    backend: Optional[str] = None
    # Where this rank computes (the trainer's parameters and batches);
    # None is the card.
    device: Any = None
    # The ranks in mesh order (row-major over `sizes`); None is rank
    # order, rank r at mesh index r (`make_hybrid_mesh` tiles hosts).
    layout: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.layout is not None and \
                sorted(self.layout) != list(range(self.world_size)):
            raise ValueError(f"layout {self.layout} is not the ranks "
                             f"0..{self.world_size - 1}, each once")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def _index(self) -> int:
        """This rank's row-major index in the mesh."""
        return self.rank if self.layout is None else \
            self.layout.index(self.rank)

    def _rank_at(self, index: int) -> int:
        return index if self.layout is None else self.layout[index]

    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        out, rest = {}, self._index()
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rest % n
            rest //= n
        return {a: out[a] for a in self.axis_names}

    @property
    def world_size(self) -> int:
        return math.prod(self.sizes)

    def axis_ranks(self, name: str) -> Tuple[int, ...]:
        """The ranks of this rank's `name` axis, in index order: those
        that share every other coordinate with it."""
        shape = self.shape
        stride = math.prod(shape[a] for a in self.axis_names[
            self.axis_names.index(name) + 1:])
        base = self._index() - self.coords()[name] * stride
        return tuple(self._rank_at(base + i * stride)
                     for i in range(shape[name]))

    def axis(self, name: str) -> "ParallelAxis":
        """This rank's `name` axis and its collectives: over a subgroup of
        the ranks that share every other coordinate (`axis_ranks`), the
        whole group where the axis spans it; a size-1 axis (SINGLE for
        tp) where the mesh does not split `name`."""
        n = self.shape[name]
        if n == 1:
            return SINGLE if name == "tp" else ParallelAxis(name=name)
        group = self.group
        if group is not None and n != self.world_size:
            group = _axis_groups(self)[self.axis_ranks(name)]
        return ParallelAxis(size=n, rank=self.coords()[name], group=group,
                            backend=self.backend, name=name,
                            ranks=self.axis_ranks(name))

    def world(self) -> "ParallelAxis":
        """Every rank of the mesh as one axis: the engines' replicated host
        loop broadcasts rank 0's calls over it."""
        n = self.world_size
        if n == 1:
            return ParallelAxis(name="world")
        return ParallelAxis(size=n, rank=self.rank, group=self.group,
                            backend=self.backend, name="world",
                            ranks=tuple(range(n)))

    def tensor_parallel(self) -> "ParallelAxis":
        """The tp axis' collectives, for an engine, whose ranks are its
        dp x tp x ep x sp. Raises where the ranks spread over pp: the
        pipeline is the trainer's (`train.train.make_sharded_train_step`),
        and the JAX engines put no pp in their mesh."""
        if self.shape.get("pp", 1) > 1:
            raise NotImplementedError(
                f"mesh axis pp={self.shape['pp']} does not shard an engine "
                f"(the pipeline is the trainer's): an engine's ranks are "
                f"its dp x tp x ep x sp")
        return self.axis("tp")

    def torch_device(self) -> torch.device:
        """The device this rank computes on (`resolve_device`: the card
        unless the mesh names the CPU)."""
        from ..device import resolve_device

        return resolve_device("cuda" if self.device is None else self.device)


# Subgroups made so far, by (default group, axis sizes, layout): every
# rank must create every subgroup of a mesh in the same order
# (`dist.new_group` is a collective over the default group), and engines
# built again over the same mesh reuse them.
_GROUPS: Dict[Tuple[Any, Tuple[int, ...], Any],
              Dict[Tuple[int, ...], Any]] = {}


def _axis_groups(mesh: Mesh) -> Dict[Tuple[int, ...], Any]:
    """A subgroup for each line of ranks of each axis that splits the mesh
    but does not span it, made on every rank in one order (axes in
    AXIS_ORDER, lines by their first rank): ranks -> group. A line's
    ranks must ascend along the axis: a subgroup numbers its ranks in
    ascending order, and the gathers concatenate in that order (every
    row-major and every hybrid layout ascends)."""
    key = (mesh.group, mesh.sizes, mesh.layout)
    if key in _GROUPS:
        return _GROUPS[key]
    from torch import distributed as dist

    groups: Dict[Tuple[int, ...], Any] = {}
    for name, n in zip(mesh.axis_names, mesh.sizes):
        if n == 1 or n == mesh.world_size:
            continue
        lines = sorted({dataclasses.replace(mesh, rank=r).axis_ranks(name)
                        for r in range(mesh.world_size)})
        for line in lines:
            if list(line) != sorted(line):
                raise ValueError(f"the {name} axis' ranks {line} do not "
                                 f"ascend in the layout")
            groups[line] = dist.new_group(list(line))
    _GROUPS[key] = groups
    return groups


def make_mesh(axis_sizes: Optional[dict] = None, *,
              axis_order: Tuple[str, ...] = AXIS_ORDER,
              world_size: Optional[int] = None,
              rank: Optional[int] = None, device: Any = None) -> Mesh:
    """A mesh over the ranks of the default process group (one rank
    without one). `world_size` and `rank` stand in for the group's (a
    caller laying out ranks it has not started); `device` is where this
    rank computes (None: the card).

    >>> make_mesh({"tp": 2})  # 2 ranks: 2-way tensor parallel
    """
    n, r, group, backend = _ranks(world_size, rank)
    sizes = mesh_sizes(axis_sizes, n, axis_order)
    return Mesh(tuple(axis_order), tuple(sizes[a] for a in axis_order),
                rank=r, group=group, backend=backend, device=device)


def _ranks(world_size: Optional[int], rank: Optional[int]
           ) -> Tuple[int, int, Any, Optional[str]]:
    """(ranks, this rank, group, backend) of the default process group,
    `world_size` and `rank` standing in for its where given (then no
    group: the caller lays out ranks it has not started)."""
    from torch import distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    n = world_size if world_size is not None else (
        dist.get_world_size() if joined else 1)
    r = rank if rank is not None else (dist.get_rank() if joined else 0)
    group = backend = None
    if joined and world_size is None and n > 1:
        group = dist.group.WORLD
        backend = dist.get_backend()
    return n, r, group, backend


def make_hybrid_mesh(ici_axis_sizes: dict,
                     dcn_axis_sizes: Optional[dict] = None, *,
                     axis_order: Tuple[str, ...] = AXIS_ORDER,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     device: Any = None) -> Mesh:
    """A mesh over several hosts: `dcn_axis_sizes` are the axes that span
    hosts, `ici_axis_sizes` those within a host (the JAX package's
    contract). With a dcn product of 1 it is `make_mesh` over the merged
    sizes. Else a host is one of torchrun's nodes: the `local_world_size`
    (`LOCAL_WORLD_SIZE`, read now) contiguous ranks torchrun numbers
    `group_rank * local_world_size + local_rank`. Each host's ranks are
    laid out row-major over the ici sizes and the hosts tile the dcn grid
    row-major, as `mesh_utils.create_hybrid_device_mesh` tiles its
    granules (`np.block`): along each axis a rank's coordinate is its
    host's dcn coordinate times the ici size plus its ici coordinate.
    Raises where the hosts are not the dcn product or a host's ranks not
    the ici product. `world_size`, `rank` and `device` are `make_mesh`'s.

    >>> make_hybrid_mesh({"tp": 4}, {"dp": 2})  # 2 hosts of 4 ranks
    """
    dcn_axis_sizes = dict(dcn_axis_sizes or {})
    unknown = [a for a in (*ici_axis_sizes, *dcn_axis_sizes)
               if a not in axis_order]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; expected {axis_order}")
    ici = [ici_axis_sizes.get(a, 1) for a in axis_order]
    dcn = [dcn_axis_sizes.get(a, 1) for a in axis_order]
    merged = {a: i * d for a, i, d in zip(axis_order, ici, dcn)}
    if math.prod(dcn) == 1:
        return make_mesh(merged, axis_order=axis_order,
                         world_size=world_size, rank=rank, device=device)
    n, r, group, backend = _ranks(world_size, rank)
    local = local_world_size if local_world_size is not None else int(
        os.environ.get("LOCAL_WORLD_SIZE", n))
    if local < 1 or n % local:
        raise ValueError(f"{n} ranks do not split into hosts of "
                         f"LOCAL_WORLD_SIZE={local}")
    if n // local != math.prod(dcn):
        raise ValueError(f"the number of hosts {n // local} must equal the "
                         f"product of the dcn axis sizes {dcn}")
    if local != math.prod(ici):
        raise ValueError(f"a host's {local} ranks must equal the product "
                         f"of the ici axis sizes {ici}")
    layout = [0] * n
    for g in range(n):
        host, own = divmod(g, local)
        index = 0
        for d, i, h, o in zip(dcn, ici, _unravel(host, dcn),
                              _unravel(own, ici)):
            index = index * d * i + h * i + o
        layout[index] = g
    return Mesh(tuple(axis_order), tuple(merged[a] for a in axis_order),
                rank=r, group=group, backend=backend, device=device,
                layout=tuple(layout))


def _unravel(index: int, sizes: List[int]) -> List[int]:
    """Row-major coordinates of `index` in a grid of `sizes`."""
    out = []
    for n in reversed(sizes):
        out.append(index % n)
        index //= n
    return out[::-1]


def single_mesh(device: Any = None) -> Mesh:
    """The mesh of one rank, whatever group the process has joined: the
    trainer's one-device path."""
    return Mesh(AXIS_ORDER, (1,) * len(AXIS_ORDER), device=device)


def init_process_group(backend: str, init_method: str, world_size: int,
                       rank: int,
                       timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the default process group explicitly: `backend` "nccl" (one GPU
    a rank) or "gloo" (named by the caller, never substituted here),
    `init_method` a `tcp://host:port` or `file://path` rendezvous."""
    from torch import distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def initialize_multihost(backend: Optional[str] = None,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> bool:
    """Join the process group torchrun describes (`MASTER_ADDR`,
    `MASTER_PORT`, `RANK`, `WORLD_SIZE` in the environment); a no-op for a
    single process. `backend` must be given where the group is joined.
    Returns True if a group of more than one rank was joined."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    from torch import distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if backend is None:
        raise ValueError(
            f"WORLD_SIZE={world}: pass the collective backend (nccl with "
            f"one GPU a rank, gloo otherwise)")
    init_process_group(backend, "env://", world, int(os.environ["RANK"]),
                       timeout)
    return True


def backend_can_capture(backend: Optional[str]) -> bool:
    """Whether a CUDA graph can capture this backend's collectives (no
    backend: one rank, nothing to capture)."""
    return backend is None or backend in CAPTURABLE_BACKENDS


@dataclasses.dataclass(frozen=True)
class ParallelAxis:
    """One axis of a mesh (`name`: tp, ep, sp, or the whole "world"): its
    size, this rank's index along it and the collectives over it. `ranks`
    are the axis' ranks in the process group (None: 0..size-1). At size 1
    (`SINGLE` for tp) every collective returns its input."""

    size: int = 1
    rank: int = 0
    group: Any = None
    backend: Optional[str] = None
    name: str = "tp"
    ranks: Optional[Tuple[int, ...]] = None

    def _global(self, index: int) -> int:
        """The process-group rank of the axis' `index`-th rank."""
        return index if self.ranks is None else self.ranks[index]

    @property
    def leader(self) -> bool:
        """Rank 0 of the axis: the rank that takes requests."""
        return self.rank == 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The "reduce" pair: the sum over the ranks forward (the
        row-parallel product's reduce, the vocabulary-parallel embedding,
        the ep combine), the identity backward. Without a gradient to
        carry it sums in place on `x`, which is returned; with one, into a
        new tensor."""
        if self.size == 1:
            return x
        if _carries_grad(x):
            return _Reduce.apply(x, self)
        return self._all_reduce_(x)

    def _all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        from torch import distributed as dist

        dist.all_reduce(x, group=self.group)
        return x

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """The "copy" pair: the identity forward, the sum of the ranks'
        gradients backward; on a replicated activation entering a
        column-parallel product or this rank's experts, each rank's
        product giving only its share of the activation's gradient. `x`
        itself without a gradient to carry."""
        if self.size == 1 or not _carries_grad(x):
            return x
        return _Copy.apply(x, self)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The "gather" pair: every rank's `x` concatenated along `dim` in
        rank order forward (the vocabulary shards of the logits); this
        rank's slice of the gradient backward, for a replicated
        computation downstream, whose gradient every rank holds whole."""
        if self.size == 1:
            return x
        if _carries_grad(x):
            return _Gather.apply(x, self, dim, False)
        return self._all_gather(x, dim)

    def all_gather_rs(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The gather whose backward is a reduce-scatter: for a caller
        that gathers, computes on the whole and goes on with its own slice
        only (the expert layer's tokens over sp and dp), so each rank's
        gradient of the whole is a share, summed over the ranks before
        this rank takes its slice. Forward exactly `all_gather`."""
        if self.size == 1:
            return x
        if _carries_grad(x):
            return _Gather.apply(x, self, dim, True)
        return self._all_gather(x, dim)

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        from torch import distributed as dist

        x = x.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(x)
                                     for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast_object(self, obj: Any = None) -> Any:
        """Rank 0's `obj` on every rank (a step's host inputs; picklable
        Python objects)."""
        if self.size == 1:
            return obj
        from torch import distributed as dist

        box = [obj if self.leader else None]
        dist.broadcast_object_list(box, src=self._global(0),
                                   group=self.group)
        return box[0]

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """The "rotate" pair: one ring step forward, sending `x` to the
        next rank along the axis and returning what the previous one sent
        (the ring attention's K/V rotation); backward the gradient goes
        the other way, to the previous rank, and the next one's comes
        back. Over gloo a CUDA tensor travels through host buffers,
        staged here explicitly: gloo's point-to-point ops move host
        memory. nccl sends the device tensor itself."""
        if self.size == 1:
            return x
        STATS["rotate"] += 1
        if _carries_grad(x):
            return _Rotate.apply(x, self)
        return self._shift(x, 1)

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def _shift(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """Send `x` to the rank `step` along the ring and receive from the
        rank `step` before it, as one paired batch of point-to-point
        ops."""
        from torch import distributed as dist

        staged = self._staged(x)
        send = x.detach().to("cpu") if staged else x.detach().contiguous()
        recv = torch.empty_like(send)
        nxt = self._global((self.rank + step) % self.size)
        prv = self._global((self.rank - step) % self.size)
        ops = [dist.P2POp(dist.isend, send, nxt, self.group),
               dist.P2POp(dist.irecv, recv, prv, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(x.device, non_blocking=False) if staged else recv

    def send(self, x: torch.Tensor, dst: int) -> None:
        """Send `x` to the axis' `dst`-th rank (a pp hop: the activation
        forward, its gradient back), through host memory over gloo."""
        from torch import distributed as dist

        t0 = time.perf_counter()
        buf = x.detach().to("cpu") if self._staged(x) else \
            x.detach().contiguous()
        dist.send(buf, self._global(dst), group=self.group)
        STATS["send"] += 1
        STATS["send_s"] += time.perf_counter() - t0

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """A tensor shaped and typed as `like`, on its device, received
        from the axis' `src`-th rank (the other end of `send`)."""
        from torch import distributed as dist

        t0 = time.perf_counter()
        staged = self._staged(like)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        dist.recv(buf, self._global(src), group=self.group)
        out = buf.to(like.device) if staged else buf
        STATS["recv"] += 1
        STATS["recv_s"] += time.perf_counter() - t0
        return out

    def abort(self) -> None:
        """Abort the process group after this rank failed mid-call: its
        peers' pending and later collectives raise instead of waiting for
        it. `_abort_process_group` where this torch has it (NCCL needs it:
        its destroy may wait on a collective that never completes), else
        `destroy_process_group` (gloo's closes the peers' connections).
        A failure to abort is logged: the rank's own error is the one
        raised."""
        if self.size == 1:
            return
        from torch import distributed as dist
        from torch.distributed import distributed_c10d as c10d

        if not dist.is_initialized():
            return
        abort = getattr(c10d, "_abort_process_group",
                        dist.destroy_process_group)
        try:
            abort(self.group)
        except Exception:
            log.exception("aborting the %s process group failed", self.name)


def _carries_grad(x: torch.Tensor) -> bool:
    """Whether a collective on `x` must carry a gradient: grad mode on and
    `x` part of the graph. Otherwise the pairs run serving's collective."""
    return torch.is_grad_enabled() and x.requires_grad


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis._all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._all_reduce_(
            g.clone(memory_format=torch.contiguous_format)), None


class _Gather(torch.autograd.Function):
    """All-gather forward; backward this rank's slice of the gradient,
    summed over the ranks first where `scatter` (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis, dim, scatter):
        ctx.axis, ctx.dim, ctx.scatter = axis, dim, scatter
        ctx.n = x.shape[dim]
        return axis._all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        if ctx.scatter:
            g = axis._all_reduce_(g.clone(memory_format=torch.contiguous_format))
        return g.narrow(ctx.dim, axis.rank * ctx.n, ctx.n), None, None, None


class _Rotate(torch.autograd.Function):
    """One ring step forward; the gradient one step back."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._shift(x, 1)

    @staticmethod
    def backward(ctx, g):
        STATS["rotate_backward"] += 1
        return ctx.axis._shift(g, -1), None


# The tp axis keeps its name: the models' and engines' callers.
TensorParallel = ParallelAxis


SINGLE = ParallelAxis()


def tensor_parallel_of(cfg: Any) -> ParallelAxis:
    """The tp axis a model config carries (`tensor_parallel`), SINGLE when
    it carries none."""
    return getattr(cfg, "tensor_parallel", None) or SINGLE


def axis_of(cfg: Any, field: str, name: str) -> ParallelAxis:
    """The axis a model config carries in `field` (`expert_parallel`,
    `sequence_parallel`), a size-1 axis `name` when it carries none."""
    return getattr(cfg, field, None) or ParallelAxis(name=name)


def divisors(n: int) -> List[int]:
    """The ascending divisors of `n`: the tp ways that split an axis of n
    evenly."""
    small = [d for d in range(1, math.isqrt(n) + 1) if n % d == 0]
    return sorted(set(small + [n // d for d in small]))
