"""The training step, the driver and the CLI: fine-tune the tutoring model
on course material, on one device or sharded over dp, tp, sp, ep and pp.

Port of `distributed_lms_raft_llm_tpu/train/train.py`. The reference has
no training (SURVEY.md §2.2); the JAX package added the path, and the port
carries it: the LM loss, AdamW with a warmup-cosine schedule and global-norm
clipping, rematerialized blocks, the MoE load-balance aux loss, periodic
checkpoints that resume, the export the tutoring node serves, and the
sharded step (`make_sharded_train_step`, `train_state_shardings`).

What differs from the JAX package:

- One process a rank over `torch.distributed` (`parallel.mesh`), where
  JAX jits one global step and lets XLA derive the collectives. Each rank
  holds its slice of the train state (`train_state_shardings`: the params
  by GPT2_RULES / MOE_RULES, a block leaf's layer axis over pp, Adam's
  moments as their parameter, counts and step whole) and its block of the
  batch (its dp rows; under sp the forward embeds its T/sp of each row,
  as `gpt2.forward`'s ring mode does). The forward's collectives are the
  conjugate pairs of `parallel.mesh`, so each rank's gradient of a leaf is
  that of the one global loss with respect to its copy or shard; the step
  then sums the gradients over the data axes (dp, sp), takes the global
  norm over distinct shards (a leaf replicated over tp, ep or pp counted
  once) and applies the same clip on every rank. The token mean divides
  the ranks' summed masked log likelihood by the all-reduced mask count;
  a shard's last position predicts the next shard's first token. MoE
  routes the global batch (the expert layer gathers the rows over dp as
  it gathers the sequence over sp), and its aux term, whole on every
  rank, enters each data rank's backward divided by the data ranks, so
  the summed gradient counts it once.
- The optimizer is written out to optax's formulas (`AdamW`), its state
  named as optax's (`EmptyState`, `ScaleByAdamState`,
  `ScaleByScheduleState`), so the checkpoint's leaf names are the
  reference's (`train/checkpoint.py`). As in optax the schedule is read
  at the count before it increments: with warmup the first step's rate is
  0, so step 1 moves no parameter while Adam's moments still take its
  gradient.
- The step updates the state's tensors in place and returns the same
  state (the reference's jitted step donates its state).
- `remat` recomputes each block in the backward pass
  (`gpt2.forward(remat=True)`; under pp each layer inside its stage),
  where the reference wraps the whole forward in `jax.checkpoint`: the
  same loss, less memory held.
- `fit` takes a mesh, or a device for one rank (`parallel.mesh.
  single_mesh`); the CLI joins torchrun's group with the `--backend` the
  caller names and lays ranks out as JAX's CLI does; rank 0 logs and
  writes the checkpoint and the export, which hold the unsharded layout.
- Llama presets raise: the reference's step runs `gpt2.forward` too.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device
from ..models import gpt2, moe
from ..parallel import mesh as mesh_lib
from ..parallel import partition
from .checkpoint import flatten_with_paths, map_with_paths

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    decay_steps: int = 10_000  # cosine horizon; set to the planned run length
    max_grad_norm: float = 1.0
    remat: bool = True  # rematerialize block activations (memory for ops)
    # GPipe microbatches per step when the mesh has a pp axis > 1 (the
    # stacked trunk pipelines via parallel.pipeline.pipeline_trunk; bubble
    # fraction (pp-1)/(pp_micro+pp-1)).
    pp_micro: int = 2
    # MoE: weight of the Switch load-balance aux loss (models/moe.py,
    # applies only to GPT2MoEConfig models — keeps the router from
    # collapsing onto a few experts).
    moe_aux_weight: float = 0.01


def _is_moe(model_cfg) -> bool:
    return isinstance(model_cfg, moe.GPT2MoEConfig)


def check_trainable(model_cfg) -> None:
    """Raise for a config the trainer cannot train: it runs `gpt2.forward`
    (GPT-2 and GPT-2-MoE), as the reference's step does."""
    if not isinstance(model_cfg, gpt2.GPT2Config):
        raise ValueError(
            f"the trainer trains the GPT-2 and GPT-2-MoE families (its step "
            f"runs gpt2.forward, as the JAX package's does); "
            f"{type(model_cfg).__name__} is not one of them"
        )


# ------------------------------------------------------------- optimizer


class EmptyState(NamedTuple):
    """optax's EmptyState: a transformation with no state (no leaves)."""


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 [], the steps taken
    mu: Params           # first moments, the params' tree
    nu: Params           # second moments


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 [], the count the schedule is read at


@dataclasses.dataclass(frozen=True)
class AdamW:
    """`optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    weight_decay))` with `schedule = warmup_cosine_decay_schedule(0,
    learning_rate, warmup_steps, decay_steps)`, written out in float32 in
    optax's order of operations. Its state is
    ``(EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState(),
    ScaleByScheduleState(count)))``, optax's tree.

    A step: the global norm of the gradients; each gradient scaled by
    max_norm / norm when norm >= max_norm (optax's clip, no epsilon);
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu; with count + 1 = n,
    u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps); u + decay * p
    (every leaf: biases, norms and both tables too, optax's mask None);
    times -schedule(count) read before its increment; p + u.
    """

    learning_rate: float
    warmup_steps: int
    decay_steps: int
    weight_decay: float
    max_grad_norm: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __post_init__(self):
        if not self.decay_steps - self.warmup_steps > 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, "
                f"got decay_steps={self.decay_steps - self.warmup_steps}.")

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """optax.warmup_cosine_decay_schedule at `count` (int32), float32:
        a linear ramp from 0 over the warmup, then a cosine to 0."""
        peak, warm = self.learning_rate, self.warmup_steps
        if warm > 0:
            frac = 1 - torch.clamp(count, 0, warm) / warm
            ramp = (0.0 - peak) * frac + peak
        else:  # optax's polynomial schedule is then its init value
            ramp = torch.zeros((), dtype=torch.float32, device=count.device)
        horizon = self.decay_steps - warm
        c = torch.clamp(count - warm, max=horizon).float()
        # optax's (1 - alpha) * cosine ** exponent + alpha is the cosine
        # itself at its end value 0 and exponent 1.
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(horizon)))
        return torch.where(count < warm, ramp, peak * cosine)

    def init(self, params: Params):
        leaf = flatten_with_paths(params)[0][1]

        def count():
            return torch.zeros((), dtype=torch.int32, device=leaf.device)

        def zeros(tree):
            return {k: zeros(v) if isinstance(v, dict)
                    else torch.zeros_like(v, requires_grad=False)
                    for k, v in tree.items()}

        return (EmptyState(), (ScaleByAdamState(count(), zeros(params),
                                                zeros(params)),
                               EmptyState(), ScaleByScheduleState(count())))

    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], opt_state,
              norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update, in place: `params` (the tree's leaves in order), the
        moments and both counts. `norm` is the gradients' global norm
        where the caller took it over shards (the sharded step: the same
        number on every rank), else taken here. Returns it (before
        clipping). Call under `torch.no_grad()`."""
        adam, _, sched = opt_state[1]
        mus = [v for _, v in flatten_with_paths(adam.mu)]
        nus = [v for _, v in flatten_with_paths(adam.nu)]
        if norm is None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        below = norm < self.max_grad_norm
        n = adam.count + 1
        bc1 = 1 - self.b1 ** n
        bc2 = 1 - self.b2 ** n
        step_size = -self.schedule(sched.count)
        b1, b2 = self.b1, self.b2
        for p, g, mu, nu in zip(params, grads, mus, nus):
            g = torch.where(below, g, (g / norm) * self.max_grad_norm)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + step_size * u)
        adam.count.copy_(n)
        sched.count.add_(1)
        return norm


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(learning_rate=cfg.learning_rate,
                 warmup_steps=cfg.warmup_steps, decay_steps=cfg.decay_steps,
                 weight_decay=cfg.weight_decay,
                 max_grad_norm=cfg.max_grad_norm)


# ------------------------------------------------------------------ step


def masked_nll(logits: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor):
    """`lm_loss`'s numerator and denominator: the masked sum of -log p of
    each target, and the mask's sum (the sharded step sums both over the
    data ranks before it divides)."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return -torch.sum(picked * mask), torch.sum(mask)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy; logits [B,T,V] f32, targets/mask [B,T]."""
    total, count = masked_nll(logits, targets, mask)
    return total / torch.clamp(count, min=1.0)


def init_train_state(seed: int, model_cfg: gpt2.GPT2Config,
                     optimizer: AdamW, device: DeviceLike = "cuda",
                     mesh: Optional[mesh_lib.Mesh] = None) -> Dict[str, Any]:
    """Params from the family's seeded init (requiring grad), the
    optimizer's zero state and step 0 (int32), on `device`. With a `mesh`
    the params are this rank's slice (`train_state_shardings`) of the same
    init on every rank, and the moments the slice's zeros."""
    check_trainable(model_cfg)
    dev = resolve_device(device)
    init = moe.init_params if _is_moe(model_cfg) else gpt2.init_params
    params = init(model_cfg, seed, dev)
    if mesh is not None and mesh.world_size > 1:
        spec = state_spec(mesh, _is_moe(model_cfg))
        coords, sizes = mesh.coords(), mesh.shape
        params = map_with_paths(
            lambda path, leaf: partition.slice_leaf(
                path, leaf, spec(f"params/{path}", leaf), coords, sizes),
            params)
    for _, leaf in flatten_with_paths(params):
        leaf.requires_grad_(True)
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def train_state_shardings(state: Dict[str, Any],
                          mesh: mesh_lib.Mesh) -> Dict[str, Any]:
    """What each leaf's slice is on this rank, the JAX package's
    `train_state_shardings` as spec tuples (`parallel.partition.Spec`):
    params and Adam's moments follow the model's partition rules (MoE
    states, recognised by their blocks, take MOE_RULES: experts over ep);
    a pp axis > 1 also splits every block leaf's layer axis over pp, each
    stage holding its L/pp layers and their moments; counts and step are
    whole. A tree matching `state`."""
    is_moe = "moe" in state["params"].get("blocks", {})
    return map_with_paths(state_spec(mesh, is_moe), state)


def state_spec(mesh: mesh_lib.Mesh, is_moe: bool
               ) -> Callable[[str, Any], partition.Spec]:
    """`spec(path, leaf)`: the partition spec of the train state's leaf at
    `path` (`params/...`, `opt_state/...`, `step`), as
    `train_state_shardings` gives it."""
    rules = partition.RULES_FOR["gpt2_moe" if is_moe else "gpt2"]
    pipelined = mesh.shape.get("pp", 1) > 1

    def param_spec(path: str, leaf: Any) -> partition.Spec:
        spec = partition._spec_for(rules, path, leaf)
        if pipelined and path.startswith("blocks/"):
            spec = ("pp",) + tuple(spec[1:])
        return spec

    def spec(path: str, leaf: Any) -> partition.Spec:
        if getattr(leaf, "ndim", 0) == 0:
            return ()
        for prefix in ("params/", "opt_state/1/0/mu/", "opt_state/1/0/nu/"):
            if path.startswith(prefix):
                return param_spec(path[len(prefix):], leaf)
        return ()

    return spec


def model_axes(mesh: mesh_lib.Mesh) -> Dict[str, Any]:
    """The rank's `ParallelAxis` by name (size 1 where the mesh does not
    split an axis)."""
    return {a: mesh.axis(a) for a in mesh.axis_names}


def _sharded_cfg(model_cfg, axes: Dict[str, Any], pipelined: bool):
    """The model config carrying the axes its forward's collectives run
    over (none under pp: the pipeline's stage body has none)."""
    if pipelined:
        return model_cfg
    kw = dict(tensor_parallel=axes["tp"] if axes["tp"].size > 1 else None,
              sequence_parallel=axes["sp"] if axes["sp"].size > 1 else None)
    if _is_moe(model_cfg):
        kw.update(expert_parallel=axes["ep"] if axes["ep"].size > 1
                  else None)
    cfg = dataclasses.replace(model_cfg, **kw)
    if _is_moe(model_cfg) and axes["dp"].size > 1:
        cfg = moe.with_data_parallel(cfg, axes["dp"])
    return cfg


def make_train_step(
    model_cfg: gpt2.GPT2Config,
    optimizer: AdamW,
    remat: bool = True,
    mesh: Optional[mesh_lib.Mesh] = None,
    pp_micro: int = 2,
    moe_aux_weight: float = 0.01,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): `state` this
    rank's slice of the train state (`train_state_shardings`; the whole
    state without a mesh), `batch` holds `input_ids` and `loss_mask`
    [B, T] (numpy or tensors; under a mesh this rank's dp rows, as
    `make_sharded_train_step`'s slicer gives them); metrics are 0-d
    tensors on the device, the same on every rank: `loss`, `grad_norm`
    (before clipping) and, for MoE, `moe_balance` (the layers' mean aux).
    The state's tensors are updated in place. `train_step.last` holds the
    last step's gradient all-reduce over the data axes: `bytes` and `ms`.

    Parallel axes activate from the mesh's shape, as in the JAX package:
    tp, ep and sp shard the forward (`gpt2.forward` with the axes in its
    config: ring attention at sp > 1); pp > 1 runs the trunk as a GPipe
    pipeline (`gpt2.forward_pipelined`) with `pp_micro` microbatches.
    """
    check_trainable(model_cfg)
    is_moe = _is_moe(model_cfg)
    mesh = mesh or mesh_lib.single_mesh()
    shape = mesh.shape
    pipelined = shape.get("pp", 1) > 1
    if pipelined and is_moe:
        raise ValueError(
            "pp and MoE cannot combine yet: the pipeline stage body has "
            "no aux-loss channel; use ep x tp x dp"
        )
    if pipelined:
        # Combinations the pipeline schedule does not implement yet (the
        # JAX package's refusals): ring attention would be dropped under
        # sp, and the stage body has no tp collectives.
        if shape.get("sp", 1) > 1:
            raise ValueError(
                "pp and sp cannot combine: the pipeline stage body uses "
                "dense attention (ring attention unreachable under pp)"
            )
        if shape.get("tp", 1) > 1:
            raise ValueError(
                "pp and tp cannot combine: the pipeline stage body has no "
                "tensor-parallel collectives; use pp x dp"
            )
    axes = model_axes(mesh)
    cfg = _sharded_cfg(model_cfg, axes, pipelined)
    sp = axes["sp"]
    data_axes = [axes[a] for a in ("sp", "dp") if axes[a].size > 1]
    data_ways = math.prod(a.size for a in data_axes)
    world = mesh.world()
    spec = state_spec(mesh, is_moe)

    def local_loss(params, ids, mask):
        """This rank's masked sum of the next-token log likelihood (the
        positions it computes), its mask count and the MoE aux."""
        if pipelined:
            logits = gpt2.forward_pipelined(params, cfg, ids, mesh,
                                            n_micro=pp_micro, remat=remat)
            aux = None
        else:
            out = gpt2.forward(params, cfg, ids, collect_moe_aux=is_moe,
                               remat=remat)
            logits, aux = out[0], (out[2] if is_moe else None)
        # Next-token prediction: position p predicts ids[p + 1]; a shard's
        # last position the next shard's first token, the last position
        # of the sequence nothing.
        t, t_loc = ids.shape[1], logits.shape[1]
        lo = sp.rank * t_loc
        n = min(t_loc, t - 1 - lo)
        return (*masked_nll(logits[:, :n], ids[:, lo + 1:lo + 1 + n],
                            mask[:, lo + 1:lo + 1 + n]), aux)

    def train_step(state, batch):
        names, leaves = zip(*flatten_with_paths(state["params"]))
        device = leaves[0].device
        ids = torch.as_tensor(batch["input_ids"], device=device).long()
        mask = torch.as_tensor(batch["loss_mask"], device=device)
        with torch.enable_grad():
            total, count, aux = local_loss(state["params"], ids, mask)
            count = count.detach()
            for ax in data_axes:
                # "reduce": each data rank's backward takes its own sum's
                # share of the global mean.
                total = ax.all_reduce(total)
                count = ax.all_reduce(count)
            loss = total / torch.clamp(count, min=1.0)
            target = loss
            if is_moe:
                # The aux is whole on every rank; the data ranks' summed
                # gradients count it once.
                target = loss + (moe_aux_weight / data_ways) * aux
                loss = loss + moe_aux_weight * aux.detach()
            grads = torch.autograd.grad(target, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        with torch.no_grad():
            train_step.last = _sum_over_data(grads, data_axes)
            norm = None
            if world.size > 1:
                specs = [spec(f"params/{k}", g) for k, g in zip(names, grads)]
                norm = _global_norm(grads, specs, mesh, world)
            gnorm = optimizer.apply(leaves, grads, state["opt_state"], norm)
            state["step"].add_(1)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        if is_moe:
            metrics["moe_balance"] = aux.detach()
        return state, metrics

    train_step.last = {"bytes": 0, "ms": 0.0}
    return train_step


def _sum_over_data(grads, data_axes) -> Dict[str, Any]:
    """Sum the gradients over the data axes (sp, then dp) in one flat
    buffer each; returns the bytes a rank all-reduced and the wall ms
    (0 without data axes). Over gloo a CUDA buffer crosses host memory, so
    the ms are gloo's, not the data axis' speed."""
    if not data_axes:
        return {"bytes": 0, "ms": 0.0}
    t0 = time.perf_counter()
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    for ax in data_axes:
        ax.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    if flat.is_cuda:
        torch.cuda.synchronize(flat.device)
    return {"bytes": flat.numel() * flat.element_size() * len(data_axes),
            "ms": (time.perf_counter() - t0) * 1e3}


def _global_norm(grads, specs, mesh, world) -> torch.Tensor:
    """optax.global_norm of the logical gradient, the same number on every
    rank: each leaf's squares divided by the ranks that hold the same
    slice of it (its replicas over the axes its spec does not name: the
    data axes, whose gradients are already summed, and tp, ep or pp where
    the leaf is whole), then summed over every rank."""
    shape = mesh.shape
    sq = []
    for g, spec in zip(grads, specs):
        split = math.prod(shape[a] for a in spec if a is not None)
        sq.append(torch.sum(g * g) / (world.size // split))
    total = sum(sq).reshape(1)
    world.all_reduce(total)
    return torch.sqrt(total[0])


def make_sharded_train_step(mesh: mesh_lib.Mesh, model_cfg: gpt2.GPT2Config,
                            train_cfg: TrainConfig, seed: int = 0):
    """Everything wired: returns (step, state, batch_slicer). `state` is
    this rank's slice of the seeded init on `mesh`'s device;
    `batch_slicer(batch)` keeps this rank's block of a global batch (every
    rank is handed the whole): its dp rows, as tensors on the device, the
    sequence whole (under sp the forward embeds this rank's T/sp of it);
    together they stand for JAX's batch sharding `P("dp", "sp")`. Call
    `step(state, batch_slicer(batch))`."""
    optimizer = make_optimizer(train_cfg)
    device = mesh.torch_device()
    step = make_train_step(model_cfg, optimizer, remat=train_cfg.remat,
                           mesh=mesh, pp_micro=train_cfg.pp_micro,
                           moe_aux_weight=train_cfg.moe_aux_weight)
    state = init_train_state(seed, model_cfg, optimizer, device, mesh)
    dp, dp_rank = mesh.shape["dp"], mesh.coords()["dp"]

    def batch_slicer(batch) -> Dict[str, torch.Tensor]:
        out = {}
        for key in ("input_ids", "loss_mask"):
            v = torch.as_tensor(batch[key])
            if v.shape[0] % dp:
                raise ValueError(f"batch of {v.shape[0]} rows does not "
                                 f"split over dp={dp}")
            per = v.shape[0] // dp
            out[key] = v[dp_rank * per:(dp_rank + 1) * per].to(device)
        return out

    return step, state, batch_slicer


# ------------------------------------------------------------------ driver


def fit(
    mesh,
    model_cfg: gpt2.GPT2Config,
    train_cfg: TrainConfig,
    dataset,                      # train.data.PackedDataset
    *,
    epochs: int = 1,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    seed: int = 0,
    log_every: int = 10,
) -> Dict[str, Any]:
    """Fine-tune on course data with periodic checkpointing and resume.

    `mesh` is a `parallel.mesh.Mesh` (its device, this rank's slice), or
    a device for one rank. Every rank walks the same batches and keeps its
    block. If `checkpoint_path` exists, training RESUMES from it: the full
    state (params, optimizer moments, counts, step) restores as this
    rank's slice, whatever layout saved it, and the data order continues
    from the recorded step, so an interrupted run and an uninterrupted one
    walk the same step sequence. Rank 0 logs and writes the checkpoints
    (gathered from every rank). Returns the metrics of the last logged
    step (host floats), the state (this rank's slice), the step, and
    `history`: each logged step's metrics with `step_ms`, the wall per
    step since the previous log (the log reads the loss, which waits for
    the device).
    """
    from . import checkpoint as ckpt_lib

    if not isinstance(mesh, mesh_lib.Mesh):
        mesh = mesh_lib.single_mesh(mesh)
    log = logging.getLogger("train")
    lead = mesh.rank == 0
    step_fn, state, batch_slicer = make_sharded_train_step(
        mesh, model_cfg, train_cfg, seed)
    if checkpoint_path and ckpt_lib.latest_step(checkpoint_path) is not None:
        state = ckpt_lib.restore_train_state(checkpoint_path, state, mesh)
        if lead:
            log.info("resumed from %s at step %d", checkpoint_path,
                     int(state["step"]))

    start_step = int(state["step"])
    steps_per_epoch = dataset.steps_per_epoch()
    metrics_host: Dict[str, float] = {}
    history = []
    step_no = start_step
    t_log, step_log = time.monotonic(), start_step
    for epoch in range(epochs):
        for i, batch in enumerate(dataset.batches(epoch)):
            # Resume: skip batches the restored run already consumed.
            if epoch * steps_per_epoch + i < start_step:
                continue
            state, metrics = step_fn(state, batch_slicer(batch))
            step_no += 1
            if step_no % log_every == 0 or step_no == start_step + 1:
                metrics_host = {k: float(v) for k, v in metrics.items()}
                now = time.monotonic()
                step_ms = 1e3 * (now - t_log) / (step_no - step_log)
                t_log, step_log = now, step_no
                history.append(dict(step=step_no, step_ms=step_ms,
                                    **metrics_host))
                if lead:
                    log.info(
                        "step %d loss %.4f gnorm %.3f%s ms/step %.2f",
                        step_no, metrics_host["loss"],
                        metrics_host["grad_norm"],
                        f" moe_balance {metrics_host['moe_balance']:.4f}"
                        if "moe_balance" in metrics_host else "", step_ms)
            if checkpoint_path and step_no % checkpoint_every == 0:
                ckpt_lib.save_train_state(checkpoint_path, state, mesh)
    if checkpoint_path:
        ckpt_lib.save_train_state(checkpoint_path, state, mesh)
    if not metrics_host:
        metrics_host = {"loss": float("nan"), "grad_norm": float("nan")}
    return {"state": state, "metrics": metrics_host, "step": step_no,
            "history": history, "mesh": mesh}


def main(argv=None) -> Dict[str, Any]:
    """CLI: fine-tune the tutoring model on course materials.

    python -m distributed_lms_raft_llm_tpu_torch.train.train \
        --data lms_data/node1/uploads --vocab data/gpt2-local/vocab.json \
        --merges data/gpt2-local/merges.txt --model tiny \
        --checkpoint ckpt/train_state.safetensors --epochs 2

    Sharded, one process a rank under torchrun (dp takes the ranks the
    other axes leave):

    torchrun --nproc-per-node 2 -m distributed_lms_raft_llm_tpu_torch.train.train \
        --data ... --pp 2 --backend gloo

    The JAX package's flags, plus `--device` (default cuda; cpu on
    request), `--backend` (nccl or gloo, never chosen for the caller: with
    nccl each rank takes the card of its LOCAL_RANK) and `--log-every`;
    returns `fit`'s result.
    """
    import argparse

    from ..models import registry
    from ..utils import tokenizer as tok_lib
    from . import checkpoint as ckpt_lib
    from .data import DataConfig, PackedDataset

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data", nargs="+", required=True,
                        help="course-text files/dirs (.txt/.md/.pdf)")
    parser.add_argument("--model", default="gpt2")
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--merges", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="train-state .safetensors (resume if present)")
    parser.add_argument("--export", default=None,
                        help="write fine-tuned params here when done")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence-parallel ways: full-sequence "
                        "attention runs as ring attention over sp shards "
                        "(long-context training)")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline stages: the stacked trunk shards "
                        "L/pp layers per rank (GPipe microbatching)")
    parser.add_argument("--pp-micro", type=int, default=2,
                        help="microbatches per step when --pp > 1")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel ways (MoE presets: expert "
                        "stacks shard over ep; aux load-balance loss is "
                        "applied automatically)")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--log-every", type=int, default=10,
                        help="log (and time) every N steps")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where to train (default the card)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="the collective backend when torchrun starts "
                        "several ranks (WORLD_SIZE > 1); required there")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    _, model_cfg = registry.resolve(args.model, torch.bfloat16,
                                    torch.float32)
    if args.ep > 1 and not _is_moe(model_cfg):
        # Before the (potentially minutes-long) corpus tokenization.
        parser.error(
            f"--ep {args.ep} requires an MoE model preset; {args.model!r} "
            f"has no expert axis — the ep chips would silently replicate"
        )
    check_trainable(model_cfg)
    device = resolve_device(args.device)
    from torch import distributed as dist

    had_group = dist.is_available() and dist.is_initialized()
    joined = mesh_lib.initialize_multihost(args.backend)
    if joined and device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = mesh_lib.make_mesh(
        {"pp": args.pp, "ep": args.ep, "sp": args.sp, "tp": args.tp,
         "dp": -1}, device=device)
    lead = mesh.rank == 0
    if not lead:
        logging.getLogger().setLevel(logging.WARNING)
    tokenizer = tok_lib.load_gpt2_tokenizer(args.vocab, args.merges, None)
    dataset = PackedDataset.from_paths(
        args.data, tokenizer,
        DataConfig(batch_size=args.batch_size, seq_len=args.seq_len),
    )
    steps = args.epochs * dataset.steps_per_epoch()
    train_cfg = TrainConfig(
        learning_rate=args.lr,
        warmup_steps=max(1, steps // 20),
        decay_steps=max(2, steps),
        pp_micro=args.pp_micro,
    )
    result = fit(
        mesh, model_cfg, train_cfg, dataset, epochs=args.epochs,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, log_every=args.log_every,
    )
    if args.export:
        ckpt_lib.export_model(args.export, result["state"], mesh)
    if lead:
        print(f"trained to step {result['step']}: {result['metrics']}")
    if joined and not had_group:
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
