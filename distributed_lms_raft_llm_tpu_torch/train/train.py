"""The training step, the driver and the CLI: fine-tune the tutoring model
on course material, on one device.

Port of `distributed_lms_raft_llm_tpu/train/train.py`. The reference has
no training (SURVEY.md §2.2); the JAX package added the path, and the port
carries it: the LM loss, AdamW with a warmup-cosine schedule and global-norm
clipping, rematerialized blocks, the MoE load-balance aux loss, periodic
checkpoints that resume, and the export the tutoring node serves.

What differs from the JAX package:

- One device. `fit` takes `device` where the reference takes a mesh, and
  the CLI refuses `--tp/--sp/--pp/--ep` above 1: those axes are
  `parallel/`'s, which is not ported yet (nor are
  `make_sharded_train_step` and `train_state_shardings`, the identity on
  one device).
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
  (`gpt2.forward(remat=True)`), where the reference wraps the whole
  forward in `jax.checkpoint`: the same loss, less memory held.
- Llama presets raise: the reference's step runs `gpt2.forward` too.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device
from ..models import gpt2, moe
from .checkpoint import flatten_with_paths

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    decay_steps: int = 10_000  # cosine horizon; set to the planned run length
    max_grad_norm: float = 1.0
    remat: bool = True  # rematerialize block activations (memory for ops)
    # GPipe microbatches per step when pp > 1 (the reference's pipeline;
    # pp is refused here until parallel/ is ported).
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
              grads: Sequence[torch.Tensor], opt_state) -> torch.Tensor:
        """One update, in place: `params` (the tree's leaves in order), the
        moments and both counts. Returns the gradients' global norm before
        clipping. Call under `torch.no_grad()`."""
        adam, _, sched = opt_state[1]
        mus = [v for _, v in flatten_with_paths(adam.mu)]
        nus = [v for _, v in flatten_with_paths(adam.nu)]
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


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy; logits [B,T,V] f32, targets/mask [B,T]."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return -torch.sum(picked * mask) / torch.clamp(torch.sum(mask), min=1.0)


def init_train_state(seed: int, model_cfg: gpt2.GPT2Config,
                     optimizer: AdamW,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Params from the family's seeded init (requiring grad), the
    optimizer's zero state and step 0 (int32), on `device`."""
    check_trainable(model_cfg)
    dev = resolve_device(device)
    init = moe.init_params if _is_moe(model_cfg) else gpt2.init_params
    params = init(model_cfg, seed, dev)
    for _, leaf in flatten_with_paths(params):
        leaf.requires_grad_(True)
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def make_train_step(
    model_cfg: gpt2.GPT2Config,
    optimizer: AdamW,
    remat: bool = True,
    moe_aux_weight: float = 0.01,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): batch holds
    `input_ids` and `loss_mask` [B, T] (numpy or tensors); metrics are
    0-d tensors on the device: `loss`, `grad_norm` (before clipping) and,
    for MoE, `moe_balance` (the layers' mean aux). The state's tensors are
    updated in place."""
    check_trainable(model_cfg)
    is_moe = _is_moe(model_cfg)

    def loss_fn(params, input_ids, loss_mask):
        out = gpt2.forward(params, model_cfg, input_ids,
                           collect_moe_aux=is_moe, remat=remat)
        # next-token prediction: shift by one
        loss = lm_loss(out[0][:, :-1], input_ids[:, 1:], loss_mask[:, 1:])
        if not is_moe:
            return loss, None
        return loss + moe_aux_weight * out[2], out[2]

    def train_step(state, batch):
        leaves = [v for _, v in flatten_with_paths(state["params"])]
        device = leaves[0].device
        ids = torch.as_tensor(batch["input_ids"], device=device).long()
        mask = torch.as_tensor(batch["loss_mask"], device=device)
        with torch.enable_grad():
            loss, aux = loss_fn(state["params"], ids, mask)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        with torch.no_grad():
            gnorm = optimizer.apply(leaves, grads, state["opt_state"])
            state["step"].add_(1)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        if is_moe:
            metrics["moe_balance"] = aux.detach()
        return state, metrics

    return train_step


# ------------------------------------------------------------------ driver


def fit(
    device: DeviceLike,
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

    If `checkpoint_path` exists, training RESUMES from it: the full state
    (params, optimizer moments, counts, step) restores onto `device` and
    the data order continues from the recorded step, so an interrupted run
    and an uninterrupted one walk the same step sequence. Returns the
    metrics of the last logged step (host floats), the state, the step,
    and `history`: each logged step's metrics with `step_ms`, the wall per
    step since the previous log (the log reads the loss, which waits for
    the device).
    """
    from . import checkpoint as ckpt_lib

    log = logging.getLogger("train")
    optimizer = make_optimizer(train_cfg)
    state = init_train_state(seed, model_cfg, optimizer, device)
    if checkpoint_path and ckpt_lib.latest_step(checkpoint_path) is not None:
        state = ckpt_lib.restore_train_state(checkpoint_path, state)
        log.info("resumed from %s at step %d", checkpoint_path,
                 int(state["step"]))
    step_fn = make_train_step(model_cfg, optimizer, remat=train_cfg.remat,
                              moe_aux_weight=train_cfg.moe_aux_weight)

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
            state, metrics = step_fn(state, batch)
            step_no += 1
            if step_no % log_every == 0 or step_no == start_step + 1:
                metrics_host = {k: float(v) for k, v in metrics.items()}
                now = time.monotonic()
                step_ms = 1e3 * (now - t_log) / (step_no - step_log)
                t_log, step_log = now, step_no
                history.append(dict(step=step_no, step_ms=step_ms,
                                    **metrics_host))
                log.info("step %d loss %.4f gnorm %.3f%s ms/step %.2f",
                         step_no, metrics_host["loss"],
                         metrics_host["grad_norm"],
                         f" moe_balance {metrics_host['moe_balance']:.4f}"
                         if "moe_balance" in metrics_host else "", step_ms)
            if checkpoint_path and step_no % checkpoint_every == 0:
                ckpt_lib.save_train_state(checkpoint_path, state)
    if checkpoint_path:
        ckpt_lib.save_train_state(checkpoint_path, state)
    if not metrics_host:
        metrics_host = {"loss": float("nan"), "grad_norm": float("nan")}
    return {"state": state, "metrics": metrics_host, "step": step_no,
            "history": history}


PARALLEL_NOT_PORTED = (
    "parallel/ carries serving's tensor, expert and sequence parallelism "
    "only; the sharded "
    "train step (tensor, sequence, pipeline and expert parallelism) is not "
    "ported to PyTorch yet, and the port trains on one device")


def main(argv=None) -> Dict[str, Any]:
    """CLI: fine-tune the tutoring model on course materials.

    python -m distributed_lms_raft_llm_tpu_torch.train.train \
        --data lms_data/node1/uploads --vocab data/gpt2-local/vocab.json \
        --merges data/gpt2-local/merges.txt --model tiny \
        --checkpoint ckpt/train_state.safetensors --epochs 2

    The JAX package's flags, plus `--device` (default cuda; cpu on
    request) and `--log-every`; returns `fit`'s result.
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
                        help="sequence-parallel ways (refused above 1: "
                        "parallel/ is not ported)")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline stages (refused above 1: parallel/ "
                        "is not ported)")
    parser.add_argument("--pp-micro", type=int, default=2,
                        help="microbatches per step when --pp > 1")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel ways (MoE presets; refused "
                        "above 1: parallel/ is not ported)")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--log-every", type=int, default=10,
                        help="log (and time) every N steps")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where to train (default the card)")
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
    wide = [f"--{axis} {n}" for axis, n in (
        ("tp", args.tp), ("sp", args.sp), ("pp", args.pp), ("ep", args.ep))
        if n > 1]
    if wide:
        raise NotImplementedError(f"{', '.join(wide)}: {PARALLEL_NOT_PORTED}")
    check_trainable(model_cfg)
    device = resolve_device(args.device)
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
        device, model_cfg, train_cfg, dataset, epochs=args.epochs,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, log_every=args.log_every,
    )
    if args.export:
        ckpt_lib.export_model(args.export, result["state"])
    print(f"trained to step {result['step']}: {result['metrics']}")
    return result


if __name__ == "__main__":
    main()
