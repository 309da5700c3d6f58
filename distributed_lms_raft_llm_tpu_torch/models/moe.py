"""Mixture-of-Experts GPT-2 on plain tensors.

Port of `distributed_lms_raft_llm_tpu/models/moe.py`. Every block's dense
MLP becomes E feed-forward experts behind a learned top-k router; the rest
is the GPT-2 trunk: `forward` IS `gpt2.forward`, whose block routes the
feed-forward through `moe_mlp` when its params carry a `moe` subtree, so
the KV cache, the engines' decode paths, speculative verification and
scoring work unchanged.

Routing follows the JAX package: softmax over all experts in float32, keep
the k largest (ties: the lower expert index first, as `jax.lax.top_k`),
renormalise their weights. Each expert holds C = ceil(cf S k / E) rows
(`capacity`); a token's position in its expert's buffer is counted
slot-major (every token's first choice before any token's second, the
GShard order), and picks past C are dropped: they add nothing, and the
token rides the residual stream.

The JAX package dispatches and combines with one-hot einsums over an
[S, E, C] tensor. Here both are index operations, which compute the same
numbers without the zeros (at C = 640, a scoring quantum's rows, the
einsums would be ~16 GFLOP of them):

- dispatch gathers each capacity slot's token row into [E, C, D], a zero
  row where the slot is empty: equal to the einsum exactly, since each
  (e, c) holds at most one token;
- combine gathers each token's k expert outputs (a zero row for a dropped
  pick) and weights them with the routing weights rounded to the working
  dtype (JAX's ``combine.astype(dtype)``), summed in float32 and rounded
  once. For k <= 2 that is the einsum's sum exactly (a + b, zeros added
  exactly); above it the order of the sum differs.

The expert products go through `ops.quant_matmul.int8_matmul_experts` for
int8 experts (one kernel launch for all E experts on the card) and
`torch.bmm` for dense ones. Everything here is static in shape and free of
host syncs (no `.item()`, `nonzero` or boolean-mask indexing): C follows
from the row count alone, so the layer runs inside the engines' captured
CUDA graphs.

Capacity caveat (the JAX docstring's): with dropping active
(capacity_factor < num_experts) a token's output depends on what else
shares its forward (whether it wins a buffer slot), pad and filler rows
included, so speculative decoding is exact for MoE only at cf >= E; both
engines refuse spec_tokens below it (`engine/engine.py::check_moe_spec`).

The training channel is `forward_with_aux` (`gpt2.forward` with
``collect_moe_aux``: the mean of the layers' load-balance scalars).

Expert parallelism (``cfg.expert_parallel``, a `parallel.mesh.ParallelAxis`
of ep > 1; `parallel.partition.MOE_RULES` slice the stacks): rank r holds
experts [r E/ep, (r+1) E/ep). The router, top-k, C and each pick's slot
stay global and replicated (every rank holds every row: the engines' host
loop is replicated), so no all-to-all is needed. A rank stages only its
experts' buffer rows, runs the expert kernel on its E/ep experts, and
combines the picks whose expert is its own (zero elsewhere) into the
float32 weighted sum, which is summed over the ep ranks before the one
rounding to the working dtype. With k = 2 a token's sum has at most two
non-zero terms, and adding zeros is exact, so the layer gives ep 1's
numbers wherever each expert's product does (on the CPU; on the card the
expert kernel's split of K follows the experts a launch holds).

Under sequence parallelism (``cfg.sequence_parallel``, the ring forward
of `gpt2.forward`) a rank holds T/sp of the tokens; routing and capacity
belong to the whole forward, so the layer gathers the sequence over sp,
runs on all of it and keeps its own tokens' rows. The trainer's data
parallelism (``cfg.data_parallel``, a `DataParallelMoEConfig`) is met
the same way: JAX's jitted
step routes the global batch, so the layer gathers the rows over dp too.
Both gathers are `ParallelAxis.all_gather_rs`: a rank goes on with its
own slice only, so each rank's gradient of the whole is summed over the
axis before it takes its slice's.

Training at ep (the conjugate pairs of `parallel/mesh.py`): the tokens a
rank's experts take, and the routing weights its combine reads, enter
through the "copy" pair, since each rank's experts give only their share
of those gradients; the combine's sum is the "reduce" pair. The router
and the load-balance scalar are replicated on every ep rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from ..ops import quant_matmul
from ..parallel.mesh import ParallelAxis, axis_of
from . import convert, gpt2

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPT2MoEConfig(gpt2.GPT2Config):
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    # The ep axis the expert stacks are sharded over (set by the engine);
    # None = every expert on this rank.
    expert_parallel: Optional[ParallelAxis] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def local_experts(self) -> int:
        """Experts on this ep rank."""
        return self.num_experts // axis_of(self, "expert_parallel",
                                           "ep").size

    @classmethod
    def moe_small(cls, **kw) -> "GPT2MoEConfig":
        """GPT-2-small trunk, 8 experts x top-2 (~124M active / ~680M
        total)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "GPT2MoEConfig":
        """Test-size config (the JAX package's `tiny`)."""
        kw.setdefault("vocab_size", 384)
        kw.setdefault("max_position_embeddings", 64)
        kw.setdefault("num_experts", 4)
        kw.setdefault("experts_per_token", 2)
        return cls(hidden_size=32, num_layers=2, num_heads=4, **kw)


@dataclasses.dataclass(frozen=True)
class DataParallelMoEConfig(GPT2MoEConfig):
    """A GPT2MoEConfig whose batch rows are split over the trainer's dp
    axis (`data_parallel`, set by `train.make_train_step`): the expert
    layer gathers the rows over it, so routing sees the global batch."""

    data_parallel: Optional[ParallelAxis] = dataclasses.field(
        default=None, compare=False, repr=False)


def with_data_parallel(cfg: GPT2MoEConfig,
                       dp: ParallelAxis) -> DataParallelMoEConfig:
    """`cfg` with its rows split over `dp`."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(GPT2MoEConfig)}
    return DataParallelMoEConfig(**fields, data_parallel=dp)


def init_params(cfg: GPT2MoEConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Params:
    """GPT-2's init (`gpt2.init_params`) with each block's `mlp` replaced
    by a `moe` subtree: router wr [L, D, E], expert stacks wi [L, E, D, M]
    and wo [L, E, M, D] (normal 0.02, wo scaled as GPT-2's residual
    projections), zero biases bi [L, E, M] and bo [L, E, D]. The experts
    come from a second `torch.Generator` (seeded with `seed` + 17, as the
    JAX package folds 17 into its key), leaf by leaf and layer by layer,
    each draw cast to `cfg.param_dtype` before the next. The draws differ
    from `jax.random`'s; parity tests carry JAX weights across with
    `convert.params_from_jax` instead."""
    params = gpt2.init_params(cfg, seed, device)
    d, n_layers, m, e = (cfg.hidden_size, cfg.num_layers, cfg.mlp_dim,
                         cfg.num_experts)
    gen = torch.Generator(device=device).manual_seed(seed + 17)
    std = 0.02
    proj_std = std / math.sqrt(2.0 * n_layers)
    pd = cfg.param_dtype

    def stacked(shape, s):
        out = torch.empty((n_layers, *shape), dtype=pd, device=device)
        for i in range(n_layers):
            x = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            out[i] = (x * s).to(pd)
        return out

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=device)

    del params["blocks"]["mlp"]
    params["blocks"]["moe"] = {
        "wr": stacked((d, e), std),
        "wi": stacked((e, d, m), std),
        "bi": zeros((n_layers, e, m)),
        "wo": stacked((e, m, d), proj_std),
        "bo": zeros((n_layers, e, d)),
    }
    return params


def capacity(cfg: GPT2MoEConfig, tokens: int) -> int:
    """Rows each expert holds in a forward of `tokens` rows."""
    return max(1, math.ceil(
        cfg.capacity_factor * tokens * cfg.experts_per_token
        / cfg.num_experts))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, larger first and, among equal values,
    the lower index first (`jax.lax.top_k`'s order; `torch.topk` promises
    none): a stable descending sort, cut."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], i[:, :k]


def _expert_dense(x: torch.Tensor, w: Any, b: torch.Tensor) -> torch.Tensor:
    """x [E, C, K] times each expert's weight [E, K, N] plus its bias
    [E, N], in x's dtype: the int8 pair through the expert kernel (its
    plain version on the CPU), a dense stack through `torch.bmm`."""
    if isinstance(w, dict):
        return quant_matmul.int8_matmul_experts(x, w["q"], w["s"], b)
    return torch.bmm(x, w.to(x.dtype)) + b.to(x.dtype)[:, None, :]


def moe_mlp(h: torch.Tensor, mp: Mapping[str, Any], cfg: GPT2MoEConfig,
            return_aux: bool = False):
    """The expert layer: [B, T, D] -> [B, T, D] (residual not included).

    `mp` holds one layer's slice of the stacked moe params (wr [D, E], wi
    [E, D, M], bi [E, M], wo [E, M, D], bo [E, D]; wi and wo dense or int8
    pairs with scales [E, M] / [E, D]); under ep, this rank's E/ep experts
    of wi, bi, wo and bo.

    return_aux=True also returns the layer's Switch load-balance scalar
    (E sum_e frac_top1_e mean_prob_e; 1.0 when perfectly balanced).
    """
    sp = axis_of(cfg, "sequence_parallel", "sp")
    dp = axis_of(cfg, "data_parallel", "dp")
    for axis, dim, field in ((sp, 1, "sequence_parallel"),
                             (dp, 0, "data_parallel")):
        if axis.size == 1:
            continue
        n_local = h.shape[dim]
        inner = dataclasses.replace(cfg, **{field: None})
        out = moe_mlp(axis.all_gather_rs(h, dim=dim), mp, inner, return_aux)
        lo = axis.rank * n_local
        y = (out[0] if return_aux else out).narrow(dim, lo, n_local)
        return (y, out[1]) if return_aux else y
    b, t, d = h.shape
    s = b * t
    e, k = cfg.num_experts, cfg.experts_per_token
    c = capacity(cfg, s)
    ep = axis_of(cfg, "expert_parallel", "ep")
    e_local = e // ep.size
    lo = ep.rank * e_local * c      # this rank's first buffer slot
    dev = h.device
    x = h.reshape(s, d)

    # The router in float32: a tiny product, and softmax and top-k are
    # sensitive to it. On the card torch.matmul keeps float32 products
    # while torch.backends.cuda.matmul.allow_tf32 is False, its default.
    logits = torch.matmul(x.float(), mp["wr"].float())
    probs = torch.softmax(logits, dim=-1)                    # [S, E]
    top_w, top_i = top_k(probs, k)                           # [S, k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)          # renormalise

    # Each pick's position in its expert's buffer, slot-major: pick
    # j S + i is token i's j-th choice, so every first choice counts
    # before any second one.
    experts = torch.arange(e, device=dev)
    eid = top_i.t().reshape(k * s)                           # [k S]
    ohf = (eid[:, None] == experts).long()                   # [k S, E]
    pos = ((ohf.cumsum(0) - ohf) * ohf).sum(-1)              # [k S]
    # The pick's capacity slot e C + pos, or E C (a zero row) if dropped.
    dest = torch.where(pos < c, eid * c + pos, e * c)

    # Dispatch: each capacity slot's token (S: the zero row after x).
    # Kept picks' slots are distinct; only the dropped ones meet, at E C,
    # which nothing reads. A rank stages its own experts' slots.
    src = torch.full((e * c + 1,), s, dtype=torch.long, device=dev)
    src.scatter_(0, dest, torch.arange(k * s, device=dev) % s)
    x0 = torch.cat([ep.copy(x), x.new_zeros((1, d))])
    expert_in = x0.index_select(0, src[lo:lo + e_local * c]).view(
        e_local, c, d)

    mid = _expert_dense(expert_in, mp["wi"], mp["bi"])
    mid = F.gelu(mid, approximate="tanh")
    out = _expert_dense(mid, mp["wo"], mp["bo"])             # [E/ep, C, D]

    # Combine: each token's k outputs (a zero row for a pick dropped or
    # held by another ep rank), weighted (the weights rounded to the
    # working dtype first), summed in float32, summed over the ep ranks,
    # rounded once.
    if ep.size > 1:
        mine = (dest >= lo) & (dest < lo + e_local * c)
        dest = torch.where(mine, dest - lo, e_local * c)
    out0 = torch.cat([out.reshape(e_local * c, d), out.new_zeros((1, d))])
    picked = out0.index_select(0, dest).view(k, s, d).float()
    w = ep.copy(top_w).t().to(h.dtype).float()               # [k, S]
    y = ep.all_reduce((picked * w[:, :, None]).sum(0))
    y = y.to(h.dtype).view(b, t, d)
    if not return_aux:
        return y
    frac = (top_i[:, :1] == experts).float().mean(0)         # top-1 share
    aux = e * (frac * probs.mean(0)).sum()
    return y, aux


def load_balance_loss(params: Params, cfg: GPT2MoEConfig,
                      hidden: torch.Tensor, layer: int) -> torch.Tensor:
    """Switch aux loss for one layer: E sum_e(frac_tokens_e
    mean_prob_e), from `hidden` [B, T, D] through that layer's router."""
    wr = params["blocks"]["moe"]["wr"][layer]
    b, t, d = hidden.shape
    x = hidden.reshape(b * t, d).float()
    probs = torch.softmax(x @ wr.float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)  # the first maximum, as jnp.argmax
    frac = F.one_hot(top1, cfg.num_experts).float().mean(0)
    return cfg.num_experts * (frac * probs.mean(0)).sum()


# The family surface: the trunk IS gpt2.forward (its block routes the MLP
# through moe_mlp when the block params carry a `moe` subtree).
forward = gpt2.forward
init_cache = gpt2.init_cache


def forward_with_aux(params: Params, cfg: GPT2MoEConfig,
                     input_ids: torch.Tensor):
    """Full-sequence forward returning (logits, mean load-balance aux):
    the training path. One trunk, `gpt2.forward` with its aux side channel
    on, so the training and serving forwards cannot drift."""
    logits, _, aux = gpt2.forward(params, cfg, input_ids,
                                  collect_moe_aux=True)
    return logits, aux


def params_from_hf(sd: Mapping[str, Any], cfg: GPT2MoEConfig,
                   device: DeviceLike = "cuda") -> Params:
    """Load an MoE checkpoint. There is no public HF GPT-2-MoE layout, so
    checkpoints use the native tree layout with slash-joined key paths
    (the JAX package's `train.checkpoint.export_model` writes it), rebuilt
    into the parameter tree here, leaves cast to `cfg.param_dtype`."""
    if not any("/" in key for key in sd):
        raise ValueError(
            "MoE checkpoints use the native slash-joined layout (written "
            "by train export); this file looks like an HF state dict, "
            "which has no GPT-2-MoE counterpart"
        )
    tree: Params = {}
    for key, value in sd.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = convert.to_tensor(value, cfg.param_dtype, device)
    missing = {"wte", "wpe", "blocks", "lnf"} - set(tree)
    if missing or "moe" not in tree.get("blocks", {}):
        raise ValueError(
            f"native MoE checkpoint is missing "
            f"{sorted(missing) or ['blocks/moe']}"
        )
    return tree
