"""GPT-2 forward on plain tensors.

Port of `distributed_lms_raft_llm_tpu/models/gpt2.py`. Parameters are the
same nested dict, with per-layer weights stacked on a leading layer axis
(`convert.params_from_jax` carries a JAX pytree across unchanged); the
trunk is a Python loop that indexes layer ``i``. There is no jit or scan:
PyTorch runs eagerly.

`forward` has four modes:

- full sequence (``cache=None``): causal attention over the input; the
  training path's mode, with the MoE aux channel (``collect_moe_aux``)
  and per-block rematerialization (``remat``);
- cached with one scalar offset (``cache.length``): prefill and decode
  write their keys/values into the cache IN PLACE at that offset;
- cached with per-row offsets (``cache.lengths``, the paged engine's
  ragged slots): each row's T new keys/values are scattered at its own
  offset, optionally into cache rows chosen on the device (``cache.rows``)
  and under a write mask (the fused admission chunk's one staged slot);
- cached with T == 1 and ``cfg.fused_decode_attention``: attention runs
  through `ops.attention.decode_attention` (the CUDA kernel on the card,
  its plain version on the CPU), reading the layer from the stacked cache,
  with the mask as a bias (scalar offset), float or int8 cache; with
  per-row offsets and no ``cache.rows`` or ``write_mask`` (the paged
  decode step) through `ops.attention.decode_attention_append` instead,
  one kernel that also quantizes and writes the step's new row;
- cached with per-row offsets, T > 1 and no ``cache.rows`` (the
  speculative verify window, T = k+1) and ``cfg.fused_decode_attention``:
  the kernel's window variant, row b's query t seeing the keys up to its
  own slot (lengths[b] + t + 1 keys), with ``kv_mask`` (the bucketed
  engine's left padding) as a bias the T rows share. The kernel takes
  T <= `ops.attention.MAX_WINDOW` rows and raises beyond: a wider window
  never drops to the plain version.

Under tensor parallelism (``cfg.tensor_parallel``, a
`parallel.mesh.TensorParallel` of tp > 1) the parameters are this rank's
slice (`parallel.partition.shard_params`, GPT2_RULES) and the forward runs
Megatron's split: the fused qkv product gives this rank's heads
(H / tp, the cache holds them), the attention-out and MLP-out products are
row-parallel (`common.row_dense`: summed over the ranks, the bias added
after the sum), the embedding is vocab-parallel and the tied unembedding
gathers the vocabulary blocks (`quant.embed_lookup` / `unembed`), so every
rank returns the whole [B, T, V] logits.

Under sequence parallelism (``cfg.sequence_parallel``, a
`parallel.mesh.ParallelAxis` of sp > 1, the JAX package's
``cfg.ring_mesh``) the full-sequence mode runs the whole trunk
sequence-sharded: every rank takes the same [B, T] ids (T a multiple of
sp), embeds its T/sp of them at positions [r T/sp, (r+1) T/sp), runs the
per-token parts on them and attention round the ring
(`parallel.ring.ring_attention`), and returns the logits of its own
positions, [B, T/sp, V]. A `kv_mask` or explicit `positions` are refused
there, as the JAX package refuses them. It composes with tp: heads over
tp, the sequence over sp.

Training runs the same forward with gradients: the collectives above are
the conjugate pairs of `parallel/mesh.py` (the column-parallel products'
inputs through `ParallelAxis.copy`), so each rank's backward gives the
gradient of the one global loss. `forward_pipelined` runs the trunk as a
GPipe pipeline over a mesh's pp axis (`trunk_layer` a stage's layer), the
JAX package's, for the trainer at pp > 1.

With ``cfg.quant_kv`` the cache is int8 with per-slot scales
(`common.quantize_kv` on write, `common.attend_quant` on read). The JAX
package refuses `fused_decode_attention` together with `quant_kv`, because
its Pallas kernel reads a full-precision cache only; the port's kernel
computes `attend_quant` itself, so the two combine here. Prefill and the
fused admission chunk (T > 1 at a scalar offset, or with ``cache.rows``)
attend through the plain `attend`/`attend_quant`, as the JAX package's XLA
einsums do.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike
from ..parallel.mesh import ParallelAxis, TensorParallel, axis_of
from ..parallel.mesh import tensor_parallel_of
from .common import (
    CachedAttention,
    KVCache,
    cache_slots,
    causal_window_mask,
    check_ring,
    dense,
    full_attention,
    layer_norm,
    layer_params,
    merge_heads,
    row_dense,
    split_heads,
    unbind_layers,
)
from ..parallel.ring import ring_attention
from .common import write_rows as _write_rows
from .quant import embed_lookup, unembed

Params = Dict[str, Any]



@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; bfloat16 serving
    param_dtype: torch.dtype = torch.float32
    # Route the single-token decode step through ops.attention's kernel
    # (set by the engine, EngineConfig.fused_attention).
    fused_decode_attention: bool = False
    # int8 KV cache with per-slot scales (EngineConfig.kv_quant).
    quant_kv: bool = False
    # The tp axis the parameters are sharded over (set by the engine);
    # None = one rank.
    tensor_parallel: Optional[TensorParallel] = dataclasses.field(
        default=None, compare=False, repr=False)
    # The sp axis the full-sequence forward shards its sequence over (the
    # scoring tenant's, set by the engine); None = the whole sequence here.
    sequence_parallel: Optional[ParallelAxis] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def local_heads(self) -> int:
        """Attention heads on this tp rank."""
        return self.num_heads // tensor_parallel_of(self).size

    @property
    def mlp_dim(self) -> int:
        return 4 * self.hidden_size

    # The published GPT-2 family (124M / 355M / 774M / 1.5B).
    @classmethod
    def small(cls, **kw) -> "GPT2Config":
        """GPT-2 small (124M): the published width."""
        return cls(**kw)

    @classmethod
    def medium(cls, **kw) -> "GPT2Config":
        return cls(hidden_size=1024, num_layers=24, num_heads=16, **kw)

    @classmethod
    def large(cls, **kw) -> "GPT2Config":
        return cls(hidden_size=1280, num_layers=36, num_heads=20, **kw)

    @classmethod
    def xl(cls, **kw) -> "GPT2Config":
        return cls(hidden_size=1600, num_layers=48, num_heads=25, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        """Test-size config (the JAX package's `tiny`)."""
        kw.setdefault("vocab_size", 384)
        kw.setdefault("max_position_embeddings", 64)
        return cls(hidden_size=32, num_layers=2, num_heads=4, **kw)


def init_params(cfg: GPT2Config, seed: int = 0,
                device: DeviceLike = "cuda") -> Params:
    """Random init in GPT-2's scheme (normal 0.02, scaled residual
    projections), drawn from a `torch.Generator` seeded with `seed` on
    `device`. The draws differ from `jax.random`'s; parity tests carry JAX
    weights across with `convert.params_from_jax` instead."""
    d, n_layers, m = cfg.hidden_size, cfg.num_layers, cfg.mlp_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    std = 0.02
    proj_std = std / math.sqrt(2.0 * n_layers)
    pd = cfg.param_dtype

    def norm(shape, s):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * s).to(pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=device)

    return {
        "wte": norm((cfg.vocab_size, d), std),
        "wpe": norm((cfg.max_position_embeddings, d), std),
        "blocks": {
            "ln1": {"scale": ones((n_layers, d)), "bias": zeros((n_layers, d))},
            "attn": {
                "wqkv": norm((n_layers, d, 3 * d), std),
                "bqkv": zeros((n_layers, 3 * d)),
                "wo": norm((n_layers, d, d), proj_std),
                "bo": zeros((n_layers, d)),
            },
            "ln2": {"scale": ones((n_layers, d)), "bias": zeros((n_layers, d))},
            "mlp": {
                "wi": norm((n_layers, d, m), std),
                "bi": zeros((n_layers, m)),
                "wo": norm((n_layers, m, d), proj_std),
                "bo": zeros((n_layers, d)),
            },
        },
        "lnf": {"scale": ones((d,)), "bias": zeros((d,))},
    }


def init_cache(cfg: GPT2Config, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = "cuda",
               quantized: Optional[bool] = None) -> KVCache:
    """A zeroed cache over this rank's heads; int8 with scales when
    `quantized` (default: `cfg.quant_kv`)."""
    if quantized is None:
        quantized = cfg.quant_kv
    return KVCache.create(cfg.num_layers, batch, cfg.local_heads, max_len,
                          cfg.head_dim, dtype or cfg.dtype, device,
                          quantized=quantized)


def apply_block(x: torch.Tensor, lp: Params, attend_fn, cfg: GPT2Config,
                collect_aux: bool = False):
    """One transformer block; `attend_fn(q, k_new, v_new) -> context` owns
    cache handling and attention. Blocks whose params carry a `moe`
    subtree instead of `mlp` route the feed-forward through the expert
    layer (`models/moe.py`): the same trunk, cache and decode paths.

    collect_aux=True returns (x, aux), aux the block's MoE load-balance
    scalar (a float32 zero for a dense block): the training objective's
    side channel."""
    eps = cfg.layer_norm_eps
    tp = tensor_parallel_of(cfg)
    heads = cfg.local_heads
    # Under tp the column-parallel products take the replicated norms
    # through the "copy" pair (each rank's product gives only its share of
    # their gradient); the row-parallel ones sum through `row_dense`.
    h = tp.copy(layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps))
    qkv = dense(h, lp["attn"]["wqkv"], lp["attn"]["bqkv"])
    q, k, v = qkv.split(heads * cfg.head_dim, dim=-1)
    a = attend_fn(
        split_heads(q, heads),
        split_heads(k, heads),
        split_heads(v, heads),
    )
    x = x + row_dense(merge_heads(a), lp["attn"]["wo"], lp["attn"]["bo"], tp)
    h2 = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
    if "moe" in lp:
        from . import moe as moe_lib  # moe imports this module

        if collect_aux:
            y, aux = moe_lib.moe_mlp(h2, lp["moe"], cfg, return_aux=True)
            return x + y, aux
        return x + moe_lib.moe_mlp(h2, lp["moe"], cfg)
    m = dense(tp.copy(h2), lp["mlp"]["wi"], lp["mlp"]["bi"])
    m = F.gelu(m, approximate="tanh")  # GPT-2 uses the tanh approximation
    x = x + row_dense(m, lp["mlp"]["wo"], lp["mlp"]["bo"], tp)
    if collect_aux:
        return x, x.new_zeros((), dtype=torch.float32)
    return x


def trunk_layer(lp: Params, h: torch.Tensor, *, cfg: GPT2Config
                ) -> torch.Tensor:
    """One block in full-sequence causal mode: the `layer_fn(lp, h) -> h`
    shape `parallel.pipeline.pipeline_trunk` consumes, the causal mask
    rebuilt from h's shape."""
    t = h.shape[1]
    pos = torch.arange(t, device=h.device)
    mask = (pos[None, :] <= pos[:, None])[None, None]
    return apply_block(h, lp, full_attention(mask), cfg)


def forward_pipelined(
    params: Params,
    cfg: GPT2Config,
    input_ids: torch.Tensor,
    mesh,
    *,
    n_micro: int,
    remat: bool = False,
) -> torch.Tensor:
    """Full-sequence forward with the stacked trunk split over the mesh's
    `pp` axis (`parallel.pipeline.pipeline_trunk`, GPipe microbatching);
    returns the logits [B, T, V] float32 on every stage.

    The embedding, the final layer norm and the tied unembedding run
    replicated on every stage; the L blocks run as pp stages, each rank
    holding L/pp of them: `params["blocks"]` holds either all L layers
    (each stage runs its own, views) or, in the sharded train state, this
    stage's L/pp (told apart by `cfg.num_layers`). `remat` recomputes each
    layer inside its stage in the backward pass, where the pipeline
    otherwise keeps every microbatch's activations. Under dp each rank
    pipelines its own rows. Equal to `forward(params, cfg, input_ids)[0]`
    up to float rounding (held in the tests).
    """
    from ..parallel.pipeline import pipeline_trunk

    if mesh.shape.get("tp", 1) > 1:
        raise ValueError(
            "forward_pipelined does not compose with tp (the pipeline "
            "stage body has no tensor-parallel collectives); use pp x dp"
        )
    _, t = input_ids.shape
    positions = torch.arange(t, device=input_ids.device)[None, :]
    x = embed_lookup(params["wte"], input_ids) + params["wpe"][positions]
    x = x.to(cfg.dtype)
    layer_fn = functools.partial(trunk_layer, cfg=cfg)
    if remat:
        plain_fn = layer_fn

        def layer_fn(lp, h):
            return checkpoint(plain_fn, lp, h, use_reentrant=False)
    blocks = params["blocks"]
    leading = next(iter(next(iter(blocks.values())).values()))
    leading = (leading["q"] if isinstance(leading, dict) else leading)
    x = pipeline_trunk(layer_fn, blocks, x, mesh, n_micro=n_micro,
                       stage_sliced=leading.shape[0] != cfg.num_layers)
    x = layer_norm(x, params["lnf"]["scale"], params["lnf"]["bias"],
                   cfg.layer_norm_eps)
    return unembed(x, params["wte"])


def forward(
    params: Params,
    cfg: GPT2Config,
    input_ids: torch.Tensor,
    cache: Optional[KVCache] = None,
    positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    write_mask: Optional[torch.Tensor] = None,
    collect_moe_aux: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the transformer; returns (logits [B, T, V] float32, cache): in
    the ring forward (``cfg.sequence_parallel``) this rank's [B, T/sp, V].

    cache      — None for full-sequence mode; a KVCache for incremental
                 prefill/decode. New keys/values are written IN PLACE into
                 the cache's tensors: at slot `cache.length` (one offset
                 for the batch), or, when `cache.lengths` is set, at each
                 row's own offset (ragged slots). The returned cache shares
                 that storage with its offsets advanced by T. A scalar
                 `cache.length + T` must fit the cache: checked here, where
                 JAX would clamp silently. Ragged offsets stay on the
                 device and are not checked (that would sync the host):
                 the caller keeps `lengths + T <= max_len` (the paged
                 engine clamps them) and the positions inside the table.
    positions  — [B, T] indices into the learned position table; defaults
                 to the slot indices. Out-of-range positions raise (PyTorch
                 indexing is bounds-checked).
    kv_mask    — [B, num_keys] validity of each key slot (False = padding).
    write_mask — [B, T] which new keys/values are written (ragged offsets
                 only): a False entry leaves the cache as it was, so a
                 chunk's pad tail past a prompt's length or past the cache
                 is dropped rather than clamped into real slots.

    With `cache.rows` set (ragged offsets only), batch row i reads and
    writes cache row `rows[i]`; attention then runs through the plain
    `attend`/`attend_quant` over those rows, gathered.
    """
    b, t = input_ids.shape
    sp = axis_of(cfg, "sequence_parallel", "sp")
    ring = cache is None and sp.size > 1
    if ring:
        check_ring(sp, t, kv_mask, positions)
    q_slots, offset = cache_slots(cache, b, t, input_ids.device, write_mask)
    ragged = cache is not None and cache.lengths is not None
    if positions is None:
        if not ragged and offset + t > cfg.max_position_embeddings:
            raise ValueError(
                f"positions up to {offset + t} exceed the position table "
                f"{cfg.max_position_embeddings}"
            )
        positions = q_slots
    if ring:
        # This rank's shard of the sequence, at its absolute positions.
        lo, t = sp.rank * (t // sp.size), t // sp.size
        input_ids = input_ids[:, lo:lo + t]
        positions = positions[:, lo:lo + t]

    tp = tensor_parallel_of(cfg)
    x = embed_lookup(params["wte"], input_ids, tp) + params["wpe"][positions]
    x = x.to(cfg.dtype)

    if ring:
        mask = None
    else:
        num_keys = t if cache is None else cache.max_len
        mask = causal_window_mask(q_slots, num_keys)  # [B, 1, T, num_keys]
        if kv_mask is not None:
            mask = mask & kv_mask[:, None, None, :]

    moe_aux = None
    if cache is None:
        attend_full = (functools.partial(ring_attention, sp=sp) if ring
                       else full_attention(mask))
        if collect_moe_aux:
            moe_aux = x.new_zeros((), dtype=torch.float32)
        for lp in unbind_layers(params):
            args = (x, lp, attend_full, cfg, collect_moe_aux)
            out = (checkpoint(apply_block, *args, use_reentrant=False)
                   if remat else apply_block(*args))
            if collect_moe_aux:
                x, aux = out
                moe_aux = moe_aux + aux
            else:
                x = out
        new_cache = None
    else:
        if collect_moe_aux:
            raise ValueError(
                "collect_moe_aux is a full-sequence (training) channel; "
                "the cached decode path does not accumulate it"
            )
        if remat:
            raise ValueError("remat is a full-sequence (training) option; "
                             "the cached path keeps no activations")
        # The decode step's append kernel (q, k_new, v_new strided views of
        # qkv) is a programmatic dependent of the qkv product just before
        # it, which writes none of lengths, the bias and the older rows.
        step = CachedAttention(
            cache, q_slots=q_slots, mask=mask, kv_mask=kv_mask,
            write_mask=write_mask, fused=cfg.fused_decode_attention,
            quant_kv=cfg.quant_kv, dependent=True,
            # looked up at each call, so a test may replace `_write_rows`
            write_rows=lambda *args: _write_rows(*args))
        for i in range(cfg.num_layers):
            x = apply_block(x, layer_params(params, i),
                            functools.partial(step, i), cfg)
        new_cache = step.advanced()

    x = layer_norm(x, params["lnf"]["scale"], params["lnf"]["bias"],
                   cfg.layer_norm_eps)
    logits = unembed(x, params["wte"], tp)
    if collect_moe_aux:
        return logits, new_cache, moe_aux / cfg.num_layers
    return logits, new_cache
