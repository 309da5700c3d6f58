"""Llama-family decoder (RoPE, RMSNorm, GQA, SwiGLU) on plain tensors.

Port of `distributed_lms_raft_llm_tpu/models/llama.py`, with the same
conventions as the port's `gpt2.py`: per-layer weights stacked on a leading
layer axis (`convert.params_from_jax` carries a JAX tree across as it is),
linear weights ``[in, out]`` or int8 pairs, a Python loop over the layers,
and the KV cache written in place.

Llama-specific, as in the JAX package:

- RMSNorm, and no biases anywhere;
- rotary position embeddings on q and k at their absolute positions, HF's
  rotate_half convention, float32 inside;
- grouped-query attention: `num_kv_heads` KV heads, each read by
  `num_heads / num_kv_heads` query heads. The cache holds the KV heads
  only; the plain attention repeats them (`common.repeat_kv`), the CUDA
  kernel indexes them by head;
- the SwiGLU MLP, ``down(silu(gate) * up)``;
- an untied `lm_head` [V, D], through `quant.unembed` (float32 logits).

`forward` has the four modes and the contract of `gpt2.forward` (full
sequence; a scalar cache offset; per-row offsets with ``cache.rows`` and
``write_mask``; the fused decode step and verify window), shared through
`common.CachedAttention`. Positions drive RoPE alone: there is no position
table.

Under tensor parallelism (``cfg.tensor_parallel``, tp > 1) the parameters
are this rank's slice (LLAMA_RULES): q, k and v give H / tp query and
Hkv / tp KV heads (whole GQA groups; the cache holds the KV heads), o and
down are row-parallel (`common.row_dense`), the embedding is vocab-parallel
and `lm_head` gathers its vocabulary blocks, so every rank returns the
whole logits. RoPE is per head and needs nothing.

Under sequence parallelism (``cfg.sequence_parallel``) the full-sequence
mode is `gpt2.forward`'s ring forward: this rank's T/sp tokens at their
absolute positions (RoPE's), the shared KV heads repeated to the query
heads before the ring (as the JAX package does, so every rotation carries
[B, H, T/sp, Dh]), this rank's logits back.

RoPE is applied in the [B, T, H, Dh] layout of the products, before the
heads are moved forward, so k and v reach the attention as views with the
same strides (`ops.attention.decode_attention_append` requires it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from ..parallel.mesh import ParallelAxis, TensorParallel, axis_of
from ..parallel.mesh import tensor_parallel_of
from ..parallel.ring import ring_attention
from .common import (
    CachedAttention,
    KVCache,
    cache_slots,
    causal_window_mask,
    check_ring,
    dense,
    full_attention,
    layer_params,
    merge_heads,
    repeat_kv,
    rms_norm,
    row_dense,
)
from .quant import embed_lookup, unembed

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    max_position_embeddings: int = 8192
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.bfloat16
    # Same contracts as GPT2Config's: the decode step and verify window
    # through ops.attention's kernel (set by the engine), and an int8 KV
    # cache with per-slot scales (EngineConfig.kv_quant).
    fused_decode_attention: bool = False
    quant_kv: bool = False
    # The tp axis the parameters are sharded over (set by the engine);
    # None = one rank.
    tensor_parallel: Optional[TensorParallel] = dataclasses.field(
        default=None, compare=False, repr=False)
    # The sp axis of the ring forward (GPT2Config.sequence_parallel's
    # contract); None = the whole sequence here.
    sequence_parallel: Optional[ParallelAxis] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def local_heads(self) -> int:
        """Query heads on this tp rank."""
        return self.num_heads // tensor_parallel_of(self).size

    @property
    def local_kv_heads(self) -> int:
        """KV heads on this tp rank."""
        return self.num_kv_heads // tensor_parallel_of(self).size

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        """Meta-Llama-3-8B's published shape (its config.json)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-size config (the JAX package's `tiny`)."""
        kw.setdefault("vocab_size", 384)
        kw.setdefault("max_position_embeddings", 64)
        kw.setdefault("rope_theta", 10000.0)
        return cls(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                   intermediate_size=64, **kw)


def init_params(cfg: LlamaConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Params:
    """Random init (normal 0.02, norm scales 1), drawn from a
    `torch.Generator` seeded with `seed` on `device`, leaf by leaf and layer
    by layer, each draw cast to `cfg.param_dtype` before the next: the
    full-width model never holds more than one layer's leaf in float32.
    The draws differ from `jax.random`'s; parity tests carry JAX weights
    across with `convert.params_from_jax` instead."""
    d, n_layers, m = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    pd = cfg.param_dtype

    def norm(shape):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * 0.02).to(pd)

    def stacked(shape):
        out = torch.empty((n_layers, *shape), dtype=pd, device=device)
        for i in range(n_layers):
            out[i] = norm(shape)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    return {
        "embed": norm((cfg.vocab_size, d)),
        "blocks": {
            "ln1": {"scale": ones((n_layers, d))},
            "attn": {
                "wq": stacked((d, d)),
                "wk": stacked((d, kvd)),
                "wv": stacked((d, kvd)),
                "wo": stacked((d, d)),
            },
            "ln2": {"scale": ones((n_layers, d))},
            "mlp": {
                "wg": stacked((d, m)),
                "wu": stacked((d, m)),
                "wd": stacked((m, d)),
            },
        },
        "lnf": {"scale": ones((d,))},
        "lm_head": norm((cfg.vocab_size, d)),
    }


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = "cuda",
               quantized: Optional[bool] = None) -> KVCache:
    """A zeroed cache over this rank's KV heads; int8 with scales when
    `quantized` (default: `cfg.quant_kv`)."""
    if quantized is None:
        quantized = cfg.quant_kv
    return KVCache.create(cfg.num_layers, batch, cfg.local_kv_heads, max_len,
                          cfg.head_dim, dtype or cfg.dtype, device,
                          quantized=quantized)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [B, T, Dh] float32 of absolute positions [B, T]: the
    frequencies theta^(-2i/Dh), each half of Dh repeating them (HF)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    freqs = positions.float()[..., None] * inv_freq  # [B, T, Dh/2]
    return (torch.cat([torch.cos(freqs)] * 2, dim=-1),
            torch.cat([torch.sin(freqs)] * 2, dim=-1))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x * cos + rotate_half(x) * sin in float32, in x's dtype; cos and sin
    broadcast against x [..., Dh]."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, HF rotate_half convention (the JAX package's
    `rope`): x [B, H, T, Dh], positions [B, T] absolute."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return apply_rope(x, cos[:, None], sin[:, None])


def apply_block(x: torch.Tensor, lp: Params, attend_fn, cfg: LlamaConfig,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One decoder block; `attend_fn(q, k_new, v_new) -> context` owns cache
    handling and attention (q [B, H, T, Dh], k and v [B, Hkv, T, Dh]);
    cos and sin [B, T, 1, Dh]."""
    eps = cfg.rms_norm_eps
    b, t, _ = x.shape
    nh, nkv, dh = cfg.local_heads, cfg.local_kv_heads, cfg.head_dim
    tp = tensor_parallel_of(cfg)
    h = rms_norm(x, lp["ln1"]["scale"], eps)
    q = dense(h, lp["attn"]["wq"]).view(b, t, nh, dh)
    k = dense(h, lp["attn"]["wk"]).view(b, t, nkv, dh)
    v = dense(h, lp["attn"]["wv"]).view(b, t, nkv, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)  # the last kernel before the attention
    a = attend_fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    x = x + row_dense(merge_heads(a), lp["attn"]["wo"], None, tp)
    h2 = rms_norm(x, lp["ln2"]["scale"], eps)
    g = dense(h2, lp["mlp"]["wg"])
    u = dense(h2, lp["mlp"]["wu"])
    return x + row_dense(F.silu(g) * u, lp["mlp"]["wd"], None, tp)


def forward(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,
    cache: Optional[KVCache] = None,
    positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    write_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder; returns (logits [B, T, V] float32, cache), in the
    ring forward (``cfg.sequence_parallel``) this rank's [B, T/sp, V].

    The contract of `gpt2.forward` (cache modes, in-place writes, the
    scalar overflow check, `kv_mask`, `write_mask`, `cache.rows`), except
    that `positions` [B, T] (default: the slot indices) drive RoPE and
    nothing else, so no position table bounds them.
    """
    b, t = input_ids.shape
    sp = axis_of(cfg, "sequence_parallel", "sp")
    ring = cache is None and sp.size > 1
    if ring:
        check_ring(sp, t, kv_mask, positions)
    q_slots, _ = cache_slots(cache, b, t, input_ids.device, write_mask)
    if positions is None:
        positions = q_slots
    if ring:
        # This rank's shard of the sequence, at its absolute positions.
        lo, t = sp.rank * (t // sp.size), t // sp.size
        input_ids = input_ids[:, lo:lo + t]
        positions = positions[:, lo:lo + t]
        q_slots = q_slots[:, lo:lo + t]
    tp = tensor_parallel_of(cfg)
    x = embed_lookup(params["embed"], input_ids, tp).to(cfg.dtype)
    # Layer-invariant: RoPE's tables once a forward.
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    num_keys = t if cache is None else cache.max_len
    mask = causal_window_mask(q_slots, num_keys)  # [B, 1, T, num_keys]
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]
    groups = cfg.num_heads // cfg.num_kv_heads

    if ring:
        def attend_fn(q, k, v):
            return ring_attention(q, repeat_kv(k, groups),
                                  repeat_kv(v, groups), sp)
    elif cache is None:
        attend_fn = full_attention(mask, groups)
    if cache is None:
        for i in range(cfg.num_layers):
            x = apply_block(x, layer_params(params, i), attend_fn, cfg, cos,
                            sin)
        new_cache = None
    else:
        # The decode step's append kernel is a programmatic dependent of
        # k's RoPE just before it. Its prologue (before griddepcontrol.wait)
        # reads the step's lengths and bias, built before the first layer,
        # and the cache rows below each row's new slot with their scales,
        # written by earlier steps; RoPE writes a fresh k tensor, none of
        # those.
        step = CachedAttention(
            cache, q_slots=q_slots, mask=mask, kv_mask=kv_mask,
            write_mask=write_mask, fused=cfg.fused_decode_attention,
            quant_kv=cfg.quant_kv, groups=groups, dependent=True)
        for i in range(cfg.num_layers):
            x = apply_block(x, layer_params(params, i),
                            lambda q, k, v, layer=i: step(layer, q, k, v),
                            cfg, cos, sin)
        new_cache = step.advanced()

    x = rms_norm(x, params["lnf"]["scale"], cfg.rms_norm_eps)
    return unembed(x, params["lm_head"], tp), new_cache
