"""GPT-2 forward on plain tensors.

Port of `distributed_lms_raft_llm_tpu/models/gpt2.py`. Parameters are the
same nested dict, with per-layer weights stacked on a leading layer axis
(`convert.params_from_jax` carries a JAX pytree across unchanged); the
trunk is a Python loop that indexes layer ``i``. There is no jit or scan:
PyTorch runs eagerly.

`forward` has four modes:

- full sequence (``cache=None``): causal attention over the input;
- cached with one scalar offset (``cache.length``): prefill and decode
  write their keys/values into the cache IN PLACE at that offset;
- cached with per-row offsets (``cache.lengths``, the paged engine's
  ragged slots): each row's T new keys/values are scattered at its own
  offset, optionally into cache rows chosen on the device (``cache.rows``)
  and under a write mask (the fused admission chunk's one staged slot);
- cached with T == 1 and ``cfg.fused_decode_attention``: attention runs
  through `ops.attention.decode_attention` (the CUDA kernel on the card,
  its plain version on the CPU), reading the layer from the stacked cache,
  in every cache mode: scalar offset with the mask as a bias, ragged with
  per-row lengths, float or int8 cache;
- cached with per-row offsets, T > 1 and no ``cache.rows`` (the
  speculative verify window, T = k+1) and ``cfg.fused_decode_attention``:
  the kernel's window variant, row b's query t seeing the keys up to its
  own slot (lengths[b] + t + 1 keys), with ``kv_mask`` (the bucketed
  engine's left padding) as a bias the T rows share. The kernel takes
  T <= `ops.attention.MAX_WINDOW` rows and raises beyond: a wider window
  never drops to the plain version.

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
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from ..ops import attention as attention_ops
from .common import (
    KVCache,
    attend,
    attend_quant,
    causal_window_mask,
    dense,
    layer_norm,
    layer_params,
    merge_heads,
    quantize_kv,
    split_heads,
)
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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return 4 * self.hidden_size

    @classmethod
    def small(cls, **kw) -> "GPT2Config":
        """GPT-2 small (124M): the published width."""
        return cls(**kw)

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
    """A zeroed cache; int8 with scales when `quantized` (default:
    `cfg.quant_kv`)."""
    if quantized is None:
        quantized = cfg.quant_kv
    return KVCache.create(cfg.num_layers, batch, cfg.num_heads, max_len,
                          cfg.head_dim, dtype or cfg.dtype, device,
                          quantized=quantized)


def apply_block(x: torch.Tensor, lp: Params, attend_fn,
                cfg: GPT2Config) -> torch.Tensor:
    """One transformer block; `attend_fn(q, k_new, v_new) -> context` owns
    cache handling and attention."""
    eps = cfg.layer_norm_eps
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)
    qkv = dense(h, lp["attn"]["wqkv"], lp["attn"]["bqkv"])
    q, k, v = qkv.split(cfg.hidden_size, dim=-1)
    a = attend_fn(
        split_heads(q, cfg.num_heads),
        split_heads(k, cfg.num_heads),
        split_heads(v, cfg.num_heads),
    )
    x = x + dense(merge_heads(a), lp["attn"]["wo"], lp["attn"]["bo"])
    h2 = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
    m = dense(h2, lp["mlp"]["wi"], lp["mlp"]["bi"])
    m = F.gelu(m, approximate="tanh")  # GPT-2 uses the tanh approximation
    return x + dense(m, lp["mlp"]["wo"], lp["mlp"]["bo"])


def _write_rows(buf: torch.Tensor, layer: int, rows: torch.Tensor,
                slots: torch.Tensor, val: torch.Tensor,
                keep: Optional[torch.Tensor]) -> None:
    """buf[layer, rows[b], :, slots[b, t]] = val[b, t] for [B, T] entries
    (rows [B, 1]); where `keep` is False the slot keeps its value."""
    if keep is not None:
        old = buf[layer, rows, :, slots]
        val = torch.where(keep.reshape(*keep.shape, *([1] * (val.dim() - 2))),
                          val, old)
    buf[layer, rows, :, slots] = val


def forward(
    params: Params,
    cfg: GPT2Config,
    input_ids: torch.Tensor,
    cache: Optional[KVCache] = None,
    positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    write_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the transformer; returns (logits [B, T, V] float32, cache).

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
    device = input_ids.device
    ragged = cache is not None and cache.lengths is not None
    rows_sel = None if cache is None else cache.rows
    if (rows_sel is not None or write_mask is not None) and not ragged:
        raise ValueError("cache.rows and write_mask need per-row offsets "
                         "(cache.lengths)")
    offset = 0 if cache is None or ragged else cache.length
    if cache is not None and not ragged and offset + t > cache.max_len:
        raise ValueError(
            f"cache overflow: {offset} + {t} slots > cache of {cache.max_len}"
        )
    steps = torch.arange(t, device=device)
    if ragged:
        q_slots = cache.lengths.long()[:, None] + steps[None, :]
    else:
        q_slots = (offset + steps)[None, :].expand(b, t)
    if positions is None:
        if not ragged and offset + t > cfg.max_position_embeddings:
            raise ValueError(
                f"positions up to {offset + t} exceed the position table "
                f"{cfg.max_position_embeddings}"
            )
        positions = q_slots

    x = embed_lookup(params["wte"], input_ids) + params["wpe"][positions]
    x = x.to(cfg.dtype)

    num_keys = t if cache is None else cache.max_len
    mask = causal_window_mask(q_slots, num_keys)  # [B, 1, T, num_keys]
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]

    if cache is None:
        def attend_full(q, k, v):
            return attend(q, k, v, mask)

        for i in range(cfg.num_layers):
            x = apply_block(x, layer_params(params, i), attend_full, cfg)
        new_cache = None
    else:
        quant_kv = cache.quantized
        if quant_kv != cfg.quant_kv:
            raise ValueError(
                f"cfg.quant_kv={cfg.quant_kv} but the cache is "
                f"{'int8' if quant_kv else 'full precision'}"
            )
        fused = cfg.fused_decode_attention and rows_sel is None and (
            t == 1 or ragged)
        # Layer-invariant kernel inputs, built once per step: the mask as a
        # bias (not needed where per-row lengths say it all; a window's
        # rows share the key-validity mask alone, their causal frontiers
        # are the lengths) and each row's key count (its offset + 1).
        bias = lengths = None
        if fused:
            if t > 1:
                if kv_mask is not None:
                    bias = attention_ops.mask_to_bias(
                        kv_mask[:, None, None, :])
            elif not ragged or kv_mask is not None:
                bias = attention_ops.mask_to_bias(mask)
            if ragged:
                lengths = (cache.lengths + 1).to(torch.int32)
        ck, cv, cks, cvs = cache.k, cache.v, cache.ks, cache.vs
        rows = slots = keep = None
        if ragged:
            rows = (torch.arange(b, device=device) if rows_sel is None
                    else rows_sel)[:, None]
            slots = q_slots
            if write_mask is not None:
                # Dropped entries are sent to the last slot and write back
                # what is there, so no index leaves the cache.
                keep = write_mask
                slots = torch.where(keep, q_slots,
                                    torch.full_like(q_slots, num_keys - 1))
        for i in range(cfg.num_layers):

            def attend_fn(q, k_new, v_new, layer=i):
                if quant_kv:
                    k_w, k_s = quantize_kv(k_new)
                    v_w, v_s = quantize_kv(v_new)
                else:
                    k_w, v_w = k_new.to(ck.dtype), v_new.to(cv.dtype)
                if ragged:
                    # Advanced indices [B, 1] rows x [B, T] slots land in
                    # front, as in JAX: values go in as [B, T, Hkv, Dh].
                    news = [(ck, k_w), (cv, v_w)]
                    if quant_kv:
                        news += [(cks, k_s), (cvs, v_s)]
                    for buf, val in news:
                        _write_rows(buf, layer, rows, slots,
                                    val.transpose(1, 2), keep)
                else:
                    ck[layer, :, :, offset:offset + t] = k_w
                    cv[layer, :, :, offset:offset + t] = v_w
                    if quant_kv:
                        cks[layer, :, :, offset:offset + t] = k_s
                        cvs[layer, :, :, offset:offset + t] = v_s
                if fused:  # q is a strided view of qkv, read in place
                    return attention_ops.decode_attention(
                        q, ck, cv, layer, bias, lengths=lengths,
                        k_scale=cks, v_scale=cvs,
                    )
                lk, lv = ck[layer], cv[layer]
                lks = None if cks is None else cks[layer]
                lvs = None if cvs is None else cvs[layer]
                if rows_sel is not None:
                    lk, lv = lk[rows_sel], lv[rows_sel]
                    if quant_kv:
                        lks, lvs = lks[rows_sel], lvs[rows_sel]
                if quant_kv:
                    return attend_quant(q, lk, lks, lv, lvs, mask)
                return attend(q, lk.to(q.dtype), lv.to(q.dtype), mask)

            x = apply_block(x, layer_params(params, i), attend_fn, cfg)
        if ragged:
            new_cache = dataclasses.replace(cache, lengths=cache.lengths + t)
        else:
            new_cache = dataclasses.replace(cache, length=offset + t)

    x = layer_norm(x, params["lnf"]["scale"], params["lnf"]["bias"],
                   cfg.layer_norm_eps)
    return unembed(x, params["wte"]), new_cache
