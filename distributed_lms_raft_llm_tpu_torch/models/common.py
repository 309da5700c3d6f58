"""Shared building blocks for the port's models, on plain tensors.

Counterpart of `distributed_lms_raft_llm_tpu/models/common.py` (dense
branch) and of the dense `embed_lookup`/`unembed` of its `models/quant.py`.

Conventions kept from the JAX package, so the parity tests compare like
with like:

- parameters are nested dicts of tensors with per-layer weights stacked on
  a leading layer axis; the trunk indexes layer ``i`` (a view, no copy);
- linear weights are stored ``[in, out]``;
- layer norm, attention scores and softmax run in float32 whatever the
  compute dtype; residual adds stay in the compute dtype;
- the KV cache is stacked ``[L, B, Hkv, S, Dh]``.

Unlike JAX's immutable carry, the KV cache here is written IN PLACE: a
forward step assigns the new keys/values into the cache tensors it was
given. That replaces the JAX package's scan carry and buffer donation.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEG_INF = -1e30  # large finite negative: avoids NaNs from (-inf) - (-inf)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in float32 regardless of input dtype; returns input dtype."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def dense(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b) with w stored [in, out], in x's dtype.

    Only the full-precision branch is ported; the JAX package's weight-only
    int8 ``{"q", "s"}`` pair comes with the int8 slice.
    """
    if isinstance(w, dict):
        raise NotImplementedError(
            "int8 weight pairs ({'q', 's'}) are not ported yet"
        )
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup of a dense [V, D] table (indices are bounds-checked)."""
    if isinstance(table, dict):
        raise NotImplementedError("int8 embedding tables are not ported yet")
    return table[ids]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x [B, T, D] @ table [V, D]^T -> float32 logits.

    The product runs in float32 from the compute-dtype activations, as the
    JAX package's `preferred_element_type=float32` einsum does, so sampling
    sees logits that were never rounded to bf16.
    """
    if isinstance(table, dict):
        raise NotImplementedError("int8 embedding tables are not ported yet")
    return torch.matmul(x.float(), table.float().t())


@dataclasses.dataclass
class KVCache:
    """Stacked KV cache, written in place.

    k, v:   [num_layers, batch, num_kv_heads, max_len, head_dim]
    length: number of slots already written (one offset for the batch).

    `window(width)` gives a cache over the first `width` slots that shares
    storage with this one: attention then reads only slots that can be
    valid yet, and writes through the window land in the full cache.
    """

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @classmethod
    def create(cls, num_layers: int, batch: int, num_kv_heads: int,
               max_len: int, head_dim: int, dtype: torch.dtype,
               device: torch.device | str) -> "KVCache":
        shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def window(self, width: int) -> "KVCache":
        if not 0 < width <= self.max_len:
            raise ValueError(f"window {width} outside cache of {self.max_len}")
        return KVCache(k=self.k[:, :, :, :width], v=self.v[:, :, :, :width],
                       length=self.length)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """Multi-head attention core on [B, H, T, Dh] tensors, f32 softmax.

    mask: broadcastable to [B, H, Tq, Tk]; True = may attend.
    """
    dtype = q.dtype
    head_dim = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(dtype))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*Dh] -> [B, H, T, Dh]."""
    b, t, _ = x.shape
    return x.reshape(b, t, num_heads, -1).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, Dh] -> [B, T, H*Dh]."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def causal_window_mask(q_positions: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Mask for attention against a fixed-size cache window.

    q_positions: [B, Tq] absolute slots of the queries. Key slot j is
    visible iff j <= q_position. Returns [B, 1, Tq, num_keys] boolean.
    """
    key_pos = torch.arange(num_keys, dtype=q_positions.dtype,
                           device=q_positions.device)
    mask = key_pos[None, None, :] <= q_positions[:, :, None]
    return mask[:, None, :, :]
