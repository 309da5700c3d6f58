"""Shared building blocks for the port's models, on plain tensors: GPT-2
(the tutoring model) and the BERT encoder of the relevance gate (carried
as an encoder only, not as a serving preset).

Counterpart of `distributed_lms_raft_llm_tpu/models/common.py` (the dense
and int8 branches of `dense`, the KV cache with its int8 scale planes,
`quantize_kv`, `attend`, `attend_quant`).

Conventions kept from the JAX package, so the parity tests compare like
with like:

- parameters are nested dicts of tensors with per-layer weights stacked on
  a leading layer axis; the trunk indexes layer ``i`` (a view, no copy);
- linear weights are stored ``[in, out]``, or as the weight-only int8 pair
  ``{"q": int8 [in, out], "s": f32 [out]}`` (`models/quant.py`);
- layer norm, attention scores and softmax run in float32 whatever the
  compute dtype; residual adds stay in the compute dtype;
- the KV cache is stacked ``[L, B, Hkv, S, Dh]``, int8 with per-slot
  float32 scales ``[L, B, Hkv, S]`` when quantized.

Unlike JAX's immutable carry, the KV cache here is written IN PLACE: a
forward step assigns the new keys/values into the cache tensors it was
given. That replaces the JAX package's scan carry and buffer donation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..ops import quant_matmul

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


def layer_params(params: dict, i: int) -> dict:
    """Layer i's weights as views into the stacked block tensors (an int8
    ``{"q", "s"}`` pair is indexed leaf by leaf)."""

    def take(v):
        return {k: x[i] for k, x in v.items()} if isinstance(v, dict) else v[i]

    return {name: {k: take(v) for k, v in group.items()}
            for name, group in params["blocks"].items()}


def dense(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b) with w stored [in, out], in x's dtype.

    `w` is a dense tensor or the weight-only int8 pair ``{"q", "s"}``; the
    pair goes through `ops.quant_matmul.int8_matmul` (the hand-written
    kernel on the card, the JAX package's expression on the CPU).
    """
    if isinstance(w, dict):
        return quant_matmul.int8_matmul(x, w["q"], w["s"], b)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


@dataclasses.dataclass
class KVCache:
    """Stacked KV cache, written in place.

    k, v:    [num_layers, batch, num_kv_heads, max_len, head_dim], int8
             when quantized
    length:  slots already written, one offset for the batch (the bucketed
             engine)
    ks, vs:  [num_layers, batch, num_kv_heads, max_len] float32 per-slot
             scales of an int8 cache (`quantize_kv`), else None
    lengths: [batch] per-row offsets (the paged engine's ragged slots), or
             None; when set it takes the place of `length`
    rows:    [batch] int64 cache rows that the batch's rows read and write,
             a device tensor (the slot a fused admission chunk prefills,
             chosen on the device), or None for rows 0..batch-1; only
             with `lengths`

    `window(width)` gives a cache over the first `width` slots that shares
    storage with this one: attention then reads only slots that can be
    valid yet, and writes through the window land in the full cache.
    """

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @classmethod
    def create(cls, num_layers: int, batch: int, num_kv_heads: int,
               max_len: int, head_dim: int, dtype: torch.dtype,
               device: torch.device | str,
               quantized: bool = False) -> "KVCache":
        shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
        if quantized:
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                ks=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                vs=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            )
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
        return dataclasses.replace(
            self, k=self.k[:, :, :, :width], v=self.v[:, :, :, :width],
            ks=None if self.ks is None else self.ks[:, :, :, :width],
            vs=None if self.vs is None else self.vs[:, :, :, :width],
        )


_divisors: Dict[Tuple[float, str], torch.Tensor] = {}


def _divisor(value: float, device: torch.device) -> torch.Tensor:
    """A float32 0-d tensor of `value` on `device`, made once per device,
    outside any CUDA graph capture (a capture would record the fill
    without running it); captured graphs then read the same tensor."""
    key = (value, str(device))
    found = _divisors.get(key)
    if found is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quantize_kv runs eagerly once on a device "
                               "before a CUDA graph captures it")
        found = _divisors[key] = torch.full((), value, dtype=torch.float32,
                                            device=device)
    return found


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(batch, head, slot) int8: [B, H, T, Dh] -> (int8 of the
    same shape, float32 [B, H, T] scales), in the JAX package's op order
    (so bit-equal to it: division, round half to even, clip)."""
    xf = x.float()
    # A tensor divisor, not the number 127: PyTorch's CUDA division by a
    # Python number multiplies by its reciprocal, which can differ from
    # the division in the last bit (the CPU and JAX divide).
    s = xf.abs().amax(dim=-1) / _divisor(127.0, x.device)
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def attend_quant(q: torch.Tensor, k_q: torch.Tensor, ks: torch.Tensor,
                 v_q: torch.Tensor, vs: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """`attend` against an int8 cache: q [B,H,T,Dh], k_q/v_q int8
    [B,H,S,Dh], ks/vs f32 [B,H,S], mask [B,1,T,S].

    As in the JAX package: float32 scores of q against the int8 keys in
    q's dtype, scaled by ks on the key axis, then by Dh^-1/2; the softmax
    probabilities times vs, cast to q's dtype, against the int8 values in
    q's dtype.
    """
    dtype = q.dtype
    head_dim = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_q.to(dtype).float())
    scores = scores * ks[:, :, None, :]
    scores = scores / math.sqrt(head_dim)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * vs[:, :, None, :]).to(dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v_q.to(dtype))


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
