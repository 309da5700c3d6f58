"""Shared building blocks for the port's models, on plain tensors: GPT-2
and Llama (the tutoring models) and the BERT encoder of the relevance gate
(carried as an encoder only, not as a serving preset).

Counterpart of `distributed_lms_raft_llm_tpu/models/common.py` (the dense
and int8 branches of `dense`, `rms_norm`, `repeat_kv`, the KV cache with
its int8 scale planes, `quantize_kv`, `attend`, `attend_quant`), and the
cache handling both decoders share (`cache_slots`, `CachedAttention`: in
the JAX package each model's forward spells it out).

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
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops import attention as attention_ops
from ..ops import quant_matmul
from ..parallel.mesh import ParallelAxis, TensorParallel

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


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm in float32 regardless of input dtype; returns input dtype."""
    dtype = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dtype)


def layer_params(params: dict, i: int) -> dict:
    """Layer i's weights as views into the stacked block tensors (an int8
    ``{"q", "s"}`` pair is indexed leaf by leaf)."""

    def take(v):
        return {k: x[i] for k, x in v.items()} if isinstance(v, dict) else v[i]

    return {name: {k: take(v) for k, v in group.items()}
            for name, group in params["blocks"].items()}


def unbind_layers(params: dict) -> list:
    """Every layer's weights, as `layer_params` gives them, with each
    stacked leaf split once (`torch.unbind`): the same views, but a
    backward pass stacks a leaf's layer gradients in one copy, where
    indexing layer by layer adds a full-size zero tensor a layer."""

    def split(v):
        if isinstance(v, dict):
            parts = {k: torch.unbind(x) for k, x in v.items()}
            return [dict(zip(parts, layer)) for layer in zip(*parts.values())]
        return torch.unbind(v)

    groups = {name: {k: split(v) for k, v in group.items()}
              for name, group in params["blocks"].items()}
    n = len(next(iter(next(iter(groups.values())).values())))
    return [{name: {k: v[i] for k, v in group.items()}
             for name, group in groups.items()} for i in range(n)]


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


def row_dense(x: torch.Tensor, w, b: torch.Tensor | None,
              tp: TensorParallel) -> torch.Tensor:
    """A row-parallel product (attention-out, MLP-out): x [..., in / tp]
    against this rank's rows w [in / tp, out], summed over the tp ranks,
    then the bias, added once after the sum (so never in the int8
    kernel's epilogue, which would add it on every rank). The sum is the
    "reduce" pair (`ParallelAxis.all_reduce`): its backward hands every
    rank the whole gradient. At tp = 1 it is `dense`, the bias in the
    epilogue."""
    if tp.size == 1:
        return dense(x, w, b)
    y = tp.all_reduce(dense(x, w))
    return y if b is None else y + b.to(y.dtype)


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


def repeat_kv(x: torch.Tensor, repeats: int) -> torch.Tensor:
    """Grouped KV heads [B, Hkv, ...] -> [B, Hkv * repeats, ...]: query head
    h reads KV head h // repeats (K and V [B, Hkv, T, Dh], or an int8
    cache's scales [B, Hkv, T])."""
    if repeats == 1:
        return x
    b, h = x.shape[:2]
    x = x[:, :, None].expand(b, h, repeats, *x.shape[2:])
    return x.reshape(b, h * repeats, *x.shape[3:])


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


def cache_slots(cache: Optional[KVCache], b: int, t: int,
                device: torch.device,
                write_mask: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, int]:
    """The slots of a forward's T new positions, [B, T], and its scalar
    offset (0 without a cache or with per-row offsets).

    Without a cache: 0 .. T-1. A scalar `cache.length + T` must fit the
    cache: checked here, where JAX would clamp silently. Per-row offsets
    (`cache.lengths`) stay on the device and are not checked (that would
    sync the host): the caller keeps `lengths + T <= max_len`.
    `cache.rows` and `write_mask` need per-row offsets."""
    ragged = cache is not None and cache.lengths is not None
    if cache is not None and (cache.rows is not None
                              or write_mask is not None) and not ragged:
        raise ValueError("cache.rows and write_mask need per-row offsets "
                         "(cache.lengths)")
    offset = 0 if cache is None or ragged else cache.length
    if cache is not None and not ragged and offset + t > cache.max_len:
        raise ValueError(
            f"cache overflow: {offset} + {t} slots > cache of {cache.max_len}"
        )
    steps = torch.arange(t, device=device)
    if ragged:
        return cache.lengths.long()[:, None] + steps[None, :], offset
    return (offset + steps)[None, :].expand(b, t), offset


def check_ring(sp: ParallelAxis, t: int, kv_mask: Optional[torch.Tensor],
               positions: Optional[torch.Tensor]) -> None:
    """Refuse what the ring forward cannot run (both families): a padding
    mask or explicit positions (the JAX package's refusal: ring attention
    computes exact causal attention from the blocks' absolute offsets),
    and a sequence that does not split into sp equal shards."""
    if kv_mask is not None or positions is not None:
        raise ValueError(
            "ring attention (cfg.sequence_parallel, the JAX package's "
            "cfg.ring_mesh) supports full causal sequences only: no "
            "kv_mask, default positions")
    if t % sp.size:
        raise ValueError(f"ring attention over sp={sp.size} takes a "
                         f"sequence of a multiple of {sp.size} tokens, "
                         f"not {t}")

def full_attention(mask: torch.Tensor, groups: int = 1) -> Callable:
    """`attend_fn(q, k, v)` of a forward without a cache: causal attention
    over the input, the `groups` query heads of a KV head reading it
    (`repeat_kv`)."""

    def attend_full(q, k, v):
        return attend(q, repeat_kv(k, groups), repeat_kv(v, groups), mask)

    return attend_full


def write_rows(buf: torch.Tensor, layer: int, rows: torch.Tensor,
               slots: torch.Tensor, val: torch.Tensor,
               keep: Optional[torch.Tensor]) -> None:
    """buf[layer, rows[b], :, slots[b, t]] = val[b, t] for [B, T] entries
    (rows [B, 1]); where `keep` is False the slot keeps its value."""
    if keep is not None:
        old = buf[layer, rows, :, slots]
        val = torch.where(keep.reshape(*keep.shape, *([1] * (val.dim() - 2))),
                          val, old)
    buf[layer, rows, :, slots] = val


class CachedAttention:
    """A decoder step's cache writes and attention, layer by layer: built
    once a forward over a KVCache, then called as
    ``step(layer, q, k_new, v_new) -> context`` (q [B, H, T, Dh], k_new and
    v_new [B, Hkv, T, Dh]). `advanced()` is the cache after the step.

    Routes, by the cache and the step:

    - the paged decode step (per-row offsets, T = 1, no ``cache.rows`` or
      ``write_mask``) with ``fused``: `ops.attention.
      decode_attention_append`, one kernel that quantizes (an int8 cache)
      and writes the new row and attends; `dependent` launches it as a
      programmatic dependent of the kernel just before it (the model says
      why that kernel writes nothing its prologue reads);
    - otherwise the new keys/values are written IN PLACE first: at
      `cache.length` (one offset), or at each row's own offset, into cache
      rows `cache.rows` where set and under `write_mask` (a False entry
      keeps the slot as it was, so a chunk's pad tail is dropped, never
      clamped into real slots); int8 with `quantize_kv` for an int8 cache;
    - then, with ``fused`` and T == 1 or per-row offsets (and no
      ``cache.rows``): `ops.attention.decode_attention`, the kernel that
      reads the stacked cache (GQA by head index), the mask as a bias, or a
      verify window's rows at their own frontiers with ``kv_mask`` as the
      bias they share; else the plain `attend` / `attend_quant` over the
      layer (gathered at ``cache.rows``), each KV head repeated for its
      `groups` query heads (`repeat_kv` on K, V and the int8 scales), as in
      the JAX package's models.

    `write_rows` does the per-row writes (`write_rows` of this module
    unless the model passes its own).
    """

    def __init__(self, cache: KVCache, *, q_slots: torch.Tensor,
                 mask: torch.Tensor, kv_mask: Optional[torch.Tensor],
                 write_mask: Optional[torch.Tensor], fused: bool,
                 quant_kv: bool, groups: int = 1, dependent: bool = False,
                 write_rows: Callable = write_rows):
        if cache.quantized != quant_kv:
            raise ValueError(
                f"cfg.quant_kv={quant_kv} but the cache is "
                f"{'int8' if cache.quantized else 'full precision'}"
            )
        b, t = q_slots.shape
        device = q_slots.device
        ragged = cache.lengths is not None
        self.cache, self.t, self.mask = cache, t, mask
        self.groups, self.dependent = groups, dependent
        self.write_rows = write_rows
        self.ragged, self.rows_sel = ragged, cache.rows
        self.offset = 0 if ragged else cache.length
        self.fused = fused and cache.rows is None and (t == 1 or ragged)
        # The paged decode step (one row a slot at its own offset): one
        # kernel appends the new K/V row (quantized for an int8 cache) and
        # attends; no torch quantize or index write runs on this route.
        self.append = self.fused and ragged and t == 1 and write_mask is None
        # Layer-invariant kernel inputs, built once per step: the mask as a
        # bias (not needed where per-row lengths say it all; a window's
        # rows share the key-validity mask alone, their causal frontiers
        # are the lengths) and each row's key count (its offset + 1).
        self.bias = self.lengths = None
        if self.fused:
            if t > 1:
                if kv_mask is not None:
                    self.bias = attention_ops.mask_to_bias(
                        kv_mask[:, None, None, :])
            elif not ragged or kv_mask is not None:
                self.bias = attention_ops.mask_to_bias(mask)
            if ragged:
                self.lengths = (cache.lengths + 1).to(torch.int32)
        self.rows = self.slots = self.keep = None
        if ragged and not self.append:
            self.rows = (torch.arange(b, device=device) if cache.rows is None
                         else cache.rows)[:, None]
            self.slots = q_slots
            if write_mask is not None:
                # Dropped entries are sent to the last slot and write back
                # what is there, so no index leaves the cache.
                self.keep = write_mask
                self.slots = torch.where(
                    write_mask, q_slots,
                    torch.full_like(q_slots, cache.max_len - 1))

    def __call__(self, layer: int, q: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> torch.Tensor:
        cache = self.cache
        ck, cv, cks, cvs = cache.k, cache.v, cache.ks, cache.vs
        if self.append:
            return attention_ops.decode_attention_append(
                q, k_new, v_new, ck, cv, layer, self.bias,
                lengths=self.lengths, k_scale=cks, v_scale=cvs,
                dependent=self.dependent)
        quant_kv = cache.quantized
        if quant_kv:
            k_w, k_s = quantize_kv(k_new)
            v_w, v_s = quantize_kv(v_new)
        else:
            k_w, v_w = k_new.to(ck.dtype), v_new.to(cv.dtype)
        if self.ragged:
            # Advanced indices [B, 1] rows x [B, T] slots land in front, as
            # in JAX: values go in as [B, T, Hkv, Dh].
            news = [(ck, k_w), (cv, v_w)]
            if quant_kv:
                news += [(cks, k_s), (cvs, v_s)]
            for buf, val in news:
                self.write_rows(buf, layer, self.rows, self.slots,
                                val.transpose(1, 2), self.keep)
        else:
            lo, hi = self.offset, self.offset + self.t
            ck[layer, :, :, lo:hi] = k_w
            cv[layer, :, :, lo:hi] = v_w
            if quant_kv:
                cks[layer, :, :, lo:hi] = k_s
                cvs[layer, :, :, lo:hi] = v_s
        if self.fused:  # q may be a strided view, read in place
            return attention_ops.decode_attention(
                q, ck, cv, layer, self.bias, lengths=self.lengths,
                k_scale=cks, v_scale=cvs,
            )
        lk, lv = ck[layer], cv[layer]
        lks = None if cks is None else cks[layer]
        lvs = None if cvs is None else cvs[layer]
        if self.rows_sel is not None:
            lk, lv = lk[self.rows_sel], lv[self.rows_sel]
            if quant_kv:
                lks, lvs = lks[self.rows_sel], lvs[self.rows_sel]
        g = self.groups
        if quant_kv:
            return attend_quant(q, repeat_kv(lk, g), repeat_kv(lks, g),
                                repeat_kv(lv, g), repeat_kv(lvs, g),
                                self.mask)
        return attend(q, repeat_kv(lk.to(q.dtype), g),
                      repeat_kv(lv.to(q.dtype), g), self.mask)

    def advanced(self) -> KVCache:
        """The cache after the step: the same storage, its offsets moved
        on by T."""
        if self.ragged:
            return dataclasses.replace(self.cache,
                                       lengths=self.cache.lengths + self.t)
        return dataclasses.replace(self.cache, length=self.offset + self.t)
