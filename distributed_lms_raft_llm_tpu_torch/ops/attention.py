"""Fused single-token decode attention: a CUDA kernel and its plain version.

Port of `distributed_lms_raft_llm_tpu/ops/attention.py` (the repository's
one Pallas kernel). The kernel, `csrc/decode_attention.cu`, is written by
hand for Hopper (`sm_90a`) and bound through ctypes (`ops/build.py`); its
source notes what bounds it and how it is laid out.

`decode_attention` dispatches on where its tensors live: CPU tensors take
`decode_attention_reference` (the plain PyTorch version, which the CPU
tests hold against JAX); CUDA tensors launch the kernel or raise. There is
no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import math
import operator
from typing import Dict

import torch

from ..models.common import NEG_INF
from . import build

KERNEL = "decode_attention"
MAX_KEYS = 1024   # f32 scores of one group live in shared memory
MAX_GROUP = 8     # query heads per KV head (csrc kMaxGroup)
HEAD_DIMS = (8, 16, 32, 64, 128)  # csrc instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches by wrapper, incremented only where a kernel is launched
# (never by the plain path). A run resets it, drives the main path, and
# reads it to show the path went through the kernel.
launch_counts: Dict[str, int] = {KERNEL: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, T, S] boolean attend-mask -> [B, 1, S] additive f32 bias
    (layer-invariant: computed once per decode step)."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, 0, 0, :], zero, neg)[:, None, :]


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, layer: int,
                               bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `common.attend` on the indexed layer.

    Scores and softmax in f32 with the additive bias, probabilities cast to
    the cache dtype for the weighted sum, output in q's dtype. Query head h
    reads KV head h // (H / Hkv).
    """
    h, hkv = q.shape[1], k_cache.shape[2]
    k = k_cache[layer]
    v = v_cache[layer]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1]) + bias[:, :, None, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)


def _check_args(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, layer: int,
                bias: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, H, 1, Dh], got {tuple(q.shape)}")
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(
            "k_cache and v_cache must both be [L, B, Hkv, S, Dh], got "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}"
        )
    b, h, _, dh = q.shape
    n_layers, cb, hkv, s, cdh = k_cache.shape
    if cb != b or cdh != dh or hkv == 0 or h % hkv:
        raise ValueError(
            f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}"
        )
    if tuple(bias.shape) != (b, 1, s) or bias.dtype != torch.float32:
        raise ValueError(
            f"bias must be float32 [{b}, 1, {s}], got {bias.dtype} "
            f"{tuple(bias.shape)}"
        )
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside [0, {n_layers})")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, layer: int,
                     bias: torch.Tensor) -> torch.Tensor:
    """Decode attention against one layer of the stacked KV cache.

    q        [B, H, 1, Dh] — the decode step's queries
    k_cache  [L, B, Hkv, S, Dh] — stacked cache (a view over the first S
             slots of a larger cache is fine: it is read in place)
    v_cache  [L, B, Hkv, S, Dh]
    layer    int — which layer's K/V to attend against
    bias     [B, 1, S] f32 — additive mask (0 = attend, NEG_INF = not)
    returns  [B, H, 1, Dh] in q's dtype.
    """
    layer = operator.index(layer)
    _check_args(q, k_cache, v_cache, layer, bias)
    devices = {t.device for t in (q, k_cache, v_cache, bias)}
    if len(devices) != 1:
        raise ValueError(
            f"decode_attention tensors on several devices: {sorted(map(str, devices))}"
        )
    (device,) = devices
    if device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, layer, bias)
    if device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {device}")
    return _launch_kernel(q, k_cache, v_cache, layer, bias)


def _launch_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, layer: int,
                   bias: torch.Tensor) -> torch.Tensor:
    """Validate what the CUDA kernel takes, launch it, count the launch."""
    b, h, _, dh = q.shape
    n_layers, _, hkv, s, _ = k_cache.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q, k_cache and v_cache must share one dtype, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if h // hkv > MAX_GROUP or dh not in HEAD_DIMS or s > MAX_KEYS:
        raise ValueError(
            f"kernel limits: H/Hkv <= {MAX_GROUP}, Dh in {HEAD_DIMS}, "
            f"S <= {MAX_KEYS}; got H/Hkv={h // hkv}, Dh={dh}, S={s}"
        )
    if not q.is_contiguous() or not bias.is_contiguous():
        raise ValueError("q and bias must be contiguous")
    s_alloc = _slot_stride(k_cache)
    if s_alloc is None or _slot_stride(v_cache) != s_alloc:
        raise ValueError(
            "k_cache/v_cache must be contiguous [L, B, Hkv, S_alloc, Dh] "
            "tensors, or views of such over their first S slots"
        )
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("k_cache/v_cache must be 16-byte aligned (the "
                         "kernel reads 16-byte vectors)")
    out = torch.empty_like(q)
    lib = _library()
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, hkv, s, s_alloc, dh, layer,
        _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts[KERNEL] += 1
    return out


def _slot_stride(cache: torch.Tensor) -> int | None:
    """S_alloc if `cache` is laid out as a contiguous [L, B, Hkv, S_alloc, Dh]
    buffer (possibly sliced to its first S slots), else None."""
    n_layers, b, hkv, s, dh = cache.shape
    st = cache.stride()
    if st[4] != 1 or st[3] != dh or st[2] % dh:
        return None
    s_alloc = st[2] // dh
    if s_alloc < s or st[1] != hkv * st[2] or st[0] != b * st[1]:
        return None
    return s_alloc


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
