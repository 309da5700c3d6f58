"""Weight-only int8 matrix product: a CUDA kernel and its plain version.

The JAX package has no Pallas kernel here: its `common.dense` and
`quant.unembed` leave ``x @ q.astype(x.dtype) * s`` to XLA, which fuses the
int8-to-float convert into the product's operand load. In eager PyTorch the
same expression materialises a converted copy of the weight on every call
(int8 read, a 2- or 4-byte copy written and read again), so an int8 model
would move more bytes than a bf16 one. `csrc/int8_matmul.cu` reads the int8
weight once and converts it in registers.

Two layouts, one kernel:

- dense:      y [M, N] = (x [M, K] @ q [K, N]) * s [N] (+ b [N]), in x's dtype
              (`common.dense`: q is [in, out] with per-out-channel scales);
- transposed: y [M, N] = (x [M, K] @ q [N, K]^T) * s [N], float32
              (`quant.unembed`: the tied table [V, D] with per-row scales).

`int8_matmul` dispatches on where x lives: CPU tensors take
`int8_matmul_reference` (the plain version, the JAX expression written in
PyTorch); CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from . import build

KERNEL = "int8_matmul"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the kernel, incremented only where it is launched (never by
# the plain path).
launch_counts: Dict[str, int] = {KERNEL: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          transposed: bool = False) -> torch.Tensor:
    """Plain version: the JAX package's expression.

    dense      ``(x @ q.to(x.dtype)) * s.to(y.dtype) (+ b.to(y.dtype))``,
               rounded to x's dtype after the product and after the scale;
    transposed ``(x @ q^T) * s`` with float32 products and sums (the
               einsum's `preferred_element_type=float32`).
    """
    if transposed:
        return torch.matmul(x.float(), q.float().t()) * s.float()
    y = torch.matmul(x, q.to(x.dtype))
    y = y * s.to(y.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _check_args(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                b: Optional[torch.Tensor], transposed: bool) -> Tuple[int, int]:
    """(K, N) of the product; raises on shapes the function does not take."""
    if q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"q must be a 2-D int8 tensor, got {q.dtype} "
                         f"{tuple(q.shape)}")
    n, k = (q.shape[0], q.shape[1]) if transposed else (q.shape[1],
                                                        q.shape[0])
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match q "
                         f"{tuple(q.shape)} (transposed={transposed})")
    if tuple(s.shape) != (n,):
        raise ValueError(f"s must be [{n}], got {tuple(s.shape)}")
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"b must be [{n}], got {tuple(b.shape)}")
    if transposed and b is not None:
        raise ValueError("the transposed (unembedding) layout takes no bias")
    return k, n


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                transposed: bool = False) -> torch.Tensor:
    """x [..., K] times the int8 weight `q` dequantized by `s` (see the
    module docstring for the two layouts); returns [..., N] in x's dtype
    (dense) or float32 (transposed)."""
    tensors = [x, q, s] + ([b] if b is not None else [])
    device = x.device
    if any(t.device != device for t in tensors):
        devices = sorted({str(t.device) for t in tensors})
        raise ValueError(f"int8_matmul tensors on several devices: {devices}")
    k, n = _check_args(x, q, s, b, transposed)
    if device.type == "cpu":
        return int8_matmul_reference(x, q, s, b, transposed)
    if device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {device}")
    return _launch_kernel(x, q, s, b, transposed, k, n)


def _launch_kernel(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   b: Optional[torch.Tensor], transposed: bool, k: int,
                   n: int) -> torch.Tensor:
    """Validate what the CUDA kernel takes (beyond `_check_args`), launch
    it, count the launch."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul kernel takes float32 or bfloat16 x, "
                        f"not {x.dtype}")
    if k % 16 or (not transposed and n % 16):
        raise ValueError(
            f"kernel reads 16-byte vectors: K ({k}) and, for the dense "
            f"layout, N ({n}) must be multiples of 16"
        )
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    s = s if s.dtype == torch.float32 and s.is_contiguous() else \
        s.float().contiguous()
    if b is not None and (b.dtype != x.dtype or not b.is_contiguous()):
        b = b.to(x.dtype).contiguous()
    out_dtype = torch.float32 if transposed else x.dtype
    out = x2.new_empty((m, n), dtype=out_dtype)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    if (x2.data_ptr() | q.data_ptr()) % 16:
        raise ValueError("x and q must be 16-byte aligned (the kernel reads "
                         "16-byte vectors)")
    launch, stream = _entry_point()
    err = launch(x2.data_ptr(), q.data_ptr(), s.data_ptr(),
                 b.data_ptr() if b is not None else None, out.data_ptr(),
                 m, n, k, int(transposed), _DTYPE_CODES[x.dtype],
                 stream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts[KERNEL] += 1
    return out.reshape(*x.shape[:-1], n)


_bound: Optional[Tuple[Callable[..., int], Callable[[int], int]]] = None


def _entry_point() -> Tuple[Callable[..., int], Callable[[int], int]]:
    """The C launch function, bound once (built first if needed), and the
    device's current raw stream handle by index."""
    global _bound
    if _bound is None:
        fn = build.load(KERNEL).int8_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = (fn, torch._C._cuda_getCurrentRawStream)
    return _bound
