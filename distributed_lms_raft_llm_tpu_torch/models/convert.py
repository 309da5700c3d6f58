"""Weights into the port: HF safetensors and JAX parameter trees.

Port of the GPT-2 half of `distributed_lms_raft_llm_tpu/models/convert.py`.

- `load_safetensors` reads a `.safetensors` file with the standard library
  and numpy alone (no `safetensors` package);
- `gpt2_params_from_hf` maps HF GPT-2 names onto the `gpt2.py` tree and
  casts in torch to `cfg.param_dtype` (numpy has no bfloat16);
- `params_from_jax` carries a JAX parameter tree, exported to numpy, across
  unchanged in layout: the two packages then hold the same weights. The
  weight-only int8 pairs ``{"q": int8, "s": f32}`` of a quantized tree come
  across as they are, never cast.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike
from .gpt2 import GPT2Config

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into numpy arrays.

    Format: 8-byte little-endian header length, JSON header
    {name: {dtype, shape, data_offsets}}, raw buffer. BF16 tensors are
    widened exactly to float32.
    """
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        buf = f.read()
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        start, end = spec["data_offsets"]
        raw = buf[start:end]
        if spec["dtype"] == "BF16":
            u32 = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = u32.view(np.float32)
        elif spec["dtype"] in _DTYPES:
            arr = np.frombuffer(raw, _DTYPES[spec["dtype"]])
        else:
            raise ValueError(f"{name}: unsupported safetensors dtype "
                             f"{spec['dtype']!r}")
        out[name] = arr.reshape(spec["shape"])
    return out


def to_tensor(x: Any, dtype: Optional[torch.dtype] = None,
              device: DeviceLike = "cuda") -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) or torch -> tensor on device."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(
                np.ascontiguousarray(arr).view(np.int16).copy()
            ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _strip_prefix(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def gpt2_params_from_hf(sd: Mapping[str, Any], cfg: GPT2Config,
                        device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Map HF GPT2LMHeadModel / GPT2Model weights onto the gpt2.py tree."""
    sd = _strip_prefix(sd, "transformer.")
    n_layers = cfg.num_layers
    pd = cfg.param_dtype

    def one(name: str) -> torch.Tensor:
        return to_tensor(sd[name], pd, device)

    def stack(fmt: str) -> torch.Tensor:
        # HF Conv1D stores [in, out]: used as-is.
        return torch.stack([one(fmt.format(i)) for i in range(n_layers)])

    return {
        "wte": one("wte.weight"),
        "wpe": one("wpe.weight"),
        "blocks": {
            "ln1": {"scale": stack("h.{}.ln_1.weight"),
                    "bias": stack("h.{}.ln_1.bias")},
            "attn": {
                "wqkv": stack("h.{}.attn.c_attn.weight"),
                "bqkv": stack("h.{}.attn.c_attn.bias"),
                "wo": stack("h.{}.attn.c_proj.weight"),
                "bo": stack("h.{}.attn.c_proj.bias"),
            },
            "ln2": {"scale": stack("h.{}.ln_2.weight"),
                    "bias": stack("h.{}.ln_2.bias")},
            "mlp": {
                "wi": stack("h.{}.mlp.c_fc.weight"),
                "bi": stack("h.{}.mlp.c_fc.bias"),
                "wo": stack("h.{}.mlp.c_proj.weight"),
                "bo": stack("h.{}.mlp.c_proj.bias"),
            },
        },
        "lnf": {"scale": one("ln_f.weight"), "bias": one("ln_f.bias")},
    }


def params_from_jax(tree: Mapping[str, Any],
                    dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A JAX parameter tree (nested dicts of numpy arrays, e.g. from
    `jax.device_get`) as the same tree of tensors, the dense leaves
    optionally cast to `dtype`; int8 ``{"q", "s"}`` pairs keep their
    types."""
    if set(tree) == {"q", "s"}:  # a quantized leaf (models/quant.py)
        return {"q": to_tensor(tree["q"], None, device),
                "s": to_tensor(tree["s"], None, device)}
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = params_from_jax(value, dtype, device)
        else:
            out[key] = to_tensor(value, dtype, device)
    return out
