"""Weights into the port: HF safetensors and JAX parameter trees.

Port of the GPT-2, Llama and BERT parts of
`distributed_lms_raft_llm_tpu/models/convert.py`.

- `load_safetensors` reads a `.safetensors` file with the standard library
  and numpy alone (no `safetensors` package); `save_safetensors` writes
  one (the same bytes as the JAX package's writer for the same arrays in
  the same order), atomically;
- `gpt2_params_from_hf` maps HF GPT-2 names onto the `gpt2.py` tree and
  casts in torch to `cfg.param_dtype` (numpy has no bfloat16);
  `gpt2_params_to_hf` is its inverse (the trainer's export);
- `llama_config_from_hf` and `llama_params_from_hf` do the same for an HF
  `LlamaForCausalLM` (linear weights transposed to [in, out]; a tied
  checkpoint without `lm_head.weight` takes the embedding);
- `bert_config_from_hf` and `bert_params_from_hf` do the same for an HF
  `BertModel` (the relevance gate's encoder; the pooler is not used);
- `params_from_jax` carries a JAX parameter tree, exported to numpy, across
  unchanged in layout: the two packages then hold the same weights. The
  weight-only int8 pairs ``{"q": int8, "s": f32}`` of a quantized tree come
  across as they are, never cast.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike
from .bert import BertConfig
from .gpt2 import GPT2Config
from .llama import LlamaConfig

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


def to_host(x: Any) -> Any:
    """A tensor or array on the host: numpy, or a CPU torch tensor for
    bfloat16 (which numpy lacks)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(x)


def save_safetensors(path: str, tensors: Mapping[str, Any]) -> None:
    """Write a .safetensors file (the inverse of `load_safetensors`), the
    tensors in the mapping's order: numpy arrays or torch tensors, bfloat16
    (torch, or ml_dtypes from JAX) stored as BF16.

    Atomic: the bytes go to `<path>.tmp`, are fsynced, then renamed over
    `path`, so a crash mid-write leaves the previous file whole (the
    trainer overwrites one checkpoint path every cadence, and a resume
    depends on it loading).
    """
    name_for = {
        np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
        np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
        np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
        np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
        np.dtype(np.bool_): "BOOL",
    }
    header: Dict[str, Any] = {}
    blobs = []
    offset = 0
    for name, arr in tensors.items():
        arr = to_host(arr)
        if isinstance(arr, torch.Tensor):  # torch bfloat16
            raw = arr.contiguous().view(torch.int16).numpy().tobytes()
            dtype_name = "BF16"
        elif arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
            raw = arr.view(np.uint16).tobytes()
            dtype_name = "BF16"
        else:
            raw = np.ascontiguousarray(arr).tobytes()
            dtype_name = name_for[arr.dtype]
        header[name] = {
            "dtype": dtype_name,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
        f.flush()
        os.fsync(f.fileno())  # durable before the rename, not just ordered
    os.replace(tmp, path)


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


def gpt2_config_from_hf(hf_config: Mapping[str, Any], **kw) -> GPT2Config:
    """A `GPT2Config` from an HF `config.json` dict (`kw`: dtypes)."""
    return GPT2Config(
        vocab_size=hf_config["vocab_size"],
        max_position_embeddings=hf_config.get("n_positions", 1024),
        hidden_size=hf_config["n_embd"],
        num_layers=hf_config["n_layer"],
        num_heads=hf_config["n_head"],
        layer_norm_eps=hf_config.get("layer_norm_epsilon", 1e-5),
        **kw,
    )


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


def gpt2_params_to_hf(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of `gpt2_params_from_hf`: the layer axis unstacked back into
    HF GPT2Model names (no `transformer.` prefix, which both loaders
    accept), in the JAX package's order, so a fine-tuned model serves
    through the standard checkpoint path. Takes torch tensors or numpy
    arrays; returns numpy arrays (CPU torch tensors for bfloat16)."""
    blocks = params["blocks"]
    n_layers = blocks["ln1"]["scale"].shape[0]
    out: Dict[str, Any] = {
        "wte.weight": to_host(params["wte"]),
        "wpe.weight": to_host(params["wpe"]),
        "ln_f.weight": to_host(params["lnf"]["scale"]),
        "ln_f.bias": to_host(params["lnf"]["bias"]),
    }
    per_layer = {
        "h.{}.ln_1.weight": blocks["ln1"]["scale"],
        "h.{}.ln_1.bias": blocks["ln1"]["bias"],
        "h.{}.attn.c_attn.weight": blocks["attn"]["wqkv"],
        "h.{}.attn.c_attn.bias": blocks["attn"]["bqkv"],
        "h.{}.attn.c_proj.weight": blocks["attn"]["wo"],
        "h.{}.attn.c_proj.bias": blocks["attn"]["bo"],
        "h.{}.ln_2.weight": blocks["ln2"]["scale"],
        "h.{}.ln_2.bias": blocks["ln2"]["bias"],
        "h.{}.mlp.c_fc.weight": blocks["mlp"]["wi"],
        "h.{}.mlp.c_fc.bias": blocks["mlp"]["bi"],
        "h.{}.mlp.c_proj.weight": blocks["mlp"]["wo"],
        "h.{}.mlp.c_proj.bias": blocks["mlp"]["bo"],
    }
    for fmt, stacked in per_layer.items():
        arr = to_host(stacked)
        for i in range(n_layers):
            out[fmt.format(i)] = arr[i]
    return out


def llama_config_from_hf(hf_config: Mapping[str, Any], **kw) -> LlamaConfig:
    """A `LlamaConfig` from an HF `config.json` dict (`kw`: dtypes)."""
    return LlamaConfig(
        vocab_size=hf_config["vocab_size"],
        max_position_embeddings=hf_config.get("max_position_embeddings",
                                              8192),
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        num_kv_heads=hf_config.get("num_key_value_heads",
                                   hf_config["num_attention_heads"]),
        intermediate_size=hf_config["intermediate_size"],
        rope_theta=hf_config.get("rope_theta", 10000.0),
        rms_norm_eps=hf_config.get("rms_norm_eps", 1e-5),
        **kw,
    )


def llama_params_from_hf(sd: Mapping[str, Any], cfg: LlamaConfig,
                         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Map HF LlamaForCausalLM weights onto the llama.py tree."""
    sd = _strip_prefix(sd, "model.")
    n_layers = cfg.num_layers
    pd = cfg.param_dtype

    def one(name: str) -> torch.Tensor:
        return to_tensor(sd[name], pd, device)

    def lin_w(fmt: str) -> torch.Tensor:
        # torch Linear stores [out, in]; dense takes [in, out].
        return torch.stack([one(fmt.format(i)).t() for i in range(n_layers)])

    def vec(fmt: str) -> torch.Tensor:
        return torch.stack([one(fmt.format(i)) for i in range(n_layers)])

    embed = one("embed_tokens.weight")
    # A tie_word_embeddings checkpoint ships no lm_head tensor.
    lm_head = one("lm_head.weight") if "lm_head.weight" in sd else embed
    p = "layers.{}."
    return {
        "embed": embed,
        "blocks": {
            "ln1": {"scale": vec(p + "input_layernorm.weight")},
            "attn": {
                "wq": lin_w(p + "self_attn.q_proj.weight"),
                "wk": lin_w(p + "self_attn.k_proj.weight"),
                "wv": lin_w(p + "self_attn.v_proj.weight"),
                "wo": lin_w(p + "self_attn.o_proj.weight"),
            },
            "ln2": {"scale": vec(p + "post_attention_layernorm.weight")},
            "mlp": {
                "wg": lin_w(p + "mlp.gate_proj.weight"),
                "wu": lin_w(p + "mlp.up_proj.weight"),
                "wd": lin_w(p + "mlp.down_proj.weight"),
            },
        },
        "lnf": {"scale": one("norm.weight")},
        "lm_head": lm_head,
    }


def bert_config_from_hf(hf_config: Mapping[str, Any], **kw) -> BertConfig:
    """A `BertConfig` from an HF `config.json` dict (`kw`: dtypes)."""
    return BertConfig(
        vocab_size=hf_config["vocab_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        type_vocab_size=hf_config.get("type_vocab_size", 2),
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        layer_norm_eps=hf_config.get("layer_norm_eps", 1e-12),
        **kw,
    )


def bert_params_from_hf(sd: Mapping[str, Any], cfg: BertConfig,
                        device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Map HF BertModel weights onto the bert.py tree (pooler ignored)."""
    sd = _strip_prefix(sd, "bert.")
    n_layers = cfg.num_layers
    pd = cfg.param_dtype

    def one(name: str) -> torch.Tensor:
        return to_tensor(sd[name], pd, device)

    def lin_w(fmt: str) -> torch.Tensor:
        # torch Linear stores [out, in]; dense takes [in, out].
        return torch.stack([one(fmt.format(i)).t() for i in range(n_layers)])

    def vec(fmt: str) -> torch.Tensor:
        return torch.stack([one(fmt.format(i)) for i in range(n_layers)])

    layer = "encoder.layer.{}."
    p = layer + "attention.self."
    wq, wk, wv = (lin_w(p + n + ".weight") for n in ("query", "key", "value"))
    bq, bk, bv = (vec(p + n + ".bias") for n in ("query", "key", "value"))
    out = layer + "attention.output."
    return {
        "embeddings": {
            "word": one("embeddings.word_embeddings.weight"),
            "position": one("embeddings.position_embeddings.weight"),
            "token_type": one("embeddings.token_type_embeddings.weight"),
            "ln": {"scale": one("embeddings.LayerNorm.weight"),
                   "bias": one("embeddings.LayerNorm.bias")},
        },
        "blocks": {
            "attn": {
                "wqkv": torch.cat([wq, wk, wv], dim=-1),
                "bqkv": torch.cat([bq, bk, bv], dim=-1),
                "wo": lin_w(out + "dense.weight"),
                "bo": vec(out + "dense.bias"),
            },
            "attn_ln": {"scale": vec(out + "LayerNorm.weight"),
                        "bias": vec(out + "LayerNorm.bias")},
            "mlp": {
                "wi": lin_w(layer + "intermediate.dense.weight"),
                "bi": vec(layer + "intermediate.dense.bias"),
                "wo": lin_w(layer + "output.dense.weight"),
                "bo": vec(layer + "output.dense.bias"),
            },
            "mlp_ln": {"scale": vec(layer + "output.LayerNorm.weight"),
                       "bias": vec(layer + "output.LayerNorm.bias")},
        },
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
