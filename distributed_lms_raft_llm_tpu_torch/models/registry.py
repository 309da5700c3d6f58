"""Serving presets the port carries: GPT-2 small (`gpt2`) and `tiny`, and
Llama-3-8B (`llama3-8b`) and `llama-tiny`.

Port of `distributed_lms_raft_llm_tpu/models/registry.py`. The engine
drives a family through the same surface as the JAX package's:

    init_params(cfg, seed, device) -> params
    forward(params, cfg, ids, cache=, positions=, kv_mask=) -> (logits, cache)
    init_cache(cfg, batch, max_len, dtype=, device=) -> KVCache
    params_from_hf(state_dict, cfg, device) -> params

Other presets of the JAX package (the larger GPT-2s and the MoE models) are
refused until a later slice ports them. BERT (`models/bert.py`) is carried for
the relevance gate (`engine/gate.py`) only: an encoder, not a serving
preset, so it has no entry here.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from . import convert, gpt2, llama


class ModelFamily(NamedTuple):
    name: str  # quantization key ("gpt2" | "llama")
    init_params: Callable
    forward: Callable
    init_cache: Callable
    params_from_hf: Callable


GPT2_FAMILY = ModelFamily(
    "gpt2", gpt2.init_params, gpt2.forward, gpt2.init_cache,
    convert.gpt2_params_from_hf,
)

LLAMA_FAMILY = ModelFamily(
    "llama", llama.init_params, llama.forward, llama.init_cache,
    convert.llama_params_from_hf,
)

PRESETS = {
    "gpt2": (GPT2_FAMILY, gpt2.GPT2Config.small),
    "tiny": (GPT2_FAMILY, gpt2.GPT2Config.tiny),
    "llama3-8b": (LLAMA_FAMILY, llama.LlamaConfig.llama3_8b),
    "llama-tiny": (LLAMA_FAMILY, llama.LlamaConfig.tiny),
}


def resolve(preset: str, dtype: torch.dtype,
            param_dtype: Optional[torch.dtype] = None,
            ) -> Tuple[ModelFamily, Any]:
    """Return (family, config) for a preset name."""
    if preset not in PRESETS:
        raise ValueError(
            f"model preset {preset!r} is not ported to PyTorch yet; the "
            f"port serves {sorted(PRESETS)}"
        )
    family, factory = PRESETS[preset]
    return family, factory(dtype=dtype, param_dtype=param_dtype or dtype)
