"""Serving presets the port carries: every preset of the JAX package's
registry. The GPT-2 family (`gpt2`, `gpt2-medium`, `gpt2-large`,
`gpt2-xl`, `tiny`), Llama-3-8B (`llama3-8b`) and `llama-tiny`, and the
GPT-2-MoE family (`gpt2-moe`: GPT-2 small's trunk with 8 experts top-2,
and `moe-tiny`).

Port of `distributed_lms_raft_llm_tpu/models/registry.py`. The engine
drives a family through the same surface as the JAX package's:

    init_params(cfg, seed, device) -> params
    forward(params, cfg, ids, cache=, positions=, kv_mask=) -> (logits, cache)
    init_cache(cfg, batch, max_len, dtype=, device=) -> KVCache
    params_from_hf(state_dict, cfg, device) -> params

BERT (`models/bert.py`) is carried for the relevance gate
(`engine/gate.py`) only: an encoder, not a serving preset, so it has no
entry here.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from . import convert, gpt2, llama, moe


class ModelFamily(NamedTuple):
    name: str  # quantization key ("gpt2" | "llama" | "gpt2_moe")
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

MOE_FAMILY = ModelFamily(
    "gpt2_moe", moe.init_params, moe.forward, moe.init_cache,
    moe.params_from_hf,
)

PRESETS = {
    "gpt2": (GPT2_FAMILY, gpt2.GPT2Config.small),
    "gpt2-medium": (GPT2_FAMILY, gpt2.GPT2Config.medium),
    "gpt2-large": (GPT2_FAMILY, gpt2.GPT2Config.large),
    "gpt2-xl": (GPT2_FAMILY, gpt2.GPT2Config.xl),
    "tiny": (GPT2_FAMILY, gpt2.GPT2Config.tiny),
    "llama3-8b": (LLAMA_FAMILY, llama.LlamaConfig.llama3_8b),
    "llama-tiny": (LLAMA_FAMILY, llama.LlamaConfig.tiny),
    "gpt2-moe": (MOE_FAMILY, moe.GPT2MoEConfig.moe_small),
    "moe-tiny": (MOE_FAMILY, moe.GPT2MoEConfig.tiny),
}


def resolve(preset: str, dtype: torch.dtype,
            param_dtype: Optional[torch.dtype] = None,
            ) -> Tuple[ModelFamily, Any]:
    """Return (family, config) for a preset name."""
    if preset not in PRESETS:
        raise ValueError(
            f"unknown model preset {preset!r}; the port serves "
            f"{sorted(PRESETS)}"
        )
    family, factory = PRESETS[preset]
    return family, factory(dtype=dtype, param_dtype=param_dtype or dtype)
