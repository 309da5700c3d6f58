"""Weight-only int8 quantization, on tensors.

Port of `distributed_lms_raft_llm_tpu/models/quant.py` (the GPT-2,
GPT-2-MoE, Llama and BERT leaves). A quantized linear is the dict
``{"q": int8 [..., in, out], "s": f32 [..., out]}`` in place of the dense
tensor; an embedding table is
``{"q": int8 [V, D], "s": f32 [V]}`` (per-row scales, so the tied
unembedding, or Llama's untied `lm_head`, scales per vocab row). `common.dense`, `embed_lookup` and
`unembed` take either form.

The quantizers keep the JAX package's op order (``s = max|w| / 127``,
``max(s, 1e-8)``, ``round(w / s)`` by division, clip to +-127), and
`torch.round` rounds half to even as `jnp.round` does, so ``q`` is
bit-equal to the JAX package's for the same input.

On the card the int8 products run through the hand-written kernel of
`ops/quant_matmul.py`, which reads the int8 weights directly.

Under tensor parallelism (`tp`, a `parallel.mesh.TensorParallel`) a table
holds this rank's contiguous block of vocabulary rows (and their per-row
scales): `embed_lookup` looks up the ids inside the block, zeroes the
others and sums over the ranks; `unembed` computes this block's logits and
gathers the blocks to the whole vocabulary, in rank order.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops import quant_matmul
from ..parallel.mesh import SINGLE, TensorParallel

Params = Dict[str, Any]

# The leaves quantized per family: the big streamed matmul weights. Norms,
# biases and the position table stay full precision.
_QUANT_LEAVES = {
    "gpt2": {
        ("wte",),
        ("blocks", "attn", "wqkv"),
        ("blocks", "attn", "wo"),
        ("blocks", "mlp", "wi"),
        ("blocks", "mlp", "wo"),
    },
    "llama": {
        ("embed",),
        ("lm_head",),
        ("blocks", "attn", "wq"),
        ("blocks", "attn", "wk"),
        ("blocks", "attn", "wv"),
        ("blocks", "attn", "wo"),
        ("blocks", "mlp", "wg"),
        ("blocks", "mlp", "wu"),
        ("blocks", "mlp", "wd"),
    },
    # The GPT-2 trunk's leaves and the expert stacks: wi [L, E, D, M] and
    # wo [L, E, M, D] get scales [L, E, M] / [L, E, D], per expert and
    # output column. The router stays dense (tiny, and softmax-sensitive).
    "gpt2_moe": {
        ("wte",),
        ("blocks", "attn", "wqkv"),
        ("blocks", "attn", "wo"),
        ("blocks", "moe", "wi"),
        ("blocks", "moe", "wo"),
    },
    "bert": {
        ("embeddings", "word"),
        ("blocks", "attn", "wqkv"),
        ("blocks", "attn", "wo"),
        ("blocks", "mlp", "wi"),
        ("blocks", "mlp", "wo"),
    },
}
# Tables looked up by row: per-row scales.
_EMBEDDING_LEAVES = {("wte",), ("embeddings", "word"), ("embed",),
                     ("lm_head",)}


def _quantize(w: torch.Tensor, dim: int) -> Dict[str, torch.Tensor]:
    """`dim` counts from the end. A stacked [L, ...] leaf is quantized
    layer by layer (the same values: each scale spans one layer), so only
    one layer is ever held in float32 (Llama-3-8B's [32, 4096, 14336]
    leaves would need 7.5 GB each at once); an expert stack [L, E, ...]
    expert by expert within each layer."""
    if w.dim() > 2:
        parts = [_quantize(layer, dim) for layer in w]
        return {"q": torch.stack([p["q"] for p in parts]),
                "s": torch.stack([p["s"] for p in parts])}
    w = w.float()
    s = w.abs().amax(dim=dim, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.squeeze(dim).float()}


def quantize_array(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 of an [..., in, out] linear: one
    scale per out column (the max over `in`)."""
    return _quantize(w, -2)


def quantize_embedding(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """An embedding table [V, D]: one scale per row (per token)."""
    return _quantize(w, -1)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_params(params: Params, family: str) -> Params:
    """Quantize the configured leaves of a family's parameter tree; the
    other leaves are carried over as they are."""
    if family not in _QUANT_LEAVES:
        raise ValueError(
            f"int8 quantization of the {family!r} family is not ported; the "
            f"port quantizes {sorted(_QUANT_LEAVES)}"
        )
    leaves = _QUANT_LEAVES[family]

    def walk(tree, path=()):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for key, value in tree.items():
            p = path + (key,)
            if p in leaves:
                out[key] = (quantize_embedding(value) if p in _EMBEDDING_LEAVES
                            else quantize_array(value))
            else:
                out[key] = walk(value, p)
        return out

    return walk(params)


def _lookup(table: Any, ids: torch.Tensor) -> torch.Tensor:
    if is_quantized(table):
        return table["q"][ids].float() * table["s"][ids][..., None]
    return table[ids]


def embed_lookup(table: Any, ids: torch.Tensor,
                 tp: TensorParallel = SINGLE) -> torch.Tensor:
    """Row lookup of a dense [V, D] table (in its dtype) or of a quantized
    one (dequantized to float32, as in the JAX package). Vocab-parallel
    under tp: the rows of this rank's block, zeros for the other ids,
    summed over the ranks (each id's row comes from one rank, so the sum
    is exact)."""
    if tp.size == 1:
        return _lookup(table, ids)
    rows = (table["q"] if is_quantized(table) else table).shape[0]
    local = ids - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    out = _lookup(table, torch.where(inside, local, torch.zeros_like(local)))
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    return tp.all_reduce(out)


def unembed(x: torch.Tensor, table: Any,
            tp: TensorParallel = SINGLE) -> torch.Tensor:
    """Tied unembedding: x [B, T, D] @ table [V, D]^T -> float32 logits.

    Dense: the product in float32 from the compute-dtype activations (the
    JAX package's `preferred_element_type=float32` einsum). Quantized:
    `quant_matmul.int8_matmul` with the table as transposed weight, the
    per-row scale applied to the float32 sums. Under tp: this rank's
    vocabulary block, then every rank's blocks gathered to [B, T, V]
    (`x` through the "copy" pair, the blocks through the "gather": the
    loss downstream is replicated on every rank).
    """
    x = tp.copy(x)
    if is_quantized(table):
        logits = quant_matmul.int8_matmul(x, table["q"], table["s"],
                                          transposed=True)
    else:
        logits = torch.matmul(x.float(), table.float().t())
    return tp.all_gather(logits, dim=-1)
