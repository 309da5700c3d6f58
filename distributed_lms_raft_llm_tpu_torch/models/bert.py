"""BERT encoder on plain tensors: the relevance gate's model.

Port of `distributed_lms_raft_llm_tpu/models/bert.py`. Parameters are the
same nested dict as the JAX package's, per-layer weights stacked on a
leading layer axis (`convert.params_from_jax` carries a JAX tree across,
`convert.bert_params_from_hf` maps an HF `BertModel` checkpoint); the
trunk is a Python loop over the layers. BERT differs from GPT-2 in three
places: it is post-LN (the norm follows each residual add), its GELU is
the exact erf form, and its attention is bidirectional under the padding
mask.

The embedding sum and its LayerNorm run in float32 (the tables stay
float32 whatever the compute dtype), then the trunk runs in `cfg.dtype`.
`embed` mean-pools the last hidden state over the mask in float32: the
gate's sentence embedding, independent of how far a row is padded.

The JAX package keeps float32 parameters and casts each product's weight
to the compute dtype inside the product, where XLA fuses the cast. Eager
PyTorch would copy every weight on every forward for that, so
`cast_products` casts the four products' weights and biases once, at load
(`engine/gate.py` does); the numbers are the same.

Under tensor parallelism (``cfg.tensor_parallel``, tp > 1) the parameters
are this rank's slice (`parallel.partition.BERT_RULES`) and the encoder
runs Megatron's split, as GPT-2's does: the fused qkv and the MLP's first
product are column-parallel (this rank's H / tp heads, its M / tp
columns), the attention-out and MLP-out products row-parallel
(`common.row_dense`: summed over the ranks, the bias after the sum), and
the word table is split by vocabulary rows (`quant.embed_lookup`: the
local rows, summed over the ranks), so every rank holds the whole hidden
state between the products.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike
from ..parallel.mesh import TensorParallel, tensor_parallel_of
from .common import (
    attend,
    dense,
    layer_norm,
    layer_params,
    merge_heads,
    row_dense,
    split_heads,
)
from .quant import embed_lookup, is_quantized

Params = Dict[str, Any]

# The four products of a block: (group, weight, bias).
PRODUCTS = (("attn", "wqkv", "bqkv"), ("attn", "wo", "bo"),
            ("mlp", "wi", "bi"), ("mlp", "wo", "bo"))


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32  # compute dtype; bfloat16 serving
    param_dtype: torch.dtype = torch.float32
    # The tp axis the parameters are sharded over (set by the gate); None
    # = one rank.
    tensor_parallel: Optional[TensorParallel] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def local_heads(self) -> int:
        """Attention heads on this tp rank."""
        return self.num_heads // tensor_parallel_of(self).size

    @property
    def mlp_dim(self) -> int:
        return 4 * self.hidden_size

    @classmethod
    def base_uncased(cls, **kw) -> "BertConfig":
        """bert-base-uncased: the published width."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """Test-size config (the JAX package's `tiny`)."""
        kw.setdefault("vocab_size", 384)
        kw.setdefault("max_position_embeddings", 64)
        return cls(hidden_size=32, num_layers=2, num_heads=4, **kw)


def init_params(cfg: BertConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Params:
    """Random init (normal 0.02, unit norms, zero biases), drawn from a
    `torch.Generator` seeded with `seed` on `device`. The draws differ from
    `jax.random`'s; parity tests carry JAX weights across instead."""
    d, n_layers, m = cfg.hidden_size, cfg.num_layers, cfg.mlp_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    pd = cfg.param_dtype

    def norm(shape):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (0.02 * x).to(pd)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=device)

    def ln(shape):
        return {"scale": torch.ones(shape, dtype=pd, device=device),
                "bias": zeros(shape)}

    return {
        "embeddings": {
            "word": norm((cfg.vocab_size, d)),
            "position": norm((cfg.max_position_embeddings, d)),
            "token_type": norm((cfg.type_vocab_size, d)),
            "ln": ln((d,)),
        },
        "blocks": {
            "attn": {
                "wqkv": norm((n_layers, d, 3 * d)),
                "bqkv": zeros((n_layers, 3 * d)),
                "wo": norm((n_layers, d, d)),
                "bo": zeros((n_layers, d)),
            },
            "attn_ln": ln((n_layers, d)),
            "mlp": {
                "wi": norm((n_layers, d, m)),
                "bi": zeros((n_layers, m)),
                "wo": norm((n_layers, m, d)),
                "bo": zeros((n_layers, d)),
            },
            "mlp_ln": ln((n_layers, d)),
        },
    }


def cast_products(params: Params, dtype: torch.dtype) -> Params:
    """The tree with each block product's dense weight and bias in `dtype`
    (an int8 ``{"q", "s"}`` weight kept as it is, its bias cast); the
    embedding tables and the norms keep their dtype. Shares every other
    tensor with `params`."""
    blocks = {name: dict(group) for name, group in params["blocks"].items()}
    for group, w, b in PRODUCTS:
        g = blocks[group]
        if not is_quantized(g[w]):
            g[w] = g[w].to(dtype)
        g[b] = g[b].to(dtype)
    return dict(params, blocks=blocks)


def forward(
    params: Params,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Encode; returns the last hidden state [B, T, D] in `cfg.dtype`.

    attention_mask — [B, T], nonzero where a token is real (right padding
                     is zero); keys at zeros are never attended.
    Positions beyond the table raise (JAX would clamp them).
    """
    b, t = input_ids.shape
    device = input_ids.device
    if t > cfg.max_position_embeddings:
        raise ValueError(f"{t} tokens exceed the position table "
                         f"{cfg.max_position_embeddings}")
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.bool, device=device)
    attention_mask = attention_mask.bool()
    tp = tensor_parallel_of(cfg)
    emb = params["embeddings"]
    x = embed_lookup(emb["word"], input_ids, tp) + emb["position"][:t][None]
    if token_type_ids is None:
        x = x + emb["token_type"][0]
    else:
        x = x + emb["token_type"][token_type_ids]
    x = layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"],
                   cfg.layer_norm_eps).to(cfg.dtype)

    mask = attention_mask[:, None, None, :]  # bidirectional, pads hidden
    eps, heads = cfg.layer_norm_eps, cfg.local_heads
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        qkv = dense(x, lp["attn"]["wqkv"], lp["attn"]["bqkv"])
        q, k, v = qkv.split(heads * cfg.head_dim, dim=-1)
        a = attend(split_heads(q, heads), split_heads(k, heads),
                   split_heads(v, heads), mask)
        a = row_dense(merge_heads(a), lp["attn"]["wo"], lp["attn"]["bo"], tp)
        x = layer_norm(x + a, lp["attn_ln"]["scale"], lp["attn_ln"]["bias"],
                       eps)
        h = dense(x, lp["mlp"]["wi"], lp["mlp"]["bi"])
        h = torch.nn.functional.gelu(h)  # BERT: the exact erf GELU
        h = row_dense(h, lp["mlp"]["wo"], lp["mlp"]["bo"], tp)
        x = layer_norm(x + h, lp["mlp_ln"]["scale"], lp["mlp_ln"]["bias"],
                       eps)
    return x


def embed(
    params: Params,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean-pooled sentence embeddings [B, D] float32 (the gate's op): the
    mask-weighted mean of the last hidden state; a row with no token
    divides by 1."""
    hidden = forward(params, cfg, input_ids, attention_mask,
                     token_type_ids).float()
    if attention_mask is None:
        return hidden.mean(dim=1)
    w = attention_mask.float()
    total = torch.einsum("btd,bt->bd", hidden, w)
    return total / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      dim: int = -1) -> torch.Tensor:
    """Cosine similarity in float32 (the gate compares it with 0.6)."""
    a, b = a.float(), b.float()
    num = (a * b).sum(dim=dim)
    denom = torch.linalg.norm(a, dim=dim) * torch.linalg.norm(b, dim=dim)
    return num / torch.clamp(denom, min=1e-12)
