"""Partition rules: tree-path regex -> partition spec, and each rank's slice.

Port of `distributed_lms_raft_llm_tpu/parallel/partition.py`. The rule
tables are the JAX package's, copied (the port imports nothing of it): a
spec is a tuple of mesh axis names or None, one entry a leading array axis,
trailing Nones dropped, as the JAX spelling drops them (`P(None, "tp")` is
`(None, "tp")`, `P()` is `()`).

Megatron-style tp on the stacked-layer layout (per-layer leaves carry a
leading layer axis L, linears are [in, out]): column-parallel QKV and
FFN-in shard their out axis, row-parallel attention-out and FFN-out their in
axis; the vocabulary tables shard their rows. In JAX these specs are a
storage layout and XLA inserts the collectives; here `shard_params` cuts
each rank's slice and the models call the collectives
(`parallel/mesh.TensorParallel`).

What the slice adds to the JAX spec:

- the fused GPT-2/BERT `wqkv` [L, D, 3D] (and `bqkv`, and the int8 pair's
  `q` and `s`): JAX's `P(None, None, "tp")` cuts the 3D axis into
  contiguous blocks and XLA repairs the q/k/v split. A rank here must hold
  the q, k and v of its own heads, so each third is sliced by heads and the
  three slices concatenated;
- a dimension that tp does not divide is refused, naming the leaf, its
  size, tp and the tp ways that would divide it, exactly where the JAX
  `shard_tree`'s `device_put` raises (GPT-2's 50,257-row `wte` at any tp
  above 1, BERT's 30,522-row word table at tp 4).

Weight-only int8 pairs (`models/quant.py`) shard as the rules say: `q` like
the dense leaf; the per-column `s` of a column-parallel leaf like its
columns; the `s` of a row-parallel leaf whole (a per-column scale commutes
with the sum over ranks); an embedding's per-row `s` with its rows.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import divisors

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]

# GPT-2 family (stacked blocks; layer axis first, replicated).
GPT2_RULES: List[Tuple[str, Spec]] = [
    (r"wte(/q)?$", ("tp",)),       # vocab-sharded embedding
    (r"wte/s$", ("tp",)),
    (r"wpe$", ()),
    (r"blocks/attn/wqkv(/q)?$", (None, None, "tp")),   # column parallel
    (r"blocks/attn/wqkv/s$", (None, "tp")),
    (r"blocks/attn/bqkv$", (None, "tp")),
    (r"blocks/attn/wo(/q)?$", (None, "tp")),     # row parallel
    (r"blocks/attn/wo/s$", ()),
    (r"blocks/attn/bo$", ()),
    (r"blocks/mlp/wi(/q)?$", (None, None, "tp")),
    (r"blocks/mlp/wi/s$", (None, "tp")),
    (r"blocks/mlp/bi$", (None, "tp")),
    (r"blocks/mlp/wo(/q)?$", (None, "tp")),
    (r"blocks/mlp/wo/s$", ()),
    (r"blocks/mlp/bo$", ()),
    (r"ln|lnf", ()),                    # norms replicated
    (r".*", ()),
]

# Llama family: q/k/v/gate/up column-parallel, o/down row-parallel; untied
# vocab-sharded embed + lm_head.
LLAMA_RULES: List[Tuple[str, Spec]] = [
    (r"embed(/q)?$", ("tp",)),
    (r"embed/s$", ("tp",)),
    (r"lm_head(/q)?$", ("tp",)),
    (r"lm_head/s$", ("tp",)),
    (r"blocks/attn/w[qkv](/q)?$", (None, None, "tp")),
    (r"blocks/attn/w[qkv]/s$", (None, "tp")),
    (r"blocks/attn/wo(/q)?$", (None, "tp")),
    (r"blocks/attn/wo/s$", ()),
    (r"blocks/mlp/w[gu](/q)?$", (None, None, "tp")),
    (r"blocks/mlp/w[gu]/s$", (None, "tp")),
    (r"blocks/mlp/wd(/q)?$", (None, "tp")),
    (r"blocks/mlp/wd/s$", ()),
    (r"ln|lnf", ()),
    (r".*", ()),
]

BERT_RULES: List[Tuple[str, Spec]] = [
    (r"embeddings/word(/q)?$", ("tp",)),
    (r"embeddings/word/s$", ("tp",)),
    (r"embeddings/(position|token_type)$", ()),
    (r"blocks/attn/wqkv(/q)?$", (None, None, "tp")),
    (r"blocks/attn/wqkv/s$", (None, "tp")),
    (r"blocks/attn/bqkv$", (None, "tp")),
    (r"blocks/attn/wo(/q)?$", (None, "tp")),
    (r"blocks/attn/wo/s$", ()),
    (r"blocks/mlp/wi(/q)?$", (None, None, "tp")),
    (r"blocks/mlp/wi/s$", (None, "tp")),
    (r"blocks/mlp/wo(/q)?$", (None, "tp")),
    (r"blocks/mlp/wo/s$", ()),
    (r".*", ()),
]

# GPT-2-MoE: the dense trunk shards like GPT-2; the expert stacks shard
# their expert axis over `ep` (not ported: at ep = 1 they stay whole on
# every rank); the router is replicated.
MOE_RULES: List[Tuple[str, Spec]] = [
    (r"blocks/moe/wr$", ()),
    (r"blocks/moe/w[io](/q)?$", (None, "ep")),
    (r"blocks/moe/w[io]/s$", (None, "ep")),
    (r"blocks/moe/b[io]$", (None, "ep")),
] + GPT2_RULES

# Rule set per model-family name (models/registry.py ModelFamily.name).
RULES_FOR = {
    "gpt2": GPT2_RULES,
    "llama": LLAMA_RULES,
    "bert": BERT_RULES,
    "gpt2_moe": MOE_RULES,
}

# The paged engine's per-plane sharding policy, keyed by plane name (the
# JAX package's table). KV planes shard their heads axis (axis 2 of
# [L, S, Hkv, T, Dh] and of the int8 scales [L, S, Hkv, T]) over tp; host
# planes are replicated. In the port each rank's engine allocates its KV
# planes at Hkv / tp heads, so the table documents the layout the cache
# shapes already have.
PAGED_PLANE_SPECS: Dict[str, Spec] = {
    "cache.k": (None, None, "tp"),
    "cache.v": (None, None, "tp"),
    "cache.ks": (None, None, "tp"),
    "cache.vs": (None, None, "tp"),
    "cache.length": (),
    "k": (None, None, "tp"),
    "v": (None, None, "tp"),
    "ks": (None, None, "tp"),
    "vs": (None, None, "tp"),
    "length": (),
    "tok": (),
    "active": (),
    "seen": (),
    "transcript": (),
    "staged": (),
    "stage_cursor": (),
    "stage_len": (),
    "stage_seq": (),
    "stage_rng": (),
}

# Leaves whose tp axis holds [q | k | v] thirds, sliced per head.
_FUSED_QKV = re.compile(r"(^|/)[wb]qkv(/[qs])?$")


def supported_tp(num_kv_heads: int) -> List[int]:
    """The tp ways that shard `num_kv_heads` KV heads evenly: the
    ascending divisors. The paged plane table splits the heads axis
    across tp shards, so any other way would leave ragged head shards
    (gpt2-large's 20 heads admit [1, 2, 4, 5, 10, 20] — not 8)."""
    return [d for d in range(1, num_kv_heads + 1) if num_kv_heads % d == 0]


def validate_tp_heads(num_kv_heads: int, tp: int, model: str) -> None:
    """Reject a tp that does not divide the KV head count — loudly, with
    the exact supported divisors, instead of padding heads (a padded
    head's KV would cost real HBM and attention bandwidth on every
    shard, the resource tp exists to split)."""
    if tp > 1 and num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide {model!r}'s {num_kv_heads} KV "
            f"heads; the paged KV planes shard the heads axis evenly — "
            f"supported tp ways for this model: "
            f"{supported_tp(num_kv_heads)}"
        )


def _map(tree: Any, fn, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def _spec_for(rules: Rules, path: str, leaf: Any) -> Spec:
    if getattr(leaf, "ndim", 0) == 0:
        return ()
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    raise ValueError(f"no partition rule matched {path!r}")


def match_partition_rules(rules: Rules, tree: Any) -> Any:
    """A tree of specs matching `tree`'s structure (nested dicts)."""
    return _map(tree, lambda path, leaf: _spec_for(rules, path, leaf))


def _slice(path: str, x: torch.Tensor, axis: int, rank: int,
           tp: int) -> torch.Tensor:
    """Rank `rank`'s contiguous copy of `x` cut along `axis`; the fused
    qkv leaves per head within each third."""
    n = x.shape[axis]
    if n % tp:
        raise ValueError(
            f"{path}: axis {axis} of size {n} does not split over tp={tp}; "
            f"tp ways that divide it: {divisors(n)}")
    if _FUSED_QKV.search(path):
        if n % (3 * tp):
            raise ValueError(
                f"{path}: each q/k/v third of {n // 3} does not split "
                f"over tp={tp}; tp ways that divide it: {divisors(n // 3)}")
        third, per = n // 3, n // (3 * tp)
        parts = [x.narrow(axis, j * third + rank * per, per)
                 for j in range(3)]
        return torch.cat(parts, dim=axis).contiguous()
    per = n // tp
    return x.narrow(axis, rank * per, per).contiguous()


def shard_params(params: Any, rules: Rules, rank: int, tp: int) -> Any:
    """This rank's slice of a parameter tree: each leaf cut along the axis
    its spec names "tp" (leaves without one are kept as they are, shared,
    not copied). tp = 1 returns the tree itself."""
    if tp == 1:
        return params
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")

    def cut(path: str, leaf: Any) -> Any:
        spec = _spec_for(rules, path, leaf)
        if "tp" not in spec:
            return leaf
        return _slice(path, leaf, spec.index("tp"), rank, tp)

    return _map(params, cut)
