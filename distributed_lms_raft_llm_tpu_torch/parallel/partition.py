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
- a dimension that tp (or ep) does not divide is refused, naming the
  leaf, its size, the axis and the ways that would divide it, exactly
  where the JAX `shard_tree`'s `device_put` raises (GPT-2's 50,257-row
  `wte` at any tp above 1, BERT's 30,522-row word table at tp 4, an
  expert stack at an ep that does not divide its experts).

The trainer's state (`train.train.train_state_shardings`) takes the
same specs, with the pipeline's "pp" on a block leaf's layer axis under
pp > 1; `slice_leaf` cuts a rank's slice of any leaf by its spec and
`gather_leaf` puts the whole leaf back together from the ranks' slices
(a checkpoint's unsharded layout).

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
# their expert axis over `ep` (whole on every tp rank of an ep index); the
# router is replicated.
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

# Leaves a rank slices beyond the JAX tables: the bias of a column-parallel
# product that the JAX table leaves whole (XLA slices it to the product's
# columns); a rank here adds only its own columns'.
EXTRA_RULES: Dict[str, List[Tuple[str, Spec]]] = {
    "bert": [(r"blocks/mlp/bi$", (None, "tp"))],
}


def slicing_rules(family: str) -> List[Tuple[str, Spec]]:
    """The rules `shard_params` cuts a family's tree by: the JAX table
    (`RULES_FOR`), after the port's EXTRA_RULES."""
    return EXTRA_RULES.get(family, []) + RULES_FOR[family]


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


def check_split(path: str, axis: int, n: int, n_ways: int,
                name: str = "tp") -> None:
    """Refuse an axis of size `n` that `n_ways` does not divide, naming the
    leaf, the axis and the ways that would (where the JAX `shard_tree`'s
    `device_put` raises)."""
    if n % n_ways:
        raise ValueError(
            f"{path}: axis {axis} of size {n} does not split over "
            f"{name}={n_ways}; {name} ways that divide it: {divisors(n)}")


def _slice(path: str, x: torch.Tensor, axis: int, rank: int,
           n_ways: int, name: str = "tp") -> torch.Tensor:
    """Rank `rank`'s contiguous copy of `x` cut `n_ways` along `axis` (the
    mesh axis `name`); the fused qkv leaves per head within each third."""
    n = x.shape[axis]
    check_split(path, axis, n, n_ways, name)
    if name == "tp" and _FUSED_QKV.search(path):
        if n % (3 * n_ways):
            raise ValueError(
                f"{path}: each q/k/v third of {n // 3} does not split "
                f"over tp={n_ways}; tp ways that divide it: "
                f"{divisors(n // 3)}")
        third, per = n // 3, n // (3 * n_ways)
        parts = [x.narrow(axis, j * third + rank * per, per)
                 for j in range(3)]
        return torch.cat(parts, dim=axis).contiguous()
    per = n // n_ways
    return x.narrow(axis, rank * per, per).contiguous()


def shard_params(params: Any, rules: Rules, rank: int, tp: int,
                 ep_rank: int = 0, ep: int = 1) -> Any:
    """This rank's slice of a parameter tree: each leaf cut along the axis
    its spec names "tp" (this rank's `rank`-th of `tp` slices) and the one
    it names "ep" (its `ep_rank`-th of `ep`: MOE_RULES' expert stacks, so
    the rank holds experts [ep_rank E/ep, (ep_rank+1) E/ep)). Leaves
    without either are kept as they are, shared, not copied; tp = ep = 1
    returns the tree itself."""
    ways = {"tp": (rank, tp), "ep": (ep_rank, ep)}
    if tp == 1 and ep == 1:
        return params
    for name, (r, n) in ways.items():
        if not 0 <= r < n:
            raise ValueError(f"rank {r} outside {name}={n}")

    def cut(path: str, leaf: Any) -> Any:
        spec = _spec_for(rules, path, leaf)
        for name, (r, n) in ways.items():
            if n > 1 and name in spec:
                leaf = _slice(path, leaf, spec.index(name), r, n, name)
        return leaf

    return _map(params, cut)


def slice_leaf(path: str, x: torch.Tensor, spec: Spec,
               coords: Dict[str, int], sizes: Dict[str, int]) -> torch.Tensor:
    """This rank's slice of a whole leaf: cut along each axis its spec
    names (tp, ep, or the trainer's pp on a block's layer axis) that splits
    the mesh, by this rank's coordinate on it; the fused qkv leaves per
    head within each third (`_slice`). A leaf the mesh does not split is
    returned as it is."""
    for axis, name in enumerate(spec):
        if name is not None and sizes.get(name, 1) > 1:
            x = _slice(path, x, axis, coords[name], sizes[name], name)
    return x


def gather_leaf(path: str, x: torch.Tensor, spec: Spec, axes: Dict) -> Any:
    """The whole leaf from every rank's slice (the inverse of
    `slice_leaf`): gathered over each axis its spec names, `axes` the
    rank's `parallel.mesh.ParallelAxis` by name; the fused qkv leaves'
    thirds put back together. A collective over those axes: every rank
    of them calls it."""
    for axis, name in enumerate(spec):
        if name is None or axes[name].size == 1:
            continue
        ax = axes[name]
        parts = torch.chunk(ax.all_gather(x.contiguous(), dim=axis),
                            ax.size, dim=axis)
        if name == "tp" and _FUSED_QKV.search(path):
            thirds = [torch.chunk(p, 3, dim=axis) for p in parts]
            x = torch.cat([t[j] for j in range(3) for t in thirds], dim=axis)
        else:
            x = torch.cat(parts, dim=axis)
    return x
