"""The program inventory: the static manifest of every engine program.

Port of `distributed_lms_raft_llm_tpu/engine/program_inventory.py`. The
serving engines promise that no live request pays for a compile: warmup
runs the whole program set, `utils/guards.compile_count_guard` polices the
promise at runtime, and this module is the contract written down.

What "a compile" is on the card. The port has no jit. A program runs
eagerly (the CPU, and the card's prefills and admissions) or as a
captured CUDA graph (the card's decode and admission chunks), so a TPU
compile's cost has three counterparts here: a graph capture, an nvcc build,
and a kernel wrapper's first launch at a layout (validation, the shared-
memory ceiling, the int8 weights' tensor maps). The guard reads a process
counter for each. A program's "cache" is the set of distinct static keys
it has run at, recorded by host code into its engine's `programs` table
(`utils/guards.ProgramKeys`): the bucket, the width, (bucket, width),
(bucket, suffix bucket), (old width, new width) or (batch, length). The
keys are the JAX package's static arguments, so the domains below are its
domains.

- `INVENTORY` (between the ``inventory:begin/end`` markers) is GENERATED by
  ``python -m distributed_lms_raft_llm_tpu_torch.tools.gen_program_inventory
  --write`` from an AST scan of the engine modules: every
  `functools.partial(...)` program binding of an engine, every module-level
  `_*_program` an engine calls, every `ChunkGraph(...)` capture site, and
  the generation and embedding calls the classification names. An entry's
  `attr` is the program's name in the engine's table (the JAX attribute:
  `_splice_block_program` splices as `_load_block` in sequential admission
  and as `_stage_block` in fused admission, as the JAX package's two
  programs do).
- `expected_counts(engine)` turns the manifest into per-program expected
  key counts for a live engine's domain (`static_paged_domain`, the math
  `PagedEngine.__init__` runs, cross-checked against the live engine).
- `utils/guards.expected_from_inventory(engine)` feeds those counts to
  `compile_count_guard`, which asserts EXACT equality at exit.

One difference from the JAX package, by design: the megastep. JAX compiles
one `_megastep` program per (width, rung >= 2) pair (and rung 1 with fused
admission): `width-k-pairs`. The port's megastep (`_megastep_program`, or
graph replays on the card) runs the width's chunk programs K times, so its
domain is the chunk graphs per width, the decode (or verify) chunk and,
with fused admission, the admission chunk: `len(widths) x (1 + fused)`
keys, `width-graphs`, whenever a megastep can be dispatched (a ladder
above 1, or fused admission, which dispatches every rung as a megastep);
0 otherwise. `static_paged_domain`'s `megastep_pairs` is that number; every
other key equals the JAX package's.

Coverage classes, as in the JAX package: ``warmup`` entries are the paged
serving set plus both engines' bulk-scoring program (`_score`, domain
``score-pairs``, empty when scoring is off). ``on-demand`` entries (the
bucketed `TutoringEngine`'s generation programs, the BERT gate's encoder)
run per live shape by design: they record keys too, but no warmup claim is
made for them. Every program that serving reaches outside warmup's own
loop is warmed over its JAX domain by `PagedEngine.warmup()`: the width
growths, and with the prefix cache the block exports, splices and partial
prefills.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..utils.guards import InventoryMismatchError, ProgramKeys
from .megastep import effective_megastep_max, megastep_ladder  # noqa: F401

GENERATOR = ("python -m "
             "distributed_lms_raft_llm_tpu_torch.tools.gen_program_inventory "
             "--write")


@dataclasses.dataclass(frozen=True)
class ProgramEntry:
    """One program site of an engine class."""

    engine: str    # owning class
    attr: str      # the program's name in the engine's `programs` table
    target: str    # the function, call or capture the site runs
    site: str      # "partial" | "call" | "graph"
    domain: str    # static-key domain, see _DOMAIN_SIZES
    coverage: str  # "warmup" | "on-demand"


# --- inventory:begin --- (generated by tools/gen_program_inventory.py)
INVENTORY: Tuple[ProgramEntry, ...] = (
    ProgramEntry(
        engine="PagedEngine", attr="_export_block", target="_export_block_program",
        site="call", domain="export-buckets", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_grow", target="_grow_state_program",
        site="call", domain="width-pairs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_install", target="_install_program",
        site="call", domain="bucket-width-pairs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_load_block", target="_splice_block_program",
        site="call", domain="load-buckets", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_megastep", target="ChunkGraph(_admission)",
        site="graph", domain="width-graphs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_megastep", target="ChunkGraph(_step)",
        site="graph", domain="width-graphs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_megastep", target="_admission_chunk",
        site="partial", domain="width-graphs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_megastep", target="_megastep_program",
        site="call", domain="width-graphs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_partial_prefill", target="_partial_prefill_program",
        site="partial", domain="bucket-suffix-pairs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_prefill", target="_prefill_program",
        site="partial", domain="buckets", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_score", target="score_program",
        site="partial", domain="score-pairs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_stage", target="_stage_program",
        site="call", domain="stage-pairs", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_stage_block", target="_splice_block_program",
        site="call", domain="stage-widths", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_step", target="_spec_step_program",
        site="partial", domain="widths", coverage="warmup",
    ),
    ProgramEntry(
        engine="PagedEngine", attr="_step", target="_step_program",
        site="partial", domain="widths", coverage="warmup",
    ),
    ProgramEntry(
        engine="RelevanceGate", attr="_embed", target="bert.embed",
        site="call", domain="shapes", coverage="on-demand",
    ),
    ProgramEntry(
        engine="TutoringEngine", attr="_decode", target="decode",
        site="call", domain="shapes", coverage="on-demand",
    ),
    ProgramEntry(
        engine="TutoringEngine", attr="_decode", target="decode_spec",
        site="call", domain="shapes", coverage="on-demand",
    ),
    ProgramEntry(
        engine="TutoringEngine", attr="_prefill", target="prefill",
        site="call", domain="shapes", coverage="on-demand",
    ),
    ProgramEntry(
        engine="TutoringEngine", attr="_score", target="score_program",
        site="partial", domain="score-pairs", coverage="warmup",
    ),
)
# --- inventory:end ---


def entries_for(engine_name: str) -> List[ProgramEntry]:
    return [e for e in INVENTORY if e.engine == engine_name]


def program_table(engine_name: str) -> Dict[str, ProgramKeys]:
    """A fresh key table for one engine: one `ProgramKeys` per program the
    inventory names for its class. An engine records into it by name, so a
    program missing from the manifest fails at its first record."""
    return {attr: ProgramKeys(engine_name, attr)
            for attr in sorted({e.attr for e in entries_for(engine_name)})}


def static_paged_domain(
    max_position_embeddings: int,
    max_new_tokens: int,
    length_buckets: Tuple[int, ...],
    spec_tokens: int,
    megastep_max: int = 0,
    prefix_cache: bool = False,
    prefix_block_tokens: int = 16,
    fused_prefill: bool = False,
    tp: int = 1,
    ep: int = 1,
) -> Dict[str, object]:
    """The paged engine's static-key domain, derived from config the way
    `PagedEngine.__init__` derives it: warmed prompt buckets, cache widths
    and the admissible (bucket, width) pairs, with the JAX package's
    signature and results (see the module docstring for `megastep_pairs`).

    `tp`/`ep` key the domain: one engine, one mesh. Under `fused_prefill`
    the sequential prefill/install/partial/load set is empty, `_stage`
    takes the admissible pairs, `_stage_block` and the block export run
    per width, and `_step` is never dispatched (every rung is a megastep).
    """
    extra = max(0, spec_tokens - 1)
    bucket_cap = min(
        max(length_buckets), max_position_embeddings - max_new_tokens - extra
    )
    buckets = sorted({min(b, bucket_cap) for b in length_buckets})
    nat = {
        t: min(t + max_new_tokens, max_position_embeddings) + extra
        for t in buckets
    }
    widths = sorted(set(nat.values()))
    pairs = sum(
        1 for w in widths for t in buckets if nat[t] <= w
    )
    ladder = megastep_ladder(megastep_max)
    # Shared-prefix programs, none with the cache off. Sequential: export
    # per bucket that holds a block, load and partial prefill where
    # plan_partial can leave at least one whole block of prefix. Fused:
    # export and splice per cache width.
    blk = max(1, prefix_block_tokens)
    any_block_bucket = any(t >= blk for t in buckets)
    partial_pairs = sum(
        1 for t in buckets for s in buckets if s <= t - blk
    ) if prefix_cache and not fused_prefill else 0
    if not prefix_cache:
        export_n = 0
    elif fused_prefill:
        export_n = len(widths) if any_block_bucket else 0
    else:
        export_n = sum(1 for t in buckets if t >= blk)
    load_buckets = sum(
        1 for t in buckets if any(s <= t - blk for s in buckets)
    ) if prefix_cache and not fused_prefill else 0
    megastep = fused_prefill or len(ladder) > 1
    return {
        "mesh": {"tp": max(1, tp), "ep": max(1, ep)},
        "buckets": buckets,
        "widths": widths,
        "prefill_buckets": 0 if fused_prefill else len(buckets),
        "step_widths": 0 if fused_prefill else len(widths),
        "install_pairs": 0 if fused_prefill else pairs,
        "stage_pairs": pairs if fused_prefill else 0,
        "stage_block_widths": (
            len(widths)
            if fused_prefill and prefix_cache and any_block_bucket else 0
        ),
        "grow_pairs": len(widths) * (len(widths) - 1) // 2,
        "k_ladder": ladder,
        # The port's megastep: the chunk graphs per width (module
        # docstring), not JAX's (width, rung) programs.
        "megastep_pairs": (
            len(widths) * (2 if fused_prefill else 1) if megastep else 0),
        "partial_pairs": partial_pairs,
        "export_buckets": export_n,
        "load_buckets": load_buckets,
    }


def static_score_domain(
    length_buckets: Tuple[int, ...],
    batch_buckets: Tuple[int, ...],
    max_position_embeddings: int,
    sp: int = 1,
    dp: int = 1,
    enabled: bool = True,
) -> Dict[str, object]:
    """The score program's domain: every (batch bucket, length bucket)
    shape `score_texts` can run, empty when scoring is off; the JAX
    package's math, which `engine/scoring.derive_score_shapes` mirrors
    (cross-checked in `expected_counts`). With sp > 1 the length buckets
    round up to sp multiples under an sp-floored limit and the batches to
    dp multiples (the engine's dp, `expected_counts`)."""
    if not enabled:
        return {"pairs": [], "score_pairs": 0}
    limit = min(max(length_buckets), max_position_embeddings)
    if sp > 1:
        limit = (limit // sp) * sp
    buckets = set()
    for b in length_buckets:
        t = min(b, limit)
        if sp > 1:
            t = min(((t + sp - 1) // sp) * sp, limit)
        buckets.add(t)
    batches = set()
    for n in batch_buckets:
        if sp > 1:
            n = ((n + dp - 1) // dp) * dp
        batches.add(n)
    pairs = sorted((nb, t) for nb in batches for t in buckets)
    return {"pairs": pairs, "score_pairs": len(pairs)}


_DOMAIN_SIZES = {
    "buckets": lambda d: d["prefill_buckets"],
    "widths": lambda d: d["step_widths"],
    "bucket-width-pairs": lambda d: d["install_pairs"],
    "stage-pairs": lambda d: d["stage_pairs"],
    "stage-widths": lambda d: d["stage_block_widths"],
    "width-pairs": lambda d: d["grow_pairs"],
    "width-graphs": lambda d: d["megastep_pairs"],
    "bucket-suffix-pairs": lambda d: d["partial_pairs"],
    "export-buckets": lambda d: d["export_buckets"],
    "load-buckets": lambda d: d["load_buckets"],
}


def _stale(what: str) -> str:
    return (f"{what} — regenerate engine/program_inventory.py "
            f"({GENERATOR})")


def expected_counts(engine) -> Dict[str, int]:
    """Per-program expected key counts after `engine.warmup()`, for the
    engine's warmup-covered inventory entries.

    Raises InventoryMismatchError when the manifest's domain math and the
    live engine disagree (a stale manifest, or a bucket/width derivation
    that moved without regenerating).
    """
    name = type(engine).__name__
    entries = [e for e in entries_for(name) if e.coverage == "warmup"]
    if not entries:
        raise InventoryMismatchError(
            f"no warmup-covered inventory entries for {name}; "
            "expected_from_inventory only applies to engines whose warmup "
            "runs the full program set (see engine/program_inventory.py)"
        )
    score_entries = [e for e in entries if e.domain == "score-pairs"]
    paged_entries = [e for e in entries if e.domain != "score-pairs"]
    if not paged_entries and not engine.config.scoring:
        # The bucketed engine's only warmup-covered set is the scoring
        # domain; with scoring off its generation programs run per live
        # shape by design: reject loudly, not guard wrongly.
        raise InventoryMismatchError(
            f"{name} has no warmup-covered program set with scoring "
            "disabled (its generation programs run per live shape by "
            "design); enable EngineConfig.scoring to guard the score "
            "domain, or guard a paged engine"
        )
    counts: Dict[str, int] = {}
    for entry in entries:
        if entry.attr not in engine.programs:
            raise InventoryMismatchError(_stale(
                f"inventory names {name}.{entry.attr} but the engine has "
                "no such program (stale manifest)"))
    if paged_entries:
        pc = engine.prefix_cache
        dom = static_paged_domain(
            engine.cfg.max_position_embeddings,
            engine.config.sampling.max_new_tokens,
            tuple(engine.config.length_buckets),
            engine.config.spec_tokens,
            megastep_max=engine.megastep_max,
            prefix_cache=pc is not None,
            prefix_block_tokens=pc.block_tokens if pc is not None else 16,
            fused_prefill=engine.fused,
            tp=engine.config.tp, ep=engine.config.ep,
        )
        live_mesh = {"tp": int(engine.tp), "ep": int(engine.ep)}
        if live_mesh != dom["mesh"]:
            raise InventoryMismatchError(_stale(
                f"inventory mesh key disagrees with the live engine: "
                f"manifest {dom['mesh']} vs engine {live_mesh}: a domain "
                "run under one mesh cannot vouch for another"))
        if list(engine.widths) != dom["widths"]:
            raise InventoryMismatchError(_stale(
                f"inventory domain math disagrees with the live engine: "
                f"manifest widths {dom['widths']} vs engine "
                f"{list(engine.widths)}"))
        if list(engine.megastep_ks) != dom["k_ladder"]:
            raise InventoryMismatchError(_stale(
                f"inventory megastep-ladder math disagrees with the live "
                f"engine: manifest {dom['k_ladder']} vs engine "
                f"{list(engine.megastep_ks)}"))
        for entry in paged_entries:
            size = _DOMAIN_SIZES.get(entry.domain)
            if size is None:
                raise InventoryMismatchError(
                    f"unknown inventory domain {entry.domain!r} for "
                    f"{name}.{entry.attr}")
            counts[entry.attr] = size(dom)
    for entry in score_entries:
        sdom = static_score_domain(
            tuple(engine.config.length_buckets),
            tuple(engine.config.batch_buckets),
            engine.cfg.max_position_embeddings,
            sp=engine.config.sp,
            dp=engine.dp,
            enabled=engine.config.scoring,
        )
        if list(engine.score_shapes) != sdom["pairs"]:
            raise InventoryMismatchError(_stale(
                f"inventory score-domain math disagrees with the live "
                f"engine: manifest {sdom['pairs']} vs engine "
                f"{list(engine.score_shapes)}"))
        counts[entry.attr] = len(sdom["pairs"])
    return counts
