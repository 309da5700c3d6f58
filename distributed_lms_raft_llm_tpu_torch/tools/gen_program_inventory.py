"""Generate the port's program inventory and its README table.

Two artifacts from one source of truth (an AST scan of the engine modules
and `engine/program_inventory.static_paged_domain`):

- the `INVENTORY` block of `engine/program_inventory.py` (between the
  ``inventory:begin/end`` markers): every program site of an engine class
  with its domain and coverage class;
- the README block between ``<!-- torch-program-inventory:begin -->`` and
  ``<!-- torch-program-inventory:end -->``: the entry table and the
  derived domain for `config.py`'s defaults and every `configs/*.toml`,
  read through `config.engine_config`.

    python -m distributed_lms_raft_llm_tpu_torch.tools.gen_program_inventory
    ... --check    # exit 1 on drift
    ... --write    # rewrite both blocks in place

The scan (pure AST, no imports of the scanned code) finds in each engine
class: every `self.X = functools.partial(F, ...)` binding, every call of a
module-level `_*_program` function of the same module, every
`ChunkGraph(lambda: self.X(...))` capture, and every call the
classification below names (the bucketed engine's generation, the gate's
encoder). What a site's domain IS, and whether warmup covers it, is a
design fact recorded here; a new site lands as ("shapes", "on-demand").
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from .blocks import README, REPO, sync

PACKAGE = REPO / "distributed_lms_raft_llm_tpu_torch"
ENGINE_MODULES = tuple(PACKAGE / "engine" / name
                       for name in ("paged.py", "engine.py", "gate.py"))
MANIFEST = PACKAGE / "engine" / "program_inventory.py"
COMMAND = ("python -m "
           "distributed_lms_raft_llm_tpu_torch.tools.gen_program_inventory")
INV_BEGIN = ("# --- inventory:begin --- "
             "(generated by tools/gen_program_inventory.py)")
INV_END = "# --- inventory:end ---"
MD_BEGIN = "<!-- torch-program-inventory:begin -->"
MD_END = "<!-- torch-program-inventory:end -->"

_W = "warmup"
# (engine class, site) -> [(program name, domain, coverage)]. A site is a
# partial binding's attribute, a called function or "ChunkGraph(attr)".
CLASSIFICATION: Dict[Tuple[str, str], List[Tuple[str, str, str]]] = {
    ("PagedEngine", "_prefill"): [("_prefill", "buckets", _W)],
    ("PagedEngine", "_partial_prefill"): [
        ("_partial_prefill", "bucket-suffix-pairs", _W)],
    ("PagedEngine", "_step"): [("_step", "widths", _W)],
    ("PagedEngine", "_install_program"): [
        ("_install", "bucket-width-pairs", _W)],
    ("PagedEngine", "_grow_state_program"): [("_grow", "width-pairs", _W)],
    # Shared-prefix cache: empty domains with the cache off. One splice
    # function serves JAX's two programs: sequential admission loads a
    # block into the slot's prompt pages, fused admission stages it.
    ("PagedEngine", "_export_block_program"): [
        ("_export_block", "export-buckets", _W)],
    ("PagedEngine", "_splice_block_program"): [
        ("_load_block", "load-buckets", _W),
        ("_stage_block", "stage-widths", _W)],
    # Fused staged admission: empty domain in sequential mode.
    ("PagedEngine", "_stage_program"): [("_stage", "stage-pairs", _W)],
    # The megastep: the host loop (eager) or the replays of the width's
    # two chunk graphs (the card); keyed by (width, graph kind).
    ("PagedEngine", "_megastep_program"): [
        ("_megastep", "width-graphs", _W)],
    ("PagedEngine", "_admission"): [("_megastep", "width-graphs", _W)],
    ("PagedEngine", "ChunkGraph(_step)"): [
        ("_megastep", "width-graphs", _W)],
    ("PagedEngine", "ChunkGraph(_admission)"): [
        ("_megastep", "width-graphs", _W)],
    # The scoring tenant: empty domain with scoring off, both engines.
    ("PagedEngine", "_score"): [("_score", "score-pairs", _W)],
    ("TutoringEngine", "_score"): [("_score", "score-pairs", _W)],
    # Run per live shape by design.
    ("TutoringEngine", "prefill"): [("_prefill", "shapes", "on-demand")],
    ("TutoringEngine", "decode"): [("_decode", "shapes", "on-demand")],
    ("TutoringEngine", "decode_spec"): [("_decode", "shapes", "on-demand")],
    ("RelevanceGate", "bert.embed"): [("_embed", "shapes", "on-demand")],
}
DEFAULT_CLASS = [("shapes", "on-demand")]
_PROGRAM_FN = re.compile(r"^_\w+_program$")


@dataclasses.dataclass(frozen=True)
class Site:
    engine: str
    name: str    # the classification key's second half
    target: str  # the function the site runs
    kind: str    # "partial" | "call" | "graph"


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        inner = _dotted(node.value)
        return f"{inner}.{node.attr}" if inner else ""
    return ""


def _is_partial(call: ast.Call) -> bool:
    return _dotted(call.func) in ("functools.partial", "partial")


def _graph_attr(call: ast.Call) -> str:
    """`ChunkGraph(lambda: self.X(...), ...)` -> "X", else ""."""
    if not call.args or not isinstance(call.args[0], ast.Lambda):
        return ""
    body = call.args[0].body
    if isinstance(body, ast.Call):
        name = _dotted(body.func)
        if name.startswith("self."):
            return name[len("self."):]
    return ""


def scan_module(path: Path) -> List[Site]:
    tree = ast.parse(path.read_text(), filename=str(path))
    module_fns = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    sites: List[Site] = []
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        named = {name for (owner, name) in CLASSIFICATION
                 if owner == cls.name}
        for node in ast.walk(cls):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.value, ast.Call)
                    and _is_partial(node.value) and node.value.args):
                attr = _dotted(node.targets[0])
                target = _dotted(node.value.args[0])
                if attr.startswith("self.") and target:
                    sites.append(Site(cls.name, attr[len("self."):], target,
                                      "partial"))
            elif isinstance(node, ast.Call):
                callee = _dotted(node.func)
                if callee == "ChunkGraph":
                    attr = _graph_attr(node)
                    sites.append(Site(cls.name, f"ChunkGraph({attr})",
                                      f"ChunkGraph({attr})", "graph"))
                elif (callee in named and not callee.startswith("self.")
                      or callee in module_fns and _PROGRAM_FN.match(callee)):
                    sites.append(Site(cls.name, callee, callee, "call"))
    return sites


def scanned_sites() -> List[Site]:
    return sorted({s for path in ENGINE_MODULES for s in scan_module(path)},
                  key=lambda s: (s.engine, s.name, s.target))


def scanned_entries() -> List[dict]:
    entries = {}
    for site in scanned_sites():
        classes = CLASSIFICATION.get((site.engine, site.name))
        if classes is None:
            classes = [(site.name,) + DEFAULT_CLASS[0]]
        for attr, domain, coverage in classes:
            e = dict(engine=site.engine, attr=attr, target=site.target,
                     site=site.kind, domain=domain, coverage=coverage)
            entries[(site.engine, attr, site.target)] = e
    return [entries[k] for k in sorted(entries)]


def render_inventory_block(entries: List[dict]) -> str:
    lines = [INV_BEGIN, "INVENTORY: Tuple[ProgramEntry, ...] = ("]
    for e in entries:
        lines += [
            "    ProgramEntry(",
            f"        engine=\"{e['engine']}\", attr=\"{e['attr']}\", "
            f"target=\"{e['target']}\",",
            f"        site=\"{e['site']}\", domain=\"{e['domain']}\", "
            f"coverage=\"{e['coverage']}\",",
            "    ),",
        ]
    lines += [")", INV_END]
    return "\n".join(lines)


def shipped_domains() -> List[Dict[str, object]]:
    """The paged domain for config.py's defaults and each configs/*.toml,
    through the port's `config.engine_config`."""
    from ..config import AppConfig, engine_config, load_config
    from ..engine.program_inventory import (
        effective_megastep_max,
        static_paged_domain,
        static_score_domain,
    )
    from ..models import registry

    named = [("defaults", AppConfig())]
    for path in sorted((REPO / "configs").glob("*.toml")):
        named.append((f"configs/{path.name}", load_config(str(path))))
    rows: List[Dict[str, object]] = []
    for name, app in named:
        ec = engine_config(app)
        _, cfg = registry.resolve(ec.model, ec.dtype, ec.param_dtype)
        t = app.tutoring
        dom = static_paged_domain(
            cfg.max_position_embeddings, ec.sampling.max_new_tokens,
            tuple(ec.length_buckets), ec.spec_tokens,
            megastep_max=effective_megastep_max(t.megastep, t.megastep_max),
            prefix_cache=t.prefix_cache,
            fused_prefill=t.prefill_chunk_tokens > 0, tp=ec.tp, ep=ec.ep)
        sdom = static_score_domain(
            tuple(ec.length_buckets), tuple(ec.batch_buckets),
            cfg.max_position_embeddings, sp=ec.sp,
            enabled=app.scoring.enabled)
        total = sum(int(dom[k]) for k in (
            "prefill_buckets", "install_pairs", "step_widths", "grow_pairs",
            "megastep_pairs", "partial_pairs", "export_buckets",
            "load_buckets", "stage_pairs", "stage_block_widths"))
        total += int(sdom["score_pairs"])
        rows.append(dict(
            name=name, model=ec.model, paged=t.paged, mesh=dom["mesh"],
            spec_tokens=ec.spec_tokens, max_new=ec.sampling.max_new_tokens,
            buckets=dom["buckets"], widths=dom["widths"],
            k_ladder=dom["k_ladder"], prefix=t.prefix_cache,
            fused=t.prefill_chunk_tokens > 0,
            megastep_keys=dom["megastep_pairs"],
            score_pairs=sdom["score_pairs"], total=total))
    return rows


def _csv(xs) -> str:
    return ", ".join(str(x) for x in xs)


def render_readme_block(entries: List[dict]) -> str:
    lines = [MD_BEGIN,
             "| engine | program | site | runs | domain | coverage |",
             "|---|---|---|---|---|---|"]
    for e in entries:
        lines.append(
            f"| `{e['engine']}` | `{e['attr']}` | {e['site']} "
            f"| `{e['target']}` | {e['domain']} | {e['coverage']} |")
    lines += [
        "",
        "Derived paged domains (prompt buckets × cache widths × megastep "
        "ladder; `total` is the key count over every warmup-covered "
        "program that `expected_from_inventory` asserts after warmup, one "
        "engine and one mesh; the megastep's keys are the chunk graphs "
        "per width, see `engine/program_inventory.py`):",
        "",
        "| config | model | paged | mesh | spec_tokens | max_new "
        "| prompt buckets | cache widths | megastep ladder | megastep keys "
        "| prefix cache | fused prefill | score programs | total |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for row in shipped_domains():
        mesh = row["mesh"]
        lines.append(
            f"| {row['name']} | `{row['model']}` "
            f"| {'yes' if row['paged'] else 'no'} "
            f"| tp={mesh['tp']} ep={mesh['ep']} | {row['spec_tokens']} "
            f"| {row['max_new']} | {_csv(row['buckets'])} "
            f"| {_csv(row['widths'])} | {_csv(row['k_ladder'])} "
            f"| {row['megastep_keys']} "
            f"| {'on' if row['prefix'] else 'off'} "
            f"| {'on' if row['fused'] else 'off'} "
            f"| {row['score_pairs']} | {row['total']} |")
    lines.append(MD_END)
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate the port's program inventory and its README "
                    "table.")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="exit 1 when the manifest or README drifted")
    mode.add_argument("--write", action="store_true",
                      help="rewrite the manifest and README blocks")
    args = parser.parse_args(argv)
    entries = scanned_entries()
    inv_block = render_inventory_block(entries)
    md_block = render_readme_block(entries)
    if not (args.check or args.write):
        print(inv_block)
        print()
        print(md_block)
        return 0
    return sync({MANIFEST: (INV_BEGIN, INV_END, inv_block),
                 README: (MD_BEGIN, MD_END, md_block)},
                check=args.check, command=COMMAND)


if __name__ == "__main__":
    sys.exit(main())
