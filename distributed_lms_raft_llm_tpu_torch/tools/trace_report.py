"""Flight-recorder waterfall: render one request's span tree as text.

The JAX package's `scripts/trace_report.py` over the port's tracer
(`utils/tracing.py`), with the same flags and output.

Every serving process retains its own trace fragments in a bounded
flight-recorder ring (utils/tracing.py) and exposes them read-only on its
admin plane. This CLI fetches those fragments over plain HTTP and renders
them:

    # What's retained (pinned exemplars + recent traces) on one node:
    python -m distributed_lms_raft_llm_tpu_torch.tools.trace_report --endpoint http://127.0.0.1:9100

    # One request's waterfall, fragments merged across processes (the
    # LMS leader holds client/handler/raft spans; the tutoring node
    # holds queue/engine spans — list every endpoint that saw it):
    python -m distributed_lms_raft_llm_tpu_torch.tools.trace_report \
        --endpoint http://127.0.0.1:9100 \
        --endpoint http://127.0.0.1:9101  <request-id>

    # Offline: --json a saved `GET /admin/trace/<id>` response (or a
    # BENCH record's embedded `slowest_trace`) instead of an endpoint.
    python -m distributed_lms_raft_llm_tpu_torch.tools.trace_report --json trace.json <request-id>

    # Regression triage: side-by-side per-stage p95 diff of two runs.
    # Each file is a stage_p95s export — a semester-sim BENCH record
    # (slos.stage_p95s), an SLO verdict, a saved trace (the breakdown is
    # computed from its spans), or a bare {stage: {p95_s, ...}} mapping:
    python -m distributed_lms_raft_llm_tpu_torch.tools.trace_report --diff before.json after.json

The waterfall is wall-clock aligned: fragments recorded by different
processes line up by their absolute start times, so cross-process clock
skew shows up as (small) overlap rather than being hidden.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from ..utils.tracing import assemble_forest

BAR_WIDTH = 32


def _fetch(url: str, timeout: float) -> Optional[Dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except (urllib.error.URLError, OSError, ValueError) as e:
        sys.stderr.write(f"warning: {url}: {e}\n")
        return None


def _flatten(span: Dict[str, Any], depth: int,
             out: List[Tuple[int, Dict[str, Any]]]) -> None:
    out.append((depth, span))
    for child in span.get("children", ()):
        _flatten(child, depth + 1, out)


def render_waterfall(trace: Dict[str, Any], out=None) -> None:
    """Text waterfall for one assembled trace dict (`trace_id`, `route`,
    `flags`, `spans`: forest of span dicts)."""
    out = out if out is not None else sys.stdout
    rows: List[Tuple[int, Dict[str, Any]]] = []
    for root in trace.get("spans", []):
        _flatten(root, 0, rows)
    if not rows:
        out.write("(no spans retained for this trace)\n")
        return
    t0 = min(s.get("start_s", 0.0) for _, s in rows)
    t1 = max(s.get("start_s", 0.0) + s.get("duration_s", 0.0)
             for _, s in rows)
    total = max(t1 - t0, 1e-9)
    flags = ",".join(trace.get("flags", [])) or "-"
    out.write(
        f"trace {trace.get('trace_id', '?')}  route={trace.get('route', '?')}"
        f"  total={total * 1e3:.1f} ms  flags={flags}\n"
    )
    name_w = max(2 + 2 * d + len(s["name"]) for d, s in rows)
    for depth, span in rows:
        start = span.get("start_s", 0.0) - t0
        dur = span.get("duration_s", 0.0)
        lo = int(start / total * BAR_WIDTH)
        hi = max(lo + 1, int((start + dur) / total * BAR_WIDTH))
        bar = " " * lo + "#" * (hi - lo) + " " * (BAR_WIDTH - hi)
        name = "  " * depth + span["name"]
        status = "" if span.get("status", "ok") == "ok" else " !ERROR"
        attrs = span.get("attrs", {})
        extra = ""
        if attrs:
            extra = "  " + ",".join(f"{k}={v}" for k, v in
                                    sorted(attrs.items()))
        out.write(
            f"  {name:<{name_w}} |{bar}| {start * 1e3:8.1f} ms "
            f"+{dur * 1e3:8.1f} ms{status}{extra}\n"
        )


def load_stage_p95s(path: str) -> Dict[str, Dict[str, float]]:
    """Per-stage stats from any artifact this repo emits: a BENCH record
    (slos.stage_p95s), an SLO verdict (stage_p95s), a saved trace doc
    (breakdown computed from its spans), or the bare mapping itself."""
    from ..sim.slo import stage_breakdown

    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise SystemExit(f"{path}: expected a JSON object")
    slos = doc.get("slos")
    if isinstance(slos, dict) and isinstance(slos.get("stage_p95s"), dict):
        return slos["stage_p95s"]
    if isinstance(doc.get("stage_p95s"), dict):
        return doc["stage_p95s"]
    tree = doc.get("trace", doc)
    if isinstance(tree, dict) and isinstance(tree.get("spans"), list):
        return stage_breakdown([tree])
    # A bare mapping: every value must look like a stats block.
    if doc and all(isinstance(v, dict) for v in doc.values()):
        return {k: {kk: float(vv) for kk, vv in v.items()}
                for k, v in doc.items()}
    raise SystemExit(f"{path}: no stage_p95s / spans found")


def render_stage_diff(a: Dict[str, Dict[str, float]],
                      b: Dict[str, Dict[str, float]],
                      label_a: str, label_b: str, out=None) -> None:
    """Side-by-side per-stage waterfall diff: where run B's latency
    budget moved relative to run A, worst p95 regression first — the
    round-6 measurement campaign's triage view."""
    out = out if out is not None else sys.stdout
    stages = sorted(
        set(a) | set(b),
        key=lambda s: -abs(b.get(s, {}).get("p95_s", 0.0)
                           - a.get(s, {}).get("p95_s", 0.0)),
    )
    name_w = max([len(s) for s in stages] + [5])
    out.write(
        f"  {'stage':<{name_w}} {'A p95':>10} {'B p95':>10} "
        f"{'delta':>10} {'pct':>8}   A={label_a}  B={label_b}\n"
    )
    for stage in stages:
        pa = a.get(stage, {}).get("p95_s")
        pb = b.get(stage, {}).get("p95_s")
        cell_a = f"{pa * 1e3:8.1f}ms" if pa is not None else "       -"
        cell_b = f"{pb * 1e3:8.1f}ms" if pb is not None else "       -"
        if pa is not None and pb is not None:
            delta = pb - pa
            pct = (f"{delta / pa * 100:+7.1f}%" if pa > 0 else "      -")
            cell_d = f"{delta * 1e3:+8.1f}ms"
        else:
            # A stage only one run has IS the finding (a new stage
            # appeared, or one vanished) — keep it visible, not dropped.
            cell_d, pct = "     new" if pa is None else "    gone", "      -"
        out.write(
            f"  {stage:<{name_w}} {cell_a:>10} {cell_b:>10} "
            f"{cell_d:>10} {pct:>8}\n"
        )


def render_summaries(listing: Dict[str, Any], source: str,
                     out=None) -> None:
    out = out if out is not None else sys.stdout
    out.write(f"== {source}\n")
    for section in ("exemplars", "recent"):
        entries = listing.get(section, [])
        out.write(f"  {section} ({len(entries)}):\n")
        for s in entries:
            flags = ",".join(s.get("flags", [])) or "-"
            pins = ",".join(s.get("pinned", [])) or "-"
            out.write(
                f"    {s.get('trace_id', '?'):<20} "
                f"{s.get('route', '?'):<28} "
                f"{s.get('duration_s', 0.0) * 1e3:9.1f} ms  "
                f"spans={s.get('spans', 0):<4} flags={flags} pins={pins}\n"
            )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("trace_id", nargs="?", default=None,
                    help="request id / trace id to render; omit to list "
                         "what each endpoint retains")
    ap.add_argument("--endpoint", action="append", default=[],
                    help="admin-plane base URL (http://host:port); "
                         "repeatable — fragments merge across endpoints")
    ap.add_argument("--json", action="append", default=[], dest="json_files",
                    help="saved /admin/trace/<id> response (or embedded "
                         "slowest_trace) to merge; repeatable")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                    help="side-by-side per-stage p95 diff of two "
                         "stage_p95s exports (BENCH records, SLO "
                         "verdicts, saved traces, or bare mappings)")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)
    if args.diff:
        a, b = args.diff
        render_stage_diff(load_stage_p95s(a), load_stage_p95s(b),
                          os.path.basename(a), os.path.basename(b))
        return 0
    if not args.endpoint and not args.json_files:
        ap.error("need at least one --endpoint or --json")

    if args.trace_id is None:
        if args.json_files:
            ap.error("--json holds one trace; pass its trace id to render")
        ok = False
        for ep in args.endpoint:
            listing = _fetch(f"{ep.rstrip('/')}/admin/trace", args.timeout)
            if listing is not None:
                render_summaries(listing, ep)
                ok = True
        return 0 if ok else 2

    # Collect this trace's fragments from every source and re-assemble:
    # a fragment whose remote parent lives in another process's fragment
    # grafts under it (assemble_forest is pure-dict, same machinery the
    # in-process store uses).
    fragments: List[Dict[str, Any]] = []
    route, flags = "", set()
    for ep in args.endpoint:
        doc = _fetch(
            f"{ep.rstrip('/')}/admin/trace/{args.trace_id}", args.timeout
        )
        tree = (doc or {}).get("trace")
        if tree:
            fragments.extend(tree.get("spans", []))
            route = route or tree.get("route", "")
            flags |= set(tree.get("flags", []))
    for path in args.json_files:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        tree = doc.get("trace", doc)
        fragments.extend(tree.get("spans", []))
        route = route or tree.get("route", "")
        flags |= set(tree.get("flags", []))
    if not fragments:
        sys.stderr.write(f"trace {args.trace_id} not found anywhere\n")
        return 2
    # Endpoints that share a store (in-process test clusters, a node
    # asked twice) return the same fragments; a span's id is unique, so
    # a repeated root is the same fragment — keep the first copy.
    seen: set = set()
    unique: List[Dict[str, Any]] = []
    for frag in fragments:
        sid = frag.get("span_id")
        if sid in seen:
            continue
        seen.add(sid)
        unique.append(frag)
    fragments = unique
    render_waterfall({
        "trace_id": args.trace_id,
        "route": route,
        "flags": sorted(flags),
        "spans": assemble_forest(fragments),
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
