"""Cluster scrape aggregator: many nodes' `/metrics` -> one timeline.

The port's copy of `distributed_lms_raft_llm_tpu/utils/scrape.py`,
its logic as it is.

One node's `TimelineSampler` (utils/timeline.py) answers "what is THIS
process doing over time"; operators and the continuous SLO engine need
the CLUSTER answer — every node's `/metrics` polled on one clock and
merged into a single timeline the windowed queries run over. The merge
rules are the boring-but-load-bearing part:

- **Counters** merge as summed per-node DELTAS, not summed values: each
  source keeps its own last-seen cumulative counters, a value that went
  backwards (the node restarted and wiped them) contributes its whole
  new value (the Prometheus reset rule), and an unreachable node simply
  contributes nothing that round — so a rolling restart reads as a blip
  in the rate, never as a negative spike or a cliff in the sum.
- **Gauges** merge as the worst (max) across nodes: breaker state, queue
  depth, `storage_recovering` — the cluster is as unhealthy as its
  unhealthiest node.
- **Histograms** merge by worst p95: the cluster-level `llm_ttft` block
  is the reporting node with the slowest tail, which is what an SLO
  bound cares about — except `count`, which is accumulated per-source
  like a counter so it stays monotonic when the worst node flips
  (Timeline's dcount/hist_rate depend on that).

Sources are either URLs (`http_source`, stdlib urllib, short timeout,
errors tolerated and counted) or plain callables returning a snapshot
dict — the semester sim feeds its own client-side `Metrics` and the
in-process tutoring queue through the same path its HTTP nodes take.
`scripts/telemetry.py` wraps this in a live dashboard + JSON export.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from .timeline import Snapshot, Timeline

SourceFn = Callable[[], Optional[Snapshot]]


def http_source(url: str, timeout_s: float = 2.0) -> SourceFn:
    """A `/metrics` poller for one node; None (not an exception) when the
    node is unreachable — restarts mid-poll are normal operations."""
    if not url.endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"

    def fetch() -> Optional[Snapshot]:
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as resp:
                doc = json.loads(resp.read().decode())
            return doc if isinstance(doc, dict) else None
        except (urllib.error.URLError, OSError, ValueError):
            return None

    return fetch


class ClusterScraper:
    """Polls every source into per-node timelines + one merged cluster
    timeline. Single-threaded by design: call `poll()` from one loop (the
    harness telemetry thread, the CLI's main loop)."""

    def __init__(
        self,
        sources: Optional[Dict[str, SourceFn]] = None,
        sources_fn: Optional[Callable[[], Dict[str, SourceFn]]] = None,
        max_points: int = 2048,
    ):
        if (sources is None) == (sources_fn is None):
            raise ValueError("pass exactly one of sources / sources_fn")
        self._sources = dict(sources or {})
        self._sources_fn = sources_fn
        self._max_points = max_points
        self.cluster = Timeline(max_points=max_points)
        self.nodes: Dict[str, Timeline] = {}
        self.unreachable: Dict[str, int] = {}
        # Per-source last-seen cumulative counters / histogram counts
        # (reset detection) and the merged monotonic accumulators the
        # cluster timeline is fed.
        self._prev: Dict[str, Dict[str, int]] = {}
        self._prev_hist: Dict[str, Dict[str, int]] = {}
        self._cum: Dict[str, int] = {}
        self._hist_cum: Dict[str, int] = {}
        self._last_node_count = 0

    # ------------------------------------------------------------ polling

    def _resolve(self) -> Dict[str, SourceFn]:
        if self._sources_fn is not None:
            # Re-resolved every poll: membership adds/removes change the
            # scrape set mid-run.
            return dict(self._sources_fn())
        return self._sources

    def poll(self, now: Optional[float] = None) -> Snapshot:
        """One scrape round; returns the merged cluster snapshot that was
        appended to `self.cluster`."""
        t = time.time() if now is None else now
        merged_gauges: Dict[str, float] = {}
        merged_hists: Dict[str, Dict[str, float]] = {}
        reachable = 0
        sources = self._resolve()
        for name, fetch in sources.items():
            snap = fetch()
            if snap is None:
                self.unreachable[name] = self.unreachable.get(name, 0) + 1
                continue
            reachable += 1
            node_tl = self.nodes.get(name)
            if node_tl is None:
                node_tl = self.nodes[name] = Timeline(
                    max_points=self._max_points
                )
            node_tl.append(snap, t=t)
            first_sight = name not in self._prev
            prev = self._prev.setdefault(name, {})
            for cname, raw in snap.get("counters", {}).items():
                cur = int(raw)
                seen = prev.get(cname, 0)
                prev[cname] = cur
                if first_sight:
                    # First sample of a source only seeds its baselines
                    # (the Prometheus two-samples-for-a-rate rule): its
                    # boot-era totals must not read as a rate spike in
                    # the first window.
                    continue
                delta = cur - seen if cur >= seen else cur
                self._cum[cname] = self._cum.get(cname, 0) + delta
            for gname, raw_g in snap.get("gauges", {}).items():
                val = float(raw_g)
                if gname not in merged_gauges or val > merged_gauges[gname]:
                    merged_gauges[gname] = val
            prev_hist = self._prev_hist.setdefault(name, {})
            for hname, block in snap.get("latency", {}).items():
                if not isinstance(block, dict):
                    continue
                cur_n = int(block.get("count", 0))
                seen_n = prev_hist.get(hname, 0)
                prev_hist[hname] = cur_n
                if not first_sight:
                    self._hist_cum[hname] = self._hist_cum.get(
                        hname, 0
                    ) + (cur_n - seen_n if cur_n >= seen_n else cur_n)
                worst = merged_hists.get(hname)
                if worst is None or float(block.get("p95_s", 0.0)) > float(
                    worst.get("p95_s", 0.0)
                ):
                    merged_hists[hname] = {
                        k: float(v) for k, v in block.items()
                    }
        self._last_node_count = len(sources)
        # The merged block keeps the worst node's percentiles, but its
        # `count` must be the cluster-cumulative observation count
        # (accumulated per-source like counters): a per-node count would
        # jump whenever the worst node flips, and Timeline.append would
        # misread the jumps as resets — garbage dcount/hist_rate.
        for hname, block in merged_hists.items():
            block["count"] = float(self._hist_cum.get(hname, 0))
        cluster_snap: Snapshot = {
            "counters": dict(self._cum),
            "gauges": merged_gauges,
            "latency": merged_hists,
        }
        self.cluster.append(cluster_snap, t=t)
        return cluster_snap

    # ------------------------------------------------------------- export

    @property
    def node_count(self) -> int:
        return self._last_node_count

    def export(self) -> Dict[str, object]:
        """One JSON document: the merged cluster timeline, every per-node
        timeline, and the scrape bookkeeping — the artifact
        `scripts/telemetry.py --capacity` fits the capacity model over."""
        return {
            "node_count": self._last_node_count,
            "unreachable": dict(self.unreachable),
            "cluster": self.cluster.to_dict(),
            "nodes": {name: tl.to_dict() for name, tl in self.nodes.items()},
        }


def endpoints_sources(endpoints: List[str],
                      timeout_s: float = 2.0) -> Dict[str, SourceFn]:
    """URL list -> named source map (the CLI's --endpoint plumbing)."""
    out: Dict[str, SourceFn] = {}
    for ep in endpoints:
        name = ep.rstrip("/").rsplit("//", 1)[-1]
        out[name] = http_source(ep, timeout_s=timeout_s)
    return out
