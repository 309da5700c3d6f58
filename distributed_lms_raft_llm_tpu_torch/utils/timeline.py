"""Telemetry timeline: the time dimension of `/metrics`.

The port's copy of `distributed_lms_raft_llm_tpu/utils/timeline.py`, its
logic as it is.

`Metrics.snapshot()` is a point-in-time document — rich, but blind to
*change*: an operator (or the continuous SLO engine in `sim/slo.py`)
needs "requests per second over the last 10 s" and "worst p95 in the
last minute", not "requests since boot". This module adds that axis with
zero dependencies:

- `Timeline` — a bounded ring of `TimelinePoint`s, each derived from one
  snapshot: per-interval counter deltas (reset-aware, so a restarted
  node's wiped counters read as fresh increments, never as negative
  rates), last-value gauges, and the histogram percentile blocks. On
  top, windowed queries: `counter_rate`/`counter_delta` over the last W
  seconds, `gauge_last`/`gauge_percentile`, and `hist_p95` — the WORST
  reservoir p95 observed inside the window (the reservoir is
  cumulative, so this is a conservative over-W bound; the true
  sliding-window quantile for in-process series is
  `LatencyHistogram.window_percentile`). Operational events (burn-rate
  alerts, fault phases) land in a sibling ring via `record_event`, so
  an exported timeline carries its own annotations.
- `TimelineSampler` — a daemon thread that snapshots one process-local
  `Metrics` every `interval_s` into a `Timeline`; each node serves its
  ring read-only at `GET /admin/timeline`. The sampler self-accounts
  (`overhead_s`) so the tier-1 overhead-bound test can prove sampling
  stays measurement, not load.
- `render_prometheus` — the `GET /metrics.prom` text exposition, rendered
  straight from the snapshot with name/kind/help looked up in
  `utils/metrics_registry.py` (counters and gauges verbatim, histograms
  as quantile-labeled summaries).
- `snap_counter`/`snap_gauge`/`snap_hist` — the shared snapshot readers
  (`sim/slo.py`, `utils/scrape.py`). The `metrics-registry` lint rule
  checks the series-name argument of these (and of the Timeline window
  queries) exactly like an emission site: an SLO bound or dashboard read
  of a never-declared series fails lint instead of reading 0 forever.

The cluster-level merge of many nodes' timelines lives in
`utils/scrape.py`; the CLI over both is `scripts/telemetry.py`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from . import metrics_registry
from .metrics import Metrics, percentile_of_sorted

Snapshot = Dict[str, Any]


# ----------------------------------------------------- snapshot readers


def snap_counter(snap: Snapshot, name: str, default: int = 0) -> int:
    """One counter out of a `Metrics.snapshot()` document."""
    return int(snap.get("counters", {}).get(name, default))


def snap_gauge(snap: Snapshot, name: str, default: float = 0.0) -> float:
    """One gauge out of a `Metrics.snapshot()` document."""
    return float(snap.get("gauges", {}).get(name, default))


def snap_hist(snap: Snapshot, name: str) -> Dict[str, float]:
    """One histogram percentile block ({} when the series never fired)."""
    out = snap.get("latency", {}).get(name, {})
    return dict(out) if isinstance(out, dict) else {}


# -------------------------------------------------------------- points


@dataclasses.dataclass
class TimelinePoint:
    """One sample: wall time, the interval it covers, and what changed."""

    t: float                       # wall-clock seconds (time.time())
    dt: float                      # seconds since the previous point
    deltas: Dict[str, int]         # counter increments over dt
    gauges: Dict[str, float]
    hists: Dict[str, Dict[str, float]]  # snapshot percentile blocks,
    #                                     plus "dcount": observations in dt

    def rates(self) -> Dict[str, float]:
        if self.dt <= 0:
            return {k: 0.0 for k in self.deltas}
        return {k: v / self.dt for k, v in self.deltas.items()}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "t": round(self.t, 3),
            "dt": round(self.dt, 3),
            "rates": {k: round(v, 4) for k, v in self.rates().items()},
            "gauges": {k: round(v, 6) for k, v in self.gauges.items()},
            "hists": {
                name: {k: round(float(v), 6) for k, v in block.items()}
                for name, block in self.hists.items()
            },
        }

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "TimelinePoint":
        dt = float(doc.get("dt", 0.0))
        return cls(
            t=float(doc.get("t", 0.0)),
            dt=dt,
            deltas={k: int(round(float(v) * dt))
                    for k, v in doc.get("rates", {}).items()},
            gauges={k: float(v) for k, v in doc.get("gauges", {}).items()},
            hists={name: {k: float(v) for k, v in block.items()}
                   for name, block in doc.get("hists", {}).items()},
        )


class Timeline:
    """Bounded in-process time series over `Metrics.snapshot()` documents.

    Thread-safe: the sampler appends from its own thread while admin
    handlers and the SLO engine query concurrently.
    """

    def __init__(self, max_points: int = 600, max_events: int = 256):
        self._lock = threading.Lock()
        self._points: Deque[TimelinePoint] = deque(  # guarded-by: _lock
            maxlen=max_points
        )
        self._events: Deque[Dict[str, Any]] = deque(  # guarded-by: _lock
            maxlen=max_events
        )
        self._prev_t: Optional[float] = None          # guarded-by: _lock
        self._prev_counters: Dict[str, int] = {}      # guarded-by: _lock
        self._prev_hist_counts: Dict[str, int] = {}   # guarded-by: _lock

    # ------------------------------------------------------------- write

    def append(self, snapshot: Snapshot,
               t: Optional[float] = None) -> TimelinePoint:
        """Fold one cumulative snapshot into the ring.

        Counter deltas are reset-aware: a value below the previous sample
        (process restart wiped the counter) contributes its whole new
        value as the delta — the Prometheus rate() convention — so a
        rolling restart reads as a blip, not a negative rate. The FIRST
        sample only seeds baselines (every delta is 0): the process may
        have been running long before the timeline started, and its
        boot-era totals must not read as a rate spike in the first
        window (the two-samples-for-a-rate rule)."""
        now = time.time() if t is None else t
        counters = {k: int(v)
                    for k, v in snapshot.get("counters", {}).items()}
        hists_in = snapshot.get("latency", {})
        with self._lock:
            first = self._prev_t is None
            dt = 0.0 if first else now - self._prev_t
            deltas: Dict[str, int] = {}
            for name, cur in counters.items():
                prev = self._prev_counters.get(name, 0)
                deltas[name] = (0 if first
                                else cur - prev if cur >= prev else cur)
            hists: Dict[str, Dict[str, float]] = {}
            for name, block in hists_in.items():
                if not isinstance(block, dict):
                    continue
                out = {k: float(v) for k, v in block.items()}
                cur_n = int(block.get("count", 0))
                prev_n = self._prev_hist_counts.get(name, 0)
                out["dcount"] = float(
                    0 if first
                    else cur_n - prev_n if cur_n >= prev_n else cur_n
                )
                self._prev_hist_counts[name] = cur_n
                hists[name] = out
            point = TimelinePoint(
                t=now, dt=max(0.0, dt), deltas=deltas,
                gauges={k: float(v)
                        for k, v in snapshot.get("gauges", {}).items()},
                hists=hists,
            )
            self._prev_t = now
            self._prev_counters = counters
            self._points.append(point)
            return point

    def record_event(self, kind: str, detail: str = "",
                     t: Optional[float] = None,
                     **attrs: Any) -> Dict[str, Any]:
        """Annotate the timeline (alert raised/cleared, fault phase...)."""
        event: Dict[str, Any] = {
            "t": round(time.time() if t is None else t, 3),
            "kind": kind, "detail": detail,
        }
        event.update(attrs)
        with self._lock:
            self._events.append(event)
        return event

    # ------------------------------------------------------------ queries

    def points(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[TimelinePoint]:
        with self._lock:
            pts = list(self._points)
        if window_s is None:
            return pts
        cutoff = (time.time() if now is None else now) - window_s
        return [p for p in pts if p.t >= cutoff]

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def counter_delta(self, name: str, window_s: float,
                      now: Optional[float] = None) -> int:
        """Counter increments observed inside the last `window_s`."""
        return sum(p.deltas.get(name, 0)
                   for p in self.points(window_s, now))

    def counter_rate(self, name: str, window_s: float,
                     now: Optional[float] = None) -> Optional[float]:
        """Mean increments/second over the window; None when the window
        holds no samples (unknown, as opposed to a measured zero)."""
        pts = self.points(window_s, now)
        span = sum(p.dt for p in pts)
        if span <= 0:
            return None
        return sum(p.deltas.get(name, 0) for p in pts) / span

    def hist_rate(self, name: str, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        """Histogram observations/second over the window (from the
        per-point `dcount` deltas), None when the window is empty."""
        pts = self.points(window_s, now)
        span = sum(p.dt for p in pts)
        if span <= 0:
            return None
        return sum(p.hists.get(name, {}).get("dcount", 0.0)
                   for p in pts) / span

    def gauge_last(self, name: str) -> Optional[float]:
        with self._lock:
            for p in reversed(self._points):
                if name in p.gauges:
                    return p.gauges[name]
        return None

    def gauge_percentile(self, name: str, window_s: float, p: float,
                         now: Optional[float] = None) -> Optional[float]:
        """Percentile of a gauge's sampled values over the window (e.g.
        p95 queue depth), via the shared nearest-rank helper."""
        vals = sorted(
            pt.gauges[name] for pt in self.points(window_s, now)
            if name in pt.gauges
        )
        if not vals:
            return None
        return percentile_of_sorted(vals, p)

    def hist_p95(self, name: str, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        """Worst p95 reported for the series inside the window. The
        underlying reservoir is cumulative, so this bounds the window's
        true p95 from above — conservative for alerting; use
        `LatencyHistogram.window_percentile` for the exact sliding-window
        quantile on in-process series."""
        vals = [
            p.hists[name]["p95_s"] for p in self.points(window_s, now)
            if "p95_s" in p.hists.get(name, {})
        ]
        return max(vals) if vals else None

    # ------------------------------------------------------------- export

    def to_dict(self) -> Dict[str, Any]:
        return {
            "points": [p.to_dict() for p in self.points()],
            "events": self.events(),
        }

    @classmethod
    def from_dict(cls, doc: Dict[str, Any],
                  max_points: int = 100000) -> "Timeline":
        """Rehydrate an exported timeline (the capacity fitter's input)."""
        tl = cls(max_points=max_points)
        with tl._lock:
            for pdoc in doc.get("points", []):
                point = TimelinePoint.from_dict(pdoc)
                tl._points.append(point)
                tl._prev_t = point.t
            for event in doc.get("events", []):
                tl._events.append(dict(event))
        return tl


class TimelineSampler:
    """Daemon thread: `metrics.snapshot()` -> `timeline` every interval.

    Self-accounting: `samples` and `overhead_s` (wall time spent inside
    snapshot+append) let the tier-1 test bound the sampler's cost — the
    watcher must stay ~free relative to what it watches."""

    def __init__(self, metrics: Metrics, interval_s: float = 1.0,
                 max_points: int = 600,
                 timeline: Optional[Timeline] = None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.metrics = metrics
        self.interval_s = interval_s
        self.timeline = timeline if timeline is not None \
            else Timeline(max_points=max_points)
        self.samples = 0        # written by the sampler thread only
        self.overhead_s = 0.0   # written by the sampler thread only
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TimelineSampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="timeline-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            t0 = time.perf_counter()
            self.timeline.append(self.metrics.snapshot())
            self.samples += 1
            self.overhead_s += time.perf_counter() - t0


# ------------------------------------------------------- shared formulas


def degraded_rate_burn(timeline: Timeline, window_s: float, bound: float,
                       now: Optional[float] = None) -> Optional[float]:
    """Degraded-answer burn over one window of a (cluster) timeline:
    (degraded / gate-eligible requests) / bound. THE formula — the
    continuous SLO engine's alerting (sim/slo.py) and the live dashboard
    (scripts/telemetry.py) share it, so an operator watching burn
    figures sees the same number that pages. Gate-rejected asks never
    reach the tutoring decision and can't degrade, so they are excluded
    from the denominator — leaving them in would dilute a total blackout
    to a sub-threshold ratio. Without a gate the correction is zero and
    the ratio is deg/req. None = the window holds no samples (no
    evidence, not a zero)."""
    req = timeline.counter_rate(metrics_registry.LLM_REQUESTS, window_s,
                                now)
    deg = timeline.counter_rate(metrics_registry.TUTORING_DEGRADED,
                                window_s, now)
    if req is None or deg is None:
        return None
    rejected = timeline.counter_rate(metrics_registry.GATE_REJECT,
                                     window_s, now) or 0.0
    denom = max(req - rejected, deg)
    if denom <= 0:
        return 0.0
    return (deg / denom) / bound


# -------------------------------------------------- Prometheus exposition


def _prom_escape(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_value(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return format(value, ".9g")


def _prom_header(lines: List[str], name: str, kind: str) -> None:
    if metrics_registry.is_declared(name):
        spec_kind, help_text = metrics_registry.SPECS[name]
        lines.append(f"# HELP {name} {_prom_escape(help_text)}")
        # A registry "histogram" is a percentile reservoir; its exposition
        # (quantile-labelled samples + _count/_sum) is a Prometheus summary.
        lines.append(f"# TYPE {name} "
                     + ("summary" if spec_kind == metrics_registry.HISTOGRAM
                        else spec_kind))
    else:
        lines.append(f"# TYPE {name} {kind}")


def render_prometheus(snapshot: Dict[str, Any]) -> str:
    """Prometheus text exposition (0.0.4) of one Metrics snapshot: counters
    and gauges verbatim, histograms as summaries (the reservoir's
    percentiles plus `_count` and `_sum`)."""
    lines: List[str] = []
    counters = snapshot.get("counters", {})
    for name in sorted(counters):
        _prom_header(lines, name, metrics_registry.COUNTER)
        lines.append(f"{name} {_prom_value(float(counters[name]))}")
    gauges = snapshot.get("gauges", {})
    for name in sorted(gauges):
        _prom_header(lines, name, metrics_registry.GAUGE)
        lines.append(f"{name} {_prom_value(float(gauges[name]))}")
    hists = snapshot.get("latency", {})
    for name in sorted(hists):
        block = hists[name]
        if not isinstance(block, dict):
            continue
        _prom_header(lines, name, "summary")
        for q, key in (("0.5", "p50_s"), ("0.9", "p90_s"),
                       ("0.95", "p95_s"), ("0.99", "p99_s")):
            if key in block:
                lines.append(f'{name}{{quantile="{q}"}} '
                             f"{_prom_value(float(block[key]))}")
        count = float(block.get("count", 0))
        mean = float(block.get("mean_s", 0.0))
        lines.append(f"{name}_count {_prom_value(count)}")
        lines.append(f"{name}_sum {_prom_value(mean * count)}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------- admin-plane glue


def timeline_admin_get(path: str,
                       timeline: Optional[Timeline]) -> Dict[str, Any]:
    """`GET /admin/timeline` handler body, shared by both servers and the
    sim cluster: the node's full ring + events as one JSON document."""
    if path != "/admin/timeline":
        raise KeyError(path)
    if timeline is None:
        raise ValueError("telemetry timeline is disabled on this node")
    return {"ok": True, "timeline": timeline.to_dict()}
