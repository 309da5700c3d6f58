"""Telemetry timeline: the time dimension of `/metrics`.

A trimmed port of `distributed_lms_raft_llm_tpu/utils/timeline.py`, for
what a tutoring node serves at ``GET /admin/timeline``:

- `Timeline`, a bounded ring of `TimelinePoint`s, each folded from one
  `Metrics.snapshot()`: per-interval counter deltas (reset-aware: a
  counter below its previous sample contributes its whole new value;
  the first sample only seeds the baselines), last-value gauges, and the
  histogram percentile blocks with the observations of the interval
  (`dcount`);
- `TimelineSampler`, a daemon thread that snapshots one `Metrics` every
  `interval_s` into a `Timeline`, and accounts its own cost
  (`samples`, `overhead_s`);
- `timeline_admin_get`, the handler body of ``GET /admin/timeline``.

The exported document has the JAX package's shape, so its cluster
scraper and dashboard (`scripts/telemetry.py`) read a port node's ring as
they read a JAX node's. The window queries, the burn-rate formula and
the snapshot readers that the JAX package's SLO engine uses stay there;
`render_prometheus` lives in `utils/healthz.py`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from .metrics import Metrics

Snapshot = Dict[str, Any]


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


class Timeline:
    """Bounded in-process time series over `Metrics.snapshot()` documents.
    Thread-safe: the sampler appends from its thread while the admin plane
    reads."""

    def __init__(self, max_points: int = 600):
        self._lock = threading.Lock()
        self._points: Deque[TimelinePoint] = deque(  # guarded-by: _lock
            maxlen=max_points)
        self._prev_t: Optional[float] = None          # guarded-by: _lock
        self._prev_counters: Dict[str, int] = {}      # guarded-by: _lock
        self._prev_hist_counts: Dict[str, int] = {}   # guarded-by: _lock

    def append(self, snapshot: Snapshot,
               t: Optional[float] = None) -> TimelinePoint:
        """Fold one cumulative snapshot into the ring (see the module
        docstring for the counter and histogram deltas)."""
        now = time.time() if t is None else t
        counters = {k: int(v)
                    for k, v in snapshot.get("counters", {}).items()}
        with self._lock:
            first = self._prev_t is None
            dt = 0.0 if first else now - self._prev_t
            deltas: Dict[str, int] = {}
            for name, cur in counters.items():
                prev = self._prev_counters.get(name, 0)
                deltas[name] = (0 if first
                                else cur - prev if cur >= prev else cur)
            hists: Dict[str, Dict[str, float]] = {}
            for name, block in snapshot.get("latency", {}).items():
                if not isinstance(block, dict):
                    continue
                out = {k: float(v) for k, v in block.items()}
                cur_n = int(block.get("count", 0))
                prev_n = self._prev_hist_counts.get(name, 0)
                out["dcount"] = float(
                    0 if first
                    else cur_n - prev_n if cur_n >= prev_n else cur_n)
                self._prev_hist_counts[name] = cur_n
                hists[name] = out
            point = TimelinePoint(
                t=now, dt=max(0.0, dt), deltas=deltas,
                gauges={k: float(v)
                        for k, v in snapshot.get("gauges", {}).items()},
                hists=hists)
            self._prev_t = now
            self._prev_counters = counters
            self._points.append(point)
            return point

    def points(self) -> List[TimelinePoint]:
        with self._lock:
            return list(self._points)

    def to_dict(self) -> Dict[str, Any]:
        # A node records no events; the key keeps the JAX document's shape.
        return {"points": [p.to_dict() for p in self.points()],
                "events": []}


class TimelineSampler:
    """Daemon thread: `metrics.snapshot()` -> `timeline` every interval."""

    def __init__(self, metrics: Metrics, interval_s: float = 1.0,
                 max_points: int = 600,
                 timeline: Optional[Timeline] = None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.metrics = metrics
        self.interval_s = interval_s
        self.timeline = (timeline if timeline is not None
                         else Timeline(max_points=max_points))
        self.samples = 0        # written by the sampler thread only
        self.overhead_s = 0.0   # written by the sampler thread only
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TimelineSampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="timeline-sampler", daemon=True)
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


def timeline_admin_get(path: str,
                       timeline: Optional[Timeline]) -> Dict[str, Any]:
    """`GET /admin/timeline`: the node's whole ring as one document.
    KeyError for another path (404), ValueError when the timeline is off
    on this node."""
    if path != "/admin/timeline":
        raise KeyError(path)
    if timeline is None:
        raise ValueError("telemetry timeline is disabled on this node")
    return {"ok": True, "timeline": timeline.to_dict()}
