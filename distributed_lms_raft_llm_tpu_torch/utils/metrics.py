"""Serving metrics: counters, gauges and latency histograms.

The port's own copy of `distributed_lms_raft_llm_tpu/utils/metrics.py`
(`Metrics`, `LatencyHistogram`), with a plain `threading.Lock` in place of
the JAX package's lock-order-recording lock. Thread-safe; snapshots are
plain floats, ready for JSON.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, List, Optional, Sequence


def percentile_of_sorted(samples: Sequence[float], p: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence."""
    n = len(samples)
    if n == 0:
        raise ValueError("percentile of an empty sequence")
    idx = min(n - 1, max(0, math.ceil(n * p / 100.0) - 1))
    return samples[idx]


class LatencyHistogram:
    """Reservoir of recent latencies with percentile queries."""

    def __init__(self, max_samples: int = 4096):
        self._samples: List[float] = []  # guarded-by: _lock
        self._max = max_samples
        self._count = 0                  # guarded-by: _lock
        self._total = 0.0                # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total += seconds
            bisect.insort(self._samples, seconds)
            if len(self._samples) > self._max:
                # Drop alternating extremes to keep the reservoir centered.
                self._samples.pop(0 if self._count % 2 else -1)

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            return percentile_of_sorted(self._samples, p)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            n = len(self._samples)
            if n == 0:
                return {"count": 0, "samples": 0}
            return {
                "count": self._count,
                "samples": n,
                "mean_s": self._total / self._count,
                "p50_s": percentile_of_sorted(self._samples, 50),
                "p90_s": percentile_of_sorted(self._samples, 90),
                "p95_s": percentile_of_sorted(self._samples, 95),
                "p99_s": percentile_of_sorted(self._samples, 99),
                "max_s": self._samples[-1],
            }


class Metrics:
    """Named counters + histograms + gauges; one per server process."""

    def __init__(self):
        self._counters: Dict[str, int] = {}            # guarded-by: _lock
        self._hists: Dict[str, LatencyHistogram] = {}  # guarded-by: _lock
        self._gauges: Dict[str, float] = {}            # guarded-by: _lock
        self._lock = threading.Lock()

    def set_gauge(self, name: str, value: float) -> None:
        """Last-value gauge for dimensionless readings (not latencies)."""
        with self._lock:
            self._gauges[name] = float(value)

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def hist(self, name: str) -> LatencyHistogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = LatencyHistogram()
            return self._hists[name]

    def time(self, name: str) -> "_Timer":
        return _Timer(self.hist(name))

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counters = dict(self._counters)
            hists = {k: h.snapshot() for k, h in self._hists.items()}
            gauges = dict(self._gauges)
        out: Dict[str, object] = {"counters": counters, "latency": hists}
        if gauges:
            out["gauges"] = gauges
        return out


class _Timer:
    def __init__(self, hist: LatencyHistogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.monotonic() - self._t0)
        return False
