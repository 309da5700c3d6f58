"""The serving loop's heartbeat watchdog.

A trimmed port of `distributed_lms_raft_llm_tpu/utils/guards.py`: its
`LoopWatchdog` and `make_serving_watchdog`. The tutoring node runs the
watchdog's heartbeat as a task on its event loop, as the JAX node does: a
handler or a queue step that blocks the loop (sync IO, a device readback
on the loop thread) shows up as the `serving_tick_lag` histogram and the
`serving_tick_stalls` counter in /metrics. It is also the witness that a
scoring quantum's readback, which runs in an executor thread, never
blocks the loop.

The JAX module's transfer guard and compile-count guard have no
counterpart here: the port has no jit. Nothing runs at import.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Optional

from . import metrics_registry

log = logging.getLogger(__name__)


class LoopWatchdog:
    """Event-loop stall detector.

    `observe(lag_s)` takes how late one iteration of a loop ran against
    its schedule: the lag lands in a Metrics histogram (`lag_metric`,
    seconds), and a lag above `warn_above_s` increments the
    `stalls_metric` counter and logs a rate-limited warning. `run()` is a
    standalone heartbeat coroutine for a loop the caller does not own: it
    sleeps `interval_s` and observes its own wake-up lag.
    """

    def __init__(self, metrics: Optional[Any] = None, *, name: str = "loop",
                 warn_above_s: float = 0.25, warn_every_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 lag_metric: Optional[str] = None,
                 stalls_metric: Optional[str] = None):
        self.metrics = metrics
        self.name = name
        self.warn_above_s = warn_above_s
        self.warn_every_s = warn_every_s
        self._clock = clock
        self._last_warn = 0.0
        self.max_lag_s = 0.0
        self.stalls = 0
        self.lag_metric = lag_metric or f"{name}_lag"
        self.stalls_metric = stalls_metric or f"{name}_stalls"

    def observe(self, lag_s: float) -> None:
        lag_s = max(0.0, float(lag_s))
        self.max_lag_s = max(self.max_lag_s, lag_s)
        if self.metrics is not None:
            self.metrics.hist(self.lag_metric).observe(lag_s)
        if lag_s <= self.warn_above_s:
            return
        self.stalls += 1
        if self.metrics is not None:
            self.metrics.inc(self.stalls_metric)
        now = self._clock()
        if now - self._last_warn >= self.warn_every_s:
            self._last_warn = now
            log.warning(
                "%s stalled %.0f ms (threshold %.0f ms): something is "
                "blocking the event loop (%d stalls so far)",
                self.name, lag_s * 1e3, self.warn_above_s * 1e3, self.stalls)

    async def run(self, interval_s: float = 0.1) -> None:
        """Heartbeat for a loop the caller cannot instrument."""
        while True:
            before = self._clock()
            await asyncio.sleep(interval_s)
            self.observe(self._clock() - before - interval_s)


def make_serving_watchdog(metrics: Any, *,
                          warn_above_s: float = 0.25) -> LoopWatchdog:
    """The serving event loop's watchdog, under the JAX node's series
    names (`serving_tick_lag`, `serving_tick_stalls`); the server runs its
    `run()` as a task."""
    return LoopWatchdog(
        metrics, name="serving_tick", warn_above_s=warn_above_s,
        lag_metric=metrics_registry.SERVING_TICK_LAG,
        stalls_metric=metrics_registry.SERVING_TICK_STALLS)
