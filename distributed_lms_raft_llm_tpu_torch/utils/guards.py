"""Runtime guards: strict dispatch, the serving loop's heartbeat watchdog
and the Raft tick watchdog.

A trimmed port of `distributed_lms_raft_llm_tpu/utils/guards.py`:

- `intended_transfer()` marks a sanctioned host<->device sync point. The
  static rule `no-host-sync-in-dispatch` accepts syncs inside this block,
  and under strict dispatch the runtime check allows them: one marker
  serves both checkers, as in the reference.
- `strict_dispatch()` (a scope) and `enable_strict_dispatch()` (the whole
  process: the tutoring node's `--strict-dispatch`) make any host sync of
  a CUDA tensor outside an `intended_transfer()` block raise
  `HostSyncError`. The reference's guard is JAX's transfer guard; here it
  is `torch.cuda.set_sync_debug_mode`, which sees what blocks the host on
  the stream: `.item()`, `.tolist()`, `.cpu()` and other copies to or
  from pageable host memory without `non_blocking`, `torch.nonzero`. It
  does not see `torch.cuda.synchronize()`, an event's or a stream's
  `synchronize()`, or a graph replay (which does not sync). On a machine
  without a card the mode does nothing, and a one-time warning says so:
  the lint rule is the enforcement there.
- `LoopWatchdog`, `make_tick_watchdog` (the LMS node's Raft runner
  observes each tick's lag: `raft_tick_lag`, `raft_tick_stalls`) and
  `make_serving_watchdog`. The tutoring node runs the watchdog's heartbeat
  as a task on its event loop, as the JAX node does: a handler or a queue
  step that blocks the loop (sync IO, a device readback on the loop
  thread) shows up as the `serving_tick_lag` histogram and the
  `serving_tick_stalls` counter in /metrics. It is also the witness that
  a scoring quantum's readback, which runs in an executor thread, never
  blocks the loop.

The scope of strict dispatch. JAX's transfer guard is a per-thread
setting; torch's sync debug mode is one setting for the whole process, and
the node's engine steps run on executor threads while its event loop runs
on another. Toggling the mode around each sanctioned readback would let an
unmarked sync on another thread slip through while a block is open, or
raise on a thread that never asked for strict dispatch. So the process
mode is only ever `warn` (while any thread is strict) or off, and the
verdict is taken per thread: torch turns the sync into a Python warning on
the thread that synced, and this module's `warnings.showwarning` hook
raises there unless that thread is strict-free or inside
`intended_transfer()` (thread-local depths). A sanctioned readback on the
engine thread stays allowed while an unmarked one on any strict thread
raises; a thread outside every strict scope (with no process-wide mode)
is never touched. The hook is reinstalled on every strict entry if
something (`logging.captureWarnings`, a `warnings.catch_warnings` block)
displaced it; while it is displaced the check is off. The one cost: while
strict is on anywhere, every sync builds a warning object (microseconds),
and a sanctioned one is dropped.

- `compile_count_guard(...)`, `RecompileError`, `InventoryMismatchError`
  and `expected_from_inventory(engine)`: the reference's promise that no
  live request pays for a compile. The port has no jit, so a program's
  "cache" is the set of distinct static keys it has run at (a bucket, a
  width, a pair; `ProgramKeys`, one per program in each engine's
  `programs` table, filled by host code only: no device sync, no tensor
  read). What a compile cost on the TPU costs on the card is one of three
  things, each a process counter the guard reads: a CUDA graph capture
  (`engine/graphs.py::captures`), an nvcc build (`ops/build.py::builds`)
  and a kernel wrapper validating a layout it has not seen
  (`ops/attention.py::layouts_validated`,
  `ops/quant_matmul.py::layouts_validated`). A guarded region may add at
  most `allow` program keys and must not move any of the three counters;
  with `expected_from_inventory(engine)` every warmup-covered program's
  key count must also EQUAL the manifest's (`engine/program_inventory.py`)
  at exit, in both directions. A counter the guard cannot read raises.

Nothing runs at import, and torch is imported only when strict dispatch
or the card's counters are asked for.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import re
import threading
import time
import warnings
from typing import Any, Callable, Dict, Hashable, Iterator, Optional, Tuple

from . import metrics_registry

log = logging.getLogger(__name__)


# --------------------------------------------------------- strict dispatch

# The text of torch's sync debug warning (c10/cuda warn_or_error_on_sync).
SYNC_WARNING = "called a synchronizing CUDA operation"


class HostSyncError(RuntimeError):
    """A host sync of a CUDA tensor under strict dispatch, outside an
    `intended_transfer()` block."""


_tls = threading.local()            # .strict / .allowed: this thread's depths
_lock = threading.Lock()
_process_strict = False             # guarded-by: _lock
_open_scopes = 0                    # guarded-by: _lock
_previous_showwarning = None        # guarded-by: _lock
# One-time flag: strict dispatch without a card warns once per process
# (tests reset it to re-pin the warning).
_warned_cpu_noop = False


def _depth(name: str) -> int:
    return getattr(_tls, name, 0)


def _strict_here() -> bool:
    return _process_strict or _depth("strict") > 0


def _showwarning(message, category, filename, lineno, file=None, line=None):
    if SYNC_WARNING in str(message):
        if _strict_here() and _depth("allowed") == 0:
            raise HostSyncError(
                f"unmarked host sync under strict dispatch ({filename}:"
                f"{lineno}): {message}; wrap a sanctioned readback in "
                f"`with intended_transfer():` (utils/guards.py)")
        return
    _previous_showwarning(message, category, filename, lineno, file, line)


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()


def _warn_if_cpu_noop() -> bool:
    """Without a card there is nothing to sync with: strict dispatch would
    silently enforce nothing. Say so once, and point at the static rule
    (`no-host-sync-in-dispatch`) that is the enforcement there. True when
    the mode is a no-op."""
    global _warned_cpu_noop
    if _cuda():
        return False
    if not _warned_cpu_noop:
        _warned_cpu_noop = True
        log.warning(
            "strict dispatch: no CUDA device, torch's sync debug mode is a "
            "no-op here (CPU tensors never sync) — unmarked syncs will NOT "
            "raise; the `no-host-sync-in-dispatch` lint rule is the "
            "enforcement on the CPU")
    return True


def _apply_mode() -> None:  # guarded-by: _lock
    """The process mode: `warn` while any thread is strict, else off; the
    hook and the filter that routes every sync warning to it in place."""
    global _previous_showwarning
    import torch

    on = _process_strict or _open_scopes > 0
    if on:
        if warnings.showwarning is not _showwarning:
            _previous_showwarning = warnings.showwarning
            warnings.showwarning = _showwarning
        # Every sync warning reaches the hook: no once-per-line registry.
        warnings.filterwarnings("always",
                                message=".*" + re.escape(SYNC_WARNING))
    torch.cuda.set_sync_debug_mode("warn" if on else "default")


@contextlib.contextmanager
def intended_transfer() -> Iterator[None]:
    """Mark a sanctioned host<->device sync point.

    Inside this block, host syncs on this thread are allowed even under
    strict dispatch. The static rule `no-host-sync-in-dispatch` recognizes
    the same block lexically, so every sync in a dispatch module is either
    wrapped here (auditable, greppable) or a lint finding.
    """
    _tls.allowed = _depth("allowed") + 1
    try:
        yield
    finally:
        _tls.allowed -= 1


@contextlib.contextmanager
def strict_dispatch() -> Iterator[None]:
    """Scoped strict mode, for this thread: a host sync of a CUDA tensor
    outside `intended_transfer()` raises `HostSyncError` (on a machine
    without a card a documented no-op with a one-time warning). Other
    threads are not affected."""
    global _open_scopes
    noop = _warn_if_cpu_noop()
    _tls.strict = _depth("strict") + 1
    if not noop:
        with _lock:
            _open_scopes += 1
            _apply_mode()
    try:
        yield
    finally:
        _tls.strict -= 1
        if not noop:
            with _lock:
                _open_scopes -= 1
                _apply_mode()


def enable_strict_dispatch() -> None:
    """Process-wide strict mode (the `--strict-dispatch` server flag):
    from here on every unmarked host sync of a CUDA tensor, on any thread,
    raises. The node enables it once its engine is built and warmed:
    loading the weights and capturing the graphs are uploads that torch
    counts as syncs."""
    global _process_strict
    if _warn_if_cpu_noop():
        return
    with _lock:
        _process_strict = True
        _apply_mode()
    log.info("strict dispatch: unmarked host syncs will raise")


# ---------------------------------------------------- compile-count guard


class RecompileError(AssertionError):
    """A guarded region paid for what warmup promised to have paid for: a
    program key warmup did not cover, a graph capture, a kernel build or
    a layout's first launch."""


class InventoryMismatchError(RecompileError):
    """The engine's program tables and the static manifest
    (engine/program_inventory.py) disagree: an uncovered program, a stale
    inventory entry, or drifted domain math. Regenerate with
    `python -m distributed_lms_raft_llm_tpu_torch.tools.gen_program_inventory
    --write` if the change was intentional."""


class ProgramKeys:
    """The distinct static keys one engine program has run at: the port's
    counterpart of a jitted callable's program cache. `record` is host
    work only (a set insert); a graph replay records nothing (it runs no
    Python), so a replayed program's keys are those of its capture and of
    the dispatches that chose it."""

    def __init__(self, owner: str, name: str):
        self.owner = owner
        self.name = name
        self.keys: set = set()

    def record(self, key: Hashable) -> None:
        self.keys.add(key)

    def cache_size(self) -> int:
        return len(self.keys)


# The card's three costs of a first use, by counter name: (module, the
# module's attributes summed).
CARD_COUNTERS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "captures": (("distributed_lms_raft_llm_tpu_torch.engine.graphs",
                  "captures"),),
    "builds": (("distributed_lms_raft_llm_tpu_torch.ops.build", "builds"),),
    "layouts": (("distributed_lms_raft_llm_tpu_torch.ops.attention",
                 "layouts_validated"),
                ("distributed_lms_raft_llm_tpu_torch.ops.quant_matmul",
                 "layouts_validated")),
}


def card_counters() -> Dict[str, int]:
    """Read the three process counters (on every device; on the CPU they
    stay 0). Raises `RecompileError` for a counter it cannot read: a guard
    never passes on a counter it did not see."""
    import importlib

    out: Dict[str, int] = {}
    for name, sources in CARD_COUNTERS.items():
        total = 0
        for module, attr in sources:
            try:
                value = getattr(importlib.import_module(module), attr)
            except (ImportError, AttributeError) as exc:
                raise RecompileError(
                    f"cannot read the {name} counter ({module}.{attr}): "
                    f"{exc}") from exc
            if isinstance(value, bool) or not isinstance(value, int):
                raise RecompileError(
                    f"the {name} counter {module}.{attr} is {value!r}, not "
                    f"a count")
            total += value
        out[name] = total
    return out


class _CompileCounts:
    """Snapshot of per-program key counts and of the card's counters."""

    def __init__(self, programs):
        self.programs = list(programs)
        self.baseline = [self._size(p) for p in self.programs]
        self.counters0 = card_counters()

    @staticmethod
    def _size(program: object) -> int:
        if not isinstance(program, ProgramKeys):
            raise TypeError(
                f"{program!r} is not an engine program (no recorded keys); "
                "pass an engine's `programs[name]`")
        return program.cache_size()

    def new_compiles(self) -> int:
        """Program keys added since the snapshot, over every program."""
        return sum(self._size(p) - b
                   for p, b in zip(self.programs, self.baseline))

    def grown(self) -> Dict[str, int]:
        """{owner.program: keys added} for the programs that grew."""
        return {f"{p.owner}.{p.name}": self._size(p) - b
                for p, b in zip(self.programs, self.baseline)
                if self._size(p) != b}

    def counter_deltas(self) -> Dict[str, int]:
        """{counter: rise} for the card counters that moved."""
        now = card_counters()
        return {k: now[k] - self.counters0[k] for k in now
                if now[k] != self.counters0[k]}


class InventoryExpectation:
    """Absolute expected key counts for an engine's warmup-covered
    programs, from the static manifest. Built by
    `expected_from_inventory(engine)`; consumed by `compile_count_guard`."""

    def __init__(self, engine: object):
        from ..engine import program_inventory as _inv

        self.engine = engine
        self.expected = _inv.expected_counts(engine)  # program -> keys
        self.programs = {
            name: engine.programs[name] for name in sorted(self.expected)
        }

    def report(self) -> Dict[str, Tuple[int, int]]:
        """{program: (actual, expected)} for every warmup-covered program."""
        return {name: (_CompileCounts._size(p), self.expected[name])
                for name, p in self.programs.items()}

    def mismatches(self) -> Dict[str, Tuple[int, int]]:
        """The programs of `report()` whose key count differs from the
        manifest's expectation, in either direction."""
        return {name: (actual, exp)
                for name, (actual, exp) in self.report().items()
                if actual != exp}


def expected_from_inventory(engine: object) -> InventoryExpectation:
    """The static<->runtime cross-validation mode of `compile_count_guard`:

        eng.warmup()
        with compile_count_guard(expected_from_inventory(eng)):
            ... live serving ...

    The region must add no program key and move none of the card's
    counters, AND at exit every program engine/program_inventory.py names
    for the engine must hold EXACTLY the manifest's key count: more means
    warmup missed a program, fewer means the manifest overstates the
    domain (stale). Either direction raises InventoryMismatchError.
    """
    return InventoryExpectation(engine)


@contextlib.contextmanager
def compile_count_guard(
    *programs: object, allow: int = 0, what: str = "guarded region"
) -> Iterator[_CompileCounts]:
    """Assert the region adds at most `allow` new keys across the given
    engine programs and moves none of the card's counters (graph
    captures, kernel builds, layout validations).

        with compile_count_guard(eng.programs["_step"]) as guard:
            eng.drain()
        # guard.new_compiles(), guard.counter_deltas() for reporting

    Passing `expected_from_inventory(engine)` as the sole argument guards
    the engine's whole warmup-covered program set and also asserts the
    key counts at exit EQUAL the static manifest's. No program at all
    guards the card's counters alone.
    """
    expectation: Optional[InventoryExpectation] = None
    if len(programs) == 1 and isinstance(programs[0], InventoryExpectation):
        expectation = programs[0]
        programs = tuple(expectation.programs.values())
        what = (
            f"{type(expectation.engine).__name__} inventoried program set"
            if what == "guarded region" else what
        )
    counts = _CompileCounts(programs)
    yield counts
    new = counts.new_compiles()
    if new > allow:
        detail = ", ".join(f"{name} +{n}"
                           for name, n in sorted(counts.grown().items()))
        raise RecompileError(
            f"{what} ran {new} new program key(s) (allowed {allow}): "
            f"{detail} — warmup does not cover a live code path")
    risen = counts.counter_deltas()
    if risen:
        detail = ", ".join(f"{name} +{n}" for name, n in sorted(
            risen.items()))
        raise RecompileError(
            f"{what} moved the card's first-use counters: {detail} "
            "(captures: a CUDA graph captured; builds: a kernel built; "
            "layouts: a kernel wrapper validated a layout warmup did not "
            "run)")
    if expectation is not None:
        bad = expectation.mismatches()
        if bad:
            detail = ", ".join(
                f"{name}: {actual} keys vs {exp} inventoried"
                for name, (actual, exp) in sorted(bad.items())
            )
            raise InventoryMismatchError(
                f"{what} disagrees with engine/program_inventory.py "
                f"({detail}) — more than inventoried means warmup missed a "
                "program; fewer means the manifest is stale (python -m "
                "distributed_lms_raft_llm_tpu_torch.tools."
                "gen_program_inventory --write)"
            )


# ------------------------------------------------------------- watchdogs


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


def make_tick_watchdog(
    metrics: Optional[Any] = None, *, tick_interval: float,
    name: str = "raft_tick", stall_factor: float = 10.0,
) -> Optional[LoopWatchdog]:
    """The Raft wiring: warn when a tick lands `stall_factor` intervals
    late (late enough to matter for heartbeats, early enough to catch
    before elections fire). None without metrics, so callers can wire
    unconditionally."""
    if metrics is None:
        return None
    default = name == "raft_tick"
    return LoopWatchdog(
        metrics, name=name, warn_above_s=tick_interval * stall_factor,
        lag_metric=metrics_registry.RAFT_TICK_LAG if default else None,
        stalls_metric=metrics_registry.RAFT_TICK_STALLS if default else None,
    )


def make_serving_watchdog(metrics: Any, *,
                          warn_above_s: float = 0.25) -> LoopWatchdog:
    """The serving event loop's watchdog, under the JAX node's series
    names (`serving_tick_lag`, `serving_tick_stalls`); the server runs its
    `run()` as a task."""
    return LoopWatchdog(
        metrics, name="serving_tick", warn_above_s=warn_above_s,
        lag_metric=metrics_registry.SERVING_TICK_LAG,
        stalls_metric=metrics_registry.SERVING_TICK_STALLS)
