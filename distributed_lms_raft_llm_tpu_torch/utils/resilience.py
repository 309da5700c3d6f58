"""Request budgets, admission errors, retries and breakers for the
student-query path.

The port's own copy of `distributed_lms_raft_llm_tpu/utils/resilience.py`:

- `Deadline`: one request-scoped time budget, created at the edge and
  recovered at each hop from the gRPC deadline and the explicit budget
  header; `DeadlineExpired`, `Overloaded`;
- `jittered_backoff`: full-jitter exponential backoff for retry loops;
- `CircuitBreaker` (`BreakerOpen`): closed, open, half-open around one
  dependency (the LMS's tutoring forward, one per fleet node);
- the metadata keys: the budget, the client's request id, and the
  trailing pair the tutoring node attaches to every answer.

Header names are the wire's, so JAX-package and port processes understand
each other. Everything takes an injectable `clock`.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .locks import make_lock

# Remaining budget in milliseconds (relative: survives clock skew).
DEADLINE_METADATA_KEY = "x-deadline-budget-ms"
# The client's logical request id (names the trace of an untraced caller).
REQUEST_ID_METADATA_KEY = "x-request-id"
# Trailing metadata on every answer: which fleet member served it, and the
# node's live serving-queue depth (a passive load signal for the router).
SERVED_BY_METADATA_KEY = "x-served-by"
QUEUE_DEPTH_METADATA_KEY = "x-queue-depth"


def _metadata_value(metadata: Any, key: str) -> Optional[str]:
    """First value for `key` in gRPC metadata (pairs or a mapping)."""
    if metadata is None:
        return None
    items = metadata.items() if hasattr(metadata, "items") else metadata
    for k, v in items:
        if k == key:
            return str(v)
    return None


def request_id_from_grpc_context(context: Any) -> Optional[str]:
    """The client's logical-request id from metadata; None when absent."""
    try:
        metadata = context.invocation_metadata()
    except Exception:
        return None
    return _metadata_value(metadata, REQUEST_ID_METADATA_KEY) or None


class Overloaded(Exception):
    """Admission refused: a bounded queue is full (maps to
    RESOURCE_EXHAUSTED on the wire)."""


class DeadlineExpired(Exception):
    """The request's time budget ran out (maps to DEADLINE_EXCEEDED)."""


class BreakerOpen(Exception):
    """The circuit breaker is open; the dependency is presumed down."""


class Deadline:
    """An absolute point on a monotonic clock; the request's total budget."""

    __slots__ = ("_deadline", "_clock")

    def __init__(self, deadline: float, *,
                 clock: Callable[[], float] = time.monotonic):
        self._deadline = float(deadline)
        self._clock = clock

    @classmethod
    def after(cls, budget_s: float, *,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + max(0.0, float(budget_s)), clock=clock)

    def remaining(self) -> float:
        """Seconds left; never negative."""
        return max(0.0, self._deadline - self._clock())

    @property
    def expired(self) -> bool:
        return self._clock() >= self._deadline

    def timeout(self, cap: Optional[float] = None) -> float:
        """The per-attempt gRPC timeout for the next hop: the remaining
        budget, optionally capped (headroom for a fallback)."""
        rem = self.remaining()
        return rem if cap is None else min(rem, float(cap))

    def to_metadata(self) -> List[Tuple[str, str]]:
        return [(DEADLINE_METADATA_KEY, str(int(self.remaining() * 1000.0)))]

    @classmethod
    def from_metadata(cls, metadata: Any, *,
                      clock: Callable[[], float] = time.monotonic,
                      ) -> Optional["Deadline"]:
        """Decode the budget header; None when absent or malformed."""
        value = _metadata_value(metadata, DEADLINE_METADATA_KEY)
        if value is None:
            return None
        try:
            return cls.after(int(value) / 1000.0, clock=clock)
        except (TypeError, ValueError):
            return None

    @classmethod
    def from_grpc_context(cls, context: Any, *,
                          clock: Callable[[], float] = time.monotonic,
                          ) -> Optional["Deadline"]:
        """The tighter of the native gRPC deadline and the budget header;
        None when the caller set neither (or there is no context)."""
        budgets = []
        try:
            rem = context.time_remaining()
        except AttributeError:
            rem = None
        if rem is not None and rem == rem and rem < 1e9:
            budgets.append(max(0.0, rem))
        try:
            md = context.invocation_metadata()
        except AttributeError:
            md = None
        from_md = cls.from_metadata(md, clock=clock)
        if from_md is not None:
            budgets.append(from_md.remaining())
        if not budgets:
            return None
        return cls.after(min(budgets), clock=clock)


def jittered_backoff(
    attempt: int,
    *,
    base_s: float = 0.05,
    factor: float = 2.0,
    cap_s: float = 2.0,
    rng: Optional[random.Random] = None,
) -> float:
    """Full-jitter exponential backoff: uniform in [0, min(cap, base·f^n)]
    (full jitter decorrelates a herd of clients re-resolving one dead
    leader)."""
    ceiling = min(float(cap_s), float(base_s) * float(factor) ** max(0, attempt))
    r = rng.random() if rng is not None else random.random()
    return r * ceiling


class CircuitBreaker:
    """Closed / open / half-open breaker around one dependency.

    - CLOSED: calls flow; `failure_threshold` *consecutive* failures open
      the circuit.
    - OPEN: `allow()` is False until `recovery_s` has elapsed, then the
      breaker moves to HALF_OPEN.
    - HALF_OPEN: up to `half_open_max` probe calls are allowed; one success
      closes the circuit, one failure re-opens it (and restarts the
      recovery clock).

    Thread-safe; `on_state_change(old, new)` lets callers mirror the state
    into metrics. The reference names its lock for a lock-order auditor
    the port does not carry; here it is a plain lock.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    _STATE_CODES = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        recovery_s: float = 10.0,
        half_open_max: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_state_change: Optional[Callable[[str, str], None]] = None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.recovery_s = recovery_s
        self.half_open_max = max(1, half_open_max)
        self._clock = clock
        self._on_state_change = on_state_change
        self._lock = make_lock("CircuitBreaker._lock")
        self._state = self.CLOSED        # guarded-by: _lock
        self._consecutive_failures = 0   # guarded-by: _lock
        self._opened_at = 0.0            # guarded-by: _lock
        self._half_open_inflight = 0     # guarded-by: _lock
        self._half_open_since = 0.0      # guarded-by: _lock
        # guarded-by: _lock
        self._stats = {"opened": 0, "rejected": 0, "failures": 0, "successes": 0}

    def _transition(self, new_state: str) -> None:  # guarded-by: _lock
        old, self._state = self._state, new_state
        if new_state is self.OPEN:
            self._opened_at = self._clock()
            self._stats["opened"] += 1
        if new_state is self.HALF_OPEN:
            self._half_open_inflight = 0
            self._half_open_since = self._clock()
        if old != new_state and self._on_state_change is not None:
            # Callbacks are metric writes (non-blocking, never re-entrant
            # into allow()).
            self._on_state_change(old, new_state)

    def set_state_change_callback(
        self, cb: Optional[Callable[[str, str], None]]
    ) -> None:
        """(Re)wire the transition observer after construction."""
        with self._lock:
            self._on_state_change = cb

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:  # guarded-by: _lock
        if (
            self._state is self.OPEN
            and self._clock() - self._opened_at >= self.recovery_s
        ):
            self._transition(self.HALF_OPEN)
        elif (
            self._state is self.HALF_OPEN
            and self._half_open_inflight >= self.half_open_max
            and self._clock() - self._half_open_since >= self.recovery_s
        ):
            # A probe slot leaked (its caller died between allow() and
            # record_*): re-arm after another recovery window.
            self._half_open_since = self._clock()
            self._half_open_inflight = 0

    def allow(self) -> bool:
        """True when a call may proceed (counts a half-open probe slot)."""
        with self._lock:
            self._maybe_half_open()
            if self._state is self.CLOSED:
                return True
            if self._state is self.HALF_OPEN:
                if self._half_open_inflight < self.half_open_max:
                    self._half_open_inflight += 1
                    return True
            self._stats["rejected"] += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._stats["successes"] += 1
            self._consecutive_failures = 0
            if self._state is not self.CLOSED:
                self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._stats["failures"] += 1
            self._consecutive_failures += 1
            if self._state is self.HALF_OPEN:
                self._transition(self.OPEN)
            elif (
                self._state is self.CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._transition(self.OPEN)

    def state_code(self) -> float:
        """Numeric encoding for a metrics gauge (0/1/2)."""
        return self._STATE_CODES[self.state]

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            self._maybe_half_open()
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                **self._stats,
            }
