"""Request budgets and admission errors for the tutoring path.

The port's own copy of the part of `distributed_lms_raft_llm_tpu/utils/
resilience.py` the tutoring node uses: `Deadline` (one request-scoped time
budget, recovered server-side from the gRPC deadline and the explicit
budget header), `DeadlineExpired`, `Overloaded`, and the trailing-metadata
keys the node attaches to every answer. Header names are the wire's, so a
JAX-package LMS and this node understand each other.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

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


class Overloaded(Exception):
    """Admission refused: a bounded queue is full (maps to
    RESOURCE_EXHAUSTED on the wire)."""


class DeadlineExpired(Exception):
    """The request's time budget ran out (maps to DEADLINE_EXCEEDED)."""


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
