"""Flight-recorder request tracing for the tutoring node.

The port's own trimmed copy of `distributed_lms_raft_llm_tpu/utils/
tracing.py` (a Dapper-style tracer), with what a tutoring node needs:

- **Span trees.** `Tracer.span(name)` nests under the contextvar-tracked
  current span; `Span.child` / `child_timed` attach spans across tasks and
  after the fact (the queue's `queue.wait` and `engine.*` spans).
  Durations come from the monotonic clock, positions from the wall clock,
  so fragments recorded by different processes line up on one waterfall.
- **Cross-process continuation.** A handler continues the caller's
  `x-trace-context` (`<trace_id>/<span_id>`, what the JAX package's LMS and
  `TutoringPool` send) as a remote-parented fragment
  (`continue_from_grpc_context`), else opens a trace named by the caller's
  `x-request-id`. `GET /admin/trace/<id>` serves this node's fragments,
  which the JAX package's `scripts/trace_report.py` merges with the LMS's.
- **Flight recorder.** A bounded ring of traces; traces flagged (error,
  deadline exhausted) are pinned, and so are the slowest few per route.

Left out (no use on a tutoring node): outgoing propagation
(`trace_metadata`), `configure_from` a TOML section, `records()`,
`reset()`, the `degraded` flag.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import copy
import functools
import inspect
import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .resilience import REQUEST_ID_METADATA_KEY, _metadata_value

# Metadata key carrying `<trace_id>/<span_id>` of the caller's position.
TRACE_METADATA_KEY = "x-trace-context"

# Flight-recorder flags: traces carrying any of these are pinned past ring
# eviction.
FLAG_ERROR = "error"
FLAG_DEADLINE = "deadline_exhausted"


def _new_id() -> str:
    """64-bit hex id. Uniqueness for correlation, not cryptographic."""
    return f"{random.getrandbits(64):016x}"


class Span:
    """One timed operation. Mutated only by its owning thread/task until
    `end()`; afterwards read-only (the store renders it under its lock)."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_unix",
        "_t0", "duration_s", "attrs", "status", "children", "root",
        "flags", "_tracer",
    )

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent: Optional["Span"], parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent.span_id if parent is not None else parent_id
        self.start_unix = tracer._wall()
        self._t0 = tracer._clock()
        self.duration_s: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.status = "ok"
        self.children: List["Span"] = []
        # The fragment root (self, for roots): flags and completion are
        # tracked there; `flag()` on any descendant marks the fragment.
        self.root: "Span" = parent.root if parent is not None else self
        self.flags: set = set()
        self._tracer = tracer
        if parent is not None:
            parent.children.append(self)

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def set_status(self, status: str) -> "Span":
        self.status = status
        return self

    def flag(self, name: str) -> "Span":
        """Mark this span's whole fragment anomalous: the flight recorder
        pins the trace so it survives ring eviction."""
        self.root.flags.add(name)
        return self

    def child(self, name: str, **attrs: Any) -> "Span":
        """Manually managed child (queue wait across tasks). Starts now;
        the caller must `end()` it."""
        return Span(self._tracer, name, self.trace_id, self, None, attrs)

    def child_timed(self, name: str, start_unix: float, duration_s: float,
                    **attrs: Any) -> "Span":
        """After-the-fact child for an interval measured elsewhere (engine
        dispatch times, attached at the reap)."""
        sp = Span(self._tracer, name, self.trace_id, self, None, attrs)
        sp.start_unix = start_unix
        sp.duration_s = max(0.0, float(duration_s))
        return sp

    def end(self, duration_s: Optional[float] = None) -> None:
        """Close the span. `duration_s` overrides the measured wall time
        when the true interval was measured elsewhere (the engine's queue
        wait). Idempotent: a second end keeps the first measurement."""
        if self.duration_s is not None:
            return
        self.duration_s = (
            max(0.0, float(duration_s)) if duration_s is not None
            else self._tracer._clock() - self._t0
        )
        if self is self.root:
            self._tracer._record_fragment(self)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name,
            "span_id": self.span_id,
            "start_s": self.start_unix,
            "duration_s": round(
                self.duration_s if self.duration_s is not None
                else self._tracer._clock() - self._t0, 6),
        }
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        if self.status != "ok":
            out["status"] = self.status
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


def _dict_span_count(span: Dict[str, Any]) -> int:
    return 1 + sum(_dict_span_count(c) for c in span.get("children", ()))


def _trim_to_budget(span: Dict[str, Any], budget: int) -> int:
    """Truncate a span-dict subtree in place to at most `budget` spans,
    preorder keep-first (the span itself always survives). Returns the
    number of spans kept."""
    kept = 1
    keep: List[Dict[str, Any]] = []
    for child in span.get("children", ()):
        if kept >= budget:
            break
        kept += _trim_to_budget(child, budget - kept)
        keep.append(child)
    if "children" in span:
        if keep:
            span["children"] = keep
        else:
            del span["children"]
    return kept


class _NullSpan:
    """No-op span: what `span()` yields outside any trace (and everything
    when tracing is disabled), so instrumentation never branches."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    duration_s = 0.0
    attrs: Dict[str, Any] = {}

    def set_attr(self, key: str, value: Any) -> "_NullSpan":
        return self

    def set_status(self, status: str) -> "_NullSpan":
        return self

    def flag(self, name: str) -> "_NullSpan":
        return self

    def child(self, name: str, **attrs: Any) -> "_NullSpan":
        return self

    def child_timed(self, name: str, start_unix: float, duration_s: float,
                    **attrs: Any) -> "_NullSpan":
        return self

    def end(self, duration_s: Optional[float] = None) -> None:
        pass


NULL_SPAN = _NullSpan()


class _TraceRecord:
    """Everything retained for one trace id."""

    __slots__ = ("trace_id", "route", "start_unix", "duration_s", "flags",
                 "fragments", "span_total", "pins")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.route = ""
        self.start_unix = float("inf")
        self.duration_s = 0.0
        self.flags: set = set()
        # Pure-dict snapshots (`Span.to_dict` at record time), immune to
        # late mutation of the live Span tree.
        self.fragments: List[Dict[str, Any]] = []
        self.span_total = 0
        self.pins: set = set()

    def summary(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "route": self.route,
            "duration_s": round(self.duration_s, 6),
            "flags": sorted(self.flags),
            "spans": self.span_total,
            "pinned": sorted(self.pins),
        }


class Tracer:
    """Span factory + the bounded flight-recorder store."""

    def __init__(self, *, enabled: bool = True, ring_size: int = 256,
                 exemplars_per_route: int = 4, flagged_max: int = 64,
                 max_spans_per_trace: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self.enabled = enabled
        self.ring_size = max(1, int(ring_size))
        self.exemplars_per_route = max(0, int(exemplars_per_route))
        self.flagged_max = max(0, int(flagged_max))
        self.max_spans_per_trace = max(1, int(max_spans_per_trace))
        self._clock = clock
        self._wall = wall
        self._current: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar("port_current_span", default=None))
        self._lock = threading.Lock()
        self._records: Dict[str, _TraceRecord] = {}     # guarded-by: _lock
        # Unpinned retention order (pinned records live only in _records).
        self._ring: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict())                  # guarded-by: _lock
        # Flagged pin order, oldest first (bounded by flagged_max).
        self._flagged: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict())                  # guarded-by: _lock
        # route -> sorted list of (duration_s, trace_id).
        self._slowest: Dict[str, List[Tuple[float, str]]] = {}  # guarded-by: _lock

    # ------------------------------------------------------------- spanning

    def current(self) -> Optional[Span]:
        return self._current.get()

    @contextlib.contextmanager
    def trace(self, name: str, trace_id: Optional[str] = None,
              **attrs: Any) -> Iterator[Any]:
        """Open a new root span (a fresh trace)."""
        if not self.enabled:
            yield NULL_SPAN
            return
        span = Span(self, name, trace_id or _new_id(), None, None, attrs)
        yield from self._run_span(span)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Any]:
        """Child of the current span; a no-op outside any trace."""
        parent = self._current.get()
        if parent is None or not self.enabled:
            yield NULL_SPAN
            return
        span = Span(self, name, parent.trace_id, parent, None, attrs)
        yield from self._run_span(span)

    @contextlib.contextmanager
    def continue_trace(self, name: str, trace_id: str,
                       parent_span_id: Optional[str],
                       **attrs: Any) -> Iterator[Any]:
        """A remote-parented fragment root: this process's piece of a
        trace whose parent span lives in the calling process."""
        if not self.enabled:
            yield NULL_SPAN
            return
        span = Span(self, name, trace_id, None, parent_span_id, attrs)
        yield from self._run_span(span)

    def _run_span(self, span: Span) -> Iterator[Span]:
        token = self._current.set(span)
        try:
            yield span
        except BaseException:
            span.set_status("error")
            span.flag(FLAG_ERROR)
            raise
        finally:
            try:
                self._current.reset(token)
            except ValueError:
                # A span opened inside an async generator can be unwound
                # from another task than the one that entered it; that
                # task's context copy died with it: nothing to restore.
                pass
            span.end()

    def continue_from_grpc_context(self, context: Any, name: str,
                                   **attrs: Any):
        """Fragment root for a server-side handler: parented on the
        caller's `x-trace-context` when present, otherwise a fresh trace
        whose id is the caller's `x-request-id`, otherwise random."""
        if not self.enabled:
            return self.trace(name)
        try:
            md = context.invocation_metadata()
        except Exception:
            md = None
        parsed = parse_trace_context(_metadata_value(md, TRACE_METADATA_KEY))
        if parsed is not None:
            return self.continue_trace(name, parsed[0], parsed[1], **attrs)
        rid = _metadata_value(md, REQUEST_ID_METADATA_KEY)
        return self.trace(name, trace_id=rid or None, **attrs)

    # ---------------------------------------------------------------- store

    def _record_fragment(self, root: Span) -> None:
        # Snapshot before storing: a late child attached to the live tree
        # must not mutate the recorded one.
        snap = root.to_dict()
        n = _dict_span_count(snap)
        with self._lock:
            rec = self._records.get(root.trace_id)
            if rec is None:
                rec = _TraceRecord(root.trace_id)
                self._records[root.trace_id] = rec
                self._ring[root.trace_id] = None
            budget = self.max_spans_per_trace - rec.span_total
            if n > budget:
                # Keep the first spans, not none: the runaway request is
                # the trace the recorder exists to keep.
                rec.flags.add("truncated")
                if budget > 0:
                    rec.span_total += _trim_to_budget(snap, budget)
                    rec.fragments.append(snap)
            else:
                rec.fragments.append(snap)
                rec.span_total += n
            rec.flags |= root.flags
            # The outermost fragment (earliest start) names the route and
            # the headline duration.
            if root.start_unix < rec.start_unix or not rec.route:
                old_route = rec.route
                rec.start_unix = root.start_unix
                rec.route = root.name
                rec.duration_s = root.duration_s or 0.0
                if old_route and old_route != rec.route:
                    self._drop_slowest_entry(old_route, rec.trace_id)
            if root.trace_id in self._ring:
                self._ring.move_to_end(root.trace_id)
            self._pin_if_anomalous(rec)
            self._pin_if_slow(rec)
            self._evict()

    def _pin(self, rec: _TraceRecord, pin: str) -> None:  # guarded-by: _lock
        rec.pins.add(pin)
        self._ring.pop(rec.trace_id, None)

    def _unpin(self, trace_id: str, pin: str) -> None:  # guarded-by: _lock
        rec = self._records.get(trace_id)
        if rec is None:
            return
        rec.pins.discard(pin)
        if not rec.pins and trace_id not in self._ring:
            # Back into the ring at the OLD end: an ex-pin must not outrank
            # genuinely newer traces.
            self._ring[trace_id] = None
            self._ring.move_to_end(trace_id, last=False)
            self._evict()

    def _pin_if_anomalous(self, rec: _TraceRecord) -> None:  # guarded-by: _lock
        if not (rec.flags - {"truncated"}) or self.flagged_max == 0:
            return
        if rec.trace_id not in self._flagged:
            self._flagged[rec.trace_id] = None
        self._pin(rec, "flagged")
        while len(self._flagged) > self.flagged_max:
            old, _ = self._flagged.popitem(last=False)
            self._unpin(old, "flagged")

    def _drop_slowest_entry(self, route: str, trace_id: str) -> None:  # guarded-by: _lock
        heap = self._slowest.get(route)
        if not heap:
            return
        kept = [(d, t) for d, t in heap if t != trace_id]
        if len(kept) != len(heap):
            self._slowest[route] = kept
            self._unpin(trace_id, "slowest")

    def _pin_if_slow(self, rec: _TraceRecord) -> None:  # guarded-by: _lock
        if self.exemplars_per_route == 0 or not rec.route:
            return
        heap = self._slowest.setdefault(rec.route, [])
        for i, (dur, tid) in enumerate(heap):
            if tid == rec.trace_id:
                heap[i] = (max(dur, rec.duration_s), tid)
                heap.sort()
                return
        if len(heap) < self.exemplars_per_route:
            heap.append((rec.duration_s, rec.trace_id))
            heap.sort()
            self._pin(rec, "slowest")
        elif heap and rec.duration_s > heap[0][0]:
            _, displaced = heap[0]
            heap[0] = (rec.duration_s, rec.trace_id)
            heap.sort()
            self._unpin(displaced, "slowest")
            self._pin(rec, "slowest")

    def _evict(self) -> None:  # guarded-by: _lock
        # `ring_size` bounds the unpinned ring only; pins ride on top.
        while len(self._ring) > self.ring_size:
            tid, _ = self._ring.popitem(last=False)
            self._records.pop(tid, None)

    # ---------------------------------------------------------------- query

    def tree(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The assembled span forest for one trace id: fragments whose
        remote parent is in another local fragment are grafted under it;
        the rest are roots (their parents live in another process)."""
        with self._lock:
            rec = self._records.get(trace_id)
            if rec is None:
                return None
            fragments = copy.deepcopy(rec.fragments)
            return {
                "trace_id": rec.trace_id,
                "route": rec.route,
                "flags": sorted(rec.flags),
                "duration_s": round(rec.duration_s, 6),
                "spans": assemble_forest(fragments),
            }

    def summaries(self, recent: int = 50) -> Dict[str, Any]:
        """The `/admin/trace` listing: pinned exemplars plus the most
        recent unpinned traces."""
        with self._lock:
            pinned = [r.summary() for r in self._records.values() if r.pins]
            pinned.sort(key=lambda s: -s["duration_s"])
            tail = [self._records[tid].summary()
                    for tid in list(self._ring)[-recent:]
                    if tid in self._records]
        tail.reverse()
        return {"exemplars": pinned, "recent": tail}


def assemble_forest(fragments: Sequence[Dict[str, Any]],
                    ) -> List[Dict[str, Any]]:
    """Merge fragment dicts into a forest: a fragment whose `parent_id`
    names a span inside another fragment becomes that span's child; the
    rest stay roots."""
    index: Dict[str, Dict[str, Any]] = {}

    def walk(span: Dict[str, Any]) -> None:
        index[span["span_id"]] = span
        for c in span.get("children", ()):
            walk(c)

    for frag in fragments:
        walk(frag)
    roots: List[Dict[str, Any]] = []
    for frag in fragments:
        parent = index.get(frag.get("parent_id", ""))
        if parent is not None and parent is not frag:
            parent.setdefault("children", []).append(frag)
        else:
            roots.append(frag)
    roots.sort(key=lambda s: s.get("start_s", 0.0))
    return roots


def parse_trace_context(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """`"<trace_id>/<span_id>"` -> (trace_id, span_id); None if absent or
    malformed (a bad header degrades to a fresh trace, never an error)."""
    if not value or "/" not in value:
        return None
    trace_id, _, span_id = value.partition("/")
    if not trace_id or not span_id:
        return None
    return trace_id, span_id


# ------------------------------------------------------- process singleton

_tracer = Tracer()
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer every component shares."""
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the global tracer (tests; `configure()`)."""
    global _tracer
    with _tracer_lock:
        _tracer = tracer
    return tracer


def configure(*, enabled: bool = True, ring_size: int = 256,
              exemplars_per_route: int = 4, flagged_max: int = 64,
              max_spans_per_trace: int = 512) -> Tracer:
    """Rebuild the global tracer with these knobs (the JAX package's
    `[tracing]` names)."""
    return set_tracer(Tracer(
        enabled=enabled, ring_size=ring_size,
        exemplars_per_route=exemplars_per_route, flagged_max=flagged_max,
        max_spans_per_trace=max_spans_per_trace))


def configure_from(cfg: Any) -> Tracer:
    """`configure()` from a `config.TracingConfig` (`[tracing]`)."""
    return configure(
        enabled=cfg.enabled, ring_size=cfg.ring_size,
        exemplars_per_route=cfg.exemplars_per_route,
        flagged_max=cfg.flagged_max,
        max_spans_per_trace=cfg.max_spans_per_trace)


# --------------------------------------------------------------- adapters


def traced_grpc_handler(name: str) -> Callable:
    """Decorator for async gRPC servicer methods: opens this process's
    fragment for the request (continuing the caller's trace context when
    present) for the duration of the handler; for a server-streaming
    handler, from the first chunk through the final one."""

    def deco(fn: Callable) -> Callable:
        if inspect.isasyncgenfunction(fn):
            @functools.wraps(fn)
            async def gen_wrapper(self: Any, request: Any,
                                  context: Any) -> Any:
                with get_tracer().continue_from_grpc_context(context, name):
                    async for item in fn(self, request, context):
                        yield item

            return gen_wrapper

        @functools.wraps(fn)
        async def wrapper(self: Any, request: Any, context: Any) -> Any:
            with get_tracer().continue_from_grpc_context(context, name):
                return await fn(self, request, context)

        return wrapper

    return deco


def trace_admin_get(path: str) -> Dict[str, Any]:
    """The read-only trace endpoints:

        GET /admin/trace           -> pinned exemplars + recent traces
        GET /admin/trace/<id>      -> the assembled span forest for <id>

    Raises KeyError for unknown paths and ids (the admin plane's 404)."""
    tracer = get_tracer()
    if path == "/admin/trace":
        return {"ok": True, **tracer.summaries()}
    prefix = "/admin/trace/"
    if path.startswith(prefix):
        tree = tracer.tree(path[len(prefix):])
        if tree is None:
            raise KeyError(path)
        return {"ok": True, "trace": tree}
    raise KeyError(path)
