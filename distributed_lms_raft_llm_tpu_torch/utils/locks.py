"""Runtime lock-order enforcement — the dynamic counterpart of the
``lock-order`` lint rule (analysis/rules/lock_order.py).

The port's copy of `distributed_lms_raft_llm_tpu/utils/locks.py`,
its logic as it is but for one repair: the metrics sink is bumped after
the state lock is released (`_count_violations`), since a `Metrics` sink
takes a named lock whose acquisition takes the state lock again. The
port's named locks record into this module's graph, under the JAX
package's declaration names.

The static rule proves the repo's lock-*acquisition-order graph* acyclic
from source; this module records the graph the process *actually* walks,
so the two can be cross-checked. :class:`OrderedLock` wraps a
non-reentrant ``threading.Lock`` under a name matching the analysis's
short lock key (``"ClassName._lock"`` — the declaration site). With
recording enabled (the ``ordered_locks`` test fixture; the semester
sim), every successful acquisition:

- pushes the name onto a per-thread held stack,
- adds one ``held -> acquired`` edge per lock already held on this
  thread to the process-wide acquisition graph,
- records a violation if the lock is already held by this thread
  (re-entry on a non-reentrant lock — the PR-13 self-deadlock would be
  caught here *before* wedging, because detection happens while the
  ``acquire`` is still pending), or if the new edge closes a cycle.

Violations are *recorded*, never raised, on the production path: a
serving thread mid-request must degrade, not die. They surface three
ways: :func:`violations` (the sim audit and the ``ordered_locks``
fixture assert it empty), :func:`assert_acyclic` (hard assert for
tests), and the ``lock_order_violations`` counter on whatever metrics
sink :func:`set_metrics_sink` installed.

``make_lock(name)`` is the declaration-site spelling. Recording off
costs one module-global boolean check per acquire; the wrapper is
otherwise a plain ``threading.Lock``. The concurrency engine's
``_LOCK_CTORS`` treats both spellings as threading locks, so converting
a declaration keeps every static rule's view unchanged.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Set, Tuple

__all__ = [
    "OrderedLock",
    "make_lock",
    "recording",
    "enable_recording",
    "disable_recording",
    "reset",
    "acquisition_edges",
    "violations",
    "assert_acyclic",
    "set_metrics_sink",
]

# Process-wide debug state. `_graph` maps lock name -> set of lock names
# acquired while it was held. Guarded by `_state_lock` (a plain leaf
# lock: nothing is ever acquired while holding it, so it cannot
# participate in the ordering it audits).
_state_lock = threading.Lock()
_recording = False
_graph: Dict[str, Set[str]] = {}
_violation_log: List[str] = []
_metrics_sink: Optional[object] = None

_tls = threading.local()


def _held_stack() -> List[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = []
        _tls.held = stack
    return stack


def set_metrics_sink(sink: Optional[object]) -> None:
    """Install a duck-typed metrics object (anything with ``.inc``);
    each recorded violation bumps its ``lock_order_violations`` counter.
    Servers call this at startup; ``None`` detaches."""
    global _metrics_sink
    _metrics_sink = sink


def enable_recording() -> None:
    global _recording
    with _state_lock:
        _recording = True


def disable_recording() -> None:
    global _recording
    with _state_lock:
        _recording = False


def reset() -> None:
    """Clear the recorded graph and violation log (not the held stacks:
    those empty themselves as the owning threads release)."""
    with _state_lock:
        _graph.clear()
        del _violation_log[:]


@contextmanager
def recording() -> Iterator[None]:
    """Scoped recording for tests: enable, run, disable — the recorded
    graph and violations stay readable after exit for assertions."""
    enable_recording()
    try:
        yield
    finally:
        disable_recording()


def acquisition_edges() -> Set[Tuple[str, str]]:
    """Snapshot of the live ``held -> acquired`` edge set."""
    with _state_lock:
        return {(src, dst) for src, dsts in _graph.items() for dst in dsts}


def violations() -> List[str]:
    with _state_lock:
        return list(_violation_log)


def _find_cycle() -> Optional[List[str]]:
    """One cycle in the recorded graph as a name path, or None.
    Iterative coloring DFS, sorted neighbors — deterministic output."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    for root in sorted(_graph):
        if color.get(root, WHITE) != WHITE:
            continue
        # (node, remaining-neighbors) stack; path mirrors the gray chain.
        stack: List[Tuple[str, List[str]]] = [
            (root, sorted(_graph.get(root, ())))
        ]
        color[root] = GRAY
        path = [root]
        while stack:
            node, nbrs = stack[-1]
            if nbrs:
                nxt = nbrs.pop(0)
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    return path[path.index(nxt):] + [nxt]
                if c == WHITE:
                    color[nxt] = GRAY
                    path.append(nxt)
                    stack.append((nxt, sorted(_graph.get(nxt, ()))))
            else:
                color[node] = BLACK
                path.pop()
                stack.pop()
    return None


def assert_acyclic() -> None:
    """Hard assertion for tests: no recorded violations, and the live
    acquisition graph has no cycle (belt-and-braces — a cycle whose
    closing edge raced two threads is caught here even if each edge
    looked fine when added)."""
    with _state_lock:
        if _violation_log:
            raise AssertionError(
                "lock-order violations recorded: " + "; ".join(_violation_log)
            )
        cycle = _find_cycle()
        if cycle is not None:
            raise AssertionError(
                "lock acquisition graph has a cycle: " + " -> ".join(cycle)
            )


def _record_violation(message: str) -> None:
    # Caller holds _state_lock.
    _violation_log.append(message)


def _count_violations(n: int) -> None:
    """Bump the sink's counter by `n`. Called with `_state_lock`
    released: a `Metrics` sink takes a named lock of its own, whose
    acquisition takes `_state_lock` again (the JAX package's auditor
    calls its sink under the lock and so wedges the thread that records
    a violation)."""
    metrics = _metrics_sink
    if n and metrics is not None:
        try:
            metrics.inc("lock_order_violations", n)  # type: ignore[attr-defined]
        except Exception:  # noqa: BLE001 — auditing must not break serving
            pass


class OrderedLock:
    """A named, non-reentrant ``threading.Lock`` that feeds the live
    acquisition graph when recording is enabled. Name it after the
    declaration site (``"ClassName._lock"``) so the runtime graph lines
    up with ``ConcurrencyEngine.static_order_shorts()``."""

    __slots__ = ("_name", "_lock")

    def __init__(self, name: str) -> None:
        self._name = name
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self._name

    def _note_acquired(self) -> None:
        held = _held_stack()
        # Unlocked fast-path read: a stale False skips at most the edges
        # of acquisitions racing enable_recording() itself.
        if not _recording:
            held.append(self._name)
            return
        with _state_lock:
            before = len(_violation_log)
            if _recording:
                if self._name in held:
                    # The acquire below would self-deadlock; record it
                    # NOW so the hang is diagnosable from the log.
                    _record_violation(
                        f"re-entry: {self._name} acquired while already "
                        f"held by this thread (held: {held})"
                    )
                for h in held:
                    if h == self._name:
                        continue
                    dsts = _graph.setdefault(h, set())
                    if self._name not in dsts:
                        dsts.add(self._name)
                        cycle = _find_cycle()
                        if cycle is not None:
                            _record_violation(
                                f"cycle closed by {h} -> {self._name}: "
                                + " -> ".join(cycle)
                            )
            recorded = len(_violation_log) - before
        _count_violations(recorded)
        held.append(self._name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Edges are recorded BEFORE the blocking acquire so that the
        # acquisition that wedges a thread is already in the graph and
        # the violation log names it.
        self._note_acquired()
        ok = self._lock.acquire(blocking, timeout)
        if not ok:
            self._unwind()
        return ok

    def _unwind(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self._name:
                del held[i]
                break

    def release(self) -> None:
        self._lock.release()
        self._unwind()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        state = "locked" if self._lock.locked() else "unlocked"
        return f"<OrderedLock {self._name} {state}>"


def make_lock(name: str) -> OrderedLock:
    """Declaration-site factory: ``self._lock = make_lock("Cls._lock")``.
    Always returns an :class:`OrderedLock`; with recording disabled the
    overhead is one boolean check per acquisition."""
    return OrderedLock(name)
