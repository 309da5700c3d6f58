"""The replicated host loop of a sharded engine.

JAX drives a sharded engine from one controller. The port runs one process
a rank (multi-controller SPMD) over the engine's tp x ep x sp ranks: every
rank builds the same engine (its parameters and KV planes hold only its
shard: its heads, its experts) and runs the same host loop,
so every rank launches the same kernels and meets its peers in the same
collectives. Rank 0 alone takes requests; the other ranks follow it:

- a call that changes host state without running the model (a submission,
  a cancellation, a session mark, a reset) runs on rank 0 at once and is
  recorded;
- a call that runs the model (a step, warmup, a score batch, a generate)
  first broadcasts the calls recorded since the last one, itself, and rank
  0's monotonic clock; each follower applies them in that order, then makes
  the same call (`Replica.follow`). Nested calls (warmup's own submissions
  and steps) run on every rank as part of their outer call and are not
  sent;
- a call that another thread makes while a model call may run (the server
  releasing a session's prefix pin, a stream's consumer unwatching it, both
  from the event loop while a step runs in an executor thread) is deferred:
  rank 0 records it and every rank, rank 0 included, applies it at the next
  broadcast (or at `stop`), so the ranks' trees change at the same point of
  the loop. Nesting is counted per thread, so a call from another thread is
  never taken for part of the call in progress. Rank 0 applies the deferred
  calls after the recorded ones a follower applies them among; the deferred
  calls (`release_session`, `stream_unwatch`) commute with those.

Everything the host loop then decides (admission, megastep K, prefix hits,
reaps) follows from the same inputs in the same order and from the device
results, which the collectives make equal on every rank (the logits are
gathered whole; every rank samples with an equally seeded generator). What
would read a clock of its own, the prefix cache's session expiry, reads
the clock rank 0 sent with the call instead (`Replica.now`).

A call that raises on any rank leaves the ranks out of step: the others
may wait in a collective it never reaches, or meet the next step's
broadcast with the wrong collective. So it fails the group: the rank
aborts the process group (its peers' collectives then raise rather than
wait) and raises `TensorParallelFailure`, and every later call on it
raises the same at once. A follower's `follow` returns by raising it, and
its process should exit non-zero; the tutoring node then ends rank 0 too
(`serving/tutoring_server.py`). There is no way back into step short of
starting the ranks again.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref
from typing import Any, Callable, List, Optional, Tuple

from .mesh import SINGLE, TensorParallel

log = logging.getLogger(__name__)

STOP = "stop"


class TensorParallelFailure(RuntimeError):
    """A call under tp raised on some rank: the ranks may be out of step,
    and the process group was aborted."""


class Replica:
    """One engine's side of the replicated loop over `tp`: the engine's
    tp axis where its ranks are its tp ranks, else every rank of its mesh
    (`Mesh.world`); its name heads the errors.
    `owner` is the engine whose methods the followers replay (by name),
    held weakly (an engine keeps its Replica; a strong reference back
    would keep every engine, its cache and its graphs, alive until a full
    garbage collection); a follower calls its `_followed(name, result)`,
    where it has one, after each replayed call."""

    def __init__(self, owner: Any, tp: TensorParallel = SINGLE):
        self._owner = weakref.ref(owner)
        self.tp = tp
        # (name, args, deferred) recorded on rank 0 since the last
        # broadcast; guarded by _lock.
        self._ops: List[Tuple[str, tuple, bool]] = []
        self._lock = threading.Lock()
        # Held by rank 0's outermost call for its whole body, and by stop:
        # the calls of two threads never interleave their collectives.
        self._busy = threading.Lock()
        # Each thread's nesting depth (`_depth`).
        self._local = threading.local()
        self._stopped = False
        # Why the group failed (`_fail`); None while it works.
        self.failed: Optional[str] = None
        # Rank 0's clock at the model call being run (every rank reads the
        # same); None until the first one.
        self.now: Optional[float] = None

    @property
    def active(self) -> bool:
        return self.tp.size > 1

    @property
    def _depth(self) -> int:
        """How deep this thread is in calls of this Replica."""
        return getattr(self._local, "depth", 0)

    @contextlib.contextmanager
    def _nested(self):
        self._local.depth = self._depth + 1
        try:
            yield
        finally:
            self._local.depth -= 1

    def clock(self) -> float:
        """The time decisions read: rank 0's at the current model call."""
        return time.monotonic() if self.now is None else self.now

    def _check_caller(self, name: str) -> None:
        if not self.tp.leader:
            raise RuntimeError(
                f"{name}() on {self.tp.name} rank {self.tp.rank}: a follower takes its "
                f"calls from rank 0 (Replica.follow), never from a caller")
        if self.failed is not None:
            raise TensorParallelFailure(
                f"{name}() after the {self.tp.name} group failed: "
                f"{self.failed}")
        if self._stopped:
            raise RuntimeError(f"{name}() after the followers were stopped")

    def _fail(self, name: str, exc: BaseException) -> TensorParallelFailure:
        """`name()` raised `exc` on this rank: mark the group failed, abort
        the process group (once) and return the error to raise."""
        msg = (f"{self.tp.name} rank {self.tp.rank}: {name}() raised "
               f"{type(exc).__name__}: {exc}; the ranks may be out of step, "
               f"so the process group is aborted")
        if self.failed is None:
            self.failed = msg
            log.error("%s", msg)
            self.tp.abort()
        return TensorParallelFailure(msg)

    def _apply(self, batch) -> None:
        """Rank 0: apply the deferred calls of a batch just broadcast."""
        owner = self._owner()
        with self._nested():
            for n, a, deferred in batch:
                if deferred:
                    getattr(owner, n)(*a)

    @contextlib.contextmanager
    def call(self, name: str, *args, collective: bool = False):
        """Run the body of the public call `name(*args)` on this rank:
        recorded on rank 0 (`collective=False`), or broadcast with the
        calls recorded before it (`collective=True`, a call that runs the
        model). A call nested in one of this thread's, or replayed, just
        runs. Rank 0's calls from two threads run one after the other; a
        body that raises fails the group."""
        if not self.active or self._depth:
            with self._nested():
                yield
            return
        self._check_caller(name)
        with self._busy:
            # The group may have failed or stopped while this thread waited.
            self._check_caller(name)
            with self._lock:
                if collective:
                    batch, self._ops = self._ops, []
                else:
                    self._ops.append((name, args, False))
            try:
                if collective:
                    now = time.monotonic()
                    self.tp.broadcast_object(
                        ([(n, a) for n, a, _ in batch] + [(name, args)], now))
                    self.now = now
                    self._apply(batch)
                with self._nested():
                    yield
            except Exception as e:
                raise self._fail(name, e) from e

    def defer(self, name: str, *args) -> bool:
        """On rank 0, from a thread that is not inside a call of its own
        (another thread's step may be running): record `name(*args)` to be
        applied on every rank at the next model call, and return True (the
        caller returns without running its body). Else (one rank, a call
        nested in this thread's, a follower's replay) False: run the
        body."""
        if not self.active or self._depth:
            return False
        self._check_caller(name)
        with self._lock:
            self._ops.append((name, args, True))
        return True

    def follow(self, on_result: Optional[Callable[[str, Any], None]] = None
               ) -> None:
        """A follower's loop: apply rank 0's calls as they come, until rank
        0 stops (`stop`). `on_result(name, result)`, where given, sees each
        replayed call's result (a check that the ranks agree). A call that
        raises here, or a broadcast that fails, fails the group and raises
        `TensorParallelFailure`."""
        if not self.active or self.tp.leader:
            raise RuntimeError("follow() runs on a rank other than 0")
        owner = self._owner()
        followed = getattr(owner, "_followed", None)
        while True:
            try:
                batch, now = self.tp.broadcast_object()
            except Exception as e:
                raise self._fail("follow", e) from e
            self.now = now
            for name, args in batch:
                if name == STOP:
                    self._stopped = True
                    return
                try:
                    with self._nested():
                        result = getattr(owner, name)(*args)
                except Exception as e:
                    raise self._fail(name, e) from e
                if on_result is not None:
                    on_result(name, result)
                if followed is not None:
                    followed(name, result)

    def stop(self) -> None:
        """Rank 0: release the followers from `follow` (their engines stay
        built), every rank applying the calls deferred since the last
        broadcast first. Idempotent; a no-op without followers or after
        the group failed."""
        if not self.active or not self.tp.leader:
            return
        with self._busy:
            if self._stopped or self.failed is not None:
                return
            with self._lock:
                batch, self._ops = self._ops, []
            try:
                self.tp.broadcast_object(
                    ([(n, a) for n, a, _ in batch] + [(STOP, ())],
                     time.monotonic()))
                self._stopped = True
                self._apply(batch)
            except Exception as e:
                raise self._fail("stop", e) from e
