"""Dynamic request batching for the tutoring engine.

Port of `BatchingQueue` from `distributed_lms_raft_llm_tpu/engine/
batcher.py`. The wire contract is unary (one query per `GetLLMAnswer`), so
concurrent queries are coalesced inside the server: a request waits at
most `max_wait_ms` for companions, then the group runs as one
`engine.answer_batch` call off the event loop.

Admission is bounded: beyond `max_queue` waiting requests `submit()`
raises `Overloaded` (RESOURCE_EXHAUSTED on the wire). A request whose
`Deadline` expires while queued is dropped before its prefill runs.

The JAX package's scoring tenant and trace spans come with later slices.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import List, Optional, Tuple

from ..utils.resilience import Deadline, DeadlineExpired, Overloaded

log = logging.getLogger(__name__)

# Queue items: (prompt, deadline-or-None, result future).
_Item = Tuple[str, Optional[Deadline], asyncio.Future]

# Engine program name -> its dispatch-time histogram.
PROGRAM_HISTOGRAMS = {"generate": "engine_prog_generate"}


class BatchingQueue:
    """Coalesces submit() calls into engine.answer_batch() invocations."""

    def __init__(self, engine, max_batch: int = 8, max_wait_ms: float = 10.0,
                 metrics=None, max_queue: int = 0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.metrics = metrics
        self.max_queue = max_queue  # 0 = unbounded
        # Loop-confined: touched only from coroutines on the serving loop;
        # the engine call alone leaves the loop, with plain prompts.
        self._queue: asyncio.Queue[_Item] = asyncio.Queue()
        self._runner: Optional[asyncio.Task] = None
        self._closed = False

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    @property
    def waiting(self) -> int:
        """Requests admitted but not yet in a device batch."""
        return self._queue.qsize()

    async def start(self) -> None:
        if self._runner is None:
            self._runner = asyncio.create_task(self._run())

    async def close(self) -> None:
        self._closed = True
        if self._runner is not None:
            self._runner.cancel()
            try:
                await self._runner
            except asyncio.CancelledError:
                pass
            self._runner = None
        while not self._queue.empty():
            _, _, fut = self._queue.get_nowait()
            if not fut.done():
                fut.set_exception(RuntimeError("batching queue closed"))

    async def submit(self, prompt: str,
                     deadline: Optional[Deadline] = None) -> str:
        """Enqueue one query; resolves with its decoded answer.

        Raises `Overloaded` when the bounded queue is full and
        `DeadlineExpired` when the budget is already gone, both before the
        request takes a queue slot.
        """
        if self._closed:
            raise RuntimeError("batching queue is closed")
        if deadline is not None and deadline.expired:
            self._inc("shed_expired")
            raise DeadlineExpired("expired before enqueue")
        if self.max_queue and self._queue.qsize() >= self.max_queue:
            self._inc("shed_overload")
            raise Overloaded(
                f"tutoring queue full ({self._queue.qsize()} waiting)"
            )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((prompt, deadline, fut))
        return await fut

    async def _collect(self, first: _Item) -> List[_Item]:
        """Gather companions for the (already-popped) first request."""
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = await asyncio.wait_for(self._queue.get(),
                                              timeout=remaining)
                group.append(item)
            except asyncio.TimeoutError:
                break
        return group

    def _drop_expired(self, group: List[_Item]) -> List[_Item]:
        """Shed queue-expired requests before their prefill dispatches."""
        live: List[_Item] = []
        for item in group:
            _, dl, fut = item
            if dl is not None and dl.expired:
                self._inc("shed_expired")
                if not fut.done():
                    fut.set_exception(
                        DeadlineExpired("expired while queued; prefill skipped")
                    )
            else:
                live.append(item)
        return live

    def _observe_program_times(self) -> None:
        pop = getattr(self.engine, "pop_program_times", None)
        entries = pop() if pop is not None else []
        if self.metrics is None:
            return
        for pname, _start, wall_s in entries:
            if pname in PROGRAM_HISTOGRAMS:
                self.metrics.hist(PROGRAM_HISTOGRAMS[pname]).observe(wall_s)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            group = self._drop_expired(await self._collect(first))
            if not group:
                continue  # everything expired while queued: zero prefills
            if self.metrics is not None:
                self.metrics.set_gauge("serving_queue_depth",
                                       float(self.waiting))
            prompts = [p for p, _, _ in group]
            try:
                # The engine call blocks on device compute; run it off-loop
                # so new requests keep queueing meanwhile.
                self._inc("engine_batches")
                answers = await loop.run_in_executor(
                    None, self.engine.answer_batch, prompts
                )
            except asyncio.CancelledError:
                for _, _, fut in group:
                    if not fut.done():
                        fut.set_exception(RuntimeError("batching queue closed"))
                raise
            except Exception as e:  # resolve all waiters with the failure
                log.exception("batch of %d failed", len(prompts))
                self._observe_program_times()
                for _, _, fut in group:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._observe_program_times()
            ttfts = getattr(self.engine, "last_batch_ttfts", [])
            if self.metrics is not None:
                for ttft in ttfts[:len(group)]:
                    self.metrics.hist("ttft").observe(ttft)
            for (_, _, fut), answer in zip(group, answers):
                if not fut.done():
                    fut.set_result(answer)
