"""Request queues in front of the tutoring engines.

Port of `BatchingQueue` and `PagedQueue` from `distributed_lms_raft_llm_tpu/
engine/batcher.py`. The wire contract is unary (one query per
`GetLLMAnswer`):

- `BatchingQueue` (bucketed `TutoringEngine`) coalesces concurrent queries:
  a request waits at most `max_wait_ms` for companions, then the group
  runs as one `engine.answer_batch` call off the event loop;
- `PagedQueue` (continuous batching, `PagedEngine`) drives the engine step
  by step and hands new submissions to it between dispatches, so a request
  arriving mid-decode joins the running batch at the next dispatch.

Admission is bounded: beyond `max_queue` waiting requests `submit()`
raises `Overloaded` (RESOURCE_EXHAUSTED on the wire). A request whose
`Deadline` expires while queued is dropped before its prefill runs.

The JAX package's scoring tenant, trace spans, streaming and sessions come
with later slices.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Tuple

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


class PagedQueue:
    """Continuous-batching front end over `engine.paged.PagedEngine`.

    Same submit()/start()/close() surface as `BatchingQueue`, different
    scheduling: instead of coalescing a group and running it to completion,
    the worker drives the paged engine step by step; new submissions are
    handed to the engine *between* dispatches, so a request arriving
    mid-decode joins the running batch at the next dispatch boundary (one
    chunk away) rather than queueing behind the whole group.
    """

    def __init__(self, engine, metrics=None, max_queue: int = 0):
        self.engine = engine
        self.metrics = metrics
        self.max_queue = max_queue  # bound on not-yet-admitted requests
        # Loop-confined: the engine's step() runs in an executor thread,
        # but it never sees these containers — admissions and reaps happen
        # on the runner coroutine between steps.
        self._incoming: asyncio.Queue[_Item] = asyncio.Queue()
        self._futures: Dict[int, asyncio.Future] = {}
        # rid -> deadline for requests sitting in the ENGINE's pending list
        # (handed over, no slot yet — prefill hasn't run).
        self._pending_deadlines: Dict[int, Deadline] = {}
        # Cumulative engine dispatch/token counts feeding the
        # host_dispatches_per_token gauge (a run ratio).
        self._dispatch_cum = 0
        self._token_cum = 0
        # Cumulative prefix-cache hit and prompt tokens (the hit-rate gauge).
        self._prefix_hit_cum = 0
        self._prefix_prompt_cum = 0
        self._runner: Optional[asyncio.Task] = None
        self._closed = False

    @property
    def waiting(self) -> int:
        """Requests admitted nowhere yet: queued here plus backlogged in
        the engine. The `max_queue` bound is enforced against this."""
        return self._incoming.qsize() + getattr(self.engine, "backlog", 0)

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

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
        while not self._incoming.empty():
            _, _, fut = self._incoming.get_nowait()
            if not fut.done():
                fut.set_exception(RuntimeError("paged queue closed"))
        futures = list(self._futures.values())
        self._futures.clear()
        self._pending_deadlines.clear()
        for fut in futures:
            if not fut.done():
                fut.set_exception(RuntimeError("paged queue closed"))

    async def submit(self, prompt: str,
                     deadline: Optional[Deadline] = None) -> str:
        """Enqueue one query; resolves with its decoded answer. Raises
        `Overloaded` when the admission bound is reached and
        `DeadlineExpired` when the budget is already gone."""
        if self._closed:
            raise RuntimeError("paged queue is closed")
        if deadline is not None and deadline.expired:
            self._inc("shed_expired")
            raise DeadlineExpired("expired before enqueue")
        if self.max_queue and self.waiting >= self.max_queue:
            self._inc("shed_overload")
            raise Overloaded(
                f"paged admission queue full ({self.waiting} waiting)"
            )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._incoming.put((prompt, deadline, fut))
        return await fut

    def _admit(self, prompt: str, deadline: Optional[Deadline],
               fut: asyncio.Future) -> None:
        # Shed before prefill: a queue-expired request never enters the
        # engine.
        if deadline is not None and deadline.expired:
            self._inc("shed_expired")
            if not fut.done():
                fut.set_exception(
                    DeadlineExpired("expired while queued; prefill skipped")
                )
            return
        rid = self.engine.submit(prompt)
        self._futures[rid] = fut
        if deadline is not None:
            self._pending_deadlines[rid] = deadline

    def _drain_incoming(self) -> None:
        while not self._incoming.empty():
            self._admit(*self._incoming.get_nowait())

    def _shed_expired_pending(self) -> None:
        """Requests that expired while backlogged in the engine's pending
        list are cancelled BEFORE the next step admits them to a slot —
        their prefill never runs. Once a request holds a slot its deadline
        stops mattering (the compute is already committed)."""
        for rid, dl in list(self._pending_deadlines.items()):
            if not dl.expired:
                continue
            self._pending_deadlines.pop(rid, None)
            if self.engine.cancel_pending(rid):
                fut = self._futures.pop(rid, None)
                self._inc("shed_expired")
                if fut is not None and not fut.done():
                    fut.set_exception(DeadlineExpired(
                        "expired while backlogged; prefill skipped"
                    ))

    def _observe(self) -> None:
        """Between steps: TTFTs into the `ttft` histogram, dispatch times
        into their program histograms, the queue depth, the megastep's live
        K (`megastep_k`) and pad lanes burnt by finishes inside megasteps
        (`megastep_dead_lane_tokens`), the decode train's admission stall
        (`prefill_stall_ms`, `decode_stalled_tokens`; both stay 0 under
        fused admission), the run's host dispatches per emitted token, and
        the prefix cache's hit tokens, evictions, blocks in use and hit
        rate (the JAX package's metric names)."""
        ttfts = self.engine.pop_ttfts()
        times = self.engine.pop_program_times()
        dispatches, tokens, dead, stall_ms, stalled = \
            self.engine.pop_dispatch_stats()
        prefix = getattr(self.engine, "pop_prefix_stats", lambda: None)()
        if self.metrics is None:
            return
        for ttft in ttfts.values():
            self.metrics.hist("ttft").observe(ttft)
        for pname, _start, wall_s in times:
            self.metrics.hist(f"engine_prog_{pname}").observe(wall_s)
        self.metrics.set_gauge("serving_queue_depth", float(self.waiting))
        mk = getattr(self.engine, "megastep_k", None)
        if mk is not None:
            self.metrics.set_gauge("megastep_k", float(mk))
        if dead:
            self.metrics.inc("megastep_dead_lane_tokens", dead)
        if stall_ms:
            self.metrics.inc("prefill_stall_ms", int(stall_ms))
        if stalled:
            self.metrics.inc("decode_stalled_tokens", stalled)
        self._dispatch_cum += dispatches
        self._token_cum += tokens
        if self._token_cum:
            self.metrics.set_gauge("host_dispatches_per_token",
                                   self._dispatch_cum / self._token_cum)
        if prefix is not None:
            hit, total, evicted, blocks_used = prefix
            if hit:
                self.metrics.inc("prefix_cache_hit_tokens", hit)
            if evicted:
                self.metrics.inc("prefix_cache_evictions", evicted)
            self.metrics.set_gauge("prefix_cache_blocks_used",
                                   float(blocks_used))
            self._prefix_hit_cum += hit
            self._prefix_prompt_cum += total
            if self._prefix_prompt_cum:
                self.metrics.set_gauge(
                    "prefix_cache_hit_rate",
                    self._prefix_hit_cum / self._prefix_prompt_cum)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # Idle: block until a request arrives, then admit it plus any
            # companions that queued behind it.
            self._admit(*await self._incoming.get())
            while self.engine.has_work:
                self._drain_incoming()
                self._shed_expired_pending()
                if not self.engine.has_work:
                    break  # everything backlogged expired; nothing to step
                try:
                    # step() blocks on device compute; run off-loop so new
                    # submissions keep landing in _incoming meanwhile.
                    done = await loop.run_in_executor(None, self.engine.step)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    log.exception("paged step failed")
                    futures = list(self._futures.values())
                    self._futures.clear()
                    self._pending_deadlines.clear()
                    for f in futures:
                        if not f.done():
                            f.set_exception(e)
                    # Rebuild a clean state, or every later request fails
                    # too.
                    self.engine.reset()
                    break
                self._observe()
                for rid, text in done:
                    self._pending_deadlines.pop(rid, None)
                    f = self._futures.pop(rid, None)
                    if f is not None and not f.done():
                        f.set_result(text)
