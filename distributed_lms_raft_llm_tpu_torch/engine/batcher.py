"""Request queues in front of the tutoring engines.

Port of `BatchingQueue` and `PagedQueue` from `distributed_lms_raft_llm_tpu/
engine/batcher.py`:

- `BatchingQueue` (bucketed `TutoringEngine`) coalesces concurrent queries:
  a request waits at most `max_wait_ms` for companions, then the group
  runs as one `engine.answer_batch` call off the event loop;
- `PagedQueue` (continuous batching, `PagedEngine`) drives the engine step
  by step and hands new submissions to it between dispatches, so a request
  arriving mid-decode joins the running batch at the next dispatch.

Admission is bounded: beyond `max_queue` waiting requests `submit()`
raises `Overloaded` (RESOURCE_EXHAUSTED on the wire). A request whose
`Deadline` expires while queued is dropped before its prefill runs.

Both queues take the request's trace span (`utils/tracing.py`) and record
`queue.wait` and the engine's spans under it, and both stream
(`submit_stream`, below).

Both co-schedule the background scoring tenant (`scorer=`, an
`engine/scoring.ScoringManager`), as in the JAX package: the idle wait runs
one scoring quantum (one device batch, in an executor thread) only while
no interactive request waits, and, on the paged queue, only once the
engine has no work (nothing in flight: its last dispatch was read); it
re-checks arrivals at every quantum boundary, so an interactive request
waits behind at most one quantum (`score_preempt_wait_ms`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import re
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from ..utils import metrics_registry as metric
from ..utils.resilience import Deadline, DeadlineExpired, Overloaded
from ..utils.tracing import FLAG_DEADLINE, NULL_SPAN, get_tracer

log = logging.getLogger(__name__)

# Queue items: (prompt, deadline-or-None, result future, request span, its
# open queue.wait child, enqueue time on the monotonic clock). Spans are
# NULL_SPAN for an untraced request, so the scheduling code never branches
# on tracing.
_Item = Tuple[str, Optional[Deadline], asyncio.Future, Any, Any, float]

# Engine program name -> its dispatch-time histogram (bucketed engine; the
# score program's for both queues).
PROGRAM_HISTOGRAMS = {"generate": "engine_prog_generate",
                      "score": metric.ENGINE_PROG_SCORE}


async def _run_score_quantum(owner) -> None:
    """Run ONE background-scoring quantum off the loop and record its
    window. Shared by both queues; called only while nothing interactive
    waits and the engine is idle. The engine's `score` program time is
    drained into the `engine_prog_score` histogram here (no request batch
    carries it)."""
    scorer = owner._scorer
    loop = asyncio.get_running_loop()
    t0 = time.monotonic()
    with get_tracer().span("scoring.quantum",
                           job=scorer.current_job_id() or "") as sp:
        did = await loop.run_in_executor(None, scorer.run_quantum,
                                         owner.waiting)
        sp.set_attr("did_work", bool(did))
    # The quantum window: interactive arrivals inside it waited for the
    # boundary; _note_preempt charges them to score_preempt_wait_ms.
    owner._last_quantum = (t0, time.monotonic())
    owner.max_quantum_window_s = max(owner.max_quantum_window_s,
                                     owner._last_quantum[1] - t0)
    pop = getattr(owner.engine, "pop_program_times", None)
    if pop is not None and owner.metrics is not None:
        for pname, _start, wall_s in pop():
            if pname in PROGRAM_HISTOGRAMS:
                owner.metrics.hist(PROGRAM_HISTOGRAMS[pname]).observe(wall_s)


async def _next_item(owner, incoming: asyncio.Queue) -> Optional[_Item]:
    """The two-tenant idle wait: interactive work first, always; a scoring
    quantum only when none waits; otherwise block on BOTH arrival sources.
    Returns an interactive item, or None after a scoring round (the caller
    loops: arrivals are re-checked at every quantum boundary)."""
    if not incoming.empty():
        return incoming.get_nowait()
    scorer = owner._scorer
    if scorer is None:
        return await incoming.get()
    if scorer.has_work:
        await _run_score_quantum(owner)
        return None
    getter = asyncio.ensure_future(incoming.get())
    waker = asyncio.ensure_future(scorer.wake_event().wait())
    try:
        await asyncio.wait({getter, waker},
                           return_when=asyncio.FIRST_COMPLETED)
    finally:
        # An un-popped item survives the getter's cancellation (the queue
        # wakes the next getter); the wake flag is level-triggered.
        for t in (getter, waker):
            if not t.done():
                t.cancel()
        await asyncio.gather(getter, waker, return_exceptions=True)
    if (getter.done() and not getter.cancelled()
            and getter.exception() is None):
        # Already-done asyncio.Task: result() is immediate.
        return getter.result()  # lint: disable=no-blocking-in-async
    scorer.clear_wake()
    return None


def _note_preempt(owner, t_enq: float) -> None:
    """Charge an interactive arrival that landed inside the last scoring
    quantum's window the wait it paid for the boundary."""
    if owner._last_quantum is None:
        return
    q0, q1 = owner._last_quantum
    if q0 <= t_enq < q1:
        wait_s = q1 - t_enq
        owner.max_preempt_wait_s = max(owner.max_preempt_wait_s, wait_s)
        if owner.metrics is not None:
            owner.metrics.inc(metric.SCORE_PREEMPT_WAIT_MS,
                              max(1, int(wait_s * 1000.0)))

# ---------------------------------------------------------------- streaming
#
# Both queues expose `submit_stream()`: an async iterator of StreamDelta
# feeding the StreamLLMAnswer wire path. The resumable-stream contract both
# implementations honor (the JAX package's, word for word):
#
# - offsets count TOKENS; within one logical stream they are monotone and
#   gap-free (delta i+1 starts exactly where delta i ended);
# - `resume_offset=K` asks for a stream whose first delta starts at token
#   K: the engine regenerates deterministically and the text of tokens
#   [0, K) is skipped, so a client that already holds K tokens' text can
#   splice the tail without duplication;
# - the final delta carries `full_text` — the COMPLETE answer from token 0
#   — so the wire layer can digest it (the client verifies its spliced
#   transcript against the digest; any resume divergence is caught there).
#
# PagedQueue streams live token progress off the engine's incremental
# channel (`stream_snapshot`); BatchingQueue engines have no token channel,
# so the completed answer is re-chunked with the deterministic splitter
# below — same token boundaries on every node, which is what makes
# cross-node resume offsets meaningful there too.

# Tokens per delta on the BatchingQueue path.
STREAM_CHUNK_TOKENS = 8

_STREAM_TOKEN_RE = re.compile(r"\s*\S+")


def split_stream_tokens(text: str) -> List[str]:
    """Deterministic whitespace-preserving tokenization for engines
    without a native token stream. Concatenation identity:
    ``''.join(split_stream_tokens(t)) == t`` for every t."""
    toks = _STREAM_TOKEN_RE.findall(text)
    consumed = sum(len(t) for t in toks)
    if consumed < len(text):
        tail = text[consumed:]
        if toks:
            toks[-1] += tail
        else:
            toks = [tail]
    return toks


@dataclasses.dataclass(frozen=True)
class StreamDelta:
    """One increment of a streamed answer: the decoded text of tokens
    [offset, offset + count). `full_text` is set on the final delta only
    (the complete answer from token 0, digest source)."""

    offset: int
    count: int
    text: str
    final: bool
    full_text: str = ""


@dataclasses.dataclass
class _StreamState:
    """Per-stream emission state the PagedQueue runner advances between
    engine steps. `abs_text` is the decoded text through `sent_tokens`
    ABSOLUTE tokens (None until the resume skip is resolved); deltas are
    emitted only at decode-prefix-stable boundaries — a snapshot whose
    decode does not extend the already-emitted text verbatim is held
    back until more tokens stabilize it."""

    q: "asyncio.Queue[StreamDelta]"
    skip: int = 0
    rid: Optional[int] = None
    sent_tokens: int = 0
    abs_text: Optional[str] = None


class BatchingQueue:
    """Coalesces submit() calls into engine.answer_batch() invocations."""

    def __init__(self, engine, max_batch: int = 8, max_wait_ms: float = 10.0,
                 metrics=None, max_queue: int = 0, scorer=None):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.metrics = metrics
        self.max_queue = max_queue  # 0 = unbounded
        # The background scoring tenant (engine/scoring.ScoringManager or
        # None): quanta run only while no interactive request waits.
        self._scorer = scorer
        # Loop-confined scoring account: the last quantum's (start, end),
        # the longest interactive wait behind one, the longest quantum.
        self._last_quantum: Optional[Tuple[float, float]] = None
        self.max_preempt_wait_s = 0.0
        self.max_quantum_window_s = 0.0
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
            _, _, fut, _, qspan, _ = self._queue.get_nowait()
            qspan.end()
            if not fut.done():
                fut.set_exception(RuntimeError("batching queue closed"))

    async def submit(self, prompt: str, deadline: Optional[Deadline] = None,
                     span: Any = None) -> str:
        """Enqueue one query; resolves with its decoded answer.

        Raises `Overloaded` when the bounded queue is full and
        `DeadlineExpired` when the budget is already gone, both before the
        request takes a queue slot. `span` is the request's trace span:
        `queue.wait` and `engine.batch` (with the engine's program times as
        children) are recorded under it.
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
        span = span if span is not None else NULL_SPAN
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((prompt, deadline, fut, span,
                               span.child("queue.wait"), time.monotonic()))
        return await fut

    async def submit_stream(
        self, prompt: str, deadline: Optional[Deadline] = None,
        span: Any = None, resume_offset: int = 0,
        session: Optional[Tuple[str, float]] = None,
    ) -> AsyncIterator[StreamDelta]:
        """Streaming over a batch engine without a token channel: the
        completed answer is delivered as deterministic token-chunk deltas
        (see the streaming contract above). `session` is accepted for
        interface parity and ignored: transcript pins need the paged
        engine's prefix cache."""
        answer = await self.submit(prompt, deadline=deadline, span=span)
        toks = split_stream_tokens(answer)
        n = len(toks)
        i = min(max(0, int(resume_offset)), n)
        if i >= n:
            yield StreamDelta(offset=n, count=0, text="", final=True,
                              full_text=answer)
            return
        while i < n:
            j = min(i + STREAM_CHUNK_TOKENS, n)
            final = j >= n
            yield StreamDelta(offset=i, count=j - i, text="".join(toks[i:j]),
                              final=final, full_text=answer if final else "")
            i = j
            if not final:
                # A real yield point between deltas: chunks of concurrent
                # streams interleave on the wire instead of bursting.
                await asyncio.sleep(0)

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
            _, dl, fut, span, qspan, _ = item
            if dl is not None and dl.expired:
                self._inc("shed_expired")
                qspan.end()
                span.flag(FLAG_DEADLINE)
                if not fut.done():
                    fut.set_exception(
                        DeadlineExpired("expired while queued; prefill skipped")
                    )
            else:
                live.append(item)
        return live

    def _finish_engine_spans(self, espans: List[Any],
                             t_batch_unix: float) -> None:
        """Close the group's engine spans, with the engine's per-program
        dispatch times as `engine.<program>` children of each (one
        measurement, mirrored under every request of the device batch);
        an engine that reports none gets one `engine.answer_batch`
        child covering the call."""
        pop = getattr(self.engine, "pop_program_times", None)
        entries = pop() if pop is not None else []
        if self.metrics is not None:
            for pname, _start, wall_s in entries:
                if pname in PROGRAM_HISTOGRAMS:
                    self.metrics.hist(PROGRAM_HISTOGRAMS[pname]).observe(
                        wall_s)
        for espan in espans:
            espan.end()
            if entries:
                for pname, start_unix, wall_s in entries:
                    espan.child_timed(f"engine.{pname}", start_unix, wall_s)
            else:
                espan.child_timed("engine.answer_batch", t_batch_unix,
                                  espan.duration_s or 0.0)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = await _next_item(self, self._queue)
            if first is None:
                continue  # a scoring quantum ran; re-check arrivals
            group = self._drop_expired(await self._collect(first))
            if not group:
                continue  # everything expired while queued: zero prefills
            for item in group:
                _note_preempt(self, item[5])
            if self.metrics is not None:
                self.metrics.set_gauge("serving_queue_depth",
                                       float(self.waiting))
            prompts = [p for p, _, _, _, _, _ in group]
            # Dispatch moment: queue.wait ends, engine.batch begins.
            espans = []
            for _, _, _, span, qspan, _ in group:
                qspan.end()
                espans.append(span.child("engine.batch", batch=len(group)))
            t_batch_unix = time.time()
            try:
                # The engine call blocks on device compute; run it off-loop
                # so new requests keep queueing meanwhile.
                self._inc("engine_batches")
                answers = await loop.run_in_executor(
                    None, self.engine.answer_batch, prompts
                )
            except asyncio.CancelledError:
                pop = getattr(self.engine, "pop_program_times", None)
                if pop is not None:
                    pop()
                for espan in espans:
                    espan.end()
                for _, _, fut, _, _, _ in group:
                    if not fut.done():
                        fut.set_exception(RuntimeError("batching queue closed"))
                raise
            except Exception as e:  # resolve all waiters with the failure
                log.exception("batch of %d failed", len(prompts))
                for espan in espans:
                    espan.set_status("error")
                self._finish_engine_spans(espans, t_batch_unix)
                for _, _, fut, _, _, _ in group:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._finish_engine_spans(espans, t_batch_unix)
            ttfts = getattr(self.engine, "last_batch_ttfts", [])
            if self.metrics is not None:
                for ttft in ttfts[:len(group)]:
                    self.metrics.hist("ttft").observe(ttft)
                tpw = getattr(self.engine, "last_spec_tokens_per_window",
                              None)
                if tpw is not None:
                    # Speculation's effect: mean tokens a verify window
                    # emitted (1.0 = nothing accepted); a ratio, a gauge.
                    self.metrics.set_gauge("spec_tokens_per_window", tpw)
            for (_, _, fut, _, _, _), answer in zip(group, answers):
                if not fut.done():
                    fut.set_result(answer)


@dataclasses.dataclass
class _ReqTrace:
    """Per-request trace state a paged request carries from admission to
    completion. Continuous batching has no per-request device batch, so
    the engine span is synthesized at completion (admission -> last
    token), and per-program dispatch times are attributed as SHARED
    aggregates: every program dispatched while the request was in flight
    (the queue's accumulator diffed against `prog_snapshot`)."""

    span: Any                 # the request's trace span (or NULL_SPAN)
    qspan: Any                # its open queue.wait child
    submitted_mono: float
    submitted_unix: float
    queued_s: float           # filled once the engine reports the wait
    prog_snapshot: Dict[str, Tuple[float, float]]
    # Prompt tokens spliced from the radix tree at admission (None until
    # the engine reports it): an attribute of the prefill span.
    prefix_hit: Optional[int] = None


class PagedQueue:
    """Continuous-batching front end over `engine.paged.PagedEngine`.

    Same submit()/start()/close() surface as `BatchingQueue`, different
    scheduling: instead of coalescing a group and running it to completion,
    the worker drives the paged engine step by step; new submissions are
    handed to the engine *between* dispatches, so a request arriving
    mid-decode joins the running batch at the next dispatch boundary (one
    chunk away) rather than queueing behind the whole group.
    """

    def __init__(self, engine, metrics=None, max_queue: int = 0,
                 scorer=None):
        self.engine = engine
        self.metrics = metrics
        self.max_queue = max_queue  # bound on not-yet-admitted requests
        # The background scoring tenant (engine/scoring.ScoringManager or
        # None): quanta run only while nothing interactive is pending AND
        # the engine holds no work (the runner reaches the idle wait only
        # once has_work is False: every dispatch reaped, its event waited).
        self._scorer = scorer
        self._last_quantum: Optional[Tuple[float, float]] = None
        self.max_preempt_wait_s = 0.0
        self.max_quantum_window_s = 0.0
        # Loop-confined: the engine's step() runs in an executor thread,
        # but it never sees these containers — admissions and reaps happen
        # on the runner coroutine between steps.
        self._incoming: asyncio.Queue[_Item] = asyncio.Queue()
        self._futures: Dict[int, asyncio.Future] = {}
        # Streams: future -> stream state while the request waits for
        # admission, re-keyed to rid -> state at _admit. Session turns ride
        # the same handoff (future -> (session id, pin TTL)).
        self._stream_reg: Dict[asyncio.Future, _StreamState] = {}
        self._streams: Dict[int, _StreamState] = {}
        self._session_reg: Dict[asyncio.Future, Tuple[str, float]] = {}
        # rid -> deadline for requests sitting in the ENGINE's pending list
        # (handed over, no slot yet — prefill hasn't run).
        self._pending_deadlines: Dict[int, Deadline] = {}
        self._spans: Dict[int, _ReqTrace] = {}
        # Cumulative per-program (count, wall_s) since queue start; each
        # request snapshots it at admission and diffs at completion.
        self._prog_cum: Dict[str, List[float]] = {}
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
            _, _, fut, _, qspan, _ = self._incoming.get_nowait()
            qspan.end()
            if not fut.done():
                fut.set_exception(RuntimeError("paged queue closed"))
        futures = list(self._futures.values()) + list(self._stream_reg)
        for entry in self._spans.values():
            entry.qspan.end()
        self._futures.clear()
        self._pending_deadlines.clear()
        self._spans.clear()
        self._stream_reg.clear()
        self._streams.clear()
        self._session_reg.clear()
        for fut in futures:
            if not fut.done():
                fut.set_exception(RuntimeError("paged queue closed"))

    def _check_admission(self, deadline: Optional[Deadline]) -> None:
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

    async def submit(self, prompt: str, deadline: Optional[Deadline] = None,
                     span: Any = None) -> str:
        """Enqueue one query; resolves with its decoded answer. Raises
        `Overloaded` when the admission bound is reached and
        `DeadlineExpired` when the budget is already gone."""
        self._check_admission(deadline)
        span = span if span is not None else NULL_SPAN
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._incoming.put((prompt, deadline, fut, span,
                                  span.child("queue.wait"),
                                  time.monotonic()))
        return await fut

    async def submit_stream(
        self, prompt: str, deadline: Optional[Deadline] = None,
        span: Any = None, resume_offset: int = 0,
        session: Optional[Tuple[str, float]] = None,
    ) -> AsyncIterator[StreamDelta]:
        """Incremental token-yield stream: deltas are emitted as the
        engine's steps produce tokens (see the streaming contract above for
        offsets and resume). `session=(session_id, ttl_s)` marks the
        request as a tutoring-session turn: its transcript is published
        into the radix cache and session-pinned at its finish."""
        self._check_admission(deadline)
        span = span if span is not None else NULL_SPAN
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        st = _StreamState(q=asyncio.Queue(), skip=max(0, int(resume_offset)))
        self._stream_reg[fut] = st
        if session is not None:
            self._session_reg[fut] = session
        await self._incoming.put((prompt, deadline, fut, span,
                                  span.child("queue.wait"),
                                  time.monotonic()))
        try:
            while True:
                getter = asyncio.ensure_future(st.q.get())
                await asyncio.wait({getter, fut},
                                   return_when=asyncio.FIRST_COMPLETED)
                if getter.done() and not getter.cancelled():
                    # Already-done future: result() is immediate.
                    delta = getter.result()  # lint: disable=no-blocking-in-async
                    yield delta
                    if delta.final:
                        return
                    continue
                getter.cancel()
                await asyncio.gather(getter, return_exceptions=True)
                # The result future resolved first: propagate its failure,
                # or drain the deltas the runner pushed in that iteration.
                exc = fut.exception()
                if exc is not None:
                    raise exc
                while not st.q.empty():
                    delta = st.q.get_nowait()
                    yield delta
                    if delta.final:
                        return
                # The answer resolved without the stream channel reporting
                # a final: degrade to one final delta.
                # fut resolved first (FIRST_COMPLETED, getter not done),
                # so result() is immediate.
                text = fut.result()  # lint: disable=no-blocking-in-async
                sent = st.abs_text or ""
                yield StreamDelta(
                    offset=st.sent_tokens, count=0,
                    text=text[len(sent):] if text.startswith(sent) else "",
                    final=True, full_text=text)
                return
        finally:
            self._stream_reg.pop(fut, None)
            self._session_reg.pop(fut, None)
            if st.rid is not None:
                self._streams.pop(st.rid, None)
                unwatch = getattr(self.engine, "stream_unwatch", None)
                if unwatch is not None:
                    unwatch(st.rid)
            if fut.done() and not fut.cancelled():
                fut.exception()  # consumed above; mark retrieved

    def _admit(self, prompt: str, deadline: Optional[Deadline],
               fut: asyncio.Future, span: Any, qspan: Any,
               t_enq: float) -> None:
        _note_preempt(self, t_enq)
        # Shed before prefill: a queue-expired request never enters the
        # engine.
        if deadline is not None and deadline.expired:
            self._inc("shed_expired")
            qspan.end()
            span.flag(FLAG_DEADLINE)
            self._stream_reg.pop(fut, None)
            self._session_reg.pop(fut, None)
            if not fut.done():
                fut.set_exception(
                    DeadlineExpired("expired while queued; prefill skipped")
                )
            return
        rid = self.engine.submit(prompt)
        self._futures[rid] = fut
        self._spans[rid] = _ReqTrace(
            span, qspan, time.monotonic(), time.time(), 0.0,
            {k: (v[0], v[1]) for k, v in self._prog_cum.items()})
        if deadline is not None:
            self._pending_deadlines[rid] = deadline
        st = self._stream_reg.pop(fut, None)
        if st is not None:
            st.rid = rid
            self._streams[rid] = st
            watch = getattr(self.engine, "stream_watch", None)
            if watch is not None:
                watch(rid)
        session = self._session_reg.pop(fut, None)
        if session is not None:
            mark = getattr(self.engine, "mark_session", None)
            if mark is not None:
                mark(rid, session[0], session[1])

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
                entry = self._spans.pop(rid, None)
                if entry is not None:
                    entry.span.flag(FLAG_DEADLINE)
                    entry.qspan.end()
                if fut is not None and not fut.done():
                    fut.set_exception(DeadlineExpired(
                        "expired while backlogged; prefill skipped"
                    ))

    def _observe(self) -> None:
        """Between steps: the engine's measured queue waits close their
        `queue.wait` spans; dispatch times feed their program histograms
        and the accumulator the completion-time spans diff against;
        TTFTs feed the `ttft` histogram; and the gauges and counters of the
        JAX queue under its names: the queue depth, the megastep's live K
        (`megastep_k`) and pad lanes burnt by finishes inside megasteps
        (`megastep_dead_lane_tokens`), the decode train's admission stall
        (`prefill_stall_ms`, `decode_stalled_tokens`; both 0 under fused
        admission), the run's host dispatches per emitted token, the prefix
        cache's hit tokens, evictions, blocks in use and hit rate, the
        blocks session pins hold (`session_pinned_blocks`), and under
        speculation the tokens a verify window emits
        (`spec_tokens_per_window`) and those beyond its guaranteed one
        (`spec_accepted_tokens`)."""
        pop_waits = getattr(self.engine, "pop_queue_waits", None)
        if pop_waits is not None:
            for rid, wait_s in pop_waits().items():
                entry = self._spans.get(rid)
                if entry is not None:
                    entry.qspan.end(duration_s=wait_s)
                    entry.queued_s = wait_s
        times = self.engine.pop_program_times()
        for pname, _start, wall_s in times:
            cum = self._prog_cum.setdefault(pname, [0.0, 0.0])
            cum[0] += 1.0
            cum[1] += wall_s
        pop_hits = getattr(self.engine, "pop_prefix_hits", None)
        if pop_hits is not None:
            for rid, hit in pop_hits().items():
                entry = self._spans.get(rid)
                if entry is not None:
                    entry.prefix_hit = hit
        ttfts = self.engine.pop_ttfts()
        dispatches, tokens, dead, stall_ms, stalled = \
            self.engine.pop_dispatch_stats()
        prefix = getattr(self.engine, "pop_prefix_stats", lambda: None)()
        sessions = getattr(self.engine, "session_pin_stats", lambda: None)()
        spec = getattr(self.engine, "pop_spec_stats", lambda: None)()
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
        # Sharded serving: the tp ways and the KV residency on each
        # rank's device (it tracks cache growth and the idle shrink).
        kvb = getattr(self.engine, "kv_bytes_per_chip", None)
        if kvb is not None:
            self.metrics.set_gauge("serving_tp",
                                   float(getattr(self.engine, "tp", 1)))
            self.metrics.set_gauge("serving_kv_bytes_per_chip", float(kvb))
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
        if sessions is not None:
            # Blocks held resident by live transcript pins (lapsed pins
            # are expired inside the stats call).
            self.metrics.set_gauge("session_pinned_blocks",
                                   float(sessions[1]))
        if spec is not None and spec[0]:
            # Speculation: mean tokens a verify window emitted (1.0 =
            # nothing accepted) and the tokens beyond each window's one.
            windows, emitted = spec
            self.metrics.set_gauge("spec_tokens_per_window",
                                   emitted / windows)
            self.metrics.inc("spec_accepted_tokens", emitted - windows)

    def _emit_stream_progress(self, done: List[Tuple[int, str]]) -> None:
        """Advance every registered stream after an engine step: finals
        for requests that completed this step (their token lists drained
        from the engine's watch channel), then partial deltas for the
        still-live ones from the incremental snapshot."""
        if not self._streams:
            return
        finals: Dict[int, List[int]] = {}
        popf = getattr(self.engine, "pop_final_tokens", None)
        if popf is not None:
            finals = popf()
        done_map = dict(done)
        for rid in [r for r in self._streams if r in done_map]:
            st = self._streams.pop(rid)
            self._push_final(st, finals.get(rid), done_map[rid])
        live = list(self._streams)
        snap = getattr(self.engine, "stream_snapshot", None)
        if not live or snap is None:
            return
        for rid, toks in snap(live).items():
            self._push_partial(self._streams[rid], toks)

    def _push_partial(self, st: _StreamState, toks: List[int]) -> None:
        n = len(toks)
        if st.abs_text is None:
            # Resume skip unresolved: wait until the regeneration reaches
            # the resume offset, then anchor the emitted-text position at
            # the skipped prefix's decoded length.
            if n < st.skip:
                return
            st.sent_tokens = st.skip
            st.abs_text = (self.engine.decode_tokens(toks[:st.skip])
                           if st.skip else "")
        if n <= st.sent_tokens:
            return
        full = self.engine.decode_tokens(toks)
        complete = getattr(self.engine, "decode_complete", None)
        if ((complete is not None and complete(toks) != full)
                or not full.startswith(st.abs_text)):
            # Decode not prefix-stable at this token boundary: the last
            # token ends inside a UTF-8 character (decoded as a
            # replacement character the next token rewrites), or an
            # earlier tail was rewritten. Hold back: delivered text is
            # never retracted. (The JAX package checks only the second
            # condition, so it can deliver the replacement character and
            # then splice the rest of the answer one character off.)
            return
        st.q.put_nowait(StreamDelta(
            offset=st.sent_tokens, count=n - st.sent_tokens,
            text=full[len(st.abs_text):], final=False))
        st.sent_tokens = n
        st.abs_text = full

    def _push_final(self, st: _StreamState, toks: Optional[List[int]],
                    text: str) -> None:
        n = len(toks) if toks is not None else max(st.sent_tokens, st.skip)
        if st.abs_text is None:
            eff = min(st.skip, n)
            st.sent_tokens = eff
            st.abs_text = (self.engine.decode_tokens(toks[:eff])
                           if (toks and eff) else "")
        # Best-effort slice when the final decode diverged from a held-back
        # partial (the digest check downstream catches corruption).
        st.q.put_nowait(StreamDelta(
            offset=st.sent_tokens, count=max(0, n - st.sent_tokens),
            text=text[len(st.abs_text):], final=True, full_text=text))

    def _finish_span(self, rid: int) -> None:
        """Synthesize the request's `engine.decode` span: admission (end of
        queue wait) -> last token. Every dispatched program is shared by
        the whole running batch, so per-program attribution is the
        AGGREGATE of dispatches that ran while this request was in flight
        (`shared: true` on the children), clamped into the parent."""
        entry = self._spans.pop(rid, None)
        if entry is None:
            return
        entry.qspan.end()  # a no-op when the reap already closed it
        queued_s = entry.queued_s
        t_unix = entry.submitted_unix
        total_s = max(0.0, time.monotonic() - entry.submitted_mono - queued_s)
        espan = entry.span.child_timed("engine.decode", t_unix + queued_s,
                                       total_s)
        for pname, cum in sorted(self._prog_cum.items()):
            before = entry.prog_snapshot.get(pname, (0.0, 0.0))
            n = int(cum[0] - before[0])
            if n <= 0:
                continue
            attrs: Dict[str, Any] = dict(shared=True, dispatches=n)
            if (entry.prefix_hit is not None
                    and pname in ("prefill", "partial_prefill")):
                # The request's own admission fact: prompt tokens spliced
                # from the shared-prefix cache instead of re-prefilled.
                attrs["prefix_hit_tokens"] = entry.prefix_hit
            espan.child_timed(f"engine.{pname}", t_unix + queued_s,
                              min(cum[1] - before[1], total_s), **attrs)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # Idle: block until a request arrives (or, with the scoring
            # tenant, run one quantum a round and re-check arrivals at its
            # boundary), then admit it plus any companions that queued
            # behind it. Scoring runs only HERE: the engine holds no work
            # at the idle wait, so a quantum never meets a live decode.
            item = await _next_item(self, self._incoming)
            if item is None:
                continue  # a scoring quantum ran; arrivals re-checked
            self._admit(*item)
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
                    for entry in self._spans.values():
                        entry.span.set_status("error")
                        entry.qspan.end()
                    self._futures.clear()
                    self._pending_deadlines.clear()
                    self._spans.clear()
                    # Stream consumers see the failure through their result
                    # future; reset() clears the engine's watch set.
                    self._streams.clear()
                    for f in futures:
                        if not f.done():
                            f.set_exception(e)
                    # Rebuild a clean state, or every later request fails
                    # too.
                    self.engine.reset()
                    break
                self._observe()
                # Stream emission BEFORE future resolution: a consumer
                # woken by its future always finds its final delta queued.
                self._emit_stream_progress(done)
                for rid, text in done:
                    self._pending_deadlines.pop(rid, None)
                    self._finish_span(rid)
                    f = self._futures.pop(rid, None)
                    if f is not None and not f.done():
                        f.set_result(text)
