"""Continuous batching: slot-based decode with per-slot KV lengths.

Port of the sequential core of `distributed_lms_raft_llm_tpu/engine/
paged.py`. The cache holds S independent slots; every decode step advances
ALL active slots by one token, and the host admits and evicts requests
BETWEEN dispatches, so a new request joins the running batch at the next
dispatch instead of queueing behind it.

Layout, as in the JAX package:

- prompts are RIGHT-padded into their slot (slot position 0 = first prompt
  token), so a slot's raggedness is one length;
- decode is a host-driven loop over a CHUNKED step (`_step_program`): each
  dispatch advances `chunk` tokens for all S slots with one readback;
- the live cache runs at the width the widest active request needs (one
  width per prompt bucket) and widens when a longer prompt arrives; an idle
  engine drops back to the width its queued work needs.

What differs from the JAX package, by design:

- state is updated IN PLACE, eagerly: there is no jit, no donation and no
  program cache. The KV cache is allocated once at the widest width, and a
  width is a window over it (a view), so growing costs nothing. Slots past
  a row's length are never attended, so stale values there change nothing.
- a prompt is prefilled straight into its slot's pages of the live cache
  (a view of the slot), so `_install_program` only sets the slot's length,
  token, active flag and seen row: there is no splice copy.
- the step is a Python loop of `chunk` forwards. Nothing inside it syncs
  the host: offsets are clamped to the width explicitly (as the JAX step
  does), so no index can leave the cache and none is checked.
- pipelining keeps the JAX semantics: dispatch N+1 before reading N. The
  device-to-host copies of a dispatch's tokens and active flags start at
  dispatch, into pinned memory, with an event recorded behind them; the
  reap waits on that event only.
- decode attention goes through the CUDA kernel by default on the card
  (`fused_attention=None`), with per-row lengths and, with `kv_quant`, an
  int8 cache. The JAX engine refuses `fused_attention` only because its
  Pallas kernel lacks ragged offsets.

Options of the JAX engine not ported yet raise `NotImplementedError` at
construction: megastep decode, the shared-prefix (radix) cache, fused
chunked prefill, speculative decoding, tp/ep/sp and the scoring tenant;
so do streaming and sessions (the serving queue offers neither).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import convert, quant, registry
from ..models.common import KVCache
from ..utils import tokenizer as tok_lib
from .engine import EngineConfig, refuse_unported
from .generate import pick_bucket
from .sampling import (
    SamplingParams,
    sample_step,
    seen_mask_from_ids,
    update_seen,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SlotState:
    """Device-side state of all S slots, updated in place.

    cache:  k/v [L, S, Hkv, width, Dh] (a window of the preallocated
            cache; int8 with ks/vs scale planes under `kv_quant`) and
            `lengths` [S] int32, each slot's written length
    tok:    [S] int64, the last sampled token per slot
    active: [S] bool
    seen:   [S, V] bool, the repetition-penalty presence mask
    """

    cache: KVCache
    tok: torch.Tensor
    active: torch.Tensor
    seen: torch.Tensor


@dataclasses.dataclass
class _Request:
    rid: int
    prompt_len: int
    tokens: List[int]
    max_new: int
    submit_time: float = 0.0
    # Set at reap time; later in-flight chunks dispatched before the finish
    # was known still carry this request in their slot snapshot and must
    # skip it (see PagedEngine.step pipelining).
    finished: bool = False


def cfg_tmax(cfg, sampling: SamplingParams, bucket: int) -> int:
    return min(bucket + sampling.max_new_tokens, cfg.max_position_embeddings)


def _prefill_program(params, ids: torch.Tensor, true_len: int,
                     generator: torch.Generator, cache: KVCache, *, cfg,
                     sampling, model) -> Tuple[torch.Tensor, torch.Tensor]:
    """[1, T] right-padded prompt -> (first token, seen row).

    `cache` is the slot's pages, [L, 1, Hkv, T, Dh] views of the live cache
    (plus scale planes when int8): the prompt's keys/values are written
    there in place, at positions 0..T-1 (0..true_len-1 real). The first
    generated token's KV lands during the next step.
    """
    _, t = ids.shape
    steps = torch.arange(t, device=ids.device)
    kv_mask = (steps < true_len)[None, :]
    positions = torch.clamp(steps, max=true_len - 1)[None, :]
    logits, _ = model.forward(params, cfg, ids, cache=cache,
                              positions=positions, kv_mask=kv_mask)
    last = logits[0, true_len - 1]
    seen = seen_mask_from_ids(ids, kv_mask, cfg.vocab_size)[0]
    first = sample_step(generator, last[None, :], seen[None, :], sampling)[0]
    return first, update_seen(seen[None, :], first[None])[0]


def _install_program(state: SlotState, slot: int, true_len: int,
                     first: torch.Tensor, seen_row: torch.Tensor, *,
                     eos_id: int) -> None:
    """Make a prefilled slot live (its pages already hold the prompt's
    KV): length, last token, active flag and seen row, all on the device."""
    state.cache.lengths[slot] = true_len
    state.tok[slot] = first
    state.active[slot] = first != eos_id
    state.seen[slot] = seen_row


def _grow_state_program(state: SlotState, full: KVCache,
                        new_len: int) -> SlotState:
    """Widen the live cache to `new_len` slots: a wider window of the
    preallocated cache `full`, the same lengths (the JAX package pads the
    cache instead; the new slots are unattended either way)."""
    return dataclasses.replace(state, cache=dataclasses.replace(
        full.window(new_len), lengths=state.cache.lengths))


def _step_program(params, state: SlotState, generator: torch.Generator, *,
                  cfg, sampling, eos_id: int, pad_id: int, model,
                  chunk: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """`chunk` decode steps for all S slots (per-row cache offsets).

    Updates `state` in place and returns fresh tensors (tokens [chunk, S]
    int32, active snapshot [S] int8) that no later dispatch writes: the
    pipelined engine dispatches step N+1 before reading N's results.
    Inactive and full slots write into their clamped position (the slot is
    dead or about to be evicted; the data is ignored), so every offset
    stays inside the window and nothing syncs the host.
    """
    width = state.cache.max_len
    pad = torch.full((), pad_id, dtype=state.tok.dtype,
                     device=state.tok.device)
    toks = []
    for _ in range(chunk):
        lengths = state.cache.lengths
        offs = torch.clamp(lengths, max=width - 1)
        logits, _ = model.forward(
            params, cfg, state.tok[:, None],
            cache=dataclasses.replace(state.cache, lengths=offs),
        )
        nxt = sample_step(generator, logits[:, 0], state.seen, sampling)
        nxt = torch.where(state.active, nxt, pad)
        still = state.active & (nxt != eos_id)
        lengths.copy_(torch.where(state.active,
                                  torch.clamp(lengths + 1, max=width),
                                  lengths))
        state.seen.copy_(torch.where(state.active[:, None],
                                     update_seen(state.seen, nxt),
                                     state.seen))
        state.tok.copy_(nxt)
        state.active.copy_(still)
        toks.append(nxt)
    return (torch.stack(toks).to(torch.int32),
            state.active.to(torch.int8))


class PagedEngine:
    """Slot-scheduled serving engine with mid-decode admission.

    Host API (single-threaded; wrap in an executor for async serving):
      submit(prompt) -> request id
      step() -> list[(rid, text)] — admit pending into free slots, dispatch
                the next chunk, return requests that finished
      drain() -> dict[rid, text] — run until no work remains
    """

    def __init__(self, config: EngineConfig, slots: Optional[int] = None,
                 chunk: int = 16, inflight: int = 2, megastep: int = 1,
                 prefix_cache: bool = False, prefill_chunk_tokens: int = 0):
        refuse_unported(config)
        unported = [name for name, on in (
            ("megastep", megastep > 1), ("prefix_cache", prefix_cache),
            ("prefill_chunk_tokens", prefill_chunk_tokens > 0)) if on]
        if unported:
            raise NotImplementedError(
                f"PagedEngine options not ported to PyTorch yet: {unported}"
            )
        self.config = config
        # Tokens per dispatched step; mid-chunk admissions wait at most
        # `chunk` steps, host round trips shrink by the same factor.
        self.chunk = max(1, chunk)
        # Dispatches kept in flight: at 2 the host dispatches step N+1
        # before reading N's tokens. 1 = dispatch, sync, reap.
        self.inflight_limit = max(1, inflight)
        self.device = resolve_device(config.device)
        self.family, self.cfg = registry.resolve(
            config.model, config.dtype, config.param_dtype
        )
        fused = config.fused_attention
        if fused is None:
            fused = self.device.type == "cuda"
        self.cfg = dataclasses.replace(self.cfg, fused_decode_attention=fused,
                                       quant_kv=config.kv_quant)
        self.tokenizer = tok_lib.load_gpt2_tokenizer(
            config.vocab_path, config.merges_path
        )
        if self.tokenizer.vocab_size > self.cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds model "
                f"vocab {self.cfg.vocab_size}"
            )
        self.slots = slots or max(config.batch_buckets)
        # Clamp the prompt bucket so bucket + max_new always fits the
        # position table (long prompts keep their tail in submit()).
        self.bucket = min(
            max(config.length_buckets),
            self.cfg.max_position_embeddings - config.sampling.max_new_tokens,
        )
        if self.bucket < 1:
            raise ValueError(
                f"max_new {config.sampling.max_new_tokens} leaves no room "
                f"for any prompt token in the position table "
                f"{self.cfg.max_position_embeddings}"
            )
        self.tmax = cfg_tmax(self.cfg, config.sampling, self.bucket)
        # Cache-width buckets: one admissible width per prompt bucket.
        self.widths = sorted({
            cfg_tmax(self.cfg, config.sampling, min(b, self.bucket))
            for b in config.length_buckets
        })
        self.buckets = sorted({min(b, self.bucket)
                               for b in config.length_buckets})

        t0 = time.monotonic()
        if config.checkpoint:
            sd = convert.load_safetensors(config.checkpoint)
            params = self.family.params_from_hf(sd, self.cfg, self.device)
        else:
            log.warning("no checkpoint — randomly initialized %s",
                        config.model)
            params = self.family.init_params(self.cfg, config.seed,
                                             self.device)
        if config.quant:
            params = quant.quantize_params(params, self.family.name)
        self.params = params
        log.info("params ready in %.1fs on %s", time.monotonic() - t0,
                 self.device)

        statics = dict(cfg=self.cfg, sampling=config.sampling,
                       model=self.family)
        self._prefill = functools.partial(_prefill_program, **statics)
        self._step = functools.partial(
            _step_program, eos_id=self.tokenizer.eos_id,
            pad_id=self.tokenizer.pad_id, chunk=self.chunk, **statics)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        # The one KV allocation, at the widest width; widths are windows.
        self._kv = self.family.init_cache(
            self.cfg, self.slots, self.widths[-1], dtype=self.cfg.dtype,
            device=self.device)
        self.state = self._init_state()
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._pending: List[_Request] = []
        # Dispatched-but-unread steps, oldest first: (tokens [chunk, S],
        # active [S] — host copies in flight on the card — the event behind
        # them or None on the CPU, slot -> request snapshot at dispatch).
        self._inflight: List[Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.cuda.Event],
                                   List[Optional[_Request]]]] = []
        self._next_rid = 0
        self.last_ttft_s: Optional[float] = None
        # Per-request time to first token (submit() -> first token on the
        # host), keyed by rid; the serving queue pops these.
        self.ttfts: Dict[int, float] = {}
        # Tokens finished requests generated.
        self.total_generated_tokens = 0
        # Model calls: prefill forwards (one per admission) and decode
        # forwards (`chunk` per dispatched step).
        self.prefill_calls = 0
        self.decode_steps = 0
        # Drained by pop_dispatch_stats(): host dispatches, tokens emitted
        # to requests, and the admission stall (host wall the decode train
        # spent blocked on sequential admission while live slots waited,
        # with the proxy tokens those slots would have decoded meanwhile).
        self._dispatches = 0
        self._emitted_tokens = 0
        self._prefill_stall_s = 0.0
        self._decode_stalled_tokens = 0
        # (program, wall-clock start, dispatch seconds) per dispatch.
        self._prog_times: List[Tuple[str, float, float]] = []

    _PROG_TIMES_MAX = 4096

    def _time_prog(self, name: str, t0: float, t0_unix: float) -> None:
        """Record one dispatch's host wall time."""
        self._dispatches += 1
        self._prog_times.append((name, t0_unix, time.monotonic() - t0))
        if len(self._prog_times) > self._PROG_TIMES_MAX:
            del self._prog_times[: -self._PROG_TIMES_MAX]

    def pop_dispatch_stats(self) -> Tuple[int, int, float, int]:
        """Drain (host_dispatches, emitted_tokens, prefill_stall_ms,
        decode_stalled_tokens) accumulated since the last call.
        dispatches/tokens is the serving queue's `host_dispatches_per_token`
        gauge."""
        out = (self._dispatches, self._emitted_tokens,
               self._prefill_stall_s * 1000.0, self._decode_stalled_tokens)
        self._dispatches = self._emitted_tokens = 0
        self._prefill_stall_s = 0.0
        self._decode_stalled_tokens = 0
        return out

    def pop_program_times(self) -> List[Tuple[str, float, float]]:
        """Drain (program, start_unix, dispatch_s) recorded since last
        call."""
        out, self._prog_times = self._prog_times, []
        return out

    @property
    def kv_bytes_total(self) -> int:
        """Logical bytes of the live slot KV working set (k/v plus the
        int8 scale planes) at the cache's current width."""
        c = self.state.cache
        return sum(x.numel() * x.element_size()
                   for x in (c.k, c.v, c.ks, c.vs) if x is not None)

    def _init_state(self, width: Optional[int] = None) -> SlotState:
        cache = dataclasses.replace(
            self._kv.window(width or self.widths[0]),
            lengths=torch.zeros((self.slots,), dtype=torch.int32,
                                device=self.device))
        return SlotState(
            cache=cache,
            tok=torch.zeros((self.slots,), dtype=torch.long,
                            device=self.device),
            active=torch.zeros((self.slots,), dtype=torch.bool,
                               device=self.device),
            seen=torch.zeros((self.slots, self.cfg.vocab_size),
                             dtype=torch.bool, device=self.device),
        )

    # ------------------------------------------------------------ host API

    def submit(self, prompt: str) -> int:
        limit = self.bucket
        toks = self.tokenizer.encode(prompt)[-limit:] or [self.tokenizer.pad_id]
        req = _Request(
            rid=self._next_rid,
            prompt_len=len(toks),
            tokens=toks,
            max_new=self.config.sampling.max_new_tokens,
            submit_time=time.monotonic(),
        )
        self._next_rid += 1
        self._pending.append(req)
        return req.rid

    @property
    def backlog(self) -> int:
        """Requests submitted but not yet admitted to a decode slot (their
        prefill has not run). The serving queue counts these toward its
        admission bound."""
        return len(self._pending)

    def cancel_pending(self, rid: int) -> bool:
        """Remove a not-yet-admitted request; True if it was still pending.
        A request already in a slot is not cancellable."""
        for i, req in enumerate(self._pending):
            if req.rid == rid:
                del self._pending[i]
                return True
        return False

    @torch.no_grad()
    def warmup(self) -> float:
        """Run every width once before serving (the first cuBLAS calls,
        the kernels' build and each launch layout happen here, not on a
        request): at each cache width, each prompt bucket that fits it is
        prefilled and installed, then one step runs; then one ghost request
        is drained. Returns seconds."""
        t0 = time.monotonic()
        for width in self.widths:
            self.state = self._init_state(width)
            for t in self.buckets:
                if cfg_tmax(self.cfg, self.config.sampling, t) > width:
                    continue  # a prompt this long can't run at this width
                ids = torch.full((1, t), self.tokenizer.pad_id,
                                 dtype=torch.long, device=self.device)
                first, seen_row = self._prefill(self.params, ids, 1,
                                                self.generator,
                                                self._slot_cache(0, t))
                _install_program(self.state, 0, 1, first, seen_row,
                                 eos_id=self.tokenizer.eos_id)
            self._step(self.params, self.state, self.generator)
        self.reset()
        rid = self.submit("warmup")
        self.drain()
        self.ttfts.pop(rid, None)
        # The warmup drain is not serving traffic.
        self.pop_dispatch_stats()
        self.pop_program_times()
        return time.monotonic() - t0

    @property
    def has_work(self) -> bool:
        return (
            bool(self._pending)
            or bool(self._inflight)
            or any(r is not None for r in self._slot_req)
        )

    def pop_ttfts(self) -> Dict[int, float]:
        """Drain the per-request TTFT measurements recorded since last call."""
        out, self.ttfts = self.ttfts, {}
        return out

    def decode_tokens(self, tokens) -> str:
        """Decode a generated-token list (eos included or not) to text."""
        return self.tokenizer.decode(list(tokens))

    def reset(self) -> None:
        """Discard all in-flight work and rebuild a clean slot state.

        Needed after a failed step: the serving queue fails the affected
        requests and resets the engine, so later requests start clean.
        """
        self.state = self._init_state()
        self._slot_req = [None] * self.slots
        self._pending = []
        self._inflight = []
        self.ttfts = {}
        self._prog_times = []

    def _maybe_rebuild_idle(self) -> None:
        # Idle rebuild: with nothing occupied or in flight, the cache can
        # jump straight to the width the queued work needs, shrinking back
        # after a wide request departs.
        if (
            self._pending
            and not self._inflight
            and not any(r is not None for r in self._slot_req)
        ):
            needed = max(
                self._required_width(r.prompt_len)
                for r in self._pending[: self.slots]
            )
            if needed != self.state.cache.max_len:
                self.state = self._init_state(needed)

    def _pop_next(self) -> Tuple[_Request, int, int, torch.Tensor]:
        """Take the oldest pending request: pick its prompt bucket and
        required cache width, and build its right-padded [1, bucket] ids."""
        req = self._pending.pop(0)
        bucket = min(
            pick_bucket(req.prompt_len, self.config.length_buckets),
            self.bucket,
        )
        w_req = self._required_width(req.prompt_len)
        ids = np.full((1, bucket), self.tokenizer.pad_id, np.int64)
        ids[0, : req.prompt_len] = req.tokens
        return req, bucket, w_req, torch.from_numpy(ids).to(self.device)

    def _grow_if_needed(self, w_req: int) -> None:
        if w_req > self.state.cache.max_len:
            t0, t0u = time.monotonic(), time.time()
            self.state = _grow_state_program(self.state, self._kv, w_req)
            self._time_prog("grow", t0, t0u)

    def _slot_cache(self, slot: int, width: int) -> KVCache:
        """One slot's first `width` pages of the live cache, as a
        single-row cache for its prefill (views: writes land in place)."""
        kv = self._kv

        def pages(x):
            return None if x is None else x[:, slot:slot + 1, :, :width]

        return KVCache(k=pages(kv.k), v=pages(kv.v), ks=pages(kv.ks),
                       vs=pages(kv.vs))

    def _admit(self) -> None:
        # All free slots fill before any host sync: the prefills of every
        # admitted request dispatch back to back; one blocking readback at
        # the end fetches every first token.
        self._maybe_rebuild_idle()
        live_train = sum(
            1 for r in self._slot_req if r is not None and not r.finished
        )
        t_admit0 = time.monotonic()
        admitted: List[Tuple[int, _Request, torch.Tensor]] = []
        for slot in range(self.slots):
            if self._slot_req[slot] is not None or not self._pending:
                continue
            req, bucket, w_req, ids = self._pop_next()
            self._grow_if_needed(w_req)
            t0, t0u = time.monotonic(), time.time()
            first, seen_row = self._prefill(
                self.params, ids, req.prompt_len, self.generator,
                self._slot_cache(slot, bucket),
            )
            self.prefill_calls += 1
            self._time_prog("prefill", t0, t0u)
            t0, t0u = time.monotonic(), time.time()
            _install_program(self.state, slot, req.prompt_len, first,
                             seen_row, eos_id=self.tokenizer.eos_id)
            self._time_prog("install", t0, t0u)
            admitted.append((slot, req, first))
        if not admitted:
            return
        # ONE sync for the whole admitted group.
        firsts = torch.stack([f for _, _, f in admitted]).tolist()
        now = time.monotonic()
        if live_train:
            self._prefill_stall_s += now - t_admit0
            self._decode_stalled_tokens += (
                live_train * self.chunk * len(admitted)
            )
        for (slot, req, _), first in zip(admitted, firsts):
            req.tokens = [int(first)]
            self._emitted_tokens += 1
            self._slot_req[slot] = req
            ttft = now - req.submit_time
            self.ttfts[req.rid] = ttft
            self.last_ttft_s = ttft

    def _required_width(self, prompt_len: int) -> int:
        bucket = min(
            pick_bucket(prompt_len, self.config.length_buckets), self.bucket
        )
        return cfg_tmax(self.cfg, self.config.sampling, bucket)

    def _live(self) -> bool:
        return any(r is not None and not r.finished for r in self._slot_req)

    @torch.no_grad()
    def step(self) -> List[Tuple[int, str]]:
        """Admit pending requests, dispatch the next `chunk` tokens, and
        reap the oldest in-flight dispatch once the pipeline is full.

        Pipelining (inflight_limit=2 default): the dispatch for step N+1
        goes out BEFORE step N's tokens are read back, so the readback
        overlaps N+1's device compute. Completions therefore surface one
        step() call after their dispatch at steady state; the tail drains
        in the same call once no live slot remains.
        """
        self._admit()
        if self._live():
            t0, t0u = time.monotonic(), time.time()
            toks, active = self._step(self.params, self.state,
                                      self.generator)
            self.decode_steps += self.chunk
            self._time_prog("step", t0, t0u)
            self._push_inflight(toks, active)
        done: List[Tuple[int, str]] = []
        while self._inflight and (
            len(self._inflight) >= self.inflight_limit
            if self._live() else True
        ):
            done.extend(self._reap(*self._inflight.pop(0)))
            # _reap may finish the last live request: the loop condition
            # re-evaluates _live(), so remaining dispatches drain here.
        return done

    def _push_inflight(self, toks: torch.Tensor,
                       active: torch.Tensor) -> None:
        """Queue one dispatched step's outputs for a later reap. No blocking
        readback here, but on the card the device-to-host copies START now,
        into pinned memory, so they stream back while later steps compute;
        the event recorded behind them is all the reap waits for."""
        event = None
        if toks.device.type == "cuda":
            host_toks = torch.empty(toks.shape, dtype=toks.dtype,
                                    pin_memory=True)
            host_active = torch.empty(active.shape, dtype=active.dtype,
                                      pin_memory=True)
            host_toks.copy_(toks, non_blocking=True)
            host_active.copy_(active, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            toks, active = host_toks, host_active
        # The slot snapshot records which request each column belonged to
        # at dispatch time (a slot reused later belongs to a later step).
        self._inflight.append((toks, active, event, list(self._slot_req)))

    def _reap(self, toks_host: torch.Tensor, active_host: torch.Tensor,
              event: Optional[torch.cuda.Event],
              slot_snapshot: List[Optional[_Request]],
              ) -> List[Tuple[int, str]]:
        """Read one dispatch's results and finish the requests it
        completed."""
        if event is not None:
            event.synchronize()  # THE sync point of the engine loop
        toks = toks_host.numpy()      # [chunk, S]
        active = active_host.numpy()  # [S] post-chunk flags
        done: List[Tuple[int, str]] = []
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        for slot, req in enumerate(slot_snapshot):
            if req is None or req.finished:
                # Empty at dispatch, or finished by an earlier chunk — this
                # chunk's column holds dead-slot filler.
                continue
            finished = False
            dead = not bool(active[slot])
            n_before = len(req.tokens)
            for t in toks[:, slot]:
                tok = int(t)
                if tok == eos:
                    # eos lands in the transcript when it's a distinct
                    # token (decode filters it); GPT-2's pad == eos stays
                    # out, matching the reference's decoded text.
                    if tok != pad:
                        req.tokens.append(tok)
                    finished = True
                    break
                if dead and tok == pad:
                    # Inactive-slot filler (the slot died at admission or
                    # in an earlier chunk) — not content. Matters when
                    # pad != eos.
                    finished = True
                    break
                req.tokens.append(tok)
                # Force-finish at the budget, or where the cache is full
                # (past it the clamped write would overwrite the newest
                # slot).
                if (
                    len(req.tokens) >= req.max_new
                    or req.prompt_len + len(req.tokens) >= self.tmax
                ):
                    finished = True
                    break
            self._emitted_tokens += len(req.tokens) - n_before
            if dead:
                finished = True
            if finished:
                req.finished = True
                self.total_generated_tokens += len(req.tokens)
                text = self.tokenizer.decode(
                    [t for t in req.tokens if t != eos]
                )
                done.append((req.rid, text))
                if self._slot_req[slot] is req:
                    self._slot_req[slot] = None
                # Kill the slot in the LIVE state (which may already be a
                # chunk ahead): load-bearing for the host-side budget caps,
                # where the device still thinks the slot is active.
                self.state.active[slot] = False
        return done

    def drain(self) -> Dict[int, str]:
        out: Dict[int, str] = {}
        while self.has_work:
            for rid, text in self.step():
                out[rid] = text
        return out
