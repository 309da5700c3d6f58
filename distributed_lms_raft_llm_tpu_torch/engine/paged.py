"""Continuous batching: slot-based decode with per-slot KV lengths.

Port of `distributed_lms_raft_llm_tpu/engine/paged.py`. The cache holds S
independent slots; every decode step advances ALL active slots by one
token, and the host admits and evicts requests BETWEEN dispatches, so a new
request joins the running batch at the next dispatch instead of queueing
behind it.

Layout, as in the JAX package:

- prompts are RIGHT-padded into their slot (slot position 0 = first prompt
  token), so a slot's raggedness is one length;
- decode is a host-driven loop over a CHUNKED step (`_step_program`): each
  chunk advances `chunk` tokens for all S slots;
- a megastep (`megastep > 1`) runs K chunks per host decision, and the
  controller (`engine/megastep.py`) moves K along the ladder: wide while no
  slot can free, down to the boundary where a waiting request can join;
- the live cache runs at the width the widest active request needs (one
  width per prompt bucket) and widens when a longer prompt arrives; an idle
  engine drops back to the width its queued work needs;
- with `prefix_cache` a radix tree of immutable KV blocks
  (`engine/prefix_cache.py`) holds the prompts' whole blocks: an admission
  splices the longest cached prefix into its slot and prefills only the
  suffix (`_partial_prefill_program`);
- with `prefill_chunk_tokens` admission is STAGED (fused, stall-free): the
  prompt's ids go to the slot's transcript row and a staged plane, and each
  megastep iteration first runs one prefill chunk of that many tokens for
  the oldest staged slot (`_admission_chunk`), which flips the slot live
  when its prompt is done, so decode never waits for a prefill.

What differs from the JAX package, by design:

- state is updated IN PLACE, eagerly: no jit and no donation. Every plane
  of `SlotState` is a persistent buffer allocated once at the widest width;
  a width is a window over it (a view), so growing costs nothing, and the
  tensors a CUDA graph reads keep their addresses through growth, idle
  rebuilds and `reset()` (which zero the planes in place).
- a prompt is prefilled straight into its slot's pages of the live cache,
  so `_install_program` only sets the slot's length, token, active flag and
  seen row; cached prefix blocks are copied straight into the slot's pages.
- a chunk is a Python loop of `chunk` forwards with no host sync inside:
  offsets are clamped to the width explicitly, and the admission chunk's
  writes past the width are masked out (JAX drops out-of-range scatter
  writes; the port checks indices instead of trusting them); its pad tail
  inside the width is written, as JAX writes it.
- on the card (`cuda_graphs`, on by default there) `warmup()` captures, at
  every cache width, one CUDA graph of a decode chunk and, with fused
  admission, one of an admission chunk (`engine/graphs.py`). A megastep is
  then a host-planned sequence of at most 2K graph replays: which
  iterations run an admission chunk is known on the host (staging is
  host-decided and each staged prompt needs a known number of chunks), so
  JAX's `lax.cond` becomes the host's choice of graph, while the staged
  slot, the flip, the first token and eos are still found on the device.
  Nothing is captured while serving: a width without graphs raises.
- pipelining keeps the JAX semantics: dispatch N+1 before reading N. Each
  dispatch's device-to-host copies (tokens, active flags, flips) are
  enqueued right behind the replay or chunk that wrote them, on the same
  stream, into that dispatch's own pinned buffers, with an event recorded
  behind them; the reap waits on that event only. The dead-lane account
  is computed from those planes at the reap (the active flags at entry
  are copied with them), with the JAX definition.
- randomness: the engine's `torch.Generator` is registered with the graphs,
  so a replay draws what an eager chunk in its place would. The fused flip
  samples its first token with uniforms drawn at staging time, in the
  order the sequential admission would have drawn them (`stage_noise`).
- decode attention goes through the CUDA kernel by default on the card
  (`fused_attention=None`), with per-row lengths and, with `kv_quant`, an
  int8 cache. The JAX engine refuses `fused_attention` only because its
  Pallas kernel lacks ragged offsets.

Streaming and sessions, as in the JAX package: a watched request's token
list is read between steps from the host lists the reap already fills
(`stream_snapshot`, no device work), its final tokens are kept at its reap
(`pop_final_tokens`); a session turn (`mark_session`) publishes its whole
transcript into the radix tree at its reap, while the slot's pages still
hold its KV, and pins it with the session's TTL.

Speculative decoding (`spec_tokens` k > 0), as in the JAX package: each
chunk iteration is a verify window (`_spec_step_program`): k drafts from
the slot's transcript (`draft_source`: prompt lookup or the n-gram table,
`engine/draft.py`), one forward over k+1 positions whose attention runs
through the kernel's window variant on the card, and the exact verifier;
a slot emits 1 to k+1 tokens a window and the host walks them from the
`counts` plane. Widths and the prompt bucket make room for the window's
k-1 overhang. On the card the verify chunk is captured per width like
the decode chunk.

The scoring tenant (`score()`, `engine/scoring.py`), as in the JAX package:
a full-sequence forward outside the slot state, warmed at each of
`score_shapes` when `scoring` is on, after the graphs are captured (never
inside a capture). The serving queue runs it only while the engine has no
work, so no dispatch is in flight beside it.

Tensor parallelism (`tp` > 1, as in the JAX package's
tests/test_paged_sharded.py): one process a rank, each holding its slice of
the parameters and KV planes of Hkv / tp heads (`partition.
PAGED_PLANE_SPECS`'s heads axis); `tp` must divide the KV heads
(`partition.validate_tp_heads`, at construction). Rank 0 takes the calls;
each step broadcasts what came in since the last one (submissions, session
marks, cancellations, resets, session releases) with rank 0's clock, and
the other ranks replay them and the step (`follow()`, `parallel/spmd.py`),
so admission, megastep K, prefix hits and reaps follow identically; the
radix tree's session expiry reads rank 0's clock. Over several ranks
`decisions` records the host's choices on every rank. CUDA graphs need a
backend whose collectives a capture can hold (nccl) where a model call
holds a collective (tp or ep above 1): `cuda_graphs=True` there over gloo
raises, and None turns them on only where the device and the backend
allow.

Expert parallelism (`ep` > 1, an MoE model; alone or beside tp): the ranks
are tp x ep, each ep rank holding E / ep experts (`models/moe.py`), the
same replicated loop over all of them. `sp` > 1 is refused with the JAX
engine's message: the paged engine has no full-sequence forward to shard.

dp takes the ranks tp x ep leave in the process group (or the `mesh` the
engine is given), as the JAX engine's ``"dp": -1`` does: the state is
replicated over dp, as `PAGED_PLANE_SPECS` names no dp axis, so every dp
rank holds every slot and follows rank 0's steps on the whole batch. A
dp-only engine's model calls hold no collective (its one is the host
loop's broadcast, between calls), so it captures graphs over gloo too.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import convert, quant, registry
from ..models.common import KVCache
from ..parallel.mesh import Mesh, backend_can_capture
from ..parallel.spmd import Replica
from ..utils.guards import intended_transfer
from .draft import build_drafts, build_drafts_ngram, verify_window
from .engine import (
    DRAFT_SOURCES,
    EngineConfig,
    check_moe_spec,
    check_quant,
    check_spec_window,
    engine_axes,
    load_tokenizer,
    shard_cfg,
    shard_for,
)
from .generate import pick_bucket
from .graphs import ChunkGraph
from .megastep import (
    dead_lane_tokens,
    effective_megastep_max,
    megastep_ladder,
    next_megastep_k,
)
from .program_inventory import program_table
from .prefix_cache import (
    BLOCK_TOKENS,
    KVBlock,
    Match,
    PrefixCache,
    plan_partial,
    plan_staged,
)
from .sampling import (
    SamplingParams,
    draw_noise,
    noise_width,
    sample_step,
    seen_mask_from_ids,
    update_seen,
)
from .scoring import (
    derive_score_shapes,
    score_program,
    score_texts,
    warm_score,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SlotState:
    """Device-side state of all S slots, windows of persistent buffers
    updated in place.

    cache:        k/v [L, S, Hkv, width, Dh] (int8 with ks/vs scale planes
                  under `kv_quant`) and `lengths` [S] int32, each slot's
                  written length
    tok:          [S] int64, the last sampled token per slot
    active:       [S] bool
    seen:         [S, V] bool, the repetition-penalty presence mask
    transcript:   [S, width] int64: a staged slot's right-padded prompt ids,
                  which the in-scan prefill chunks read back
    staged:       [S] bool, slots whose prompt is prefilling in the scan
    stage_cursor: [S] int32, the next prompt position to prefill (starts at
                  the spliced prefix length)
    stage_len:    [S] int32, the true prompt length
    stage_seq:    [S] int32, the staging order (FIFO service: slot index
                  would let churn starve an early admission)
    stage_noise:  [S, n] float32, the uniforms the flip samples the first
                  token with (n = 0 under greedy decoding)
    """

    cache: KVCache
    tok: torch.Tensor
    active: torch.Tensor
    seen: torch.Tensor
    transcript: torch.Tensor
    staged: torch.Tensor
    stage_cursor: torch.Tensor
    stage_len: torch.Tensor
    stage_seq: torch.Tensor
    stage_noise: torch.Tensor


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
    # False while STAGED (fused admission: prefill advancing inside the
    # megastep, first token not yet sampled; `tokens` still holds the
    # prompt until the flip is reaped).
    live: bool = True
    # Staged only: prefill chunks not yet dispatched, and the staging order.
    chunks_left: int = 0
    stage_seq: int = 0


@dataclasses.dataclass
class _Dispatch:
    """One dispatched step or megastep, read by a later reap: tokens [K,
    chunk, S] int32 ([K, chunk, S, k+1] under speculation) and active
    snapshots [K, S] int8 (host copies in flight on the card); the active
    flags at entry [S] bool (the dead-lane account's base); the fused flips
    [K, S] bool and first tokens [K, S] int32; each verify window's
    emission count [K, chunk, S] int32 under speculation; the event behind
    the copies (None on the CPU); and slot -> request at dispatch time."""

    toks: torch.Tensor
    active: torch.Tensor
    started: torch.Tensor
    flipped: Optional[torch.Tensor]
    firsts: Optional[torch.Tensor]
    counts: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event]
    slots: List[Optional[_Request]]

    @property
    def k(self) -> int:
        return self.active.shape[0]


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


def _partial_prefill_program(params, cache: KVCache, ids_full: torch.Tensor,
                             ids_suf: torch.Tensor, prefix_len: int,
                             true_len: int, generator: torch.Generator, *,
                             cfg, sampling,
                             model) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill only the uncached suffix of a shared-prefix prompt.

    `cache` is the slot's prompt-bucket-wide pages, whose first
    `prefix_len` positions hold KV spliced from the radix tree; `ids_full`
    is the [1, t] right-padded whole prompt (the seen mask's source, as in
    the cold prefill), `ids_suf` the [1, s] right-padded suffix. The
    forward runs over the suffix at offset `prefix_len`, so each real
    suffix query attends over the same keys as in the cold prefill; the
    last real suffix position is the prompt's last, so the first token is
    sampled as the cold path samples it. Returns (first, seen_row), the
    contract of `_prefill_program`.
    """
    _, t = ids_full.shape
    logits, _ = model.forward(params, cfg, ids_suf,
                              cache=dataclasses.replace(cache,
                                                        length=prefix_len))
    last = logits[0, true_len - prefix_len - 1]
    valid = (torch.arange(t, device=ids_full.device) < true_len)[None, :]
    seen = seen_mask_from_ids(ids_full, valid, cfg.vocab_size)[0]
    first = sample_step(generator, last[None, :], seen[None, :], sampling)[0]
    return first, update_seen(seen[None, :], first[None])[0]


def _splice_block_program(kv: KVCache, block: KVBlock, slot: int,
                          off: int) -> None:
    """Copy one immutable tree block into a slot's pages of the live cache
    at token offset `off` (the JAX package's `_load_block` and
    `_stage_block`: the port prefills in the slot's pages, so both splice
    there). The block is read, never written."""
    n = block.k.shape[3]
    kv.k[:, slot:slot + 1, :, off:off + n] = block.k
    kv.v[:, slot:slot + 1, :, off:off + n] = block.v
    if kv.quantized:
        kv.ks[:, slot:slot + 1, :, off:off + n] = block.ks
        kv.vs[:, slot:slot + 1, :, off:off + n] = block.vs


def _export_block_program(kv: KVCache, off: int, slot: int, *,
                          block: int) -> KVBlock:
    """A fresh copy of one block-aligned KV run of a slot's pages: the
    block the radix tree owns. The prompt region is never rewritten by
    decode (which writes at >= prompt_len), so the copy is the prompt's."""

    def cut(x):
        return None if x is None else x[:, slot:slot + 1, :,
                                        off:off + block].clone()

    return KVBlock(k=cut(kv.k), v=cut(kv.v), ks=cut(kv.ks), vs=cut(kv.vs))


def _install_program(state: SlotState, slot: int, ids: torch.Tensor,
                     true_len: int, first: torch.Tensor,
                     seen_row: torch.Tensor, *, eos_id: int) -> None:
    """Make a prefilled slot live (its pages already hold the prompt's
    KV): length, last token, active flag and seen row, all on the device;
    the transcript row takes the right-padded prompt `ids` [1, t] and the
    first token at slot `true_len` (the drafts of speculative decoding
    read it; stale ids of an earlier occupant past them are never read:
    the drafter reads slots up to the slot's length alone)."""
    state.transcript[slot, :ids.shape[1]] = ids[0]
    state.transcript[slot, true_len] = first
    # Scalars are written with fill_ (a kernel argument): an item
    # assignment of a Python number copies it from pageable host memory,
    # which on the card waits for the stream.
    state.cache.lengths[slot].fill_(true_len)
    state.tok[slot] = first
    state.active[slot] = first != eos_id
    state.seen[slot] = seen_row


def _stage_program(state: SlotState, slot: int, ids: torch.Tensor,
                   true_len: int, cursor0: int, seq: int,
                   noise: torch.Tensor) -> None:
    """Arm one slot's staged admission: the right-padded prompt into its
    transcript row and the staged plane set; the prefill then advances
    inside the megastep (`_admission_chunk`) until the flip.

    `cursor0` is the prefix already spliced into the slot's pages (0
    cold). The slot's length is parked at width-1: decode still runs a
    forward for every slot and an inactive row writes its KV at its
    length, which, parked above the prompt, never touches the staged
    pages. `noise` [1, n] is the first token's uniforms, drawn now."""
    width = state.transcript.shape[1]
    state.transcript[slot, :ids.shape[1]] = ids[0]
    # fill_, not item assignment: no host sync (see _install_program).
    state.cache.lengths[slot].fill_(width - 1)
    state.active[slot].fill_(False)
    state.staged[slot].fill_(True)
    state.stage_cursor[slot].fill_(cursor0)
    state.stage_len[slot].fill_(true_len)
    state.stage_seq[slot].fill_(seq)
    if noise.shape[1]:
        state.stage_noise[slot] = noise[0]


def _grow_state_program(state: SlotState, kv: KVCache, transcript: torch.Tensor,
                        new_len: int) -> SlotState:
    """Widen the live state to `new_len` slots: wider windows of the
    persistent cache and transcript, the same planes, the new slots zeroed
    in place (the JAX package pads with zeros: parked staged rows attend
    them, and under an MoE model those rows share expert capacity with the
    live ones)."""
    old = state.cache.max_len
    for x in (kv.k, kv.v, kv.ks, kv.vs):
        if x is not None:
            x[:, :, :, old:new_len].zero_()
    transcript[:, old:new_len].zero_()
    return dataclasses.replace(
        state, cache=dataclasses.replace(kv.window(new_len),
                                         lengths=state.cache.lengths),
        transcript=transcript[:, :new_len])


def _step_program(params, state: SlotState, generator: torch.Generator, *,
                  cfg, sampling, eos_id: int, pad_id: int, model,
                  chunk: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """`chunk` decode steps for all S slots (per-row cache offsets).

    Updates `state` in place and returns fresh tensors (tokens [chunk, S]
    int32, active snapshot [S] int8). Inactive and full slots write into
    their clamped position (the slot is dead, staged or about to be
    evicted; the data is ignored), so every offset stays inside the window
    and nothing syncs the host.
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


def _spec_step_program(params, state: SlotState,
                       generator: Optional[torch.Generator], *, cfg,
                       sampling, eos_id: int, pad_id: int, model,
                       spec_tokens: int, chunk: int = 1,
                       draft_fn=build_drafts,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`chunk` speculative verify windows for all S slots.

    Each iteration widens the [S, 1] step to an [S, k+1] window: drafts
    come from the slot transcripts (right-padded: transcript slot = cache
    slot = position id), one forward over [tok, d_1..d_k] writes the
    window's KV at each slot's offset and attends through the kernel's
    window variant, and `draft.verify_window` walks the drafts. Slots
    accept different counts, so their lengths advance raggedly within a
    dispatch; the host learns each window's emission count from `counts`.

    A slot's next window starts m >= 1 slots after its last and spans k+1
    slots, so it rewrites every slot a rejected draft left behind before
    anything attends to it. The window base is clamped to width-1-k, as in
    the JAX package: only a slot past its budget (the host finishes it at
    max_new; its window is garbage nothing reads), a dead or a staged slot
    (parked at width-1, above its prompt) gets there, and every cache
    write and position then stays inside the window. Emitted tokens past
    the width are masked out of the transcript writes.

    Updates `state` in place and returns fresh tensors: emitted [chunk, S,
    k+1] int32, counts [chunk, S] int32 (the first counts[c, s] columns of
    emitted[c, s] are that window's tokens in order; 0 = the slot was
    inactive) and the active snapshot [S] int8. No host sync.
    """
    k = spec_tokens
    width = state.cache.max_len
    dev = state.tok.device
    pos_w = torch.arange(width, device=dev)[None, :]
    offs_k1 = torch.arange(k + 1, device=dev)[None, :]
    emitted_all, counts_all = [], []
    for _ in range(chunk):
        lengths = state.cache.lengths
        offs = torch.clamp(lengths, max=width - 1 - k).long()  # window base
        # The pending token sits at transcript slot `offs`; an anchor must
        # have k filled continuation slots after it (one near the frontier
        # would propose unwritten slots).
        prev = state.transcript.gather(
            1, torch.clamp(offs - 1, min=0)[:, None])[:, 0]
        match_valid = pos_w <= (offs - k)[:, None]
        drafts = draft_fn(state.transcript, match_valid, prev, state.tok, k)
        feed = torch.cat([state.tok[:, None], drafts], dim=1)  # [S, k+1]
        logits, _ = model.forward(
            params, cfg, feed,
            cache=dataclasses.replace(state.cache,
                                      lengths=offs.to(torch.int32)))
        emitted, valid, seen, hit_eos = verify_window(
            generator, logits, drafts, state.seen, state.active, sampling,
            eos_id, pad_id)
        # Emitted token i belongs at transcript slot offs+1+i (where its KV
        # goes once it is fed); slots past the width are dropped. One
        # column at a time: each write hits one slot a row, and a dropped
        # entry writes back what is there.
        slots = (offs + 1)[:, None] + offs_k1  # [S, k+1]
        valid = valid & (slots < width)
        for i in range(k + 1):
            col = torch.clamp(slots[:, i:i + 1], max=width - 1)
            old = state.transcript.gather(1, col)
            state.transcript.scatter_(1, col, torch.where(
                valid[:, i:i + 1], emitted[:, i:i + 1], old))
        m = valid.sum(dim=1)  # [S] window emissions
        new_tok = torch.where(
            m > 0,
            emitted.gather(1, torch.clamp(m - 1, min=0)[:, None])[:, 0],
            state.tok)
        lengths.copy_(torch.where(state.active, (offs + m).to(lengths.dtype),
                                  lengths))
        state.seen.copy_(seen)
        state.tok.copy_(new_tok)
        state.active.copy_(state.active & ~hit_eos)
        emitted_all.append(emitted)
        counts_all.append(m)
    return (torch.stack(emitted_all).to(torch.int32),
            torch.stack(counts_all).to(torch.int32),
            state.active.to(torch.int8))


def _admission_chunk(params, state: SlotState, *, cfg, sampling, model,
                     eos_id: int, pad_id: int,
                     prefill_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One prefill chunk of `prefill_chunk` prompt positions for the oldest
    staged slot: the fused admission's part of a megastep iteration.

    The slot is found on the device (the lowest `stage_seq` among staged
    slots) and its next ids are read from its transcript row; the forward
    writes their KV into the slot's pages at the cursor, the pad tail past
    the true length included, as the JAX package's ragged scatter writes
    it (only writes past the width are masked out; the chunk is clamped to
    end inside it), and positions past the true length clamped to its last
    position (as the cold prefill's are). The real rows never read the pad
    tail's KV; under an MoE model the pad rows, which attend it, share
    expert capacity with the real ones, so they must see what JAX's see.
    When the cursor covers the prompt, the flip: the first token is
    sampled from the last real position's logits with the full-prompt seen
    mask and the slot's staged uniforms, the contract `_prefill_program`
    feeds `_install_program`, and the slot goes live. With nothing staged
    every write is masked and the state stays as it was.

    Returns (flipped [S] bool, firsts [S] int32), one-hot at the flipped
    slot (first tokens `pad_id` elsewhere).
    """
    c = prefill_chunk
    n_slots = state.tok.shape[0]
    width = state.cache.max_len
    dev = state.tok.device
    big = torch.full_like(state.stage_seq, torch.iinfo(torch.int32).max)
    sl = torch.argmin(torch.where(state.staged, state.stage_seq, big))[None]
    has = state.staged[sl]                        # [1]
    cur = state.stage_cursor[sl].long()           # [1]
    tl = state.stage_len[sl].long()               # [1]
    q_slots = cur[:, None] + torch.arange(c, device=dev)[None, :]  # [1, c]
    row = state.transcript.index_select(0, sl)    # [1, width]
    ids = torch.gather(row, 1, torch.clamp(q_slots, max=width - 1))
    positions = torch.clamp(torch.minimum(q_slots, tl[:, None] - 1), min=0)
    keep = has[:, None] & (q_slots < width)
    logits, _ = model.forward(
        params, cfg, ids,
        cache=dataclasses.replace(state.cache, lengths=cur.to(torch.int32),
                                  rows=sl),
        positions=positions, write_mask=keep)
    done = has & (cur + c >= tl)                  # [1]
    last = logits[0].index_select(0, torch.clamp(tl - 1 - cur, 0, c - 1))
    valid = torch.arange(width, device=dev)[None, :] < tl[:, None]
    seen0 = seen_mask_from_ids(row, valid, cfg.vocab_size)   # [1, V]
    noise = (state.stage_noise.index_select(0, sl)
             if state.stage_noise.shape[1] else None)
    first = sample_step(None, last, seen0, sampling, noise=noise)  # [1]
    seen1 = update_seen(seen0, first)
    lengths = state.cache.lengths
    lengths.index_put_((sl,), torch.where(done, tl.to(lengths.dtype),
                                          lengths[sl]))
    state.tok.index_put_((sl,), torch.where(done, first, state.tok[sl]))
    state.active.index_put_((sl,), torch.where(
        has, done & (first != eos_id), state.active[sl]))
    state.seen.index_put_((sl,), torch.where(done[:, None], seen1,
                                             state.seen[sl]))
    state.transcript.index_put_((sl, tl), torch.where(
        done, first, state.transcript[sl, tl]))
    state.staged.index_put_((sl,), torch.where(has, ~done, state.staged[sl]))
    state.stage_cursor.index_put_((sl,), torch.where(
        has, (cur + c).to(torch.int32), state.stage_cursor[sl]))
    flipped = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
    flipped.index_put_((sl,), done)
    firsts = torch.full((n_slots,), pad_id, dtype=torch.int32, device=dev)
    firsts.index_put_((sl,), torch.where(
        done, first, torch.full_like(first, pad_id)).to(torch.int32))
    return flipped, firsts


def _megastep_program(step, admission, active: torch.Tensor,
                      admit: Sequence[bool], *, pad_id: int):
    """K = len(admit) chunks back to back, eagerly (the CPU, and the card
    without graphs): iteration j runs an admission chunk first when
    `admit[j]`, then a decode chunk. `step()` runs one decode chunk
    (`_step_program`, or `_spec_step_program` under speculation),
    `admission()` one admission chunk (`_admission_chunk`), or is None
    without fused admission; `active` is the live state's active plane,
    read at entry. The generator advances exactly as K chunk-loop
    dispatches would advance it.

    Returns (toks [K, chunk, S] int32 (speculation: emitted [K, chunk, S,
    k+1]), active [K, S] int8 post-chunk snapshots, started [S] bool the
    active flags at entry, flipped [K, S] bool and firsts [K, S] int32 with
    fused admission, else None, and counts [K, chunk, S] int32 under
    speculation, else None): the planes `megastep.dead_lane_tokens` reads
    for the JAX package's dead-lane account, which the reap computes."""
    started = active.clone()
    n_slots = active.shape[0]
    planes, actives, flips, firsts = [], [], [], []
    for on in admit:
        if admission is not None:
            if on:
                f, fi = admission()
            else:
                f = torch.zeros((n_slots,), dtype=torch.bool,
                                device=active.device)
                fi = torch.full((n_slots,), pad_id, dtype=torch.int32,
                                device=active.device)
            flips.append(f)
            firsts.append(fi)
        *outs, a = step()
        planes.append(outs)
        actives.append(a)
    toks = torch.stack([p[0] for p in planes])
    counts = (torch.stack([p[1] for p in planes]) if len(planes[0]) > 1
              else None)
    return (toks, torch.stack(actives), started,
            torch.stack(flips) if admission is not None else None,
            torch.stack(firsts) if admission is not None else None, counts)


class PagedEngine:
    """Slot-scheduled serving engine with mid-decode admission.

    Host API (single-threaded; wrap in an executor for async serving):
      submit(prompt) -> request id
      step() -> list[(rid, text)] — admit pending into free slots, dispatch
                the next chunk or megastep, return requests that finished
      drain() -> dict[rid, text] — run until no work remains
    """

    def __init__(self, config: EngineConfig, slots: Optional[int] = None,
                 chunk: int = 16, inflight: int = 2, megastep: int = 1,
                 megastep_max: int = 0, prefix_cache: bool = False,
                 prefix_cache_blocks: int = 512,
                 prefix_block_tokens: int = BLOCK_TOKENS,
                 prefill_chunk_tokens: int = 0,
                 cuda_graphs: Optional[bool] = None,
                 mesh: Optional[Mesh] = None):
        check_quant(config)
        self.config = config
        # Speculative decoding: draft tokens verified per window
        # (`_spec_step_program`); 0 = the plain step. A chunk then counts
        # verify windows, each emitting 1 to spec+1 tokens.
        self.spec = max(0, config.spec_tokens)
        # Tokens per chunk; mid-chunk admissions wait at most `chunk`
        # steps, host round trips shrink by the same factor.
        self.chunk = max(1, chunk)
        # Dispatches kept in flight: at 2 the host dispatches step N+1
        # before reading N's tokens. 1 = dispatch, sync, reap.
        self.inflight_limit = max(1, inflight)
        # Megastep: `megastep` is the controller's starting K, `megastep_max`
        # its ceiling (0 = follow `megastep`); K=1 is the chunk loop.
        self.megastep_max = effective_megastep_max(megastep, megastep_max)
        self.megastep_ks = megastep_ladder(self.megastep_max)
        self._megastep_initial = max(
            k for k in self.megastep_ks if k <= max(1, megastep))
        self.megastep_k = self._megastep_initial
        self.family, self.cfg = registry.resolve(
            config.model, config.dtype, config.param_dtype
        )
        if config.sp > 1:
            raise ValueError(
                "sp applies to TutoringEngine.score's ring-attention path; "
                "the paged engine has no full-sequence forward to shard"
            )
        # The mesh axes (the head split and ep checked first); `tp`, `ep`
        # and `dp` are their sizes.
        self.axes = engine_axes(config, self.family.name, self.cfg,
                                paged=True, mesh=mesh)
        self.tensor_parallel = self.axes.tp
        self.tp, self.ep, self.dp = (self.axes.tp.size, self.axes.ep.size,
                                     self.axes.dp.size)
        # A model call holds a collective only at tp or ep above 1.
        capturable = self.tp == self.ep == 1 or backend_can_capture(
            self.axes.ranks.backend)
        if cuda_graphs and not capturable:
            raise ValueError(
                f"cuda_graphs over the {self.axes.ranks.backend} "
                f"backend: a CUDA graph cannot capture its collectives "
                f"(tp={self.tp}, ep={self.ep}); use nccl with one GPU a "
                f"rank, or cuda_graphs=False")
        self.device = resolve_device(config.device)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda" and capturable
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError("cuda_graphs needs a CUDA device")
        self.cuda_graphs = cuda_graphs
        check_moe_spec(self.spec, self.family.name, self.cfg)
        fused = config.fused_attention
        if fused is None:
            fused = self.device.type == "cuda"
        check_spec_window(config.spec_tokens, fused)
        self.cfg = shard_cfg(self.cfg, self.axes,
                             fused_decode_attention=fused,
                             quant_kv=config.kv_quant)
        # Over several ranks: rank 0's calls, replayed on the others.
        self._spmd = Replica(self, self.axes.ranks)
        self.tokenizer = load_tokenizer(config, self.family.name,
                                        self.cfg.vocab_size)
        self.slots = slots or max(config.batch_buckets)
        # Clamp the prompt bucket so bucket + max_new always fits the
        # position table (long prompts keep their tail in submit()), and
        # under speculation the widest verify window too: it ends k-1
        # slots past the last budgeted token.
        self._spec_extra = max(0, self.spec - 1)
        self.bucket = min(
            max(config.length_buckets),
            self.cfg.max_position_embeddings - config.sampling.max_new_tokens
            - self._spec_extra,
        )
        if self.bucket < 1:
            raise ValueError(
                f"max_new {config.sampling.max_new_tokens} "
                + (f"+ spec overhang {self._spec_extra} " if self.spec
                   else "")
                + f"leaves no room for any prompt token in the position "
                f"table {self.cfg.max_position_embeddings}"
            )
        self.tmax = cfg_tmax(self.cfg, config.sampling, self.bucket)
        # Cache-width buckets: one admissible width per prompt bucket
        # (plus the verify window's overhang under speculation).
        self.widths = sorted({
            cfg_tmax(self.cfg, config.sampling, min(b, self.bucket))
            + self._spec_extra
            for b in config.length_buckets
        })
        self.buckets = sorted({min(b, self.bucket)
                               for b in config.length_buckets})
        # The radix shared-prefix cache of prompt blocks.
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(
                block_tokens=max(1, prefix_block_tokens),
                max_blocks=max(1, prefix_cache_blocks))
            if self._spmd.active:
                # Session expiry on every rank at rank 0's clock.
                self.prefix_cache.clock = self._spmd.clock
        # Fused staged admission: prompt positions prefilled per megastep
        # iteration, clamped (as in the JAX package) so a final chunk's pad
        # tail still ends inside the cache width.
        self.fused = prefill_chunk_tokens > 0
        self.prefill_chunk = 0
        if self.fused:
            self.prefill_chunk = max(1, min(
                prefill_chunk_tokens,
                config.sampling.max_new_tokens + self._spec_extra + 1))
            if self.spec and config.sampling.max_new_tokens < 2:
                # A staged slot's parked window (base width-1-k) must sit
                # above its prompt; max_new = 1 would park it inside.
                raise ValueError(
                    "prefill_chunk_tokens with spec_tokens requires "
                    "max_new_tokens >= 2 (staged-slot parking position)")
        if config.draft_source not in DRAFT_SOURCES:
            raise ValueError(
                f"unknown draft_source {config.draft_source!r}; expected "
                "'prompt_lookup' or 'ngram'")
        self._draft_fn = (build_drafts_ngram
                          if config.draft_source == "ngram"
                          else build_drafts)

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
        self.params = shard_for(params, self.family.name, self.axes)
        log.info("params ready in %.1fs on %s (rank %d of %d: dp %d, tp "
                 "%d, ep %d)", time.monotonic() - t0, self.device,
                 self.axes.ranks.rank, self.axes.world, self.dp, self.tp,
                 self.ep)

        statics = dict(cfg=self.cfg, sampling=config.sampling,
                       model=self.family)
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        self._prefill = functools.partial(_prefill_program, **statics)
        self._partial_prefill = functools.partial(_partial_prefill_program,
                                                  **statics)
        if self.spec:
            self._step = functools.partial(
                _spec_step_program, eos_id=eos, pad_id=pad, chunk=self.chunk,
                spec_tokens=self.spec, draft_fn=self._draft_fn, **statics)
        else:
            self._step = functools.partial(
                _step_program, eos_id=eos, pad_id=pad, chunk=self.chunk,
                **statics)
        self._admission = functools.partial(
            _admission_chunk, eos_id=eos, pad_id=pad,
            prefill_chunk=self.prefill_chunk, **statics)
        # The scoring tenant's program and the shapes warmup runs it at
        # (none unless `config.scoring`).
        self._score = functools.partial(score_program, cfg=self.cfg,
                                        model=self.family)
        self.score_shapes: List[Tuple[int, int]] = (
            derive_score_shapes(config.length_buckets, config.batch_buckets,
                                self.cfg.max_position_embeddings)
            if config.scoring else [])
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        # The one allocation of every state plane, at the widest width;
        # widths are windows, and the planes are only written in place.
        wmax, dev = self.widths[-1], self.device
        self._kv = self.family.init_cache(
            self.cfg, self.slots, wmax, dtype=self.cfg.dtype, device=dev)
        self._lengths = torch.zeros((self.slots,), dtype=torch.int32,
                                    device=dev)
        self._transcript = torch.zeros((self.slots, wmax), dtype=torch.long,
                                       device=dev)
        self._planes = dict(
            tok=torch.zeros((self.slots,), dtype=torch.long, device=dev),
            active=torch.zeros((self.slots,), dtype=torch.bool, device=dev),
            seen=torch.zeros((self.slots, self.cfg.vocab_size),
                             dtype=torch.bool, device=dev),
            staged=torch.zeros((self.slots,), dtype=torch.bool, device=dev),
            stage_cursor=torch.zeros((self.slots,), dtype=torch.int32,
                                     device=dev),
            stage_len=torch.ones((self.slots,), dtype=torch.int32,
                                 device=dev),
            stage_seq=torch.zeros((self.slots,), dtype=torch.int32,
                                  device=dev),
            stage_noise=torch.zeros(
                (self.slots, noise_width(config.sampling,
                                         self.cfg.vocab_size)),
                dtype=torch.float32, device=dev),
        )
        self.state = self._init_state()
        # The distinct static keys each program has run at (host only):
        # what `utils/guards.compile_count_guard` counts.
        self.programs = program_table("PagedEngine")
        # Captured graphs by cache width: (decode chunk, admission chunk or
        # None); filled by warmup() when `cuda_graphs`.
        self._graphs: Dict[int, Tuple[ChunkGraph, Optional[ChunkGraph]]] = {}
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._pending: List[_Request] = []
        # Dispatched-but-unread steps and megasteps, oldest first.
        self._inflight: List[_Dispatch] = []
        self._next_rid = 0
        self.last_ttft_s: Optional[float] = None
        # Per-request time to first token (submit() -> first token on the
        # host), keyed by rid; the serving queue pops these.
        self.ttfts: Dict[int, float] = {}
        # Tokens finished requests generated.
        self.total_generated_tokens = 0
        # Model calls: prefill forwards (one per sequential admission, cold
        # or partial), decode forwards (`chunk` per dispatched chunk) and
        # fused admission chunks; graph replays and host decisions (one per
        # step or megastep dispatch) on the card.
        self.prefill_calls = 0
        self.decode_steps = 0
        self.admission_chunks = 0
        self.graph_replays = 0
        self.host_decisions = 0
        # Drained by pop_dispatch_stats(): host dispatches, tokens emitted
        # to requests, pad lanes burnt inside megasteps, and the admission
        # stall (host wall the decode train spent blocked on sequential
        # admission while live slots waited, with the proxy tokens those
        # slots would have decoded meanwhile; both 0 under fused admission).
        self._dispatches = 0
        self._emitted_tokens = 0
        self._dead_lane_tokens = 0
        self._prefill_stall_s = 0.0
        self._decode_stalled_tokens = 0
        # Speculation's acceptance, from the reaped counts planes and
        # drained by pop_spec_stats(): verify windows a live request ran,
        # and the tokens they emitted.
        self._spec_windows = 0
        self._spec_emitted = 0
        # (program, wall-clock start, dispatch seconds) per dispatch.
        self._prog_times: List[Tuple[str, float, float]] = []
        # Shared-prefix accounting: per-rid pinned tree paths (released when
        # the request completes), per-rid hit lengths, and the counts
        # pop_prefix_stats() drains.
        self._prefix_pins: Dict[int, Match] = {}
        self._prefix_hits: Dict[int, int] = {}
        self._prefix_hit_tokens = 0
        self._prefix_prompt_tokens = 0
        self._prefix_evictions = 0
        # rid -> prompt ids of STAGED requests (their blocks are published
        # at the flip's reap, when `tokens` already holds the answer).
        self._staged_prompts: Dict[int, List[int]] = {}
        self._stage_seq = 0
        # Streaming: watched rids keep their final (eos-filtered) token
        # list at the reap, for pop_final_tokens().
        self._stream_watch: set = set()
        self._final_tokens: Dict[int, List[int]] = {}
        # Session turns: rid -> (session id, pin TTL, prompt ids), set by
        # mark_session() and consumed at the finish reap.
        self._session_reqs: Dict[int, Tuple[str, float, List[int]]] = {}
        # rid -> seconds from submit() to its admission (the queue.wait
        # span's true length), drained by pop_queue_waits().
        self._queue_waits: Dict[int, float] = {}
        # Over several ranks, the host's choices, newest last, on each:
        # ("admit", rid, slot) and ("stage", rid, slot) per admission,
        # ("dispatch", K, admission plan) per step; the ranks' logs are
        # equal. Empty at tp 1.
        self.decisions: collections.deque = collections.deque(
            maxlen=self._PROG_TIMES_MAX)

    _PROG_TIMES_MAX = 4096

    def follow(self, on_result=None) -> None:
        """A rank other than 0: replay rank 0's calls until it stops
        (`stop_followers`); `on_result(name, result)` sees each replayed
        call's result before this rank drains its stats (`Replica.follow`).
        """
        self._spmd.follow(on_result)

    def stop_followers(self) -> None:
        """Rank 0: release the other ranks from `follow`."""
        self._spmd.stop()

    def _decide(self, *decision) -> None:
        """Log a host decision over several ranks (`decisions`)."""
        if self._spmd.active:
            self.decisions.append(decision)

    def _followed(self, name: str, result) -> None:
        """On a follower after each replayed call: drain what rank 0's
        queue would drain, so nothing piles up."""
        for pop in (self.pop_final_tokens, self.pop_ttfts,
                    self.pop_dispatch_stats, self.pop_program_times,
                    self.pop_queue_waits, self.pop_prefix_hits,
                    self.pop_spec_stats, self.pop_prefix_stats):
            pop()

    def _time_prog(self, name: str, t0: float, t0_unix: float) -> None:
        """Record one dispatch's host wall time."""
        self._dispatches += 1
        self._prog_times.append((name, t0_unix, time.monotonic() - t0))
        if len(self._prog_times) > self._PROG_TIMES_MAX:
            del self._prog_times[: -self._PROG_TIMES_MAX]

    def _shed_oldest(self, d: Dict[int, object]) -> None:
        """Bound a per-rid dict that a queue-less caller never pops."""
        if len(d) > self._PROG_TIMES_MAX:
            for rid in list(d)[: -self._PROG_TIMES_MAX // 2]:
                d.pop(rid, None)

    def pop_dispatch_stats(self) -> Tuple[int, int, int, float, int]:
        """Drain (host_dispatches, emitted_tokens, dead_lane_tokens,
        prefill_stall_ms, decode_stalled_tokens) accumulated since the last
        call, the JAX engine's tuple. dispatches/tokens is the serving
        queue's `host_dispatches_per_token` gauge; the rest feed the
        `megastep_dead_lane_tokens`, `prefill_stall_ms` and
        `decode_stalled_tokens` counters."""
        out = (self._dispatches, self._emitted_tokens,
               self._dead_lane_tokens, self._prefill_stall_s * 1000.0,
               self._decode_stalled_tokens)
        self._dispatches = self._emitted_tokens = self._dead_lane_tokens = 0
        self._prefill_stall_s = 0.0
        self._decode_stalled_tokens = 0
        return out

    def pop_spec_stats(self) -> Optional[Tuple[int, int]]:
        """Drain (verify windows, tokens they emitted) since the last call;
        None when speculation is off. emitted / windows is the mean tokens
        a window (1.0 = no draft accepted, spec_tokens + 1 = all);
        emitted - windows counts the tokens beyond each window's guaranteed
        one. The serving queue's `spec_tokens_per_window` gauge and
        `spec_accepted_tokens` counter."""
        if not self.spec:
            return None
        out = (self._spec_windows, self._spec_emitted)
        self._spec_windows = self._spec_emitted = 0
        return out

    def pop_prefix_stats(self) -> Optional[Tuple[int, int, int, int]]:
        """Drain (hit_tokens, prompt_tokens, evicted_blocks, blocks_used)
        since the last call; None without a prefix cache. hit_tokens counts
        prompt tokens whose KV was spliced from the tree (the prefix USED
        after fitting), prompt_tokens all admitted prompt tokens."""
        if self.prefix_cache is None:
            return None
        out = (self._prefix_hit_tokens, self._prefix_prompt_tokens,
               self._prefix_evictions, self.prefix_cache.blocks_used)
        self._prefix_hit_tokens = self._prefix_prompt_tokens = 0
        self._prefix_evictions = 0
        return out

    def pop_prefix_hits(self) -> Dict[int, int]:
        """Drain rid -> shared-prefix tokens spliced at that request's
        admission (0 = cold prefill)."""
        out, self._prefix_hits = self._prefix_hits, {}
        return out

    def pop_program_times(self) -> List[Tuple[str, float, float]]:
        """Drain (program, start_unix, dispatch_s) recorded since last
        call."""
        out, self._prog_times = self._prog_times, []
        return out

    def pop_queue_waits(self) -> Dict[int, float]:
        """Drain rid -> seconds spent pending before its admission (the
        `queue.wait` stage of a trace)."""
        out, self._queue_waits = self._queue_waits, {}
        return out

    @property
    def kv_bytes_per_chip(self) -> int:
        """Bytes of the live slot KV working set (k/v plus the int8 scale
        planes) at the cache's current width on this rank's device: its
        Hkv / tp heads. The `serving_kv_bytes_per_chip` gauge."""
        c = self.state.cache
        return sum(x.numel() * x.element_size()
                   for x in (c.k, c.v, c.ks, c.vs) if x is not None)

    @property
    def kv_bytes_total(self) -> int:
        """Logical bytes of the whole model's slot KV working set: every
        rank's heads (tp x this rank's)."""
        return self.kv_bytes_per_chip * self.tp

    def _init_state(self, width: Optional[int] = None) -> SlotState:
        """A clean state at `width`: every plane and the KV pages zeroed IN
        PLACE (stage_len to ones) and windowed, as the JAX package builds
        a fresh zero state. A live slot never attends past its length, but
        dead and parked staged rows still run a forward over their pages,
        and under an MoE model their rows compete for expert capacity with
        the live ones: stale pages would change live answers."""
        width = width or self.widths[0]
        self._lengths.zero_()
        self._transcript.zero_()
        for x in (self._kv.k, self._kv.v, self._kv.ks, self._kv.vs):
            if x is not None:
                x.zero_()
        for name, x in self._planes.items():
            x.fill_(1 if name == "stage_len" else 0)
        return SlotState(
            cache=dataclasses.replace(self._kv.window(width),
                                      lengths=self._lengths),
            transcript=self._transcript[:, :width], **self._planes)

    # ------------------------------------------------------------ host API

    def submit(self, prompt: str) -> int:
        with self._spmd.call("submit", prompt):
            return self._submit(prompt)

    def _submit(self, prompt: str) -> int:
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

    def mark_session(self, rid: int, session_id: str, ttl_s: float) -> bool:
        """Tag a just-submitted request as a tutoring-session turn: at its
        finish its whole transcript (prompt + generated tokens, eos
        excluded) is published into the radix tree and session-pinned for
        `ttl_s`, so the next turn, whose prompt extends this transcript,
        admits with a shared-prefix hit. Only while the request is still
        pending (its `tokens` still hold the prompt); no-op without a
        prefix cache."""
        if self.prefix_cache is None:
            return False
        with self._spmd.call("mark_session", rid, session_id, ttl_s):
            for req in self._pending:
                if req.rid == rid:
                    self._session_reqs[rid] = (session_id, float(ttl_s),
                                               list(req.tokens))
                    return True
            return False

    @property
    def backlog(self) -> int:
        """Requests submitted but not yet admitted to a decode slot (their
        prefill has not run). The serving queue counts these toward its
        admission bound."""
        return len(self._pending)

    def cancel_pending(self, rid: int) -> bool:
        """Remove a not-yet-admitted request; True if it was still pending.
        A request already in a slot is not cancellable."""
        with self._spmd.call("cancel_pending", rid):
            for i, req in enumerate(self._pending):
                if req.rid == rid:
                    del self._pending[i]
                    self._session_reqs.pop(rid, None)
                    self._stream_watch.discard(rid)
                    return True
            return False

    @torch.no_grad()
    def warmup(self) -> float:
        """Run every program over its whole domain before serving, so no
        request pays for a first launch, a kernel build or a graph
        capture (`programs` then holds exactly the keys
        `engine/program_inventory.py` inventories): at each cache width,
        each prompt bucket that fits it is admitted (prefilled and
        installed, or staged), then each dispatch serving can choose runs
        there; with `cuda_graphs` the chunk programs are captured first (a
        decode chunk, and with fused admission an admission chunk: a
        rung-K megastep replays them K times, so this covers every rung).
        Then every width growth runs, and with the prefix cache its block
        export and splice (per width when fused; per bucket, with every
        partial prefill, when sequential), as the JAX package warms them.
        Then one ghost request is drained and the generator is seeded
        again, so serving draws the same numbers with or without graphs.
        With `scoring` on, the score program runs at each of
        `score_shapes` once the graphs are captured. Returns seconds."""
        with self._spmd.call("warmup", collective=True):
            return self._warmup()

    def _warmup(self) -> float:
        t0 = time.monotonic()
        for width in self.widths:
            self.state = self._init_state(width)
            for t in self.buckets:
                if self._required_width(t) > width:
                    continue  # a prompt this long can't run at this width
                ids = torch.full((1, t), self.tokenizer.pad_id,
                                 dtype=torch.long, device=self.device)
                if self.fused:
                    self._record("_stage", (t, width))
                    _stage_program(self.state, 0, ids, 1, 0, 0, draw_noise(
                        self.generator, 1, self.config.sampling,
                        self.cfg.vocab_size, self.device))
                    continue
                self._record("_prefill", t)
                first, seen_row = self._prefill(self.params, ids, 1,
                                                self.generator,
                                                self._slot_cache(0, t))
                self._record("_install", (t, width))
                _install_program(self.state, 0, ids, 1, first, seen_row,
                                 eos_id=self.tokenizer.eos_id)
            if self.cuda_graphs:
                self._capture(width)
            # Each dispatch serving can choose at this width, through the
            # serving path (graph replays on the card): the chunk loop and,
            # where the ladder climbs, a megastep.
            self._dispatch([self.fused])
            if not self.fused and len(self.megastep_ks) > 1:
                self._dispatch([False, False])
            if self.fused and self._block_buckets():
                # Fused shared-prefix programs at this width: a block
                # published out of the live state and spliced back.
                blk = self._export_block(0, 0, width)
                self._splice_blocks([blk], 0, "_stage_block", width)
        for i, wa in enumerate(self.widths):
            for wb in self.widths[i + 1:]:
                self.state = self._init_state(wa)
                self._grow_if_needed(wb)
        self._warm_score()
        if self.prefix_cache is not None and not self.fused:
            self._warm_partial_prefill()
        self.reset()
        rid = self.submit("warmup")
        self.drain()
        self.ttfts.pop(rid, None)
        if self.prefix_cache is not None:
            # The ghost prompt's blocks must not seed the live tree.
            self.prefix_cache.clear()
            self._prefix_hit_tokens = self._prefix_prompt_tokens = 0
            self._prefix_evictions = 0
            self._prefix_hits = {}
        # The warmup drain is not serving traffic.
        self.pop_dispatch_stats()
        self.pop_program_times()
        self.pop_queue_waits()
        self.megastep_k = self._megastep_initial
        self.generator.manual_seed(self.config.seed)
        return time.monotonic() - t0

    def _block_buckets(self) -> List[int]:
        """Prompt buckets that hold a whole prefix-cache block (none
        without the cache)."""
        pc = self.prefix_cache
        if pc is None:
            return []
        return [t for t in self.buckets if t >= pc.block_tokens]

    def _warm_partial_prefill(self) -> None:
        """Sequential admission's shared-prefix programs over their whole
        domain, as the JAX package warms them: per bucket that holds a
        block, a cold prefill and the block's export; per suffix bucket
        that leaves a whole block of prefix, the splice and the partial
        prefill. Offsets and lengths are not keys, so pad prompts cover
        the live domain."""
        blk_t = self.prefix_cache.block_tokens
        for t in self._block_buckets():
            ids = torch.full((1, t), self.tokenizer.pad_id, dtype=torch.long,
                             device=self.device)
            pages = self._slot_cache(0, t)
            self._record("_prefill", t)
            self._prefill(self.params, ids, 1, self.generator, pages)
            blk = self._export_block(0, 0, t)
            for s in self.buckets:
                if s > t - blk_t:
                    continue
                self._splice_blocks([blk], 0, "_load_block", t)
                suf = torch.full((1, s), self.tokenizer.pad_id,
                                 dtype=torch.long, device=self.device)
                self._record("_partial_prefill", (t, s))
                self._partial_prefill(self.params, pages, ids, suf, blk_t,
                                      blk_t + 1, self.generator)

    def _record(self, program: str, key) -> None:
        """Note a static key `program` ran at (host work only)."""
        self.programs[program].record(key)

    def _export_block(self, off: int, slot: int, key) -> KVBlock:
        """A fresh copy of one block of a slot's pages (`key`: the
        export's static key, the prompt bucket in sequential admission,
        the live width in fused admission and for session turns)."""
        self._record("_export_block", key)
        return _export_block_program(self._kv, off, slot,
                                     block=self.prefix_cache.block_tokens)

    def _splice_blocks(self, blocks: Sequence[KVBlock], slot: int,
                       program: str, key) -> None:
        """Copy tree blocks into a slot's pages from offset 0, as
        `program` ("_load_block": sequential, keyed by the prompt bucket;
        "_stage_block": fused, keyed by the live width)."""
        self._record(program, key)
        for i, blk in enumerate(blocks):
            _splice_block_program(self._kv, blk, slot,
                                  i * self.prefix_cache.block_tokens)

    def _capture(self, width: int) -> None:
        """Capture the chunk graphs of `width` over the state windowed to
        it (the addresses every later window of that width shares)."""
        state = self.state
        decode = ChunkGraph(
            lambda: self._step(self.params, state, self.generator),
            self.generator)
        admission = None
        if self.fused:
            admission = ChunkGraph(
                lambda: self._admission(self.params, state))
        self._graphs[width] = (decode, admission)

    def _warm_score(self) -> int:
        """Run the score program over its (batch bucket x length bucket)
        domain; a no-op when scoring is off."""
        return warm_score(self)

    @property
    def score_batch_cap(self) -> int:
        """Texts a single-dispatch score quantum holds (the largest batch
        bucket): the scoring tenant's preemption granularity."""
        return max(self.config.batch_buckets)

    def score(self, texts: Sequence[str]) -> List[dict]:
        """Log-likelihood scoring (`engine/scoring.py`): per text the
        logprob, tokens, perplexity and a `truncated` flag. The scoring
        tenant's quantum calls this with at most `score_batch_cap` texts:
        one forward and one readback."""
        with self._spmd.call("score", list(texts), collective=True):
            return score_texts(self, texts)

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

    def stream_watch(self, rid: int) -> None:
        """Mark `rid` as streamed: its final token list is kept at the reap
        for pop_final_tokens(). Idempotent."""
        with self._spmd.call("stream_watch", rid):
            self._stream_watch.add(rid)

    def stream_unwatch(self, rid: int) -> None:
        """Stop watching `rid`. Under tp deferred to the next step on every
        rank, like `release_session` (a stream's consumer calls it from
        the event loop while a step may run)."""
        if self._spmd.defer("stream_unwatch", rid):
            return
        self._stream_watch.discard(rid)
        self._final_tokens.pop(rid, None)

    def stream_snapshot(self, rids) -> Dict[int, List[int]]:
        """The incremental token channel: for each requested rid live in a
        slot (flipped, not finished), a copy of its generated-so-far token
        list with eos filtered, the view decode() renders at the finish.
        Reads the host lists the reap fills: no device work. Called
        between steps, never concurrently with step()."""
        want = set(rids)
        out: Dict[int, List[int]] = {}
        if not want:
            return out
        eos = self.tokenizer.eos_id
        for req in self._slot_req:
            if req is None or req.finished or not req.live:
                continue
            if req.rid in want:
                out[req.rid] = [t for t in req.tokens if t != eos]
        return out

    def decode_tokens(self, tokens) -> str:
        """Decode a generated-token prefix (stream offsets count these
        tokens; a resume at offset K skips len(decode(tokens[:K]))
        characters)."""
        return self.tokenizer.decode(list(tokens))

    def decode_complete(self, tokens) -> str:
        """decode_tokens() less a trailing incomplete UTF-8 character: a
        stream delivers a token prefix only when the two agree."""
        return self.tokenizer.decode_complete(list(tokens))

    def pop_final_tokens(self) -> Dict[int, List[int]]:
        """Drain the final (eos-filtered) token lists of watched requests
        that finished since the last call."""
        out, self._final_tokens = self._final_tokens, {}
        return out

    def reset(self) -> None:
        """Discard all in-flight work and rebuild a clean slot state (in
        place: the graphs keep reading the same planes).

        Needed after a failed step: the serving queue fails the affected
        requests and resets the engine, so later requests start clean. The
        radix tree survives (its blocks are never written); the requests'
        pins die with them.
        """
        with self._spmd.call("reset"):
            self._reset()

    def _reset(self) -> None:
        self.state = self._init_state()
        self._slot_req = [None] * self.slots
        self._pending = []
        self._inflight = []
        self.ttfts = {}
        self._stream_watch = set()
        self._final_tokens = {}
        self._session_reqs = {}
        self._prog_times = []
        self._queue_waits = {}
        self._staged_prompts = {}
        self.megastep_k = self._megastep_initial
        if self.prefix_cache is not None:
            for pin in self._prefix_pins.values():
                self.prefix_cache.release(pin)
        self._prefix_pins = {}
        self._prefix_hits = {}

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
        self._queue_waits[req.rid] = time.monotonic() - req.submit_time
        self._shed_oldest(self._queue_waits)
        bucket = min(
            pick_bucket(req.prompt_len, self.config.length_buckets),
            self.bucket,
        )
        w_req = self._required_width(req.prompt_len)
        ids = np.full((1, bucket), self.tokenizer.pad_id, np.int64)
        ids[0, : req.prompt_len] = req.tokens
        # The upload is a copy from pageable memory: on the card it waits
        # for the stream (a sync the strict-dispatch check sees).
        with intended_transfer():
            ids_dev = torch.from_numpy(ids).to(self.device)
        return req, bucket, w_req, ids_dev

    def _grow_if_needed(self, w_req: int) -> None:
        if w_req > self.state.cache.max_len:
            self._record("_grow", (self.state.cache.max_len, w_req))
            t0, t0u = time.monotonic(), time.time()
            self.state = _grow_state_program(self.state, self._kv,
                                             self._transcript, w_req)
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
            first, seen_row = self._run_prefill(req, slot, bucket, ids)
            self._record("_install", (bucket, self.state.cache.max_len))
            t0, t0u = time.monotonic(), time.time()
            _install_program(self.state, slot, ids, req.prompt_len, first,
                             seen_row, eos_id=self.tokenizer.eos_id)
            self._time_prog("install", t0, t0u)
            self._decide("admit", req.rid, slot)
            admitted.append((slot, req, first))
        if not admitted:
            return
        with intended_transfer():  # ONE sync for the whole admitted group
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

    def _run_prefill(self, req: _Request, slot: int, bucket: int,
                     ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One request's prompt into its slot's first `bucket` pages: a
        cold prefill, or, on a shared-prefix hit, the cached blocks spliced
        in and a partial prefill over the suffix. The completed prompt's
        blocks are then published to the tree, and the matched path stays
        pinned until the request finishes. Returns (first, seen_row)."""
        pc = self.prefix_cache
        prefix_used = suffix_bucket = 0
        match: Optional[Match] = None
        if pc is not None:
            match = pc.lookup(req.tokens)
            if match.tokens:
                prefix_used, suffix_bucket = plan_partial(
                    match.tokens, req.prompt_len, bucket, self.buckets,
                    pc.block_tokens)
        pages = self._slot_cache(slot, bucket)
        if prefix_used:
            pc.acquire(match)
            self._prefix_pins[req.rid] = match
            blocks = match.blocks()[: prefix_used // pc.block_tokens]
            t0, t0u = time.monotonic(), time.time()
            self._splice_blocks(blocks, slot, "_load_block", bucket)
            self._dispatches += max(0, len(blocks) - 1)
            self._time_prog("load_block", t0, t0u)
            suf = np.full((1, suffix_bucket), self.tokenizer.pad_id,
                          np.int64)
            suf[0, : req.prompt_len - prefix_used] = req.tokens[prefix_used:]
            with intended_transfer():  # the suffix's upload
                suf_dev = torch.from_numpy(suf).to(self.device)
            self._record("_partial_prefill", (bucket, suffix_bucket))
            t0, t0u = time.monotonic(), time.time()
            first, seen_row = self._partial_prefill(
                self.params, pages, ids, suf_dev,
                prefix_used, req.prompt_len, self.generator)
            self._time_prog("partial_prefill", t0, t0u)
        else:
            self._record("_prefill", bucket)
            t0, t0u = time.monotonic(), time.time()
            first, seen_row = self._prefill(self.params, ids, req.prompt_len,
                                            self.generator, pages)
            self._time_prog("prefill", t0, t0u)
        self.prefill_calls += 1
        if pc is not None:
            self._publish(req.tokens, req.prompt_len, slot, bucket)
            self._prefix_hit_tokens += prefix_used
            self._prefix_prompt_tokens += req.prompt_len
            self._prefix_hits[req.rid] = prefix_used
            self._shed_oldest(self._prefix_hits)
        return first, seen_row

    def _publish(self, prompt: List[int], prompt_len: int, slot: int,
                 key) -> None:
        """Publish a prefilled prompt's whole blocks into the radix tree,
        copied out of the slot's pages (only blocks the tree lacks; `key`
        is the export's static key), then enforce the block budget (after
        the insert, so a publish never evicts blocks its own admission
        references; pinned paths never go)."""
        pc = self.prefix_cache
        blk_t = pc.block_tokens
        t0, t0u = time.monotonic(), time.time()
        added = pc.insert(
            prompt[: (prompt_len // blk_t) * blk_t],
            lambda i: self._export_block(i * blk_t, slot, key))
        if added:
            self._dispatches += added - 1
            self._time_prog("export_block", t0, t0u)
        self._prefix_evictions += pc.evict_to_budget()

    def _stage_admissions(self) -> None:
        """Fused admission: hand every admissible pending request to the
        device as a STAGED slot (ids into the transcript row, cached prefix
        blocks spliced into the slot's pages, the staged plane armed) with
        no blocking work. The prefill advances inside the megasteps, and
        the flip's first token comes back through their flipped/firsts
        planes at a later reap: the decode train never pauses."""
        self._maybe_rebuild_idle()
        pc = self.prefix_cache
        for slot in range(self.slots):
            if self._slot_req[slot] is not None or not self._pending:
                continue
            req, bucket, w_req, ids = self._pop_next()
            # The uniforms the sequential admission's prefill would draw
            # here: the flip samples with them.
            noise = draw_noise(self.generator, 1, self.config.sampling,
                               self.cfg.vocab_size, self.device)
            cursor0 = 0
            if pc is not None:
                match = pc.lookup(req.tokens)
                cursor0 = plan_staged(match.tokens, req.prompt_len,
                                      pc.block_tokens)
                if cursor0:
                    pc.acquire(match)
                    self._prefix_pins[req.rid] = match
                self._prefix_hit_tokens += cursor0
                self._prefix_prompt_tokens += req.prompt_len
                self._prefix_hits[req.rid] = cursor0
                self._shed_oldest(self._prefix_hits)
                self._staged_prompts[req.rid] = list(req.tokens)
            self._grow_if_needed(w_req)
            if cursor0:
                blocks = match.blocks()[: cursor0 // pc.block_tokens]
                t0, t0u = time.monotonic(), time.time()
                self._splice_blocks(blocks, slot, "_stage_block",
                                    self.state.cache.max_len)
                self._dispatches += max(0, len(blocks) - 1)
                self._time_prog("stage_block", t0, t0u)
            self._record("_stage", (bucket, self.state.cache.max_len))
            t0, t0u = time.monotonic(), time.time()
            _stage_program(self.state, slot, ids, req.prompt_len, cursor0,
                           self._stage_seq, noise)
            self._time_prog("stage", t0, t0u)
            req.stage_seq = self._stage_seq
            self._decide("stage", req.rid, slot)
            self._stage_seq += 1
            req.live = False
            req.chunks_left = -(-(req.prompt_len - cursor0)
                                // self.prefill_chunk)
            self._slot_req[slot] = req

    def _publish_staged(self, req: _Request, slot: int) -> None:
        """Fused admission's publish, at the flip's reap: the prompt's KV
        is in the slot's pages of the live cache (decode writes only at >=
        prompt_len, and the slot cannot be staged again before this reap
        returns)."""
        tokens = self._staged_prompts.pop(req.rid, None)
        if tokens is not None:
            self._publish(tokens, req.prompt_len, slot,
                          self.state.cache.max_len)

    def _publish_session(self, req: _Request, slot: int) -> None:
        """A session turn's finish-reap publish: the slot's pages hold the
        KV of the prompt and of every generated token fed back (all but the
        last sampled one), so the block export that publishes prompts
        publishes the whole transcript. The path is then session-pinned
        with the turn's TTL; the same insert-then-evict policy as prompt
        publishes."""
        entry = self._session_reqs.pop(req.rid, None)
        pc = self.prefix_cache
        if entry is None or pc is None:
            return
        session_id, ttl_s, prompt_toks = entry
        eos = self.tokenizer.eos_id
        gen: List[int] = []
        for t in req.tokens:
            if t == eos:
                break
            gen.append(t)
        full = prompt_toks + gen
        # KV exists only for fed positions: the last sampled token (and
        # any eos) never went back into the model.
        safe = min(len(full), req.prompt_len + len(req.tokens) - 1)
        blk_t = pc.block_tokens
        n = (safe // blk_t) * blk_t
        if n <= 0:
            return
        t0, t0u = time.monotonic(), time.time()
        width = self.state.cache.max_len
        added = pc.insert(
            full[:n], lambda i: self._export_block(i * blk_t, slot, width))
        if added:
            self._dispatches += added - 1
            self._time_prog("export_block", t0, t0u)
        pc.pin_session(session_id, full[:n], ttl_s)
        self._prefix_evictions += pc.evict_to_budget()

    def release_session(self, session_id: str) -> bool:
        """Drop a session's transcript pin (the session closed). Under tp,
        rank 0 defers it to the next step on every rank (the server calls
        it from the event loop while a step may run) and returns whether
        the session was pinned."""
        if self.prefix_cache is None:
            return False
        if self._spmd.defer("release_session", session_id):
            return session_id in self.prefix_cache._session_pins
        return self.prefix_cache.release_session(session_id)

    def session_pin_stats(self) -> Optional[Tuple[int, int]]:
        """(live pinned sessions, blocks their paths hold resident) for the
        session gauges; None without a prefix cache. Expires lapsed pins
        first, so the gauge never counts dead sessions."""
        pc = self.prefix_cache
        if pc is None:
            return None
        self.expire_sessions(self._spmd.clock())
        return pc.session_count, pc.session_pinned_blocks()

    def expire_sessions(self, now: float) -> int:
        """Release the session pins lapsed at `now`. Under tp recorded
        with `now`, so every rank releases the same pins before the next
        step (the eviction's pin order breaks its ties)."""
        with self._spmd.call("expire_sessions", now):
            return self.prefix_cache.expire_sessions(now)

    def _required_width(self, prompt_len: int) -> int:
        bucket = min(
            pick_bucket(prompt_len, self.config.length_buckets), self.bucket
        )
        return (cfg_tmax(self.cfg, self.config.sampling, bucket)
                + self._spec_extra)

    def _live(self) -> bool:
        return any(r is not None and not r.finished and r.live
                   for r in self._slot_req)

    def _any_staged(self) -> bool:
        """Any slot whose staged prefill has not flipped yet: device work
        that keeps dispatching even while no slot is live."""
        return any(r is not None and not r.finished and not r.live
                   for r in self._slot_req)

    def _slack_chunks(self) -> Optional[int]:
        """Chunks until some live slot is GUARANTEED to free (the K
        controller's admission horizon): the fewest remaining budget chunks
        among live slots, less one chunk per dispatched-but-unreaped chunk.
        None when no live slot bounds it."""
        rem = None
        for req in self._slot_req:
            if req is None or req.finished or not req.live:
                continue  # staged requests hold no budget yet
            r = req.max_new - len(req.tokens)
            rem = r if rem is None else min(rem, r)
        if rem is None:
            return None
        chunks = -(-max(0, rem) // self.chunk)  # ceil
        return max(0, chunks - sum(d.k for d in self._inflight))

    def _plan_admissions(self, k: int) -> List[bool]:
        """Which of the next `k` iterations run an admission chunk: one per
        iteration, in staging order, while staged prompts have chunks left
        (the device serves the lowest `stage_seq` the same way)."""
        queue = sorted((r for r in self._slot_req
                        if r is not None and not r.live and r.chunks_left),
                       key=lambda r: r.stage_seq)
        plan = []
        for _ in range(k):
            while queue and not queue[0].chunks_left:
                queue.pop(0)
            plan.append(bool(queue))
            if queue:
                queue[0].chunks_left -= 1
        return plan

    @torch.no_grad()
    def step(self) -> List[Tuple[int, str]]:
        """Admit (or stage) pending requests, dispatch the next chunk (K=1)
        or megastep, and reap the oldest in-flight dispatch once the
        pipeline is full.

        Pipelining (inflight_limit=2 default): the dispatch for step N+1
        goes out BEFORE step N's tokens are read back, so the readback
        overlaps N+1's device compute. Completions therefore surface one
        step() call after their dispatch at steady state; the tail drains
        in the same call once no live or staged slot remains.
        """
        with self._spmd.call("step", collective=True):
            return self._step_once()

    def _step_once(self) -> List[Tuple[int, str]]:
        if self.fused:
            self._stage_admissions()
        else:
            self._admit()
        work = self._live() or self._any_staged()
        if work:
            self.megastep_k = next_megastep_k(
                self.megastep_k, self.megastep_ks, len(self._pending),
                self._slack_chunks(), fused=self.fused)
            k = self.megastep_k
            admit = (self._plan_admissions(k) if self.fused
                     else [False] * k)
            self._decide("dispatch", k, tuple(admit))
            t0, t0u = time.monotonic(), time.time()
            self._dispatch(admit)
            self.decode_steps += k * self.chunk
            self.admission_chunks += sum(admit)
            self.host_decisions += 1
            self._time_prog("megastep" if self.fused or k > 1 else "step",
                            t0, t0u)
        done: List[Tuple[int, str]] = []
        while self._inflight and (
            len(self._inflight) >= self.inflight_limit
            if self._live() or self._any_staged() else True
        ):
            done.extend(self._reap(self._inflight.pop(0)))
            # _reap may finish the last live request: the loop condition
            # re-evaluates _live(), so remaining dispatches drain here.
        return done

    def _dispatch(self, admit: List[bool]) -> None:
        """Run K = len(admit) chunks on the device and queue their outputs
        for a later reap: graph replays on the card with `cuda_graphs`,
        else eager chunks. No host sync either way. Records the program
        the JAX package would dispatch: `_step` for a lone chunk of
        sequential admission, else `_megastep`, keyed by the width and the
        chunk graphs it runs."""
        width = self.state.cache.max_len
        if self.fused or len(admit) > 1:
            self._record("_megastep", (width, "decode"))
            if any(admit):
                self._record("_megastep", (width, "admission"))
        else:
            self._record("_step", width)
        if self.cuda_graphs:
            self._inflight.append(self._replay(admit))
            return
        planes = self._run_eager(admit)
        event = None
        if planes[0].device.type == "cuda":
            # The copies start now, into pinned memory, and stream back
            # while later dispatches compute.
            planes = tuple(None if x is None else _to_pinned(x)
                           for x in planes)
            event = torch.cuda.Event()
            event.record()
        toks, active, started, flipped, firsts, counts = planes
        # The slot snapshot records which request each column belonged to
        # at dispatch time (a slot reused later belongs to a later step).
        self._inflight.append(_Dispatch(
            toks=toks, active=active, started=started, flipped=flipped,
            firsts=firsts, counts=counts, event=event,
            slots=list(self._slot_req)))

    def _run_eager(self, admit: List[bool]):
        """`_megastep_program` over the live state: K eager chunks."""
        state = self.state
        return _megastep_program(
            lambda: self._step(self.params, state, self.generator),
            (lambda: self._admission(self.params, state)) if self.fused
            else None,
            state.active, admit, pad_id=self.tokenizer.pad_id)

    def _replay(self, admit: List[bool]) -> _Dispatch:
        """One megastep as graph replays at the live width: per iteration
        the admission graph (where planned) and the decode graph, each
        followed on the same stream by the copies of its outputs into this
        dispatch's own pinned buffers (the next replay rewrites them)."""
        width = self.state.cache.max_len
        graphs = self._graphs.get(width)
        if graphs is None:
            raise RuntimeError(
                f"no CUDA graph captured for cache width {width}: call "
                f"warmup() before serving (graphs are not captured while "
                f"serving)")
        decode, admission = graphs
        k, s = len(admit), self.slots
        window = (self.spec + 1,) if self.spec else ()
        toks = torch.empty((k, self.chunk, s, *window), dtype=torch.int32,
                           pin_memory=True)
        counts = (torch.empty((k, self.chunk, s), dtype=torch.int32,
                              pin_memory=True) if self.spec else None)
        active = torch.empty((k, s), dtype=torch.int8, pin_memory=True)
        started = torch.empty((s,), dtype=torch.bool, pin_memory=True)
        started.copy_(self.state.active, non_blocking=True)
        flipped = firsts = None
        if self.fused:
            flipped = torch.zeros((k, s), dtype=torch.bool, pin_memory=True)
            firsts = torch.full((k, s), self.tokenizer.pad_id,
                                dtype=torch.int32, pin_memory=True)
        for j, on in enumerate(admit):
            if on:
                f, fi = admission.replay()
                flipped[j].copy_(f, non_blocking=True)
                firsts[j].copy_(fi, non_blocking=True)
                self.graph_replays += 1
            *outs, a = decode.replay()
            toks[j].copy_(outs[0], non_blocking=True)
            if counts is not None:
                counts[j].copy_(outs[1], non_blocking=True)
            active[j].copy_(a, non_blocking=True)
            self.graph_replays += 1
        event = torch.cuda.Event()
        event.record()
        return _Dispatch(toks=toks, active=active, started=started,
                         flipped=flipped, firsts=firsts, counts=counts,
                         event=event, slots=list(self._slot_req))

    def _reap(self, d: _Dispatch) -> List[Tuple[int, str]]:
        """Read one dispatch's results (its whole [K, chunk, S] plane in
        one pass) and finish the requests it completed. Under fused
        admission the same pass learns which staged slots flipped live: the
        flip's first token heads the request's stream (TTFT recorded here,
        the first host moment the token exists), its prompt blocks publish
        into the radix tree, and its decode walk starts at the flip
        iteration's rows (earlier rows are pre-flip filler)."""
        if d.event is not None:
            with intended_transfer():  # THE sync point of the engine loop
                d.event.synchronize()
        k_axis = d.k
        # A lane under speculation is a verify window of spec+1 positions.
        self._dead_lane_tokens += int(dead_lane_tokens(
            d.started, d.active, d.flipped, self.chunk * (self.spec + 1)))
        toks = d.toks.numpy().reshape(k_axis * self.chunk, self.slots,
                                      *d.toks.shape[3:])
        counts = (None if d.counts is None
                  else d.counts.numpy().reshape(k_axis * self.chunk,
                                                self.slots))
        # Dead-slot detection keys off the FINAL snapshot: a slot that
        # died in chunk j padded every later lane.
        active = d.active.numpy()[-1]
        flipped = None if d.flipped is None else d.flipped.numpy()
        firsts = None if d.firsts is None else d.firsts.numpy()
        done: List[Tuple[int, str]] = []
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        now = time.monotonic()
        for slot, req in enumerate(d.slots):
            if req is None or req.finished:
                # Empty at dispatch, or finished by an earlier chunk — this
                # chunk's column holds dead-slot filler.
                continue
            start_row = 0
            if not req.live:
                # Staged at dispatch: only a flip makes this column
                # meaningful, and its inactive flag is not a death.
                col = (np.zeros((k_axis,), bool) if flipped is None
                       else flipped[:, slot])
                if not col.any():
                    continue
                j = int(np.argmax(col))
                req.tokens = [int(firsts[j, slot])]
                req.live = True
                self._emitted_tokens += 1
                ttft = now - req.submit_time
                self.ttfts[req.rid] = ttft
                self.last_ttft_s = ttft
                if self.prefix_cache is not None:
                    self._publish_staged(req, slot)
                start_row = j * self.chunk
            finished = False
            dead = not bool(active[slot])
            n_before = len(req.tokens)
            if counts is None:
                # The plain step: one token an iteration; a dead slot's
                # column holds pad filler (detected below).
                stream, filler = toks[start_row:, slot], True
            else:
                # Verify windows: the first counts[c, slot] columns of
                # window c are its tokens in order; an inactive window
                # emits nothing, so there is no filler. Windows run while
                # the request was live feed the acceptance stats.
                col = counts[start_row:, slot]
                self._spec_windows += int(np.count_nonzero(col))
                self._spec_emitted += int(col.sum())
                stream = [t for c in range(col.shape[0])
                          for t in toks[start_row + c, slot, :int(col[c])]]
                filler = False
            for t in stream:
                tok = int(t)
                if tok == eos:
                    # eos lands in the transcript when it's a distinct
                    # token (decode filters it); GPT-2's pad == eos stays
                    # out, matching the reference's decoded text.
                    if tok != pad:
                        req.tokens.append(tok)
                    finished = True
                    break
                if filler and dead and tok == pad:
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
                self._staged_prompts.pop(req.rid, None)
                pin = self._prefix_pins.pop(req.rid, None)
                if pin is not None and self.prefix_cache is not None:
                    # The slot no longer reads shared blocks.
                    self.prefix_cache.release(pin)
                if (req.rid in self._session_reqs
                        and self._slot_req[slot] is req):
                    # A session turn: publish and pin the whole transcript
                    # while the slot's pages still hold its KV.
                    self._publish_session(req, slot)
                self._session_reqs.pop(req.rid, None)
                self.total_generated_tokens += len(req.tokens)
                final = [t for t in req.tokens if t != eos]
                text = self.tokenizer.decode(final)
                if req.rid in self._stream_watch:
                    self._final_tokens[req.rid] = final
                    self._stream_watch.discard(req.rid)
                done.append((req.rid, text))
                if self._slot_req[slot] is req:
                    self._slot_req[slot] = None
                # Kill the slot in the LIVE state (which may already be a
                # chunk ahead): load-bearing for the host-side budget caps,
                # where the device still thinks the slot is active.
                self.state.active[slot].fill_(False)  # no host sync
        return done

    def drain(self) -> Dict[int, str]:
        out: Dict[int, str] = {}
        while self.has_work:
            for rid, text in self.step():
                out[rid] = text
        return out


def _to_pinned(x: torch.Tensor) -> torch.Tensor:
    """Start a device-to-host copy of `x` into fresh pinned memory."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host
