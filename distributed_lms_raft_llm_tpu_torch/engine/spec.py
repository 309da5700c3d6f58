"""Speculative decoding for the bucketed engine: `decode_spec`.

Port of `distributed_lms_raft_llm_tpu/engine/spec.py`. `TutoringEngine`
swaps `generate.decode` for `decode_spec` when `spec_tokens` k > 0: each
model call verifies a window [last, d_1..d_k] of prompt-lookup drafts
(`engine/draft.py`) and emits 1 to k+1 tokens, from exactly the sampler's
distribution (greedy streams equal token for token).

Rows accept different counts, so each row keeps its own generated count
`n` and the cache takes per-row offsets (the model's ragged path: the
window's keys/values are written at each row's own slots, and the window
attends through `ops.attention.decode_attention`'s window variant on the
card, with the prompt's left padding as a shared bias). A row's next
window starts m >= 1 slots after its last and spans k+1 slots, so it
rewrites every slot a rejected draft left behind before anything attends
to it; the causal frontier hides the window's own unwritten tail.

The loop is driven from the host, one window a step, and stops once every
row is done (a host sync per window, as `generate.decode` syncs per step).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..models import registry
from ..models.common import KVCache
from ..models.registry import ModelFamily
from .draft import build_drafts, verify_window
from .generate import DecodeState, GenerateResult
from .sampling import SamplingParams


class SpecState(NamedTuple):
    """The speculative loop's state after its last window."""

    cache: KVCache
    transcript: torch.Tensor  # [B, t + max_new] prompt slots, then generated
    generator: torch.Generator
    out: torch.Tensor         # [B, max_new] emitted tokens (pad after EOS)
    seen: torch.Tensor        # [B, V] repetition-penalty presence mask
    done: torch.Tensor        # [B]
    n: torch.Tensor           # [B] tokens generated so far (== lengths)
    real_lens: torch.Tensor   # [B] true prompt lengths (position base)
    kv_mask: torch.Tensor     # [B, cache width] key-slot validity
    windows: int              # verify windows run (model calls)


def _grow_cache(cache: KVCache, width: int) -> KVCache:
    """A cache `width` slots wide holding `cache`'s slots (zeros past them),
    at `cache.length`."""
    def grown(x):
        if x is None:
            return None
        out = x.new_zeros((*x.shape[:3], width, *x.shape[4:]))
        out[:, :, :, :x.shape[3]] = x
        return out

    return KVCache(k=grown(cache.k), v=grown(cache.v), ks=grown(cache.ks),
                   vs=grown(cache.vs), length=cache.length)


def verify_width(t: int, max_new: int, k: int) -> int:
    """The cache width `decode_spec` grows a [B, t] prompt's cache to: the
    widest verify window starts at slot t + max_new - 2 and spans k + 1
    slots."""
    return t + max_new + k - 1


def decode_spec(
    params,
    state: DecodeState,
    input_ids: torch.Tensor,
    cfg,
    sampling: SamplingParams,
    eos_id: int,
    pad_id: int,
    model: ModelFamily = registry.GPT2_FAMILY,
    spec_tokens: int = 4,
) -> Tuple[GenerateResult, SpecState]:
    """Speculative continuation of a prefilled `DecodeState`.

    The contract of `generate.decode` plus the prompt `input_ids` [B, t],
    which seed the lookup transcript. The cache grows once to its
    high-water width (`verify_width`). A budget past the position table
    raises (`prefill` checks t + max_new alone).
    """
    k = spec_tokens
    max_new = sampling.max_new_tokens
    b, t = input_ids.shape
    width = verify_width(t, max_new, k)
    if width > cfg.max_position_embeddings:
        raise ValueError(
            f"verify-window budget exceeds the position table: prompt {t} "
            f"+ max_new_tokens {max_new} + spec_tokens {k} - 1 = {width} "
            f"> max_position_embeddings {cfg.max_position_embeddings}"
        )
    device = input_ids.device
    prompt_valid = state.kv_mask[:, :t]
    cache = _grow_cache(state.cache, width)
    kv_mask = torch.cat(
        [prompt_valid, torch.ones((b, width - t), dtype=torch.bool,
                                  device=device)], dim=1)
    w = t + max_new
    # Transcript: prompt ids in slots [0, t) (left-padded like the cache),
    # generated token g at slot t + g, and one spill column (slot w) that
    # takes the writes a window drops. Pad slots never anchor a match.
    transcript = torch.cat(
        [input_ids.long(), torch.full((b, max_new + 1), pad_id,
                                      dtype=torch.long, device=device)],
        dim=1)
    transcript[:, t] = state.out[:, 0]
    # out likewise, with its spill column max_new.
    out = torch.cat([state.out, torch.full((b, 1), pad_id, dtype=torch.long,
                                           device=device)], dim=1)
    seen, done, n = state.seen, state.done, state.lengths
    pos_w = torch.arange(w, device=device)[None, :]
    offs = torch.arange(k + 1, device=device)[None, :]
    prompt_valid_w = torch.cat(
        [prompt_valid, torch.zeros((b, max_new), dtype=torch.bool,
                                   device=device)], dim=1)
    rows = torch.arange(b, device=device)[:, None]
    windows = 0
    while not bool(done.all()):
        # Window base: active rows feed their last emitted token (slot
        # t+n-1). Done rows idle inside the budget; their rewrites touch
        # only their own cache tail, which nothing reads.
        base = torch.clamp(n, max=max_new - 1) - 1
        last = transcript.gather(1, (t + base)[:, None])[:, 0]
        prev = transcript.gather(1, torch.clamp(t + base - 1, min=0)[:, None]
                                 )[:, 0]
        # An anchor must be filled (a real prompt token or generated) and
        # have its k continuation slots filled too.
        filled = torch.where(pos_w < t, prompt_valid_w,
                             pos_w < (t + n)[:, None])
        match_valid = filled & (pos_w <= (t + n - 1 - k)[:, None])
        drafts = build_drafts(transcript[:, :w], match_valid, prev, last, k)
        feed = torch.cat([last[:, None], drafts], dim=1)  # [B, k+1]
        positions = state.real_lens[:, None] + base[:, None] + offs
        logits, _ = model.forward(
            params, cfg, feed,
            cache=dataclasses.replace(cache, lengths=(t + base).to(
                torch.int32)),
            positions=positions, kv_mask=kv_mask)
        emitted, valid, seen, hit_eos = verify_window(
            state.generator, logits, drafts, seen, ~done, sampling, eos_id,
            pad_id)
        # Only tokens inside the budget land; the rest go to the spill
        # columns.
        slots = n[:, None] + offs  # [B, k+1] output indices
        valid = valid & (slots < max_new)
        out[rows, torch.where(valid, slots, max_new)] = emitted
        transcript[rows, torch.where(valid, t + slots, w)] = emitted
        n = n + valid.sum(dim=1)
        done = done | hit_eos | (n >= max_new)
        windows += 1
    out = out[:, :max_new]
    spec = SpecState(cache=cache, transcript=transcript[:, :w],
                     generator=state.generator, out=out, seen=seen,
                     done=done, n=n, real_lens=state.real_lens,
                     kv_mask=kv_mask, windows=windows)
    return GenerateResult(tokens=out, lengths=n), spec
