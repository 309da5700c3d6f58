"""Speculative decoding's shared pieces: prompt-lookup drafts and the exact
verifier, on tensors.

Port of `distributed_lms_raft_llm_tpu/engine/draft.py`. Both engines
speculate through this module: `engine/spec.py` (the bucketed engine's
`decode_spec`) and `engine/paged.py` (the paged engine's verify-window
step), so the exactness properties are held once, against one
implementation (tests/test_torch_spec.py):

- **Drafting** proposes the k tokens that followed the most recent earlier
  occurrence of the current (previous, last) bigram in the row's
  transcript, falling back to a unigram match (`build_drafts`), or the
  modal continuations of the row's own n-gram table (`build_drafts_ngram`).
  No draft model, no extra weights.
- **Verification** (`verify_window`) walks the k drafts with rejection
  sampling against the model's logits: draft d_i is accepted with its
  probability p_i(d_i) under the full processed distribution (repetition
  penalty with the seen set as of that position, temperature, top-k,
  top-p); the first rejection resamples from p with the draft removed,
  renormalized; if every draft survives, a bonus token is sampled from
  the last row. Every emitted token is distributed as the plain sampler's
  (`sampling.sample_step`): greedy streams are identical token for token,
  sampled ones identical in distribution.

Random draws come from an explicit `torch.Generator`, by `torch.rand` on
the device as `sample_step` draws them: no host round trip, so a verify
chunk is captured in a CUDA graph (with the generator registered) and
replays without a host sync. The draws differ from `jax.random`'s, so
sampled tokens are compared as distributions, never one for one.
`approx_top_k` samples the exact top-k here, as everywhere in the port
(`engine/sampling.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .sampling import (
    NEG_INF,
    SamplingParams,
    _categorical,
    apply_repetition_penalty,
    noise_width,
    seen_mask_from_ids,
)


def _shifted(transcript: torch.Tensor, match_valid: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the id before each slot, -1 at slot 0; whether that slot may anchor
    a match, False at slot 0)."""
    prev_ids = torch.cat([torch.full_like(transcript[:, :1], -1),
                          transcript[:, :-1]], dim=1)
    prev_ok = torch.cat([torch.zeros_like(match_valid[:, :1]),
                         match_valid[:, :-1]], dim=1)
    return prev_ids, prev_ok


def build_drafts(transcript: torch.Tensor, match_valid: torch.Tensor,
                 prev_tok: torch.Tensor, last_tok: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Prompt-lookup proposals: [B, k] continuation of the best n-gram match.

    transcript [B, W] token ids; match_valid [B, W] marks slots that may
    anchor a match (filled AND followed by k filled slots). Bigram matches
    (prev_tok, last_tok) outrank unigram matches (last_tok); ties break
    toward recency. Rows with no match propose `last_tok` repeated, a
    throwaway draft the verifier will almost surely reject (the verify
    forward runs at its width regardless). Continuations past the last
    slot read the last slot, as in the JAX package (match_valid keeps a
    valid anchor's k continuation slots inside the transcript).
    """
    w = transcript.shape[1]
    pos = torch.arange(w, device=transcript.device)
    uni = (transcript == last_tok[:, None]) & match_valid
    prev_ids, prev_ok = _shifted(transcript, match_valid)
    bi = uni & prev_ok & (prev_ids == prev_tok[:, None])
    score = uni.long() + bi.long()  # 0 | 1 | 2
    best = torch.argmax(score * w + pos[None, :], dim=1)   # [B]
    has = score.max(dim=1).values > 0
    idx = best[:, None] + 1 + torch.arange(k, device=transcript.device)
    drafts = torch.gather(transcript, 1, torch.clamp(idx, max=w - 1))
    return torch.where(has[:, None], drafts, last_tok[:, None])


def build_drafts_ngram(transcript: torch.Tensor, match_valid: torch.Tensor,
                       prev_tok: torch.Tensor, last_tok: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Per-row n-gram table proposals: [B, k] modal continuations.

    Every filled slot i whose id equals the current token votes for its
    continuation transcript[i+1]; a bigram-context match ((prev, cur) both
    equal) outvotes any number of unigram matches (weight W, the
    transcript's width); the continuation with the most votes wins,
    recency breaking ties, and becomes the next lookup context, so the k
    drafts walk the table like a tiny per-row language model: one [B, W,
    W] comparison per draft position. Higher acceptance than the most
    recent match once sampling stops copying itself (temperature > 0).
    Rows with no match propose the current token repeated.
    """
    w = transcript.shape[1]
    pos = torch.arange(w, device=transcript.device)
    # Continuation at anchor i is transcript[i+1]; the wrapped last column
    # is never a valid anchor (it has no continuation slots).
    nxt = torch.cat([transcript[:, 1:], transcript[:, :1]], dim=1)
    prev_ids, prev_ok = _shifted(transcript, match_valid)
    same = nxt[:, :, None] == nxt[:, None, :]  # continuation classes
    prev, cur = prev_tok, last_tok
    drafts = []
    for _ in range(k):
        uni = (transcript == cur[:, None]) & match_valid
        bi = uni & prev_ok & (prev_ids == prev[:, None])
        votes = ((same & uni[:, None, :]).sum(dim=-1)
                 + (same & bi[:, None, :]).sum(dim=-1) * w)
        score = torch.where(uni, votes, torch.zeros_like(votes))
        # Lexicographic (score, recency) argmax: the most recent anchor of
        # the best-voted class.
        m = score.max(dim=1, keepdim=True).values
        best = torch.argmax(torch.where((score == m) & uni, pos[None, :],
                                        torch.full_like(score, -1)), dim=1)
        has = m[:, 0] > 0
        proposed = torch.where(
            has, torch.gather(nxt, 1, best[:, None])[:, 0], cur)
        drafts.append(proposed)
        prev, cur = cur, proposed
    return torch.stack(drafts, dim=1)


def _processed_top(logits: torch.Tensor, seen: torch.Tensor,
                   params: SamplingParams,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(filtered values [N, K], ids [N, K]) of the processed distribution's
    support, `sample_step`'s pipeline: repetition penalty, then temperature,
    then top-k, then top-p (NEG_INF outside the nucleus). Values sorted
    descending; without top-k the support is the whole vocabulary, equal
    values ordered higher id first (the JAX package's reversed stable
    sort)."""
    logits = apply_repetition_penalty(logits, seen, params.repetition_penalty)
    temp = params.temperature if params.temperature > 0 else 1.0
    logits = logits / temp
    k = params.top_k
    if 0 < k < logits.shape[-1]:
        vals, idx = torch.topk(logits, k, dim=-1)
    else:
        idx = torch.argsort(logits, dim=-1, stable=True).flip(-1)
        vals = torch.gather(logits, -1, idx)
    if params.top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        vals = torch.where((cum - probs) > params.top_p,
                           torch.full_like(vals, NEG_INF), vals)
    return vals, idx


def _seen_stack(seen: torch.Tensor, drafts: torch.Tensor) -> torch.Tensor:
    """[B, k+1, V]: the seen set each window position would have if every
    draft before it were accepted (position i: seen | {d_1..d_i})."""
    stacks = [seen]
    for i in range(drafts.shape[1]):
        stacks.append(stacks[-1].scatter(-1, drafts[:, i:i + 1].long(), True))
    return torch.stack(stacks, dim=1)


def verify_window(generator: Optional[torch.Generator], logits: torch.Tensor,
                  drafts: torch.Tensor, seen: torch.Tensor,
                  active_in: torch.Tensor, sampling: SamplingParams,
                  eos_id: int, pad_id: int,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Walk one verify window: (emitted [B, k+1] int64, valid [B, k+1]
    bool, seen' [B, V], hit_eos [B]).

    logits [B, k+1, V]: row i is the model's next-token distribution given
    the prefix and drafts d_1..d_i; draft d_{i+1} is checked against row i.
    Rows enter with `active_in` (False: already done, emit nothing).
    `valid` is a contiguous prefix per row (the accept chain breaks once),
    so a row's emission count is `valid.sum(1)` and its tokens are the
    first that many columns.

    The sampling pipeline runs once over all k+1 positions: position i
    matters only if drafts 1..i were all accepted, and then its seen set is
    `seen | {d_1..d_i}`, known before any decision. Greedy decoding takes
    the argmax of the penalized logits (top-k and top-p cannot move it; a
    rejected draft's residual argmax is the argmax itself) and draws
    nothing. Otherwise every uniform the walk needs is drawn up front from
    `generator` ([B, k+1] for the accept tests, [B, k+1, n] for the
    categorical draws; n = `noise_width`).
    """
    b, k1, v = logits.shape
    k = k1 - 1
    greedy = sampling.temperature <= 0.0
    logits = logits.float()
    stack = _seen_stack(seen, drafts)
    if greedy:
        lg = apply_repetition_penalty(logits, stack,
                                      sampling.repetition_penalty)
        am = torch.argmax(lg, dim=-1)  # [B, k+1]
    else:
        vals, idx = _processed_top(logits.reshape(b * k1, v),
                                   stack.reshape(b * k1, v), sampling)
        vals = vals.reshape(b, k1, -1)
        idx = idx.reshape(b, k1, -1)
        u_acc = torch.rand((b, k1), generator=generator,
                           device=logits.device, dtype=torch.float32)
        u_cat = torch.rand((b, k1, noise_width(sampling, v)),
                           generator=generator, device=logits.device,
                           dtype=torch.float32)

    pad = torch.full((b,), pad_id, dtype=torch.long, device=logits.device)
    emitted, valid = [], []
    hit_eos = torch.zeros((b,), dtype=torch.bool, device=logits.device)
    chain = active_in  # rows whose drafts have all been accepted so far
    for i in range(k1):
        if greedy:
            tok = am[:, i]
            accept = (drafts[:, i] == tok) if i < k else torch.zeros_like(
                chain)
        elif i < k:
            d = drafts[:, i].long()
            at = idx[:, i] == d[:, None]  # the draft's place in the support
            probs = torch.softmax(vals[:, i], dim=-1)
            p_d = torch.where(at, probs, torch.zeros_like(probs)).sum(-1)
            accept = u_acc[:, i] < p_d
            # The residual of a rejected draft: the processed distribution
            # with the draft removed, renormalized (the exact leftover rule
            # for a point-mass proposal).
            res_vals = torch.where(at, torch.full_like(vals[:, i], NEG_INF),
                                   vals[:, i])
            choice = _categorical(None, res_vals, u_cat[:, i])
            resample = torch.gather(idx[:, i], 1, choice[:, None])[:, 0]
            tok = torch.where(accept, d, resample)
        else:
            # The bonus position: all k drafts survived; sample normally.
            accept = torch.zeros_like(chain)
            choice = _categorical(None, vals[:, i], u_cat[:, i])
            tok = torch.gather(idx[:, i], 1, choice[:, None])[:, 0]
        emit = chain  # rows still in the chain emit at window position i
        emitted.append(torch.where(emit, tok.long(), pad))
        valid.append(emit)
        is_eos = emit & (tok == eos_id)
        hit_eos = hit_eos | is_eos
        # A rejection emits its resample and ends the row's window; an
        # accepted eos ends it too (nothing follows eos).
        chain = emit & accept & ~is_eos
    emitted_t = torch.stack(emitted, dim=1)
    valid_t = torch.stack(valid, dim=1)
    # The seen update of what was actually emitted.
    seen = seen | seen_mask_from_ids(emitted_t, valid_t, v)
    return emitted_t, valid_t, seen, hit_eos
