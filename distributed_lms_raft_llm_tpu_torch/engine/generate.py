"""Autoregressive generation: bucketed prefill, then segmented decode.

Port of `distributed_lms_raft_llm_tpu/engine/generate.py`.

- `prefill` runs the left-padded prompt batch through the model and samples
  the first token; the engine waits for that token, the honest TTFT
  boundary;
- `decode` continues one token per step until the budget is spent or every
  row has emitted EOS.

The KV cache is allocated once at its final size (``bucket +
max_new_tokens``) and written in place. The JAX package instead grows it
between decode segments so attention reads only slots that can be valid
yet; here each segment attends over a window of the cache (a view, no
copy) up to the same high-water mark, with the same segment schedule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models import registry
from ..models.common import KVCache
from ..models.registry import ModelFamily
from .sampling import (
    SamplingParams,
    sample_step,
    seen_mask_from_ids,
    update_seen,
)


class GenerateResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_new]; rows padded with pad_id after EOS
    lengths: torch.Tensor  # [B] emitted tokens per row (including EOS)


class DecodeState(NamedTuple):
    """What `decode` resumes from, and the running decode loop's state."""

    cache: KVCache                # full size: t + max_new slots
    tok: torch.Tensor             # [B] last sampled token
    generator: torch.Generator
    out: torch.Tensor             # [B, max_new]
    seen: torch.Tensor            # [B, V] repetition-penalty presence mask
    done: torch.Tensor            # [B]
    lengths: torch.Tensor         # [B]
    step: int                     # tokens sampled so far (1 after prefill)
    real_lens: torch.Tensor       # [B] true prompt lengths (positions base)
    kv_mask: torch.Tensor         # [B, t + max_new] key-slot validity


def make_positions(prompt_mask: torch.Tensor) -> torch.Tensor:
    """Per-row position ids for a left-padded prompt ([B, T] bool -> int64)."""
    return (torch.cumsum(prompt_mask.long(), dim=1) - 1).clamp(min=0)


def prefill(
    params,
    cfg,
    input_ids: torch.Tensor,
    prompt_mask: torch.Tensor,
    generator: torch.Generator,
    sampling: SamplingParams,
    eos_id: int,
    pad_id: int,
    model: ModelFamily = registry.GPT2_FAMILY,
) -> DecodeState:
    """Prompt pass + first sampled token; returns the state `decode` resumes.

    input_ids [B, T] int, prompt_mask [B, T] bool (False = left padding).
    Every row needs one valid slot (the engine's filler rows keep one).
    """
    b, t = input_ids.shape
    max_new = sampling.max_new_tokens
    if t + max_new > cfg.max_position_embeddings:
        raise ValueError(
            f"bucket {t} + max_new {max_new} exceeds position table "
            f"{cfg.max_position_embeddings}"
        )
    device = input_ids.device
    positions = make_positions(prompt_mask)
    real_lens = prompt_mask.long().sum(dim=1)

    cache = model.init_cache(cfg, b, t + max_new, dtype=cfg.dtype,
                             device=device)
    kv_mask = torch.cat(
        [prompt_mask.bool(),
         torch.ones((b, max_new), dtype=torch.bool, device=device)], dim=1
    )
    logits, prompt_cache = model.forward(
        params, cfg, input_ids, cache=cache.window(t), positions=positions,
        kv_mask=kv_mask[:, :t],
    )
    cache.length = prompt_cache.length
    last_logits = logits[:, -1]  # left padding: every row's last slot is real

    seen = seen_mask_from_ids(input_ids, prompt_mask, cfg.vocab_size)
    first_tok = sample_step(generator, last_logits, seen, sampling)

    out = torch.full((b, max_new), pad_id, dtype=torch.long, device=device)
    out[:, 0] = first_tok
    return DecodeState(
        cache=cache,
        tok=first_tok,
        generator=generator,
        out=out,
        seen=update_seen(seen, first_tok),
        done=first_tok == eos_id,
        lengths=torch.ones((b,), dtype=torch.long, device=device),
        step=1,
        real_lens=real_lens,
        kv_mask=kv_mask,
    )


def decode(
    params,
    state: DecodeState,
    cfg,
    sampling: SamplingParams,
    eos_id: int,
    pad_id: int,
    model: ModelFamily = registry.GPT2_FAMILY,
    segments: Optional[int] = None,
) -> Tuple[GenerateResult, DecodeState]:
    """Decode from a prefilled state to completion.

    The budget splits into `segments` spans (None: 8 for batches of 16 or
    more, else 4, as in the JAX package); steps of a span attend over the
    cache window up to the span's high-water mark. The loop stops early
    once every row is done, checked on the host after each step.

    Returns (result, final_state); `final_state.step - 1` is the number of
    decode steps (model calls) that ran.
    """
    max_new = sampling.max_new_tokens
    t = state.kv_mask.shape[1] - max_new
    if segments is None:
        segments = 8 if state.out.shape[0] >= 16 else 4
    segments = max(1, min(segments, max_new))
    pad = torch.tensor(pad_id, dtype=torch.long, device=state.out.device)

    s = state
    all_done = bool(s.done.all())
    for i in range(segments):
        seg_end = (max_new * (i + 1)) // segments
        # Steps in [.., seg_end) write slots up to t + seg_end - 2; the
        # window t + seg_end matches the JAX package's grown cache.
        width = t + seg_end
        while s.step < seg_end and not all_done:
            # Feed the last token: its slot is t + step - 1, its position
            # real_lens + step - 1 (left-padded layout).
            pos = (s.real_lens + s.step - 1)[:, None]
            window = s.cache.window(width)
            logits, stepped = model.forward(
                params, cfg, s.tok[:, None], cache=window, positions=pos,
                kv_mask=s.kv_mask[:, :width],
            )
            s.cache.length = stepped.length
            nxt = sample_step(s.generator, logits[:, 0], s.seen, sampling)
            nxt = torch.where(s.done, pad, nxt)
            s.out[:, s.step] = nxt
            lengths = s.lengths + (~s.done).long()
            done = s.done | (nxt == eos_id)
            s = s._replace(tok=nxt, seen=update_seen(s.seen, nxt), done=done,
                           lengths=lengths, step=s.step + 1)
            all_done = bool(done.all())
    return GenerateResult(tokens=s.out, lengths=s.lengths), s


def generate(
    params,
    cfg,
    input_ids: torch.Tensor,
    prompt_mask: torch.Tensor,
    generator: torch.Generator,
    sampling: SamplingParams,
    eos_id: int,
    pad_id: int,
    model: ModelFamily = registry.GPT2_FAMILY,
) -> GenerateResult:
    """`prefill` + `decode` for callers that do not need the TTFT split."""
    state = prefill(params, cfg, input_ids, prompt_mask, generator, sampling,
                    eos_id, pad_id, model=model)
    return decode(params, state, cfg, sampling, eos_id, pad_id, model=model)[0]


def pick_bucket(length: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= length (last bucket if none fit — caller truncates)."""
    for bkt in buckets:
        if length <= bkt:
            return bkt
    return buckets[-1]
