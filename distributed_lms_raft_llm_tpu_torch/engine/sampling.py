"""Sampling with HF-equivalent semantics, on tensors.

Port of `distributed_lms_raft_llm_tpu/engine/sampling.py`. The reference
samples with temperature 0.7, top-k 50, top-p 0.9 and repetition penalty
1.2; the filters here match the JAX ops on the same logits, ties included
(tests/test_torch_sampling.py). Random draws come from an explicit
`torch.Generator`; they differ from `jax.random`'s, so sampled tokens are
compared as distributions, never one for one.

`approx_top_k` is accepted and computes the exact top-k: the JAX package's
`jax.lax.approx_max_k` is an approximate algorithm for the TPU (on the CPU
it returns the exact top-k), and the port has no approximate kernel, so a
node with `approx_top_k = true` samples exactly as with `false` (a
deliberate difference; the TPU's throughput figure for it is not the
port's).
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.7
    top_k: int = 50
    top_p: float = 0.9
    repetition_penalty: float = 1.2
    max_new_tokens: int = 128
    # Accepted for the JAX package's configs; the top-k is exact either way.
    approx_top_k: bool = False

    @classmethod
    def reference_defaults(cls, **kw) -> "SamplingParams":
        """The reference tutoring server's sampling configuration."""
        return cls(**kw)

    @classmethod
    def greedy(cls, **kw) -> "SamplingParams":
        kw.setdefault("temperature", 0.0)
        kw.setdefault("top_k", 0)
        kw.setdefault("top_p", 1.0)
        kw.setdefault("repetition_penalty", 1.0)
        return cls(**kw)


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF semantics: seen tokens get logit/p if positive else logit*p."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row (ties at the k-th value kept)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering, HF-style: keep the smallest prefix of the sorted
    distribution whose cumulative probability exceeds p (the crossing token
    is kept). Among equal logits the higher vocab index ranks first, as in
    the JAX op (a stable ascending sort, reversed)."""
    if p >= 1.0:
        return logits
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    remove_sorted = (cum - probs) > p
    remove = torch.zeros_like(remove_sorted).scatter(-1, order, remove_sorted)
    return torch.where(remove, torch.full_like(logits, NEG_INF), logits)


def noise_width(params: SamplingParams, vocab_size: int) -> int:
    """Uniforms one sampled row draws: the top-k values when top_k bounds
    the draw, else the whole vocabulary; 0 under greedy decoding."""
    if params.temperature <= 0.0:
        return 0
    k = params.top_k
    return k if 0 < k < vocab_size else vocab_size


def draw_noise(generator: torch.Generator, rows: int, params: SamplingParams,
               vocab_size: int, device: torch.device) -> torch.Tensor:
    """The uniforms `sample_step` would draw for `rows` rows, drawn now: the
    same call, so the generator advances exactly as that step would have
    advanced it. [rows, noise_width] float32 (no columns when greedy)."""
    n = noise_width(params, vocab_size)
    if n == 0:
        return torch.empty((rows, 0), dtype=torch.float32, device=device)
    return torch.rand((rows, n), generator=generator, device=device,
                      dtype=torch.float32)


def _categorical(generator: torch.Generator, logits: torch.Tensor,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick (no
    host round-trip, unlike `torch.multinomial`). `noise`: the uniforms,
    drawn beforehand (`draw_noise`), in place of a draw from `generator`."""
    u = noise if noise is not None else torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def sample_step(generator: torch.Generator, logits: torch.Tensor,
                seen_mask: torch.Tensor, params: SamplingParams,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """One sampling step: [B, V] float32 logits -> [B] int64 token ids.

    When top_k is active it bounds the nucleus set: top-p, temperature and
    the draw run on the k retained values (one top-k over the vocab instead
    of full-vocab sorts), as in the JAX package. `noise` ([B,
    noise_width]): uniforms drawn earlier by `draw_noise`, used instead of
    drawing from `generator` (the fused admission's first token).
    """
    logits = apply_repetition_penalty(logits, seen_mask,
                                      params.repetition_penalty)
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / params.temperature
    k = params.top_k
    if 0 < k < logits.shape[-1]:
        # Values come back sorted descending: the order HF's nucleus filter
        # accumulates in.
        top_vals, top_idx = torch.topk(logits, k, dim=-1)
        if params.top_p < 1.0:
            probs = torch.softmax(top_vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            top_vals = torch.where((cum - probs) > params.top_p,
                                   torch.full_like(top_vals, NEG_INF),
                                   top_vals)
        choice = _categorical(generator, top_vals, noise)
        return torch.gather(top_idx, -1, choice[:, None])[:, 0]
    logits = apply_top_p(logits, params.top_p)
    return _categorical(generator, logits, noise)


def update_seen(seen_mask: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mark `tokens` [B] as seen in the [B, V] mask (returns a new mask)."""
    return seen_mask.scatter(-1, tokens[:, None].long(), True)


def seen_mask_from_ids(ids: torch.Tensor, valid: torch.Tensor,
                       vocab_size: int) -> torch.Tensor:
    """[B, T] ids + [B, T] validity -> [B, V] presence mask."""
    b = ids.shape[0]
    # Invalid slots scatter into a spill column that is dropped.
    idx = torch.where(valid, ids.long(), torch.full_like(ids.long(), vocab_size))
    seen = torch.zeros((b, vocab_size + 1), dtype=torch.bool, device=ids.device)
    seen.scatter_(-1, idx, True)
    return seen[:, :vocab_size]
