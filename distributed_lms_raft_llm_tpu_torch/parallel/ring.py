"""Ring attention: causal self-attention with the sequence sharded over sp.

Port of `distributed_lms_raft_llm_tpu/parallel/ring.py`, written for one
process a rank. Each rank holds one sequence shard of q, k and v
([B, H, T/sp, Dh], rank r the positions [r T/sp, (r+1) T/sp)) and keeps
its queries' online-softmax state (the running max, the running sum and
the unnormalised output, all float32). At each of sp - 1 steps it folds in
the K/V block it holds, sends that block to the next rank and receives the
previous rank's (`ParallelAxis.rotate`: point-to-point, send to rank + 1,
receive from rank - 1); the last block is folded in without a send. After
s steps a rank holds the block that started on rank (r - s) mod sp, whose
absolute offset drives the causal mask. No rank ever holds more than a
[T/sp, T/sp] block of scores, and the result is dense causal attention up
to float rounding (held against `models.common.attend` in the tests).

The block step is plain torch (`torch.matmul`, the mask, `exp`), as the
JAX package computes it with einsums outside any Pallas kernel. Over gloo
the blocks travel through host buffers, staged explicitly by `rotate`:
that is the gloo route, and there is no other; nccl sends the device
tensors.

Scope, as in the JAX package: the full-sequence direction (the scoring
tenant's forward at `EngineConfig.sp > 1`, and the trainer's at sp > 1).
Decode reads a KV cache a token at a time and never shards the sequence.

The backward is autograd's through the online-softmax loop: `rotate` is
the "rotate" pair of `parallel/mesh.py`, so each block's gradient travels
back round the ring to the rank that sent the block, one rotation a step
(sp - 1 a call), and the ranks' K/V gradients sum to the dense attention's.
The block's scores are kept for the backward (sp blocks of [T/sp, T/sp]
a layer); the trainer's remat recomputes them, rotations included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .mesh import ParallelAxis

NEG_INF = -1e30


def ring_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_offset: int, kv_offset: int, scale: float,
               m: torch.Tensor, l: torch.Tensor, o: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one K/V block into the online softmax of q (the JAX package's
    `_ring_block`): q [B, H, Tq, Dh], k and v [B, H, Tk, Dh]; the offsets
    are the blocks' absolute first positions (the causal mask); m, l
    [B, H, Tq, 1] and o [B, H, Tq, Dh] the running max, sum and
    unnormalised output, float32. Returns the new (m, l, o)."""
    tq, tk = q.shape[2], k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
    k_pos = kv_offset + torch.arange(tk, device=q.device)[None, :]
    scores = torch.where(k_pos <= q_pos, scores,
                         torch.full_like(scores, NEG_INF))
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    # A row no key of this block (nor any before it) reaches keeps m at
    # NEG_INF; exp(NEG_INF - NEG_INF) = 1 would poison its sum, so the
    # shift is clamped to 0 there.
    shift = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new), m_new)
    p = torch.exp(scores - shift)
    correction = torch.exp(torch.where(m <= NEG_INF / 2,
                                       torch.full_like(m, NEG_INF), m)
                           - shift)
    l_new = l * correction + p.sum(dim=-1, keepdim=True)
    # p rounded to v's dtype, the product accumulated in float32 (the JAX
    # einsum's preferred_element_type).
    o_new = o * correction + torch.matmul(p.to(v.dtype).float(), v.float())
    return m_new, l_new, o_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sp: ParallelAxis,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal multi-head attention over a sequence sharded on `sp`: q, k
    and v are this rank's shard [B, H, T/sp, Dh] (every rank the same
    T/sp; H this rank's heads under tp); returns its queries' outputs
    [B, H, T/sp, Dh] in q's dtype. At sp = 1 it is dense causal
    attention."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n, idx, tq = sp.size, sp.rank, q.shape[2]
    if k.shape[2] != tq or v.shape[2] != tq:
        raise ValueError(f"ring attention takes equal shards: q {q.shape[2]}"
                         f", k {k.shape[2]}, v {v.shape[2]}")
    q_offset = idx * tq
    m = torch.full((*q.shape[:-1], 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    # K and V travel as one tensor: one send and one receive a step.
    kv = torch.stack((k, v))
    for step in range(n):
        owner = (idx - step) % n
        m, l, o = ring_block(q, kv[0], kv[1], q_offset,
                             owner * tq, scale, m, l, o)
        if step < n - 1:
            # The last block is folded in without a send: its rotation
            # would carry a shard nobody reads.
            kv = sp.rotate(kv)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)
