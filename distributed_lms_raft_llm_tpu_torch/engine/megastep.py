"""Megastep decode: the K ladder, the K controller and the dead-lane account.

The port's own copies of pure functions of the JAX package:
`effective_megastep_max` and `megastep_ladder`
(`distributed_lms_raft_llm_tpu/engine/program_inventory.py`),
`next_megastep_k` (`engine/paged.py`), and the dead-lane account that
`_megastep_program` computes there. A megastep runs K `chunk`-token decode
chunks per host decision; the controller moves K along the ladder.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def effective_megastep_max(megastep: int, megastep_max: int) -> int:
    """The controller ceiling in force: `megastep_max` when set (> 0) is the
    ceiling, and a starting `megastep` above it is clamped down to it; 0
    means follow `megastep`. Floored at 1."""
    return max(1, megastep_max) if megastep_max > 0 else max(1, megastep)


def megastep_ladder(megastep_max: int) -> List[int]:
    """The megastep sizes the controller can reach: 1 (the chunk loop) plus
    doubling rungs up to `megastep_max`, which is always the top rung even
    when it is not a power of two (6 -> [1, 2, 4, 6])."""
    out = [1]
    k = 2
    while k < megastep_max:
        out.append(k)
        k *= 2
    if megastep_max > 1:
        out.append(megastep_max)
    return out


def next_megastep_k(current: int, ladder: Sequence[int], pending: int,
                    slack_chunks: Optional[int] = None,
                    fused: bool = False) -> int:
    """The next megastep's K (one decision per dispatch).

    No request waiting: grow one rung toward the ceiling. Requests waiting
    for a slot: the largest rung that fits `slack_chunks`, the chunks until
    some live slot must free (`PagedEngine._slack_chunks`; None = no live
    slot bounds it, which falls to the floor). Boundaries more frequent than
    that admit nobody and only give up amortization. With fused staged
    admission (`fused`) the floor is the second rung: a boundary only hands
    a freed slot to the stager, the prefill itself runs inside the scan.
    """
    if len(ladder) <= 1:
        return ladder[0] if ladder else 1
    if pending <= 0:
        i = ladder.index(current) if current in ladder else 0
        return ladder[min(len(ladder) - 1, i + 1)]
    cap = 1 if slack_chunks is None else max(1, slack_chunks)
    if fused:
        cap = max(cap, ladder[1])
    return max(k for k in ladder if k <= cap)


def dead_lane_tokens(started: torch.Tensor, active: torch.Tensor,
                     flipped: Optional[torch.Tensor],
                     lane_tokens: int) -> torch.Tensor:
    """Pad lanes burnt by slots that finished inside a megastep.

    started [S]: active flags at the megastep's entry; active [K, S]: the
    post-chunk snapshots; flipped [K, S] or None: slots a fused admission
    made live at each iteration. A lane is stranded from the first chunk
    after which a slot that was live (active at entry, or flipped live at
    an earlier or the same iteration) is inactive, until the megastep ends:
    ``lane_tokens * sum over j < K-1 of |live_j & ~active_j|``. Zero at
    K = 1. Returns a 0-d int64 tensor on the inputs' device.
    """
    act = active != 0
    if flipped is not None:
        live = started[None, :].bool() | (
            torch.cumsum(flipped.to(torch.int32), dim=0) > 0)
    else:
        live = started[None, :].bool().expand_as(act)
    return lane_tokens * (live[:-1] & ~act[:-1]).sum()
