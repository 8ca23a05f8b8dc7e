"""Capacity-bounded MoE dispatch by a cumsum rank
(flexflow_tpu/ops/moe_dispatch.py).

Tokens are served in flattened (sample-major, slot-minor) order.  Each
(token, slot) pair's rank within its expert is the running count of a
one-hot cumsum; ranks at or past `capacity` are dropped, and a dropped
pair's slot is clamped to its expert's last row.  Rows move with one
`index_add` (dispatch) and one gather (combine), each O(b·k·d).  The
integer ranks carry no gradient: gradients flow through the moved rows
only, as in the reference.

Only dropped pairs share a slot, and they contribute zero rows, so the
`index_add` sums the same values in whatever order the card's atomics
take them: the dispatch stays deterministic.  Ids and slots are int64
at the op, where the graph carries int32.

The local forms serve expert parallelism (parallel/expert_parallel.py):
`rank_offset` adds, per expert, the pairs that the tokens of the ranks
before this one route there, so that a shard of the tokens gets its
pairs' global ranks; `expert_offset` and `num_experts` keep the rows of
a chunk of the experts, at slots counted from the chunk's first row,
and treat a pair of another expert like a dropped one (a zero row).
With the defaults they are the one-device functions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def dispatch_indices(assign: torch.Tensor, capacity: int, n: int,
                     rank_offset: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, k] expert ids -> (slot [b·k], keep [b·k]).

    slot[i] = expert_id[i] * capacity + min(rank of i within its expert,
    capacity - 1); keep[i] = rank < capacity.  The rank counts from
    rank_offset[expert] when `rank_offset` ([n] int64) is given."""
    flat = assign.reshape(-1).long()
    # the running count per expert, scanned along the contiguous dim of
    # [n, bk] (a scan down the outer dim of [bk, n] runs n columns wide:
    # ~6 ms a call on the card at bk 32768, n 8)
    onehot = F.one_hot(flat, n).t().contiguous()  # [n, bk]
    pos = torch.cumsum(onehot, dim=1) - 1
    rank = pos.gather(0, flat[None]).squeeze(0)  # [bk] rank within expert
    if rank_offset is not None:
        rank = rank + rank_offset[flat]
    keep = rank < capacity
    slot = flat * capacity + torch.clamp(rank, max=capacity - 1)
    return slot, keep


def _local_slots(slot, keep, capacity: int, expert_offset: int,
                 num_experts: int, n: int):
    """Slots counted from the first row of experts [expert_offset,
    expert_offset + num_experts); a pair of another expert is not
    kept."""
    if expert_offset == 0 and num_experts == n:
        return slot, keep
    rows = num_experts * capacity
    local = slot - expert_offset * capacity
    inside = (local >= 0) & (local < rows)
    # a pair of another expert moves a zero row at a slot of its own
    # choosing, spread over the rows: all at one slot, the combine's
    # backward serializes on it (209 ms of a step on the card)
    spread = torch.arange(local.numel(), device=local.device) % rows
    return torch.where(inside, local, spread), keep & inside


def sort_group_by(data: torch.Tensor, assign: torch.Tensor, n: int,
                  capacity: int, expert_offset: int = 0,
                  num_experts: Optional[int] = None,
                  rank_offset: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """[b, d] tokens + [b, k] assignments -> [num_experts, capacity, d]
    inputs of experts expert_offset.. (all n by default; dropped pairs
    and pairs of other experts contribute zero rows)."""
    b, k = assign.shape
    d = data.shape[1]
    m = n if num_experts is None else num_experts
    slot, keep = _local_slots(*dispatch_indices(assign, capacity, n,
                                                rank_offset),
                              capacity, expert_offset, m, n)
    # row i serves flat pair i; the output size given, nothing is read
    # back to the host
    rows = data.repeat_interleave(k, dim=0, output_size=data.shape[0] * k)
    contrib = rows * keep[:, None].to(data.dtype)
    out = torch.zeros(m * capacity, d, dtype=data.dtype, device=data.device)
    return out.index_add(0, slot, contrib).reshape(m, capacity, d)


def sort_combine(expert_out: torch.Tensor, assign: torch.Tensor,
                 capacity: int, n: Optional[int] = None,
                 expert_offset: int = 0,
                 rank_offset: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[m, cap, e] outputs of experts expert_offset.. of n (all of them
    by default) -> per-(token, slot) rows [b·k, e] (zero for dropped
    pairs and pairs of other experts), and keep [b·k]."""
    m = expert_out.shape[0]
    n = m if n is None else n
    slot, keep = _local_slots(*dispatch_indices(assign, capacity, n,
                                                rank_offset),
                              capacity, expert_offset, m, n)
    flat_out = expert_out.reshape(-1, expert_out.shape[-1])
    return flat_out[slot] * keep[:, None].to(expert_out.dtype), keep
