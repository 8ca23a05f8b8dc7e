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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def dispatch_indices(assign: torch.Tensor, capacity: int,
                     n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, k] expert ids -> (slot [b·k], keep [b·k]).

    slot[i] = expert_id[i] * capacity + min(rank of i within its expert,
    capacity - 1); keep[i] = rank < capacity."""
    flat = assign.reshape(-1).long()
    onehot = F.one_hot(flat, n)  # [bk, n]
    pos = torch.cumsum(onehot, dim=0) - 1  # running count per expert
    rank = (pos * onehot).sum(dim=-1)  # [bk] rank within its expert
    keep = rank < capacity
    slot = flat * capacity + torch.clamp(rank, max=capacity - 1)
    return slot, keep


def sort_group_by(data: torch.Tensor, assign: torch.Tensor, n: int,
                  capacity: int) -> torch.Tensor:
    """[b, d] tokens + [b, k] assignments -> [n, capacity, d] expert
    inputs (dropped pairs contribute zero rows)."""
    b, k = assign.shape
    d = data.shape[1]
    slot, keep = dispatch_indices(assign, capacity, n)
    rows = data.repeat_interleave(k, dim=0)  # row i serves flat pair i
    contrib = rows * keep[:, None].to(data.dtype)
    out = torch.zeros(n * capacity, d, dtype=data.dtype, device=data.device)
    return out.index_add(0, slot, contrib).reshape(n, capacity, d)


def sort_combine(expert_out: torch.Tensor, assign: torch.Tensor,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, cap, e] expert outputs -> per-(token, slot) rows [b·k, e]
    (zero for dropped pairs), and keep [b·k]."""
    n = expert_out.shape[0]
    slot, keep = dispatch_indices(assign, capacity, n)
    flat_out = expert_out.reshape(-1, expert_out.shape[-1])
    return flat_out[slot] * keep[:, None].to(expert_out.dtype), keep
