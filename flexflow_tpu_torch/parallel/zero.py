"""The ZeRO ladder's update layout (flexflow_tpu/parallel/zero.py).

A weight's update layout is its strategy layout with the weight-update
axis (`wus_axis`, "data" by default) added to its first logical dim that
the layout leaves free and whose size the axis divides.  Stage 1 keeps
the optimizer's slots in that layout and updates each rank's shard of
the weight after a reduce-scatter of its grad, then all-gathers the
weight; stage 2 reduce-scatters each grad as soon as the backward has
made it; stage 3 keeps the weight itself in that layout and gathers it
just in time for each op's forward (its backward reduce-scatters the
grad).  A weight with no such dim, or one the axis already shards,
falls back to the replicated update and is counted
(`GraphExecutor.zero_fallback_leaves`).
"""
from __future__ import annotations

from typing import Optional, Sequence

from .machine import Spec


def shard_update_spec(spec: Spec, shape: Sequence[int], axis: str,
                      axis_size: int) -> Optional[Spec]:
    """The update-layout spec of one weight, or None when it cannot
    shard over `axis` (the axis already shards it, no free dim divides
    evenly, or the axis is trivial)."""
    if axis_size <= 1 or any(axis in axes for axes in spec):
        return None
    entries = list(spec)
    for i, dim in enumerate(shape):
        if not entries[i] and dim > 0 and dim % axis_size == 0:
            entries[i] = (axis,)
            return tuple(entries)
    return None
