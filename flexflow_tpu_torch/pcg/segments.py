"""Graph segmentation utilities shared by the Unity DP search and the
pipeline-stage planner.

Reference: `find_split_node` (substitution.cc:2094) cuts the PCG at
single-tensor bottlenecks for the sequence DP; the same cuts are where
pipeline stages can legally begin (exactly one activation crosses, so
one ppermute per tick moves the full inter-stage state).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..ops.op import Op
from .graph import Graph


def external_inputs(ops: List[Op]) -> List[int]:
    """Guids of tensors consumed by `ops` but produced outside, ordered
    by first consumption — THE boundary-detection helper shared by the
    Unity region DP, the pipeline planner, and pp candidate costing."""
    produced = {t.guid for op in ops for t in op.outputs}
    out: List[int] = []
    seen = set()
    for op in ops:
        for t in op.inputs:
            if t.guid not in produced and t.guid not in seen:
                seen.add(t.guid)
                out.append(t.guid)
    return out


def last_use_positions(topo: List[Op]) -> Dict[int, int]:
    """tensor guid -> topo position of its last consumer (shared by the
    segment splitter and the simulator's liveness scan)."""
    pos = {op.guid: i for i, op in enumerate(topo)}
    last_use: Dict[int, int] = {}
    for op in topo:
        for t in op.inputs:
            last_use[t.guid] = max(last_use.get(t.guid, -1), pos[op.guid])
    return last_use


def split_segments(graph: Graph) -> Tuple[List[List[Op]], List[Optional[int]]]:
    """Split topo order at single-tensor cuts.

    Returns (segments, crossing_guid_per_boundary): segment k feeds
    segment k+1 through exactly one tensor (the bottleneck); the final
    boundary is None."""
    return split_segments_ops(graph.topo_order())


def split_segments_ops(
    topo: List[Op],
) -> Tuple[List[List[Op]], List[Optional[int]]]:
    """`split_segments` over an already topo-ordered op list — the form
    the searched-remat costing uses on the evaluator's applied op
    sequences (where no Graph object exists on the delta path).  Runs a
    single O(n) liveness sweep: a tensor produced at position j with
    last use at position lu crosses every boundary i with j <= i < lu,
    so the live set is maintained incrementally instead of rescanning
    the prefix per position."""
    last_use = last_use_positions(topo)
    live = set()
    cuts: List[Tuple[int, int]] = []  # (topo position, crossing tensor guid)
    n = len(topo)
    expire: Dict[int, List[int]] = {}
    for op in topo:
        for t in op.outputs:
            lu = last_use.get(t.guid, -1)
            if lu >= 0:
                expire.setdefault(lu, []).append(t.guid)
    for i, op in enumerate(topo):
        for t in op.outputs:
            if last_use.get(t.guid, -1) > i:
                live.add(t.guid)
        for g in expire.get(i, ()):
            live.discard(g)
        if i < n - 1 and len(live) == 1:
            cuts.append((i, next(iter(live))))
    segments: List[List[Op]] = []
    boundaries: List[Optional[int]] = []
    start = 0
    for i, guid in cuts:
        segments.append(topo[start : i + 1])
        boundaries.append(guid)
        start = i + 1
    segments.append(topo[start:])
    boundaries.append(None)
    return segments, boundaries


def segment_signature(seg: List[Op], boundary_in: List[int]) -> Tuple:
    """Structural signature: identical stacked layers share it."""
    local = {guid: ("b", k) for k, guid in enumerate(boundary_in)}
    parts = []
    for j, op in enumerate(seg):
        srcs = tuple(local[t.guid] for t in op.inputs)
        parts.append((op.op_type, op.params, srcs))
        for oi, t in enumerate(op.outputs):
            local[t.guid] = ("i", j, oi)
    return tuple(parts)


def find_repeated_blocks(graph: Graph) -> List[List[Op]]:
    """Longest run of consecutive, structurally identical,
    shape-preserving single-tensor-boundary blocks — the pipelineable
    region (e.g. a transformer's stacked encoder layers).

    A block may span several segments (a period): the detector tries
    every (start, period) over the segment list and keeps the maximal
    repetition count x period coverage.  Requirements for pipelining:
      * >= 2 repetitions;
      * every block boundary crosses exactly one tensor whose logical
        shape/dtype matches the region's input (homogeneous stages —
        gpipe rotates a fixed-shape activation).
    Returns [] when no such region exists.
    """
    segments, boundaries = split_segments(graph)
    # signature of each segment, keyed by its incoming boundary guid
    sigs: List[Tuple] = []
    incoming: List[int] = []
    for seg, out_guid in zip(segments, boundaries):
        sigs.append(segment_signature(seg, incoming))
        incoming = [out_guid] if out_guid is not None else []

    tensor_by_guid = {}
    for op in graph.ops:
        for t in op.outputs:
            tensor_by_guid[t.guid] = t

    def boundary_shape(i: int):
        g = boundaries[i]
        if g is None:
            return None
        t = tensor_by_guid[g]
        return (tuple(t.shape.logical_shape), t.shape.dtype)

    n = len(segments)
    best: Tuple[int, int, int] = (0, 0, 0)  # (coverage, start, period)
    for period in range(1, n // 2 + 1):
        for start in range(0, n - 2 * period + 1):
            # block k = segments[start + k*period : start + (k+1)*period]
            reps = 1
            while True:
                nxt = start + reps * period
                if nxt + period > n:
                    break
                if any(
                    sigs[nxt + j] != sigs[start + j] for j in range(period)
                ):
                    break
                reps += 1
            if reps < 2:
                continue
            # homogeneous boundaries: each block ends at a single-tensor
            # cut with the same activation shape as the region input
            in_shape = boundary_shape(start - 1) if start > 0 else None
            shapes = [
                boundary_shape(start + (k + 1) * period - 1)
                for k in range(reps - 1)
            ]
            ref = shapes[0]
            if ref is None or any(s != ref for s in shapes):
                continue
            if in_shape is not None and in_shape != ref:
                # region input reshaped differently -> first block is not
                # homogeneous with the rest; drop it
                continue
            coverage = reps * period
            if coverage > best[0]:
                best = (coverage, start, period)
    if best[0] == 0:
        return []
    _, start, period = best
    reps = best[0] // period
    blocks = []
    for k in range(reps):
        ops: List[Op] = []
        for j in range(period):
            ops.extend(segments[start + k * period + j])
        blocks.append(ops)
    return blocks
