"""Expert parallelism: a MoE layer's GroupBy and Aggregate on ranks that
hold a shard of the tokens and a chunk of the experts.

The reference shards dim 0 of GroupBy's stacked [n, capacity, d] output
and of ExpertsDense's [n, d, out] kernel over mesh axes and lets GSPMD
insert the collectives (flexflow_tpu/ops/moe.py, ops/experts.py).  The
semantics stay global: capacity is ceil(alpha·k·b/n) over the global
batch, a (token, slot) pair's slot is its rank in the global,
sample-major order, and the balance loss counts over the global batch.

A rank holds the tokens of its chunk along one token axis `t` (or all
of them) and the experts of its chunk along the expert axes `X` (the
axes of GroupBy's output view on dim 0).  Its pairs' global ranks need
the pairs that the tokens before its shard route to each expert: an
all-gather over `t` of the [n] per-expert counts, then an exclusive
prefix (`rank_offset`).  The rows then move so that each rank of `t`
gets its experts' rows from every token shard (`route`, `group_by`):
to the peer along `t` whose chunk holds the row's expert, by an
all-to-all whose split sizes vary by rank (`collectives.exchange`).
When `t` is one of the expert axes that is a true all-to-all; when it
is not, every peer of `t` holds the same chunk and gets the same rows.
Axes of `X` that do not shard the tokens need no exchange: each rank
keeps the pairs of its own chunk.

The combine is the dispatch's reverse where `t` shards the experts
(the rows of this rank's pairs come back from the peers that computed
them); otherwise each rank combines the rows of its local experts for
its local tokens, and the result is a partial sum over the expert axes
that do not shard the tokens, reduced into the output's view like a
row-parallel Linear's.

Split sizes must be known on the host, so each exchange (a GroupBy
over sharded tokens, an Aggregate whose token axis shards the experts)
reads the counts there.  Only kept rows cross ranks: a dropped pair, or
a pair of an expert no peer holds, moves nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch

from ..ops.moe_dispatch import dispatch_indices, sort_combine, sort_group_by
from .collectives import all_gather, all_reduce, all_reduce_, exchange
from .machine import DeviceMesh


def expert_chunk(mesh: DeviceMesh, axes: Sequence[str], coords=None) -> int:
    """The index of the chunk of experts held at `coords` (this rank's
    by default) along the expert axes, major first."""
    coords = mesh.coords if coords is None else coords
    idx = 0
    for a in axes:
        idx = idx * mesh.size(a) + coords[a]
    return idx


def num_chunks(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.size(a) for a in axes)


def count_table(assign: torch.Tensor, n: int, mesh: DeviceMesh,
                t: str) -> torch.Tensor:
    """[size of t, n]: the pairs each rank of the token axis routes to
    each expert, by coordinate."""
    counts = torch.bincount(assign.reshape(-1).long(), minlength=n)
    return all_gather(counts[None], 0, mesh.size(t), mesh.group(t))


def rank_offset(table: torch.Tensor, mesh: DeviceMesh,
                t: str) -> torch.Tensor:
    """[n]: the pairs the ranks before this one along t route to each
    expert."""
    return table[:mesh.coord(t)].sum(dim=0)


@dataclasses.dataclass
class Route:
    """The exchange of one MoE layer along the token axis.

    send_pairs: this rank's flat pair indices whose rows go out, peer by
    peer (send[j] of them to the peer of coordinate j), each peer's by
    (expert, global rank), or, with `copies` > 1, the rows every peer
    gets alike; recv_slots: the local expert slots (from the chunk's
    first row) of the rows that arrive, sender by sender (recv[j] from
    coordinate j), each sender's by (expert, global rank)."""

    send_pairs: torch.Tensor
    send: List[int]
    recv_slots: torch.Tensor
    recv: List[int]
    copies: int = 1


def route(assign: torch.Tensor, n: int, capacity: int, mesh: DeviceMesh,
          t: str, expert_axes: Sequence[str]) -> Route:
    """The Route of this rank's pairs (`assign`, its shard of the [b, k]
    expert ids along `t`)."""
    nt, me = mesh.size(t), mesh.coord(t)
    m = n // num_chunks(mesh, expert_axes)
    table = count_table(assign, n, mesh, t)
    host = table.cpu()
    before = torch.cumsum(host, dim=0) - host  # exclusive prefix
    kept = torch.minimum(torch.clamp(capacity - before, min=0), host)
    chunks = [expert_chunk(mesh, expert_axes, dict(mesh.coords, **{t: j}))
              for j in range(nt)]
    # the pairs to send, by global slot: (chunk, expert, rank) order
    flat = assign.reshape(-1).long()
    slot, keep = dispatch_indices(assign, capacity, n,
                                  before[me].to(assign.device))
    wanted = torch.zeros(num_chunks(mesh, expert_axes), dtype=torch.bool,
                         device=assign.device)
    wanted[sorted(set(chunks))] = True
    key = torch.where(keep & wanted[flat // m], slot, n * capacity)
    order = torch.sort(key, stable=True).indices
    per_chunk = {c: int(kept[me, c * m:(c + 1) * m].sum()) for c in chunks}
    copies = 1
    if len(set(chunks)) == nt:  # t shards the experts: one chunk a peer
        send = [per_chunk[c] for c in chunks]
    else:  # every peer holds this rank's chunk
        send, copies = [per_chunk[chunks[me]]] * nt, nt
    lo = chunks[me] * m
    parts, recv = [], []
    for s in range(nt):
        got = 0
        for e in range(lo, lo + m):
            c = int(kept[s, e])
            if c:
                start = (e - lo) * capacity + int(before[s, e])
                parts.append(torch.arange(start, start + c))
                got += c
        recv.append(got)
    slots = (torch.cat(parts) if parts
             else torch.zeros(0, dtype=torch.long)).to(assign.device)
    return Route(order[:sum(send) // copies], send, slots, recv, copies)


def group_by(data: torch.Tensor, assign: torch.Tensor, n: int,
             capacity: int, mesh: DeviceMesh, t: Optional[str],
             expert_axes: Sequence[str]) -> torch.Tensor:
    """GroupBy's [n/E, capacity, d] rows of this rank's experts, from
    every token shard, at their global slots."""
    m = n // num_chunks(mesh, expert_axes)
    lo = expert_chunk(mesh, expert_axes) * m
    if t is None:  # every rank holds every token
        return sort_group_by(data, assign, n, capacity, lo, m)
    r = route(assign, n, capacity, mesh, t, expert_axes)
    k, d = assign.shape[1], data.shape[1]
    rows = data.repeat_interleave(k, dim=0)[r.send_pairs]
    if r.copies > 1:
        # a copy for each peer: the backward sums the copies' grads in a
        # fixed order (gathering from repeated indices would add them by
        # the card's atomics)
        rows = rows.repeat(r.copies, 1)
    got = exchange(rows, mesh, t, r.send, r.recv)
    out = data.new_zeros(m * capacity, d).index_copy(0, r.recv_slots, got)
    return out.reshape(m, capacity, d)


def combine(expert_out: torch.Tensor, assign: torch.Tensor, n: int,
            mesh: DeviceMesh, t: Optional[str],
            expert_axes: Sequence[str]) -> torch.Tensor:
    """The [b·k, e] rows of this rank's (token, slot) pairs: every pair's
    where `t` shards the experts, else those of this rank's experts
    (zero elsewhere: a partial sum over the other expert axes)."""
    m, capacity, e = expert_out.shape
    lo = expert_chunk(mesh, expert_axes) * m
    if t is None or t not in expert_axes:
        off = (None if t is None
               else rank_offset(count_table(assign, n, mesh, t), mesh, t))
        return sort_combine(expert_out, assign, capacity, n, lo, off)[0]
    r = route(assign, n, capacity, mesh, t, expert_axes)
    sent = expert_out.reshape(m * capacity, e)[r.recv_slots]
    got = exchange(sent, mesh, t, r.recv, r.send)
    return expert_out.new_zeros(assign.numel(), e).index_copy(
        0, r.send_pairs, got)


def balance_reduce(mesh: DeviceMesh, t: Optional[str], batch: int):
    """Aggregate's reduction of its balance-loss terms to the global
    batch: (first-choice counts, gate-probability sums) summed over the
    token axis (the sums differentiably), and the global batch."""

    def reduce(counts, sums):
        if t is not None:
            all_reduce_(counts, mesh.group(t))
            sums = all_reduce(sums, mesh, t)
        return counts, sums, batch

    return reduce
