"""The ZeRO ladder's update layout and stage 2's scatter at production
(flexflow_tpu/parallel/zero.py, flexflow_tpu/executor.py).

A weight's update layout is its strategy layout with the weight-update
axis (`wus_axis`, "data" by default) added to its first logical dim that
the layout leaves free and whose size the axis divides.  What each
stage does in the port's executor:

- stage 1 keeps the optimizer's slots in that layout: after the
  backward has made every grad, each grad is reduce-scattered over the
  axis, each rank updates its shard of the weight, and the updated
  shards are all-gathered into the weight;
- stage 2 adds the reduce-scatter at production: as the backward makes
  each grad, it goes into a bucket (`ScatterBuckets`), and a full
  bucket is reduce-scattered asynchronously while the backward goes on;
  only the 1/N shard is kept, so the full grads are freed during the
  backward, and the update then waits on the handles, updates and
  gathers as stage 1 does (the reference constrains its grad buffer to
  the scattered layout, `grad_shardings`);
- stage 3 keeps the weight itself in that layout and gathers it for
  each op's forward, op k+1's gather issued before op k runs (the
  executor's prefetch, the reference's `_z3_prefetch`); its backward
  reduce-scatters the grad.

A weight with no such dim, or one the axis already shards, falls back
to the replicated update and is counted
(`GraphExecutor.zero_fallback_leaves`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .collectives import reduce_scatter_async
from .machine import Spec

#: bytes of grads per bucket of stage 2's reduce-scatter (the size
#: torch's DistributedDataParallel buckets by default)
BUCKET_BYTES = 25 * 2 ** 20


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


class ScatterBuckets:
    """Stage 2's reduce-scatter at production over one backward.

    `scatter` holds (key, leaf, dim) of every weight whose grad is
    scattered, in the order the backward is expected to make them (the
    reverse of the forward's); `others` the leaves whose grads stay
    whole (they are only counted).  A hook on each leaf runs when the
    backward has accumulated its grad: the grad, cut into its n chunks
    along `dim`, is copied into its bucket's [n, M] buffer (chunk c in
    row c) and the leaf's grad is dropped.  Buckets are launched in
    order, each once its grads are in and every earlier one is
    launched, so every rank issues the same collectives in the same
    order whatever order its hooks run in; at most one launched bucket
    is in flight (its buffer is released when the next one launches).
    `finish` launches what is left (a grad that never came is zero),
    waits, and returns each key's shard: chunk `coord` of the summed
    grad along `dim`.

    `held` and `peak` count the bytes of grads this object keeps alive
    (bucket buffers, shards, the whole grads of `others`), from their
    shapes."""

    def __init__(self, scatter: Sequence[Tuple[object, torch.Tensor, int]],
                 others: Sequence[torch.Tensor], n: int, coord: int, group,
                 bucket_bytes: int = BUCKET_BYTES):
        self.n, self.coord, self.group = n, coord, group
        self.buckets: List[List[tuple]] = []
        size = 0
        for key, leaf, dim in scatter:
            shape = list(leaf.shape)
            shape[dim] //= n
            m = leaf.numel() // n
            nbytes = leaf.numel() * leaf.element_size()
            if (not self.buckets or size + nbytes > bucket_bytes
                    or self.buckets[-1][0][1].dtype != leaf.dtype):
                self.buckets.append([])
                size = 0
            off = sum(e[4] for e in self.buckets[-1])
            self.buckets[-1].append((key, leaf, dim, off, m, tuple(shape)))
            size += nbytes
        self._where = {id(e[1]): (b, e) for b, bucket in
                       enumerate(self.buckets) for e in bucket}
        self._pending = [len(b) for b in self.buckets]
        self._arrived = [set() for _ in self.buckets]
        self._buffers: Dict[int, torch.Tensor] = {}
        self._shards: Dict[int, torch.Tensor] = {}
        self._inflight: Optional[Tuple[int, object]] = None
        self._launched = 0
        self.held = self.peak = 0
        self._hooks = [leaf.register_post_accumulate_grad_hook(self._on_grad)
                       for _, leaf, _ in scatter]
        self._hooks += [leaf.register_post_accumulate_grad_hook(self._count)
                        for leaf in others]

    def _add(self, nbytes: int) -> None:
        self.held += nbytes
        self.peak = max(self.peak, self.held)

    def _count(self, leaf: torch.Tensor) -> None:
        self._add(leaf.numel() * leaf.element_size())

    def _buffer(self, b: int) -> torch.Tensor:
        buf = self._buffers.get(b)
        if buf is None:
            bucket = self.buckets[b]
            width = sum(e[4] for e in bucket)
            leaf = bucket[0][1]
            buf = torch.empty((self.n, width), dtype=leaf.dtype,
                              device=leaf.device)
            self._buffers[b] = buf
            self._add(buf.numel() * buf.element_size())
        return buf

    def _put(self, b: int, entry, g: Optional[torch.Tensor]) -> None:
        _, leaf, dim, off, m, shape = entry
        slot = self._buffer(b)[:, off:off + m].unflatten(1, shape)
        if g is None:
            slot.zero_()
        else:
            slot.copy_(g.unflatten(dim, (self.n, -1)).movedim(dim, 0))
        self._arrived[b].add(id(leaf))
        self._pending[b] -= 1

    def _on_grad(self, leaf: torch.Tensor) -> None:
        b, entry = self._where[id(leaf)]
        self._add(leaf.numel() * leaf.element_size())
        self._put(b, entry, leaf.grad)
        leaf.grad = None
        self.held -= leaf.numel() * leaf.element_size()
        while (self._launched < len(self.buckets)
               and self._pending[self._launched] == 0):
            self._launch(self._launched)

    def _retire(self) -> None:
        if self._inflight is not None:
            b, handle = self._inflight
            handle.wait()
            buf = self._buffers.pop(b)
            self.held -= buf.numel() * buf.element_size()
            self._inflight = None

    def _launch(self, b: int) -> None:
        self._retire()
        shard, handle = reduce_scatter_async(self._buffers[b].view(-1),
                                             self.n, self.coord, self.group)
        self._add(shard.numel() * shard.element_size())
        self._shards[b] = shard
        self._inflight = (b, handle)
        self._launched += 1

    def remove(self) -> None:
        """Take the hooks off the leaves."""
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def finish(self) -> Dict[object, torch.Tensor]:
        """{key: this rank's shard of the summed grad}, once the backward
        has ended; removes the hooks."""
        self.remove()
        for b in range(self._launched, len(self.buckets)):
            for entry in self.buckets[b]:
                if id(entry[1]) not in self._arrived[b]:
                    self._put(b, entry, None)
            self._launch(b)
        self._retire()
        out = {}
        for b, bucket in enumerate(self.buckets):
            for key, _, _, off, m, shape in bucket:
                out[key] = self._shards[b][off:off + m].view(shape)
        return out
