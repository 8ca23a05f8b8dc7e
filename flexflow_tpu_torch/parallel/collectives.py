"""Collectives of the multi-GPU executor, and the layouts they move
tensors between.

A `Layout` says how a global tensor lies on the ranks of a DeviceMesh:
per logical dim, the mesh axes that shard it (major first), and the set
of axes over which the local tensors are partial sums.  An axis a
tensor neither shards nor sums over replicates it.  `redistribute`
moves a local tensor from one layout to another through the primitives
below, each an autograd Function whose backward is the adjoint
collective:

    all-reduce     (partial -> replicated)   backward all-reduce
    reduce-scatter (partial -> sharded)      backward all-gather
    all-gather     (sharded -> replicated)   backward reduce-scatter
    slice          (replicated -> sharded)   backward zero-pad (partial)
    to-partial     (replicated -> partial)   backward the same mask
    all-to-all     (sharded on d -> on d')   backward the reverse

and two more: `exchange` (`all_to_all_v`), rows whose counts vary by
rank sent to the ranks that need them (expert parallelism's dispatch
and combine), whose backward is the reverse exchange, and `ppermute`,
the pipeline's shift of a tensor `step` ranks on along an axis, whose
backward shifts by -step.  With the first six, the gradient a rank
holds for a tensor of layout L has the adjoint layout: sharded stays
sharded, replicated becomes partial and partial becomes replicated.  So
the grad of a replicated weight comes back partial and the executor
sums it over those axes before the update.

Every collective here runs on the group's backend.  On `gloo` with CUDA
tensors (ranks sharing one card) the tensor is staged through host
memory: gloo takes CUDA tensors for some collectives and not others,
depending on the torch build, and staging gives every build one path.
A reduce-scatter on gloo is an all-reduce and a slice.

`reduce_scatter_async` and `all_gather_async` (and `prefetch_gather`,
the differentiable gather built on the latter) return a handle with
`wait()`: on NCCL the collective runs on the group's own stream, and
`wait()` orders the caller's stream after it without blocking the host,
so the caller's kernels overlap it (ZeRO-2's scatter during the
backward, ZeRO-3's prefetch of the next op's weights).  On gloo they
run the staged form above and return a handle that is done; those
cannot be captured in a CUDA graph (capture.py).

`traffic` counts the payload bytes this rank hands to each collective,
keyed by (scope, kind): the scope is the op whose forward ran it (the
executor sets it with `traffic_scope`), and a backward counts under its
forward's scope.  Callers read and clear it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import (Counter, FrozenSet, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist

from .machine import DeviceMesh, Spec


@dataclasses.dataclass(frozen=True)
class Layout:
    spec: Spec
    partial: FrozenSet[str] = frozenset()

    @classmethod
    def replicated(cls, rank: int) -> "Layout":
        return cls(((),) * rank)

    def axes(self) -> Tuple[str, ...]:
        return tuple(a for dim in self.spec for a in dim)

    def local_shape(self, shape, mesh: DeviceMesh) -> Tuple[int, ...]:
        out = []
        for size, axes in zip(shape, self.spec):
            n = 1
            for a in axes:
                n *= mesh.size(a)
            out.append(size // n)
        return tuple(out)

    def local_index(self, shape, mesh: DeviceMesh) -> Tuple[slice, ...]:
        """This rank's chunk of a global tensor of `shape`, one slice
        per dim (whole past the spec's dims)."""
        out = []
        for d, size in enumerate(shape):
            idx, n = self.chunk(d, mesh) if d < len(self.spec) else (0, 1)
            per = size // n
            out.append(slice(idx * per, (idx + 1) * per))
        return tuple(out)

    def chunk(self, dim: int, mesh: DeviceMesh) -> Tuple[int, int]:
        """(index, count) of this rank's chunk along `dim`."""
        idx, n = 0, 1
        for a in self.spec[dim]:
            idx = idx * mesh.size(a) + mesh.coord(a)
            n *= mesh.size(a)
        return idx, n

    def __str__(self) -> str:
        body = ",".join("+".join(a) if a else "_" for a in self.spec)
        if self.partial:
            body += "|P:" + "+".join(sorted(self.partial))
        return f"Layout({body})"


def local_slice(x, layout: Layout, mesh: DeviceMesh):
    """This rank's chunk of the global tensor (or array) `x`."""
    return x[layout.local_index(x.shape, mesh)]


# -- traffic ---------------------------------------------------------------

traffic: Counter = collections.Counter()
_scope: List[Optional[str]] = [None]


@contextlib.contextmanager
def traffic_scope(name: Optional[str]):
    """Count the collectives run inside under `name`."""
    prev, _scope[0] = _scope[0], name
    try:
        yield
    finally:
        _scope[0] = prev


def _count(kind: str, t: torch.Tensor) -> None:
    traffic[(_scope[0], kind)] += t.numel() * t.element_size()


# -- raw collectives (no autograd) ---------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group`."""
    _count("all_reduce", t)
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The chunks of `group`'s ranks, by rank, joined along `dim`."""
    src = t.contiguous()
    _count("all_gather", src)
    if _staged(src, group):
        host = src.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, n: int, idx: int,
                   group) -> torch.Tensor:
    """Chunk `idx` along `dim` of the sum over `group`."""
    if dist.get_backend(group) == "gloo":
        full = all_reduce_(t.clone(), group)
        # a copy: a chunk that is contiguous already would be a view
        # that keeps the whole sum alive
        return full.chunk(n, dim=dim)[idx].clone(
            memory_format=torch.contiguous_format)
    parts = [c.contiguous() for c in t.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    _count("reduce_scatter", t)
    dist.reduce_scatter(out, parts, group=group)
    return out


class _Done:
    """The handle of a collective that has already run (gloo)."""

    def wait(self) -> None:
        return None


def reduce_scatter_async(flat: torch.Tensor, n: int, idx: int, group):
    """(chunk `idx` of the sum over `group` of the 1-D `flat`, whose
    length n divides; its handle)."""
    if dist.get_backend(group) == "gloo":
        return reduce_scatter(flat, 0, n, idx, group), _Done()
    out = flat.new_empty(flat.numel() // n)
    _count("reduce_scatter", flat)
    work = dist.reduce_scatter_tensor(out, flat, group=group, async_op=True)
    return out, work


def all_gather_async(t: torch.Tensor, n: int, group):
    """([n, *t.shape]: the tensors of `group`'s ranks stacked by rank;
    its handle)."""
    src = t.contiguous()
    if dist.get_backend(group) == "gloo":
        return all_gather(src[None], 0, n, group), _Done()
    out = src.new_empty((n,) + tuple(src.shape))
    _count("all_gather", src)
    work = dist.all_gather_into_tensor(out, src, group=group, async_op=True)
    return out, work


def all_to_all(t: torch.Tensor, split_dim: int, cat_dim: int, n: int,
               group) -> torch.Tensor:
    """Send chunk j along `split_dim` to rank j of `group`; join what
    arrives along `cat_dim`."""
    parts = [c.contiguous() for c in t.chunk(n, dim=split_dim)]
    staged = _staged(t, group)
    send = torch.stack([p.cpu() if staged else p for p in parts])
    _count("all_to_all", send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = torch.cat(list(recv.unbind(0)), dim=cat_dim)
    return out.to(t.device) if staged else out


def all_to_all_v(t: torch.Tensor, send: Sequence[int], recv: Sequence[int],
                 group) -> torch.Tensor:
    """Rows of `t` to the ranks of `group`: send[j] rows, in order, to
    rank j; recv[j] rows arrive from rank j, joined in rank order along
    dim 0."""
    src = t.contiguous()
    _count("all_to_all_v", src)
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, list(recv), list(send), group=group)
    return out.to(t.device) if staged else out


def ring_shift(tensors: List[torch.Tensor], mesh: DeviceMesh, axis: str,
               step: Union[int, Sequence[int]] = 1) -> List[torch.Tensor]:
    """Each tensor sent to the rank `step` places on along `axis`
    (coordinate + step, mod its size) and received from the rank `step`
    places back, as one batch of point-to-point operations; `step` is
    one shift for every tensor or one per tensor (1F1B shifts
    activations +1 and cotangents -1 in one batch, so that no rank
    waits on a send its peer has not posted)."""
    steps = [step] * len(tensors) if isinstance(step, int) else list(step)
    members = mesh.members(axis)
    n, c = len(members), mesh.coord(axis)
    group = mesh.group(axis)
    staged = any(_staged(t, group) for t in tensors)
    out, ops = [], []
    for t, s in zip(tensors, steps):
        _count("ppermute", t)
        src = t.contiguous().cpu() if staged else t.contiguous()
        buf = torch.empty_like(src)
        ops.append(dist.P2POp(dist.isend, src, members[(c + s) % n], group))
        ops.append(dist.P2POp(dist.irecv, buf, members[(c - s) % n], group))
        out.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(t.device) for b, t in zip(out, tensors)] if staged else out


# -- autograd primitives -------------------------------------------------
# each forward keeps the traffic scope it ran under; its backward counts
# there

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.scope = mesh, axis, _scope[0]
        return all_reduce_(x.clone(), mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        with traffic_scope(ctx.scope):
            return (all_reduce_(g.clone(), ctx.mesh.group(ctx.axis)), None,
                    None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.scope = _scope[0]
        return all_gather(x, dim, mesh.size(axis), mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        m, a = ctx.mesh, ctx.axis
        with traffic_scope(ctx.scope):
            return (reduce_scatter(g, ctx.dim, m.size(a), m.coord(a),
                                   m.group(a)), None, None, None)


class _GatherStacked(torch.autograd.Function):
    """x -> [n, *x.shape], the shards of `axis` stacked by coordinate,
    gathered asynchronously (the handle goes into `box`); the backward
    reduce-scatters the stacked grad."""

    @staticmethod
    def forward(ctx, x, mesh, axis, box):
        ctx.mesh, ctx.axis, ctx.scope = mesh, axis, _scope[0]
        out, handle = all_gather_async(x, mesh.size(axis), mesh.group(axis))
        box.append(handle)
        return out

    @staticmethod
    def backward(ctx, g):
        m, a = ctx.mesh, ctx.axis
        with traffic_scope(ctx.scope):
            return (reduce_scatter(g, 0, m.size(a), m.coord(a),
                                   m.group(a))[0], None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.scope = _scope[0]
        return reduce_scatter(x, dim, mesh.size(axis), mesh.coord(axis),
                              mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        m, a = ctx.mesh, ctx.axis
        with traffic_scope(ctx.scope):
            return (all_gather(g, ctx.dim, m.size(a), m.group(a)), None,
                    None, None)


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        n, c = mesh.size(axis), mesh.coord(axis)
        ctx.n, ctx.c, ctx.dim, ctx.size = n, c, dim, x.shape[dim]
        return x.chunk(n, dim=dim)[c].contiguous()

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.size
        full = g.new_zeros(shape)
        full.narrow(ctx.dim, ctx.c * g.shape[ctx.dim],
                    g.shape[ctx.dim]).copy_(g)
        return full, None, None, None


class _ToPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.keep = mesh.coord(axis) == 0
        return x.clone() if ctx.keep else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, gather_dim, scatter_dim):
        ctx.mesh, ctx.axis, ctx.scope = mesh, axis, _scope[0]
        ctx.gd, ctx.sd = gather_dim, scatter_dim
        return all_to_all(x, scatter_dim, gather_dim, mesh.size(axis),
                          mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        m, a = ctx.mesh, ctx.axis
        with traffic_scope(ctx.scope):
            return (all_to_all(g, ctx.gd, ctx.sd, m.size(a), m.group(a)),
                    None, None, None, None)


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        ctx.scope = _scope[0]
        return all_to_all_v(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        with traffic_scope(ctx.scope):
            return (all_to_all_v(g, ctx.recv, ctx.send, ctx.group), None,
                    None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        ctx.scope = _scope[0]
        return ring_shift([x], mesh, axis, step)[0]

    @staticmethod
    def backward(ctx, g):
        with traffic_scope(ctx.scope):
            return (ring_shift([g], ctx.mesh, ctx.axis, -ctx.step)[0], None,
                    None, None)


def all_reduce(x, mesh: DeviceMesh, axis: str):
    """Differentiable sum over `axis` (partial -> replicated)."""
    return _AllReduce.apply(x, mesh, axis) if mesh.size(axis) > 1 else x


def prefetch_gather(x, mesh: DeviceMesh, axis: str, dim: int):
    """Start gathering `x`, sharded over `axis` along `dim`; returns
    finish() -> the gathered tensor, differentiable (its backward
    reduce-scatters), which waits for the gather at its first call and
    returns the same tensor after."""
    box: list = []
    stacked = _GatherStacked.apply(x, mesh, axis, box)
    done: list = []

    def finish() -> torch.Tensor:
        if not done:
            box[0].wait()
            done.append(stacked.movedim(0, dim).flatten(dim, dim + 1))
        return done[0]

    return finish


def exchange(x, mesh: DeviceMesh, axis: str, send: Sequence[int],
             recv: Sequence[int]):
    """Differentiable `all_to_all_v` over `axis` (send[j] rows to the
    rank of coordinate j, recv[j] from it); the backward sends each
    row's grad back to where the row came from."""
    if mesh.size(axis) == 1:
        return x
    return _AllToAllV.apply(x, tuple(send), tuple(recv), mesh.group(axis))


def ppermute(x, mesh: DeviceMesh, axis: str, step: int = 1):
    """Differentiable cyclic shift along `axis` (the reference's
    `lax.ppermute` with pairs (i, i + step)): each rank's x goes to the
    rank `step` places on and it gets the one from `step` places back;
    the backward shifts the grads by -step.  Every rank of the axis must
    call it, and must reach its backward, in the same order."""
    return _PPermute.apply(x, mesh, axis, step) if mesh.size(axis) > 1 else x


def redistribute(x: torch.Tensor, src: Layout, dst: Layout,
                 mesh: DeviceMesh) -> torch.Tensor:
    """x, the local tensor of layout `src`, as the local tensor of
    `dst`.  Partial axes are summed first (a reduce-scatter where `dst`
    shards a dim on that axis next); then every dim is gathered down to
    the axes it shares with `dst` (minor axes first) and sliced up to
    `dst`'s; an axis that moves alone from one dim to another goes by
    all-to-all."""
    if src == dst:
        return x
    spec = [list(a) for a in src.spec]
    partial = set(src.partial)
    for axis in [a for a in mesh.names if a in src.partial]:
        if axis in dst.partial:
            continue
        partial.discard(axis)
        for d, axes in enumerate(dst.spec):
            if (axis not in spec[d] and list(axes[:len(spec[d])]) == spec[d]
                    and len(axes) > len(spec[d]) and axes[len(spec[d])] == axis
                    and all(axis not in s for s in spec)):
                x = _ReduceScatter.apply(x, mesh, axis, d)
                spec[d].append(axis)
                break
        else:
            x = all_reduce(x, mesh, axis)
    keep = []
    for d, axes in enumerate(dst.spec):
        k = 0
        while (k < len(spec[d]) and k < len(axes)
               and spec[d][k] == axes[k]):
            k += 1
        keep.append(k)
    # an axis that is the whole changed suffix of one dim in src and of
    # another in dst moves by all-to-all
    for d in range(len(spec)):
        if len(spec[d]) != keep[d] + 1:
            continue
        axis = spec[d][-1]
        for e in range(len(spec)):
            if (e != d and len(dst.spec[e]) == keep[e] + 1
                    and len(spec[e]) == keep[e]
                    and dst.spec[e][-1] == axis
                    and axis not in dst.spec[d]):
                x = _AllToAll.apply(x, mesh, axis, d, e)
                spec[d].pop()
                spec[e].append(axis)
                break
    for d in range(len(spec)):
        while len(spec[d]) > keep[d]:
            axis = spec[d].pop()
            x = _AllGather.apply(x, mesh, axis, d)
    for d, axes in enumerate(dst.spec):
        for axis in axes[len(spec[d]):]:
            x = _Slice.apply(x, mesh, axis, d)
            spec[d].append(axis)
    for axis in [a for a in mesh.names if a in dst.partial
                 and a not in partial]:
        x = _ToPartial.apply(x, mesh, axis)
    return x


def gather_global(x: torch.Tensor, layout: Layout,
                  mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """The whole global tensor on every rank (no autograd)."""
    if mesh is None:
        return x
    with torch.no_grad():
        return redistribute(x, layout, Layout.replicated(len(layout.spec)),
                            mesh)
