"""Parallelization operators: the parallelism IR of the PCG
(flexflow_tpu/parallel/parallel_op.py).

Repartition, Combine, Replicate, Reduction and AllToAll change a
tensor's parallel shape (its degrees and replica dim) and are the
identity on the global logical tensor: each forward returns its input.
On a torch.distributed group the executor then redistributes that input
from its layout to the output's view (parallel/collectives.py), which
is the collective each name says, with its adjoint as the backward:
Repartition a local slice (backward: zero-padded, summed where it is
used), Combine an all-gather (a reduce-scatter), Replicate the identity
(an all-reduce of the partial grads), Reduction a sum (an all-reduce,
or a reduce-scatter where the output is sharded), AllToAll an
all_to_all_single; a FusedParallelOp chains them.  StackReplicate and FoldReduce are compute
ops with real work (stack copies along an axis, sum equal slices).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..fftype import OperatorType
from ..ops.op import Op, ShapeError
from ..tensor import ParallelDim, ParallelTensorShape


def _replace_dim(shape: ParallelTensorShape, logical_idx: int, new: ParallelDim):
    dims = []
    li = 0
    for d in shape.dims:
        if d.is_replica_dim:
            dims.append(d)
        else:
            dims.append(new if li == logical_idx else d)
            li += 1
    return ParallelTensorShape(tuple(dims), shape.dtype)


def _with_replica(shape: ParallelTensorShape, degree: int):
    dims = tuple(
        dataclasses.replace(d, degree=degree) if d.is_replica_dim else d
        for d in shape.dims
    )
    return ParallelTensorShape(dims, shape.dtype)


class ParallelOpBase(Op):
    def forward(self, inputs, weights, *, training=False, generator=None):
        return [inputs[0]]


@dataclasses.dataclass(frozen=True)
class RepartitionParams:
    dim: int
    degree: int


class Repartition(ParallelOpBase):
    op_type = OperatorType.REPARTITION

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: RepartitionParams = self.params
        dd = [d for d in ishape.dims if not d.is_replica_dim]
        dim = dd[p.dim % len(dd)]
        new_degree = dim.degree * p.degree
        if dim.size % new_degree != 0:
            raise ShapeError(
                f"{self.name}: dim size {dim.size} not divisible by {new_degree}"
            )
        return [_replace_dim(ishape, p.dim % len(dd), dim.with_degree(new_degree))]


@dataclasses.dataclass(frozen=True)
class CombineParams:
    dim: int
    degree: int


class Combine(ParallelOpBase):
    op_type = OperatorType.COMBINE

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: CombineParams = self.params
        dd = [d for d in ishape.dims if not d.is_replica_dim]
        dim = dd[p.dim % len(dd)]
        if dim.degree % p.degree != 0:
            raise ShapeError(f"{self.name}: degree {dim.degree} not divisible by {p.degree}")
        return [
            _replace_dim(ishape, p.dim % len(dd), dim.with_degree(dim.degree // p.degree))
        ]


@dataclasses.dataclass(frozen=True)
class ReplicateParams:
    degree: int


class Replicate(ParallelOpBase):
    op_type = OperatorType.REPLICATE

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        return [_with_replica(ishape, ishape.replica_degree * self.params.degree)]


@dataclasses.dataclass(frozen=True)
class ReductionParams:
    degree: int


class Reduction(ParallelOpBase):
    op_type = OperatorType.REDUCTION

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        rd = ishape.replica_degree
        if rd % self.params.degree != 0:
            raise ShapeError(f"{self.name}: replica degree {rd} not divisible")
        return [_with_replica(ishape, rd // self.params.degree)]


@dataclasses.dataclass(frozen=True)
class AllToAllParams:
    from_dim: int  # dim currently sharded
    to_dim: int  # dim to move the degree onto
    degree: int


class AllToAll(ParallelOpBase):
    """Move `degree` of parallelism from one dim to another in one
    collective (sequence <-> head resharding; expert dispatch)."""

    op_type = OperatorType.ALLTOALL

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: AllToAllParams = self.params
        dd = [d for d in ishape.dims if not d.is_replica_dim]
        src = dd[p.from_dim % len(dd)]
        dst = dd[p.to_dim % len(dd)]
        if src.degree % p.degree != 0:
            raise ShapeError(f"{self.name}: from-dim degree {src.degree} not divisible")
        new_dst_degree = dst.degree * p.degree
        if dst.size % new_dst_degree != 0:
            raise ShapeError(f"{self.name}: to-dim size not divisible")
        s = _replace_dim(ishape, p.from_dim % len(dd), src.with_degree(src.degree // p.degree))
        return [_replace_dim(s, p.to_dim % len(dd), dst.with_degree(new_dst_degree))]


@dataclasses.dataclass(frozen=True)
class StackReplicateParams:
    axis: int  # row-major logical axis
    degree: int


class StackReplicate(Op):
    """`degree` copies of the input stacked (concatenated) along `axis`
    — the reference Replicate's actual logical semantics
    (replicate.cc:74-75: dims[replicate_dim].size *= degree).  A compute
    op, not a sharding annotation: when the stacked axis is sharded at
    `degree`, each shard holds one copy, which is physical replication.
    Used by the TASO substitution catalog (pcg/taso.py)."""

    op_type = OperatorType.REPLICATE_STACK

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: StackReplicateParams = self.params
        dd = [d for d in ishape.dims if not d.is_replica_dim]
        ax = p.axis % len(dd)
        dim = dd[ax]
        new_size = dim.size * p.degree
        if new_size % dim.degree != 0:
            raise ShapeError(f"{self.name}: stacked size not shardable")
        return [_replace_dim(ishape, ax, dataclasses.replace(dim, size=new_size))]

    def forward(self, inputs, weights, *, training=False, generator=None):
        (x,) = inputs
        ax = self.params.axis % x.dim()
        return [torch.cat([x] * self.params.degree, dim=ax)]

    def flops(self):
        return 0.0


@dataclasses.dataclass(frozen=True)
class FoldReduceParams:
    axis: int  # row-major logical axis
    degree: int


class FoldReduce(Op):
    """Sum of `degree` equal slices along `axis` — the reference
    Reduction's logical semantics (reduction.cc:74-77:
    dims[reduction_dim].size /= degree): partial sums laid out along a
    dim are folded.  Inverse-composes with StackReplicate and with
    Concat (a concat axis is a stack of partials — what lets the TASO
    catalog trade elementwise adds for concat+reduce)."""

    op_type = OperatorType.REDUCTION_FOLD

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: FoldReduceParams = self.params
        dd = [d for d in ishape.dims if not d.is_replica_dim]
        ax = p.axis % len(dd)
        dim = dd[ax]
        if dim.size % p.degree != 0:
            raise ShapeError(f"{self.name}: size {dim.size} not divisible by fold {p.degree}")
        new_size = dim.size // p.degree
        if new_size % dim.degree != 0:
            raise ShapeError(f"{self.name}: folded size not shardable")
        return [_replace_dim(ishape, ax, dataclasses.replace(dim, size=new_size))]

    def forward(self, inputs, weights, *, training=False, generator=None):
        (x,) = inputs
        p: FoldReduceParams = self.params
        ax = p.axis % x.dim()
        parts = torch.chunk(x, p.degree, dim=ax)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return [out]

    def flops(self):
        return float(self.inputs[0].shape.num_elements())


@dataclasses.dataclass(frozen=True)
class FusedParallelParams:
    ops: Tuple = ()  # tuple of (kind, params) pairs


class FusedParallelOp(ParallelOpBase):
    """A chain of parallel ops collapsed into one resharding boundary
    (reference fused_parallel_op.cc): one boundary, one collective."""

    op_type = OperatorType.FUSED_PARALLEL

    _KINDS = None

    def infer_output_shapes(self, input_shapes):
        shape = input_shapes[0]
        for kind, params in self.params.ops:
            cls = PARALLEL_OP_KINDS[kind]
            shape = cls.infer_output_shapes_static(shape, params)
        return [shape]


def _static(cls):
    def fn(shape, params):
        dummy = object.__new__(cls)
        dummy.params = params
        dummy.name = cls.__name__
        return cls.infer_output_shapes(dummy, [shape])[0]

    return fn


for _cls in (Repartition, Combine, Replicate, Reduction, AllToAll):
    _cls.infer_output_shapes_static = staticmethod(_static(_cls))

PARALLEL_OP_KINDS = {
    "repartition": Repartition,
    "combine": Combine,
    "replicate": Replicate,
    "reduction": Reduction,
    "all_to_all": AllToAll,
    "fused": FusedParallelOp,
}
