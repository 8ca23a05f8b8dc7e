"""Shape ops of flexflow_tpu/ops/shape.py: `Reduce` (sum or mean over
axes), `Mean`, which BERT's mean-pooled classifier calls, and `Flat`,
which ResNet's head calls.  The other shape ops of that module come
with later slices."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..fftype import OperatorType
from ..tensor import ParallelDim, ParallelTensorShape
from .op import Op, ShapeError


@dataclasses.dataclass(frozen=True)
class ReduceParams:
    axes: Tuple[int, ...]
    keepdims: bool = False
    op: str = "sum"  # "sum" | "mean"


class Reduce(Op):
    op_type = OperatorType.REDUCE_SUM

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        ddims = [d for d in ishape.dims if not d.is_replica_dim]
        axes = {a % len(ddims) for a in self.params.axes}
        dims = []
        reduced_degree = 1
        for i, d in enumerate(ddims):
            if i in axes:
                # a partitioned reduced axis leaves its degree as
                # replication of the result
                reduced_degree *= d.degree
                if self.params.keepdims:
                    dims.append(ParallelDim(1))
            else:
                dims.append(ParallelDim(d.size, d.degree))
        dims.append(ParallelDim(1, ishape.replica_degree * reduced_degree,
                                is_replica_dim=True))
        return [ParallelTensorShape(tuple(dims), ishape.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        p: ReduceParams = self.params
        fn = torch.sum if p.op == "sum" else torch.mean
        return [fn(inputs[0], dim=p.axes, keepdim=p.keepdims)]


class Mean(Reduce):
    op_type = OperatorType.MEAN


class Flat(Op):
    """Flatten all but the sample dim (reference src/ops/flat.cc)."""

    op_type = OperatorType.FLAT

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        ddims = [d for d in ishape.dims if not d.is_replica_dim]
        if any(d.degree > 1 for d in ddims[1:]):
            raise ShapeError(f"{self.name}: flattened dims are partitioned")
        rest = 1
        for d in ddims[1:]:
            rest *= d.size
        dims = (ParallelDim(ddims[0].size, ddims[0].degree),
                ParallelDim(rest),
                ParallelDim(1, ishape.replica_degree, is_replica_dim=True))
        return [ParallelTensorShape(dims, ishape.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]
