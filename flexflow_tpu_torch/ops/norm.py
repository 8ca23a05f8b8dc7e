"""LayerNorm (flexflow_tpu/ops/norm.py), written out over any axes as
the reference writes it: mean, biased variance, rsqrt(var + eps)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..fftype import OperatorType
from ..initializer import ConstantInitializer, ZeroInitializer
from ..tensor import ParallelDim, ParallelTensorShape
from .op import Op, ShapeError, WeightSpec


@dataclasses.dataclass(frozen=True)
class LayerNormParams:
    axes: Tuple[int, ...]
    elementwise_affine: bool = True
    eps: float = 1e-5


class LayerNorm(Op):
    op_type = OperatorType.LAYER_NORM

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        rank = ishape.logical_rank
        data = [d for d in ishape.dims if not d.is_replica_dim]
        for ax in self.params.axes:
            if data[ax % rank].degree != 1:
                raise ShapeError(
                    f"{self.name}: normalized axis {ax} is partitioned")
        return [ishape]

    def make_weight_specs(self, input_shapes):
        p: LayerNormParams = self.params
        if not p.elementwise_affine:
            return []
        (ishape,) = input_shapes
        lshape = ishape.logical_shape
        rank = len(lshape)
        norm_shape = tuple(lshape[ax % rank]
                           for ax in sorted(a % rank for a in p.axes))
        dims = tuple(ParallelDim(s) for s in norm_shape) + (
            ParallelDim(1, ishape.total_degree, is_replica_dim=True),
        )
        wshape = ParallelTensorShape(dims, ishape.dtype)
        return [
            WeightSpec("gamma", wshape, ConstantInitializer(1.0)),
            WeightSpec("beta", wshape, ZeroInitializer()),
        ]

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        (x,) = inputs
        p: LayerNormParams = self.params
        axes = tuple(sorted(a % x.ndim for a in p.axes))
        mean = x.mean(dim=axes, keepdim=True)
        var = (x - mean).square().mean(dim=axes, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + p.eps)
        if p.elementwise_affine:
            gamma, beta = weights
            shape = [1] * x.ndim
            for i, ax in enumerate(axes):
                shape[ax] = gamma.shape[i]
            y = y * gamma.reshape(shape) + beta.reshape(shape)
        return [y.to(x.dtype)]
