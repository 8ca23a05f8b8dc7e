"""Normalization ops (flexflow_tpu/ops/norm.py): LayerNorm, BatchNorm
and Softmax.

LayerNorm is written out over any axes as the reference writes it:
mean, biased variance, rsqrt(var + eps).  BatchNorm keeps the
reference's own rules, not torch's: one-pass statistics E[x^2] - E[x]^2
in float32, clamped at 0 (biased variance); running statistics
`momentum * old + (1 - momentum) * new` with momentum 0.9, carried as
op state and never part of the autograd graph; scale and shift cast to
x's dtype before the apply.  The apply itself, with the residual add
and the ReLU that follow it when the executor fuses them, is P1, the
hand-written kernel of ops/kernels/bn_apply.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..fftype import OperatorType
from ..initializer import ConstantInitializer, ZeroInitializer
from ..tensor import ParallelDim, ParallelTensorShape
from .kernels.bn_apply import BNApply
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


class BatchStats(torch.autograd.Function):
    """Per-channel E[x] and E[x^2] of an NCHW-shaped x (any memory
    format) in float32, the reference's one-pass statistics.  Its
    backward, dx = (dmean + 2 x dmeansq) / n, needs only x, which the
    apply saves anyway; autograd through x.float() * x.float() would
    keep a float32 copy of every bfloat16 BatchNorm input alive until
    the backward."""

    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        meansq = xf.square().mean(dim=(0, 2, 3))
        ctx.save_for_backward(x)
        return mean, meansq

    @staticmethod
    def backward(ctx, dmean, dmeansq):
        (x,) = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        # one pass in float32 (x widened as it is read), one cast
        dx = torch.addcmul((dmean / n).view(1, -1, 1, 1), x,
                           (2.0 * dmeansq / n).view(1, -1, 1, 1))
        return dx.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class BatchNormParams:
    relu: bool = True  # the reference's batch_norm has a fused relu
    eps: float = 1e-5
    momentum: float = 0.9


class BatchNorm(Op):
    """NCHW batch norm.  Weights [0:2] (gamma, beta) are trainable;
    [2:4] (running_mean, running_var) are op state, returned updated
    after the output."""

    op_type = OperatorType.BATCH_NORM
    has_aux_state = True

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        if ishape.logical_rank != 4:
            raise ShapeError(f"{self.name}: BatchNorm takes NCHW input, "
                             f"got rank {ishape.logical_rank}")
        return [ishape]

    def make_weight_specs(self, input_shapes):
        (ishape,) = input_shapes
        c = ishape.logical_shape[1]
        cdeg = [d for d in ishape.dims if not d.is_replica_dim][1].degree
        rep = ishape.total_degree // cdeg
        dims = (ParallelDim(c, cdeg),
                ParallelDim(1, rep, is_replica_dim=True))
        ws = ParallelTensorShape(dims, ishape.dtype)
        return [
            WeightSpec("gamma", ws, ConstantInitializer(1.0)),
            WeightSpec("beta", ws, ZeroInitializer()),
            WeightSpec("running_mean", ws, ZeroInitializer()),
            WeightSpec("running_var", ws, ConstantInitializer(1.0)),
        ]

    def num_trainable_weights(self) -> int:
        return 2

    def forward(self, inputs, weights, *, training=False, generator=None,
                residual: Optional[torch.Tensor] = None,
                relu: Optional[bool] = None, stats_reduce=None):
        """[y, new running_mean, new running_var].  The executor's
        fusion plan passes `residual` (the other operand of the add this
        BatchNorm feeds) and `relu` (whether the ReLU after it is fused);
        alone, the op applies its own `params.relu`.  On a mesh that
        shards the batch, the executor passes `stats_reduce`, which
        turns this rank's E[x] and E[x^2] into the global batch's
        (differentiably), so that every rank normalizes alike."""
        (x,) = inputs
        p: BatchNormParams = self.params
        gamma, beta, rmean, rvar = weights
        if training:
            mean, meansq = BatchStats.apply(x)
            if stats_reduce is not None:
                mean, meansq = stats_reduce(mean, meansq)
            var = torch.clamp_min(meansq - mean.square(), 0.0)
            with torch.no_grad():
                new_rmean = (p.momentum * rmean
                             + (1 - p.momentum) * mean.to(rmean.dtype))
                new_rvar = (p.momentum * rvar
                            + (1 - p.momentum) * var.to(rvar.dtype))
        else:
            mean, var = rmean, rvar
            new_rmean, new_rvar = rmean, rvar
        scale = gamma.to(var.dtype) * torch.rsqrt(var + p.eps)
        shift = beta.to(var.dtype) - mean * scale
        y = BNApply.apply(x, scale.to(x.dtype), shift.to(x.dtype), residual,
                          p.relu if relu is None else relu)
        return [y, new_rmean, new_rvar]


@dataclasses.dataclass(frozen=True)
class SoftmaxParams:
    axis: int = -1


class Softmax(Op):
    op_type = OperatorType.SOFTMAX

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        ax = self.params.axis % ishape.logical_rank
        if [d for d in ishape.dims if not d.is_replica_dim][ax].degree != 1:
            raise ShapeError(f"{self.name}: softmax axis {ax} is "
                             "partitioned")
        return [ishape]

    def forward(self, inputs, weights, *, training=False, generator=None):
        return [torch.softmax(inputs[0], dim=self.params.axis)]
