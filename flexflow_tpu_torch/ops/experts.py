"""Batched per-expert dense layer (flexflow_tpu/ops/experts.py).

One product over the stacked expert dim, [n, cap, d] x [n, d, out]
(torch.bmm, cuBLAS's batched GEMM on the card), plus a per-expert bias
and the activation.  Its op type is LINEAR, as in the reference, but
its kernel is [n, d, out] and its bias [n, out]: code that dispatches
on LINEAR must not assume Linear's weight layout.
"""
from __future__ import annotations

import dataclasses

import torch

from ..fftype import ActiMode, OperatorType
from ..initializer import DEFAULT_BIAS_INIT, DEFAULT_WEIGHT_INIT
from ..tensor import ParallelDim, ParallelTensorShape
from .dense import apply_activation
from .op import Op, ShapeError, WeightSpec


@dataclasses.dataclass(frozen=True)
class ExpertsDenseParams:
    out_dim: int
    use_bias: bool = True
    activation: ActiMode = ActiMode.NONE


class ExpertsDense(Op):
    op_type = OperatorType.LINEAR  # a linear to the search, as upstream

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        dd = [d for d in ishape.dims if not d.is_replica_dim]
        if len(dd) != 3:
            raise ShapeError(f"{self.name}: expect [experts, cap, dim]")
        n, cap, din = dd
        expert_degree = max(n.degree, self.shard.expert)
        if n.size % expert_degree != 0:
            raise ShapeError(f"{self.name}: experts {n.size} not divisible")
        dims = (
            ParallelDim(n.size, expert_degree),
            ParallelDim(cap.size, cap.degree),
            ParallelDim(self.params.out_dim, self.shard.channel),
            ParallelDim(1, ishape.replica_degree * din.degree,
                        is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, ishape.dtype)]

    def make_weight_specs(self, input_shapes):
        (ishape,) = input_shapes
        n, cap, din = [d for d in ishape.dims if not d.is_replica_dim]
        expert_degree = max(n.degree, self.shard.expert)
        p: ExpertsDenseParams = self.params
        kernel = ParallelTensorShape(
            (
                ParallelDim(n.size, expert_degree),
                ParallelDim(din.size, din.degree),
                ParallelDim(p.out_dim, self.shard.channel),
                ParallelDim(1, cap.degree, is_replica_dim=True),
            ),
            ishape.dtype,
        )
        specs = [WeightSpec("kernel", kernel, DEFAULT_WEIGHT_INIT)]
        if p.use_bias:
            bias = ParallelTensorShape(
                (
                    ParallelDim(n.size, expert_degree),
                    ParallelDim(p.out_dim, self.shard.channel),
                    ParallelDim(1, cap.degree * din.degree,
                                is_replica_dim=True),
                ),
                ishape.dtype,
            )
            specs.append(WeightSpec("bias", bias, DEFAULT_BIAS_INIT))
        return specs

    def forward(self, inputs, weights, *, training=False, generator=None):
        (x,) = inputs
        p: ExpertsDenseParams = self.params
        y = torch.bmm(x, weights[0])
        if p.use_bias:
            y = y + weights[1][:, None, :]
        return [apply_activation(y, p.activation)]

    def flops(self):
        ishape = self.inputs[0].shape
        return 2.0 * ishape.num_elements() * self.params.out_dim
