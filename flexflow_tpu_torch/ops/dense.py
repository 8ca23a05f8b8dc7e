"""Dense compute ops of the serving slice: Linear and Embedding.

Counterpart of flexflow_tpu/ops/dense.py.  The weight layouts are the
reference's: Linear.kernel is [in, out] and Embedding.weight is
[num_entries, out_dim].  The products go to torch.matmul, as the
reference left them to XLA.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..fftype import ActiMode, AggrMode, DataType, OperatorType
from ..initializer import DEFAULT_BIAS_INIT, DEFAULT_WEIGHT_INIT
from ..tensor import ParallelDim, ParallelTensorShape
from .op import Op, WeightSpec


def apply_activation(x: torch.Tensor, act: ActiMode) -> torch.Tensor:
    if act == ActiMode.NONE:
        return x
    if act == ActiMode.RELU:
        return torch.relu(x)
    if act == ActiMode.SIGMOID:
        return torch.sigmoid(x)
    if act == ActiMode.TANH:
        return torch.tanh(x)
    if act == ActiMode.GELU:
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(act)


@dataclasses.dataclass(frozen=True)
class LinearParams:
    out_channels: int
    use_bias: bool = True
    activation: ActiMode = ActiMode.NONE
    dtype: DataType = DataType.FLOAT


class Linear(Op):
    op_type = OperatorType.LINEAR

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: LinearParams = self.params
        data_dims = [d for d in ishape.dims if not d.is_replica_dim]
        in_dim = data_dims[-1]
        ri = ishape.replica_degree
        c = self.shard.channel
        if c > 1 and ri % c == 0:
            ri //= c
        out_dims = tuple(data_dims[:-1]) + (
            ParallelDim(p.out_channels, c),
            ParallelDim(1, ri * in_dim.degree, is_replica_dim=True),
        )
        return [ParallelTensorShape(out_dims, p.dtype)]

    def make_weight_specs(self, input_shapes):
        (ishape,) = input_shapes
        p: LinearParams = self.params
        data_dims = [d for d in ishape.dims if not d.is_replica_dim]
        in_dim = data_dims[-1]
        batch_degree = 1
        for d in data_dims[:-1]:
            batch_degree *= d.degree
        kernel = ParallelTensorShape(
            (
                ParallelDim(in_dim.size, in_dim.degree),
                ParallelDim(p.out_channels, self.shard.channel),
                ParallelDim(1, batch_degree, is_replica_dim=True),
            ),
            p.dtype,
        )
        specs = [WeightSpec("kernel", kernel, DEFAULT_WEIGHT_INIT)]
        if p.use_bias:
            bias = ParallelTensorShape(
                (
                    ParallelDim(p.out_channels, self.shard.channel),
                    ParallelDim(1, batch_degree * in_dim.degree,
                                is_replica_dim=True),
                ),
                p.dtype,
            )
            specs.append(WeightSpec("bias", bias, DEFAULT_BIAS_INIT))
        return specs

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        (x,) = inputs
        p: LinearParams = self.params
        y = torch.matmul(x, weights[0])
        if p.use_bias:
            y = y + weights[1]
        return [apply_activation(y, p.activation)]


@dataclasses.dataclass(frozen=True)
class EmbeddingParams:
    num_entries: int
    out_dim: int
    aggr: AggrMode = AggrMode.NONE
    dtype: DataType = DataType.FLOAT


class Embedding(Op):
    op_type = OperatorType.EMBEDDING

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: EmbeddingParams = self.params
        data_dims = [d for d in ishape.dims if not d.is_replica_dim]
        out_replica = ishape.replica_degree * self.shard.attribute
        kept = data_dims if p.aggr == AggrMode.NONE else data_dims[:-1]
        dims = tuple(ParallelDim(d.size, d.degree) for d in kept) + (
            ParallelDim(p.out_dim, self.shard.channel),
            ParallelDim(1, out_replica, is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, p.dtype)]

    def make_weight_specs(self, input_shapes):
        (ishape,) = input_shapes
        p: EmbeddingParams = self.params
        batch_degree = 1
        for d in ishape.dims:
            if not d.is_replica_dim:
                batch_degree *= d.degree
        weight = ParallelTensorShape(
            (
                ParallelDim(p.num_entries, self.shard.attribute),
                ParallelDim(p.out_dim, self.shard.channel),
                ParallelDim(1, batch_degree, is_replica_dim=True),
            ),
            p.dtype,
        )
        return [WeightSpec("weight", weight, DEFAULT_WEIGHT_INIT)]

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        (ids,) = inputs
        p: EmbeddingParams = self.params
        emb = weights[0][ids.long()]
        if p.aggr == AggrMode.SUM:
            emb = emb.sum(dim=-2)
        elif p.aggr == AggrMode.AVG:
            emb = emb.mean(dim=-2)
        return [emb]
