"""Dense compute ops: Linear, Conv2D, Pool2D, Embedding and BatchMatmul.

Counterpart of flexflow_tpu/ops/dense.py.  The weight layouts are the
reference's: Linear.kernel is [in, out], Conv2D.kernel is OIHW and
Embedding.weight is [num_entries, out_dim].  The products go to
torch.matmul and the convolutions to F.conv2d (cuDNN on the card), as
the reference left them to XLA.  Conv2D and Pool2D keep the logical
NCHW shapes; the executor hands them channels_last tensors where
pcg/layout.py says so, and torch keeps that memory format through them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..fftype import ActiMode, AggrMode, DataType, OperatorType
from ..initializer import DEFAULT_BIAS_INIT, DEFAULT_WEIGHT_INIT
from ..tensor import ParallelDim, ParallelTensorShape
from .op import Op, ShapeError, WeightSpec


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

    def flops(self):
        ishape = self.inputs[0].shape
        return 2.0 * ishape.num_elements() * self.params.out_channels


@dataclasses.dataclass(frozen=True)
class Conv2DParams:
    out_channels: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    groups: int = 1
    use_bias: bool = True
    activation: ActiMode = ActiMode.NONE
    dtype: DataType = DataType.FLOAT


def _out_hw(name: str, h: int, w: int, p) -> Tuple[int, int]:
    """Output height and width of a conv or pool window p (kernel,
    stride, padding) over h x w."""
    oh = (h + 2 * p.padding[0] - p.kernel[0]) // p.stride[0] + 1
    ow = (w + 2 * p.padding[1] - p.kernel[1]) // p.stride[1] + 1
    if oh <= 0 or ow <= 0:
        raise ShapeError(f"{name}: non-positive output spatial dims")
    return oh, ow


class Conv2D(Op):
    """NCHW conv with an OIHW kernel (reference conv_2d.cc)."""

    op_type = OperatorType.CONV2D

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: Conv2DParams = self.params
        n, cin, h, w = [d for d in ishape.dims if not d.is_replica_dim]
        if cin.size % p.groups != 0 or p.out_channels % p.groups != 0:
            raise ShapeError(f"{self.name}: groups {p.groups} mismatch")
        oh, ow = _out_hw(self.name, h.size, w.size, p)
        dims = (
            ParallelDim(n.size, n.degree),
            ParallelDim(p.out_channels, self.shard.channel),
            ParallelDim(oh, h.degree),
            ParallelDim(ow, w.degree),
            ParallelDim(1, ishape.replica_degree * cin.degree,
                        is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, p.dtype)]

    def make_weight_specs(self, input_shapes):
        (ishape,) = input_shapes
        p: Conv2DParams = self.params
        n, cin, h, w = [d for d in ishape.dims if not d.is_replica_dim]
        spatial = n.degree * h.degree * w.degree
        kernel = ParallelTensorShape(
            (
                ParallelDim(p.out_channels, self.shard.channel),
                ParallelDim(cin.size // p.groups, cin.degree),
                ParallelDim(p.kernel[0]),
                ParallelDim(p.kernel[1]),
                ParallelDim(1, spatial, is_replica_dim=True),
            ),
            p.dtype,
        )
        specs = [WeightSpec("kernel", kernel, DEFAULT_WEIGHT_INIT)]
        if p.use_bias:
            bias = ParallelTensorShape(
                (
                    ParallelDim(p.out_channels, self.shard.channel),
                    ParallelDim(1, spatial * cin.degree,
                                is_replica_dim=True),
                ),
                p.dtype,
            )
            specs.append(WeightSpec("bias", bias, DEFAULT_BIAS_INIT))
        return specs

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        (x,) = inputs
        p: Conv2DParams = self.params
        y = F.conv2d(x, weights[0], weights[1] if p.use_bias else None,
                     stride=p.stride, padding=p.padding, groups=p.groups)
        return [apply_activation(y, p.activation)]

    def flops(self):
        oshape = self.outputs[0].shape
        p: Conv2DParams = self.params
        cin = self.inputs[0].shape.logical_shape[1]
        return (2.0 * oshape.num_elements() * (cin // p.groups)
                * p.kernel[0] * p.kernel[1])


@dataclasses.dataclass(frozen=True)
class Pool2DParams:
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    padding: Tuple[int, int] = (0, 0)
    pool_type: str = "max"  # "max" | "avg"
    activation: ActiMode = ActiMode.NONE


class Pool2D(Op):
    """Max pool over -inf padding; avg pool dividing by the whole
    window, padding included (count_include_pad).  An avg pool pads
    with explicit zeros and pools unpadded: on the card, torch 2.11's
    avg_pool2d backward over a channels_last input with padding returns
    wrong input grads (the forward is right), and zero padding then an
    unpadded pool is the same average."""

    op_type = OperatorType.POOL2D

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        p: Pool2DParams = self.params
        n, c, h, w = [d for d in ishape.dims if not d.is_replica_dim]
        oh, ow = _out_hw(self.name, h.size, w.size, p)
        dims = (
            ParallelDim(n.size, n.degree),
            ParallelDim(c.size, c.degree),
            ParallelDim(oh, h.degree),
            ParallelDim(ow, w.degree),
            ParallelDim(1, ishape.replica_degree, is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, ishape.dtype)]

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        (x,) = inputs
        p: Pool2DParams = self.params
        padding = p.padding
        if any(padding) and (p.pool_type != "max" or any(
                pd > k // 2 for pd, k in zip(p.padding, p.kernel))):
            # torch pads at most half a window itself, and its padded
            # avg pool back-propagates wrongly on the card: pad
            # explicitly with what the reference pads with
            value = float("-inf") if p.pool_type == "max" else 0.0
            x = F.pad(x, (p.padding[1], p.padding[1], p.padding[0],
                          p.padding[0]), value=value)
            padding = (0, 0)
        if p.pool_type == "max":
            y = F.max_pool2d(x, p.kernel, p.stride, padding)
        else:
            y = F.avg_pool2d(x, p.kernel, p.stride, padding,
                             count_include_pad=True)
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


@dataclasses.dataclass(frozen=True)
class BatchMatmulParams:
    a_seq_length_dim: int = -1
    b_seq_length_dim: int = -1


class BatchMatmul(Op):
    """[b..., m, k] @ [b..., k, n] -> [b..., m, n], torch.matmul (cuBLAS
    on the card).  FFModel.set_iteration_config stamps `_iter_seq_length`
    on every op: positions at or past it on the declared seq dims
    (`a_seq_length_dim`, `b_seq_length_dim`) are zeroed before the
    product, as the reference masks them."""

    op_type = OperatorType.BATCH_MATMUL

    def infer_output_shapes(self, input_shapes):
        a, b = input_shapes
        ad = [d for d in a.dims if not d.is_replica_dim]
        bd = [d for d in b.dims if not d.is_replica_dim]
        if len(ad) != len(bd):
            raise ShapeError(f"{self.name}: rank mismatch {len(ad)} vs "
                             f"{len(bd)}")
        if ad[-1].size != bd[-2].size:
            raise ShapeError(f"{self.name}: contraction mismatch")
        for da, db in zip(ad[:-2], bd[:-2]):
            if da.size != db.size or da.degree != db.degree:
                raise ShapeError(f"{self.name}: batch dims mismatch")
        if ad[-1].degree != bd[-2].degree:
            raise ShapeError(f"{self.name}: contraction degrees differ")
        # a partitioned contraction leaves partial sums: its degree
        # becomes replication of the output
        out_replica = max(a.replica_degree, b.replica_degree) * ad[-1].degree
        dims = tuple(ParallelDim(d.size, d.degree) for d in ad[:-2]) + (
            ParallelDim(ad[-2].size, ad[-2].degree),
            ParallelDim(bd[-1].size, bd[-1].degree),
            ParallelDim(1, out_replica, is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, a.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        a, b = inputs
        seq_len = getattr(self, "_iter_seq_length", -1)
        p: BatchMatmulParams = self.params
        if seq_len > 0:
            a = _mask_seq(a, p.a_seq_length_dim, seq_len)
            b = _mask_seq(b, p.b_seq_length_dim, seq_len)
        return [torch.matmul(a, b)]

    def flops(self):
        a = self.inputs[0].shape.logical_shape
        n = self.outputs[0].shape.logical_shape[-1]
        return 2.0 * float(math.prod(a)) * n


def _mask_seq(x: torch.Tensor, dim: int, seq_len: int) -> torch.Tensor:
    if dim < 0 or dim >= x.dim():
        return x
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    keep = torch.arange(x.shape[dim], device=x.device) < seq_len
    return x * keep.reshape(shape).to(x.dtype)
