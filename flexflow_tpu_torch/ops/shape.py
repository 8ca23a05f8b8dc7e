"""Shape ops of flexflow_tpu/ops/shape.py: `Reduce` (sum or mean over
axes), `Mean`, `Flat`, `Reshape`, `Expand`, `Transpose`, `Reverse`,
`Pad`, `Concat`, `Split` and `Gather`.  Each forward is the torch call
of the reference's jnp call; the backward comes from autograd.  None is
layout-agnostic (pcg/layout.py): the executor hands each a logical
NCHW tensor, except a Concat or Split between channels_last edges,
which runs on those along the same logical axis.  The shape rules
propagate partition degrees as the reference's do and raise ShapeError
on the same partitioned inputs."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

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
        ddims = _data_dims(ishape)
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
        ddims = _data_dims(ishape)
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


def _data_dims(shape: ParallelTensorShape):
    return [d for d in shape.dims if not d.is_replica_dim]


def _is_prefix_merge(ddims, target0: int) -> bool:
    """True if target0 is the product of a leading run of input dims."""
    prod = 1
    for d in ddims:
        prod *= d.size
        if prod == target0:
            return True
        if prod > target0:
            return False
    return False


def _is_prefix_split(lead_size: int, target) -> bool:
    """True if a leading run of target dims multiplies to lead_size."""
    prod = 1
    for s in target:
        prod *= s
        if prod == lead_size:
            return True
        if prod > lead_size:
            return False
    return False


@dataclasses.dataclass(frozen=True)
class ReshapeParams:
    shape: Tuple[int, ...]


class Reshape(Op):
    """Logical reshape; one -1 takes the rest of the elements.  The
    forward is torch.reshape, which copies when the input's strides
    demand it (a Split part, an Expand), where `view` would fail."""

    op_type = OperatorType.RESHAPE

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        target = list(self.params.shape)
        neg = [i for i, s in enumerate(target) if s == -1]
        if len(neg) > 1:
            raise ShapeError(f"{self.name}: multiple -1 in reshape")
        numel = math.prod(ishape.logical_shape)
        if neg:
            target[neg[0]] = numel // -math.prod(target)
        if math.prod(target) != numel:
            raise ShapeError(f"{self.name}: cannot reshape {ishape} to "
                             f"{target}")
        ddims = _data_dims(ishape)
        degrees = [1] * len(target)
        # The leading (sample) dim's degree survives three cases in which
        # every shard stays contiguous: the size is kept; a merge of the
        # partitioned leading dim with following unpartitioned dims
        # ([b(deg), s, h] -> [b*s, h]); a split of it into a prefix of
        # the target ([b*s(deg), h] -> [b, s, h] with deg | b).
        rest_whole = all(d.degree == 1 for d in ddims[1:])
        lead = max(ddims[0].degree, 1) if ddims else 1
        if ddims and target and rest_whole and (
                ddims[0].size == target[0]
                or (_is_prefix_merge(ddims, target[0])
                    and target[0] % lead == 0)
                or (_is_prefix_split(ddims[0].size, target)
                    and target[0] % lead == 0)):
            degrees[0] = ddims[0].degree
        elif any(d.degree > 1 for d in ddims):
            raise ShapeError(
                f"{self.name}: reshape of partitioned dims unsupported")
        dims = tuple(ParallelDim(s, g) for s, g in zip(target, degrees)) + (
            ParallelDim(1, ishape.replica_degree, is_replica_dim=True),)
        return [ParallelTensorShape(dims, ishape.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        return [torch.reshape(inputs[0], self.outputs[0].shape.logical_shape)]


@dataclasses.dataclass(frozen=True)
class ExpandParams:
    sizes: Tuple[int, ...]


class Expand(Op):
    """Broadcast size-1 dims up to `sizes` (torch Tensor.expand; -1 keeps
    a dim).  Of type RESHAPE, as in the reference.  The backward sums
    over the broadcast dims (autograd)."""

    op_type = OperatorType.RESHAPE

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        ddims = _data_dims(ishape)
        if len(self.params.sizes) != len(ddims):
            raise ShapeError(f"{self.name}: expand rank "
                             f"{len(self.params.sizes)} != input rank "
                             f"{len(ddims)}")
        dims = []
        for d, s in zip(ddims, self.params.sizes):
            s = d.size if s == -1 else s
            if d.size != s and d.size != 1:
                raise ShapeError(f"{self.name}: cannot expand dim of size "
                                 f"{d.size} to {s}")
            if d.size == 1 and s != 1 and d.degree != 1:
                raise ShapeError(
                    f"{self.name}: cannot expand partitioned dim")
            dims.append(ParallelDim(s, d.degree))
        dims.append(ParallelDim(1, ishape.replica_degree, is_replica_dim=True))
        return [ParallelTensorShape(tuple(dims), ishape.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        return [inputs[0].expand(self.outputs[0].shape.logical_shape)]


@dataclasses.dataclass(frozen=True)
class TransposeParams:
    perm: Tuple[int, ...]


class Transpose(Op):
    """A permutation of the dims, materialized in the permuted order
    (as jnp.transpose's result is).  A strided view would pass its
    layout on: elementwise ops keep their input's strides, so a ViT's
    patch transpose would leave the whole residual stream, and every
    LayerNorm and Linear input after it, in the transposed layout."""

    op_type = OperatorType.TRANSPOSE

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        ddims = _data_dims(ishape)
        perm = self.params.perm
        if sorted(perm) != list(range(len(ddims))):
            raise ShapeError(f"{self.name}: bad perm {perm}")
        dims = tuple(ParallelDim(ddims[p].size, ddims[p].degree)
                     for p in perm) + (
            ParallelDim(1, ishape.replica_degree, is_replica_dim=True),)
        return [ParallelTensorShape(dims, ishape.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        return [inputs[0].permute(self.params.perm).contiguous()]


@dataclasses.dataclass(frozen=True)
class ReverseParams:
    axis: int


class Reverse(Op):
    op_type = OperatorType.REVERSE

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        ax = self.params.axis % ishape.logical_rank
        if _data_dims(ishape)[ax].degree != 1:
            raise ShapeError(f"{self.name}: reversed axis is partitioned")
        return [ishape]

    def forward(self, inputs, weights, *, training=False, generator=None):
        return [torch.flip(inputs[0], [self.params.axis])]


@dataclasses.dataclass(frozen=True)
class PadParams:
    pads: Tuple[Tuple[int, int], ...]  # (before, after) per logical dim
    value: float = 0.0


class Pad(Op):
    """Constant padding along the logical dims (ONNX Pad, F.pad)."""

    op_type = OperatorType.PAD

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        pads = self.params.pads
        if len(pads) != ishape.logical_rank:
            raise ShapeError(f"{self.name}: {len(pads)} pad pairs for rank "
                             f"{ishape.logical_rank}")
        dims = []
        for d, (b, a) in zip(_data_dims(ishape), pads):
            if (b or a) and d.degree != 1:
                raise ShapeError(f"{self.name}: padded axis is partitioned")
            dims.append(ParallelDim(d.size + b + a, d.degree))
        dims.append(ParallelDim(1, ishape.replica_degree, is_replica_dim=True))
        return [ParallelTensorShape(tuple(dims), ishape.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        # F.pad takes (before, after) pairs from the last dim backwards
        flat = [n for pair in reversed(self.params.pads) for n in pair]
        return [F.pad(inputs[0], flat, value=self.params.value)]


@dataclasses.dataclass(frozen=True)
class ConcatParams:
    axis: int


class Concat(Op):
    op_type = OperatorType.CONCAT

    def infer_output_shapes(self, input_shapes):
        first = input_shapes[0]
        fd = _data_dims(first)
        ax = self.params.axis % len(fd)
        total = 0
        for s in input_shapes:
            dd = _data_dims(s)
            if len(dd) != len(fd):
                raise ShapeError(f"{self.name}: rank mismatch")
            if dd[ax].degree != 1:
                raise ShapeError(f"{self.name}: concat axis partitioned")
            for i in range(len(fd)):
                if i != ax and (dd[i].size != fd[i].size
                                or dd[i].degree != fd[i].degree):
                    raise ShapeError(f"{self.name}: dim {i} mismatch")
            total += dd[ax].size
        dims = [ParallelDim(total, 1) if i == ax
                else ParallelDim(d.size, d.degree) for i, d in enumerate(fd)]
        dims.append(ParallelDim(1, first.replica_degree, is_replica_dim=True))
        return [ParallelTensorShape(tuple(dims), first.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        return [torch.cat(list(inputs), dim=self.params.axis)]


@dataclasses.dataclass(frozen=True)
class SplitParams:
    sizes: Tuple[int, ...]
    axis: int


class Split(Op):
    op_type = OperatorType.SPLIT

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        ddims = _data_dims(ishape)
        ax = self.params.axis % len(ddims)
        if ddims[ax].degree != 1:
            raise ShapeError(f"{self.name}: split axis partitioned")
        if sum(self.params.sizes) != ddims[ax].size:
            raise ShapeError(f"{self.name}: split sizes {self.params.sizes} "
                             f"!= {ddims[ax].size}")
        rep = ParallelDim(1, ishape.replica_degree, is_replica_dim=True)
        return [ParallelTensorShape(
            tuple(ParallelDim(sz if i == ax else d.size, d.degree)
                  for i, d in enumerate(ddims)) + (rep,), ishape.dtype)
            for sz in self.params.sizes]

    def forward(self, inputs, weights, *, training=False, generator=None):
        parts = torch.split(inputs[0], list(self.params.sizes),
                            dim=self.params.axis)
        if inputs[0].dim() == 4 and inputs[0].is_contiguous(
                memory_format=torch.channels_last):
            # a channel slice of a channels_last tensor is contiguous in
            # neither format: materialize it, as jnp.split's parts are
            return [p.contiguous(memory_format=torch.channels_last)
                    for p in parts]
        return list(parts)


@dataclasses.dataclass(frozen=True)
class GatherParams:
    axis: int


class Gather(Op):
    """Gather along `axis` with an index tensor of the same rank
    (take_along_axis, torch.gather): the output has the index's shape."""

    op_type = OperatorType.GATHER

    def infer_output_shapes(self, input_shapes):
        data, index = input_shapes
        ax = self.params.axis % data.logical_rank
        if _data_dims(data)[ax].degree != 1:
            raise ShapeError(f"{self.name}: gather axis partitioned")
        dims = tuple(ParallelDim(d.size, d.degree)
                     for d in _data_dims(index)) + (
            ParallelDim(1, data.replica_degree, is_replica_dim=True),)
        return [ParallelTensorShape(dims, data.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        data, index = inputs
        return [torch.gather(data, self.params.axis, index.long())]
