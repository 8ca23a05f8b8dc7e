"""Shape ops of flexflow_tpu/ops/shape.py: `Reduce` (sum or mean over
axes), `Mean`, `Flat`, `Reshape`, `Expand`, `Transpose`, `Reverse`,
`Pad`, `Concat`, `Split` and `Gather`.  Each forward is the torch call
of the reference's jnp call; the backward comes from autograd.  None is
layout-agnostic (pcg/layout.py): the executor hands each a logical
NCHW tensor, except a Concat or Split between channels_last edges,
which runs on those along the same logical axis."""
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


# The ops below take the logical shape rules only: the port runs on one
# device, and the reference's degree and replica bookkeeping waits for
# the multi-GPU executor (ROADMAP §1.D).


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
        return [ParallelTensorShape.make(target, ishape.dtype)]

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
        shape = ishape.logical_shape
        if len(self.params.sizes) != len(shape):
            raise ShapeError(f"{self.name}: expand rank "
                             f"{len(self.params.sizes)} != input rank "
                             f"{len(shape)}")
        out = []
        for d, s in zip(shape, self.params.sizes):
            s = d if s == -1 else s
            if d != s and d != 1:
                raise ShapeError(f"{self.name}: cannot expand dim of size "
                                 f"{d} to {s}")
            out.append(s)
        return [ParallelTensorShape.make(out, ishape.dtype)]

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
        shape = ishape.logical_shape
        perm = self.params.perm
        if sorted(perm) != list(range(len(shape))):
            raise ShapeError(f"{self.name}: bad perm {perm}")
        return [ParallelTensorShape.make([shape[p] for p in perm],
                                         ishape.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        return [inputs[0].permute(self.params.perm).contiguous()]


@dataclasses.dataclass(frozen=True)
class ReverseParams:
    axis: int


class Reverse(Op):
    op_type = OperatorType.REVERSE

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

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
        shape = ishape.logical_shape
        pads = self.params.pads
        if len(pads) != len(shape):
            raise ShapeError(f"{self.name}: {len(pads)} pad pairs for rank "
                             f"{len(shape)}")
        return [ParallelTensorShape.make(
            [d + b + a for d, (b, a) in zip(shape, pads)], ishape.dtype)]

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
        first = input_shapes[0].logical_shape
        ax = self.params.axis % len(first)
        total = 0
        for s in input_shapes:
            shape = s.logical_shape
            if len(shape) != len(first):
                raise ShapeError(f"{self.name}: rank mismatch")
            for i in range(len(first)):
                if i != ax and shape[i] != first[i]:
                    raise ShapeError(f"{self.name}: dim {i} mismatch")
            total += shape[ax]
        out = list(first)
        out[ax] = total
        return [ParallelTensorShape.make(out, input_shapes[0].dtype)]

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
        shape = ishape.logical_shape
        ax = self.params.axis % len(shape)
        if sum(self.params.sizes) != shape[ax]:
            raise ShapeError(f"{self.name}: split sizes {self.params.sizes} "
                             f"!= {shape[ax]}")
        outs = []
        for sz in self.params.sizes:
            out = list(shape)
            out[ax] = sz
            outs.append(ParallelTensorShape.make(out, ishape.dtype))
        return outs

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
        return [ParallelTensorShape.make(index.logical_shape, data.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        data, index = inputs
        return [torch.gather(data, self.params.axis, index.long())]
