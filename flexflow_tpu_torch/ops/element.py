"""Elementwise ops (flexflow_tpu/ops/element.py): ElementUnary, with the
reference's table of functions and its scalar ops, and ElementBinary."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..fftype import OpBinary, OperatorType, OpUnary
from ..tensor import ParallelDim, ParallelTensorShape
from .op import Op, ShapeError


@dataclasses.dataclass(frozen=True)
class ElementUnaryParams:
    op: OpUnary
    inplace: bool = False
    scalar: float = 0.0


_UNARY_FNS = {
    OpUnary.EXP: torch.exp,
    OpUnary.LOG: torch.log,
    OpUnary.SIN: torch.sin,
    OpUnary.COS: torch.cos,
    OpUnary.RELU: torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    OpUnary.GELU: lambda x: F.gelu(x, approximate="tanh"),
    OpUnary.SIGMOID: torch.sigmoid,
    OpUnary.TANH: torch.tanh,
    OpUnary.ELU: F.elu,
    OpUnary.IDENTITY: lambda x: x,
    OpUnary.RSQRT: torch.rsqrt,
    OpUnary.SQRT: torch.sqrt,
    OpUnary.ERF: torch.erf,
    OpUnary.FLOOR: torch.floor,
    OpUnary.NEGATIVE: torch.neg,
}

_SCALAR_FNS = {
    OpUnary.POW: torch.pow,
    OpUnary.SCALAR_MULTIPLY: torch.mul,
    OpUnary.SCALAR_ADD: torch.add,
    OpUnary.SCALAR_SUB: torch.sub,
    OpUnary.SCALAR_TRUE_DIV: torch.div,
}


class ElementUnary(Op):
    op_type = OperatorType.ELEMENT_UNARY

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        return [ishape]

    def forward(self, inputs, weights, *, training=False, generator=None):
        (x,) = inputs
        p: ElementUnaryParams = self.params
        if p.op in _UNARY_FNS:
            return [_UNARY_FNS[p.op](x)]
        return [_SCALAR_FNS[p.op](x, p.scalar)]


@dataclasses.dataclass(frozen=True)
class ElementBinaryParams:
    op: OpBinary
    inplace_a: bool = False


_BINARY_FNS = {
    OpBinary.ADD: torch.add,
    OpBinary.SUB: torch.sub,
    OpBinary.MUL: torch.mul,
    OpBinary.DIV: torch.div,
    OpBinary.MAX: torch.maximum,
    OpBinary.MIN: torch.minimum,
    OpBinary.POW: torch.pow,
}


class ElementBinary(Op):
    """Numpy-broadcasting binary op; degrees must agree on matching
    dims."""

    op_type = OperatorType.ELEMENT_BINARY

    def infer_output_shapes(self, input_shapes):
        a, b = input_shapes
        ad = [d for d in a.dims if not d.is_replica_dim]
        bd = [d for d in b.dims if not d.is_replica_dim]
        rank = max(len(ad), len(bd))
        out = []
        for i in range(1, rank + 1):
            da = ad[-i] if i <= len(ad) else None
            db = bd[-i] if i <= len(bd) else None
            if da is None:
                out.append(ParallelDim(db.size, db.degree))
            elif db is None:
                out.append(ParallelDim(da.size, da.degree))
            else:
                if da.size != db.size and 1 not in (da.size, db.size):
                    raise ShapeError(
                        f"{self.name}: cannot broadcast {da.size} vs "
                        f"{db.size}")
                size = max(da.size, db.size)
                deg = da.degree if da.size >= db.size else db.degree
                other = db if da.size >= db.size else da
                if other.size == size and other.degree != deg:
                    raise ShapeError(
                        f"{self.name}: degree mismatch on dim size {size}")
                out.append(ParallelDim(size, deg))
        out.reverse()
        replica = max(a.replica_degree, b.replica_degree)
        dims = tuple(out) + (ParallelDim(1, replica, is_replica_dim=True),)
        return [ParallelTensorShape(dims, a.dtype)]

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        a, b = inputs
        return [_BINARY_FNS[self.params.op](a, b)]
