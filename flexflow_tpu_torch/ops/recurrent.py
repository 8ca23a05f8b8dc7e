"""Recurrent ops: the LSTM (flexflow_tpu/ops/recurrent.py).

One LSTM op over [batch, seq, in_dim] with the reference's weight
layout: kernel [in + hidden, 4 * hidden] in gate order i, f, g, o, and
bias [4 * hidden] whose forget block starts at 1.  The reference's
`lax.scan` body runs here as a Python loop over the sequence, so
autograd gives BPTT.  The input half of the gate product does not
depend on the carry and is hoisted out of the loop as one
[b * s, d] x [d, 4h] GEMM (bias folded in); each step then adds
h_{t-1} x kernel[d:] to its slice with one addmm.  The same formulation
runs on both devices (cuDNN's LSTM is not used).
"""
from __future__ import annotations

import dataclasses

import torch

from ..fftype import DataType, OperatorType
from ..initializer import GlorotUniform, Initializer
from ..tensor import ParallelDim, ParallelTensorShape
from .op import Op, ShapeError, WeightSpec


@dataclasses.dataclass(frozen=True)
class LSTMBiasInitializer(Initializer):
    """Zeros with the forget-gate block set to 1: the offset lives in
    the stored weight, so weights cross to and from Keras- or
    ONNX-convention LSTMs unchanged."""

    hidden: int

    def __call__(self, gen, shape, dtype, device):
        b = torch.zeros(shape, dtype=dtype, device=device)
        b[self.hidden:2 * self.hidden] = 1.0
        return b


@dataclasses.dataclass(frozen=True)
class LSTMParams:
    hidden_size: int
    return_sequences: bool = True
    dtype: DataType = DataType.FLOAT


class LSTM(Op):
    """Single-layer LSTM over [batch, seq, in_dim].

    Output: [batch, seq, hidden] (return_sequences) or [batch, hidden].
    """

    op_type = OperatorType.LSTM

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        if ishape.logical_rank != 3:
            raise ShapeError(f"{self.name}: LSTM expects [batch, seq, d]")
        b, s, _ = ishape.logical_shape
        h = self.params.hidden_size
        bdim = ishape.dims[0]
        rep = ParallelDim(1, ishape.replica_degree, is_replica_dim=True)
        if self.params.return_sequences:
            dims = (ParallelDim(b, bdim.degree), ParallelDim(s),
                    ParallelDim(h), rep)
        else:
            dims = (ParallelDim(b, bdim.degree), ParallelDim(h), rep)
        return [ParallelTensorShape(dims, ishape.dtype)]

    def make_weight_specs(self, input_shapes):
        (ishape,) = input_shapes
        d = ishape.logical_shape[2]
        h = self.params.hidden_size
        rep = ParallelDim(1, 1, is_replica_dim=True)
        kshape = ParallelTensorShape(
            (ParallelDim(d + h), ParallelDim(4 * h), rep), self.params.dtype)
        bshape = ParallelTensorShape((ParallelDim(4 * h), rep),
                                     self.params.dtype)
        return [WeightSpec("kernel", kshape, GlorotUniform()),
                WeightSpec("bias", bshape, LSTMBiasInitializer(h))]

    def forward(self, inputs, weights, *, training=False, generator=None):
        (x,) = inputs
        kernel, bias = weights
        b, s, d = x.shape
        h = self.params.hidden_size
        # the carry-free half of every step's gate product, in one GEMM
        xz = torch.addmm(bias, x.reshape(b * s, d),
                         kernel[:d]).reshape(b, s, 4 * h)
        wh = kernel[d:]
        hid = x.new_zeros(b, h)
        cell = x.new_zeros(b, h)
        outs = []
        for t in range(s):
            z = torch.addmm(xz[:, t], hid, wh)
            i, f, g, o = z.chunk(4, dim=-1)
            cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
            hid = torch.sigmoid(o) * torch.tanh(cell)
            outs.append(hid)
        if self.params.return_sequences:
            return [torch.stack(outs, dim=1)]
        return [hid]

    def flops(self) -> float:
        b, s, d = self.inputs[0].shape.logical_shape
        h = self.params.hidden_size
        return 2.0 * b * s * (d + h) * 4 * h
