"""PCG source nodes: InputOp, WeightOp and NoOp
(flexflow_tpu/ops/sources.py)."""
from __future__ import annotations

import dataclasses

from ..fftype import OperatorType
from ..initializer import DEFAULT_WEIGHT_INIT
from ..tensor import ParallelTensorShape
from .op import Op, WeightSpec


@dataclasses.dataclass(frozen=True)
class SourceParams:
    shape: ParallelTensorShape
    kind: str = "input"  # "input" | "weight" | "noop"
    # weight sources only: False freezes the value (torch buffers)
    trainable: bool = True


class InputOp(Op):
    op_type = OperatorType.INPUT

    def infer_output_shapes(self, input_shapes):
        return [self.params.shape]

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        raise RuntimeError("source ops are fed by the executor, not executed")


class WeightOp(Op):
    """A standalone parameter surfaced as a tensor (the torch frontend's
    bare nn.Parameter or buffer operand).  A frozen one (a buffer, or a
    parameter with requires_grad False) keeps its value in the op
    state: no gradient, no optimizer update, no weight decay."""

    op_type = OperatorType.WEIGHT

    def infer_output_shapes(self, input_shapes):
        return [self.params.shape]

    def make_weight_specs(self, input_shapes):
        return [WeightSpec("value", self.params.shape, DEFAULT_WEIGHT_INIT)]

    def num_trainable_weights(self) -> int:
        return 1 if self.params.trainable else 0

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        return [weights[0]]


class NoOp(Op):
    op_type = OperatorType.NOOP

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        return [inputs[0]]
