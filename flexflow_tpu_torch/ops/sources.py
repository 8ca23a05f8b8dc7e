"""PCG source node: InputOp (flexflow_tpu/ops/sources.py)."""
from __future__ import annotations

import dataclasses

from ..fftype import OperatorType
from ..tensor import ParallelTensorShape
from .op import Op


@dataclasses.dataclass(frozen=True)
class SourceParams:
    shape: ParallelTensorShape
    kind: str = "input"


class InputOp(Op):
    op_type = OperatorType.INPUT

    def infer_output_shapes(self, input_shapes):
        return [self.params.shape]

    def forward(self, inputs, weights, *, training=False,
                generator=None):
        raise RuntimeError("source ops are fed by the executor, not executed")
