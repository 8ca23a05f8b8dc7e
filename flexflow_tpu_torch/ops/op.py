"""Base operator class for the PCG.

Counterpart of flexflow_tpu/ops/op.py.  Each op is a frozen params
dataclass, a shape rule `infer_output_shapes` over ParallelTensorShape,
weight specs, and a `forward` on torch tensors.  Ops hold no tensors:
the executor owns the weight and state dictionaries and passes each op
its entries.  State entries (the paged KV pools) are updated in place
by `forward`, where the reference returned new arrays.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

import torch

from ..fftype import OperatorType
from ..initializer import Initializer
from ..tensor import ParallelTensor, ParallelTensorShape

_op_guid = itertools.count(2001)


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Op-internal parallelism degrees (all 1 on one device)."""

    channel: int = 1
    reduction: int = 1
    attribute: int = 1
    expert: int = 1


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    name: str
    shape: ParallelTensorShape
    initializer: Optional[Initializer] = None


class ShapeError(ValueError):
    """Raised when an op cannot accept the given input parallel shapes."""


class Op:
    """A node in the parallel computation graph."""

    op_type: OperatorType = OperatorType.NOOP

    def __init__(self, params, inputs: Sequence[ParallelTensor],
                 name: str = "", shard: ShardConfig = ShardConfig()):
        self.guid = next(_op_guid)
        self.params = params
        self.inputs: List[ParallelTensor] = list(inputs)
        self.shard = shard
        self.name = name or f"{self.op_type.value}_{self.guid}"
        out_shapes = self.infer_output_shapes([t.shape for t in inputs])
        self.outputs: List[ParallelTensor] = [
            ParallelTensor(s, owner_op=self, owner_idx=i,
                           name=f"{self.name}.out{i}")
            for i, s in enumerate(out_shapes)
        ]
        self.weight_specs: List[WeightSpec] = self.make_weight_specs(
            [t.shape for t in inputs])

    def infer_output_shapes(
        self, input_shapes: Sequence[ParallelTensorShape]
    ) -> List[ParallelTensorShape]:
        raise NotImplementedError

    def make_weight_specs(
        self, input_shapes: Sequence[ParallelTensorShape]
    ) -> List[WeightSpec]:
        return []

    def num_trainable_weights(self) -> int:
        """Weights [0:n] are trainable; the rest are op state."""
        return len(self.weight_specs)

    def forward(self, inputs: Sequence[torch.Tensor],
                weights: Sequence[torch.Tensor], *,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """The op's outputs (then its updated state entries).  A random
        op draws from `generator`, which the executor passes down in
        place of the reference's per-op rng key."""
        raise NotImplementedError

    def __repr__(self) -> str:
        ins = ",".join(str(t.shape) for t in self.inputs)
        outs = ",".join(str(t.shape) for t in self.outputs)
        return f"{self.name}({ins} -> {outs})"
