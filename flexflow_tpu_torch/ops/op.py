"""Base operator class for the PCG.

Counterpart of flexflow_tpu/ops/op.py.  Each op is a frozen params
dataclass, a shape rule `infer_output_shapes` over ParallelTensorShape
that propagates logical sizes and partition degrees (raising ShapeError
where the reference's does), weight specs, a `forward` on torch tensors,
and the cost and search hooks the simulator and the strategy searches
read (`flops`, `memory_bytes`, `node_key`, `ctor_kwargs`).  Ops hold no
tensor data: the executor owns the weight and state dictionaries and
passes each op its entries; `weights` are the ParallelTensors that
describe them to the search.  State entries (the paged KV pools) are
updated in place by `forward`, where the reference returned new
arrays.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import torch

from ..fftype import OperatorType
from ..initializer import Initializer
from ..tensor import ParallelTensor, ParallelTensorShape

_op_guid = itertools.count(2001)


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Op-internal parallelism degrees, mutated by the strategy search.

    channel: shard the op's weight/output channel dim (linear
        out-channels, attention heads, conv out-channels).
    reduction: shard the contraction dim (linear in-channels); the
        output becomes a partial sum of replica degree `reduction`.
    attribute: shard an attribute dim (embedding vocab).
    expert: expert parallelism degree of the MoE ops.
    """

    channel: int = 1
    reduction: int = 1
    attribute: int = 1
    expert: int = 1

    def is_trivial(self) -> bool:
        return self.channel == self.reduction == self.attribute \
            == self.expert == 1


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
        self.weights: List[ParallelTensor] = [
            ParallelTensor(ws.shape, owner_op=self, owner_idx=i,
                           name=f"{self.name}.{ws.name}")
            for i, ws in enumerate(self.weight_specs)
        ]

    def ctor_kwargs(self) -> dict:
        """Extra constructor kwargs a reconstruction must pass: ops are
        re-instantiated as type(op)(params, inputs, name=, shard=,
        **ctor_kwargs()) by apply_strategy, clone_op and the searches'
        variant enumeration."""
        return {}

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

    # -- cost hooks (simulator) -----------------------------------------
    def flops(self) -> float:
        """Forward FLOPs for one full (unsharded) application."""
        return 0.0

    def memory_bytes(self) -> int:
        total = sum(t.shape.size_bytes() for t in self.outputs)
        total += sum(w.shape.size_bytes() for w in self.weights)
        return total

    def is_parallel_op(self) -> bool:
        return self.op_type.is_parallel_op()

    # -- search support --------------------------------------------------
    def with_shard(self, shard: ShardConfig) -> ShardConfig:
        return shard

    def node_key(self) -> Tuple:
        """Hashable dedup key (reference get_or_create_node, model.h:676)."""
        return (self.op_type, self.params, self.shard,
                tuple(t.shape for t in self.inputs))

    def __repr__(self) -> str:
        ins = ",".join(str(t.shape) for t in self.inputs)
        outs = ",".join(str(t.shape) for t in self.outputs)
        return f"{self.name}({ins} -> {outs})"


def trainable_weight_count(op: Op) -> int:
    """Weights [0:n] are trainable; the rest are op state."""
    return op.num_trainable_weights()
