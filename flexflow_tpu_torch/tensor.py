"""Parallel tensor representation: the IR datatype of the port.

Counterpart of flexflow_tpu/tensor.py.  Pure Python: a logical tensor
whose dims each carry a partition degree, plus a trailing replica dim.
The ops' shape inference and weight specs are written against it, and
the strategy search and simulator read its degrees and shard sizes.  A
ParallelTensor's `machine_view` names the mesh axes its degrees map
onto (parallel/machine.py).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple

from .fftype import DataType


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    """One dimension of a parallel tensor: global `size`, the number of
    shards `degree`, and whether it exists only to express
    replication."""

    size: int
    degree: int = 1
    is_replica_dim: bool = False

    def __post_init__(self):
        if not self.is_replica_dim and self.degree > 1 \
                and self.size % self.degree != 0:
            raise ValueError(
                f"dim size {self.size} not divisible by degree {self.degree}"
            )

    @property
    def shard_size(self) -> int:
        if self.is_replica_dim:
            return 1
        return self.size // self.degree

    def with_degree(self, degree: int) -> "ParallelDim":
        return dataclasses.replace(self, degree=degree)


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    """Shape + dtype of a parallel tensor (hashable)."""

    dims: Tuple[ParallelDim, ...]
    dtype: DataType

    @classmethod
    def make(cls, shape: Sequence[int], dtype: DataType = DataType.FLOAT,
             degrees: Optional[Sequence[int]] = None,
             replica_degree: int = 1) -> "ParallelTensorShape":
        """Build from a plain logical shape, appending the replica dim."""
        degrees = list(degrees) if degrees is not None else [1] * len(shape)
        if len(degrees) != len(shape):
            raise ValueError("degrees must match shape rank")
        dims = tuple(ParallelDim(s, d) for s, d in zip(shape, degrees)) + (
            ParallelDim(1, replica_degree, is_replica_dim=True),)
        return cls(dims, DataType.from_any(dtype))

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims if not d.is_replica_dim)

    @property
    def logical_rank(self) -> int:
        return len(self.logical_shape)

    @property
    def replica_degree(self) -> int:
        deg = 1
        for d in self.dims:
            if d.is_replica_dim:
                deg *= d.degree
        return deg

    @property
    def degrees(self) -> Tuple[int, ...]:
        return tuple(d.degree for d in self.dims if not d.is_replica_dim)

    @property
    def total_degree(self) -> int:
        deg = 1
        for d in self.dims:
            deg *= d.degree
        return deg

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(d.shard_size for d in self.dims if not d.is_replica_dim)

    def num_elements(self) -> int:
        return math.prod(self.logical_shape) if self.dims else 0

    def shard_elements(self) -> int:
        return math.prod(self.shard_shape) if self.dims else 0

    def size_bytes(self) -> int:
        return self.num_elements() * self.dtype.size_bytes

    def shard_bytes(self) -> int:
        return self.shard_elements() * self.dtype.size_bytes

    def with_degrees(self, degrees: Sequence[int],
                     replica_degree: Optional[int] = None
                     ) -> "ParallelTensorShape":
        degrees = list(degrees)
        new_dims = []
        di = 0
        for d in self.dims:
            if d.is_replica_dim:
                new_dims.append(d if replica_degree is None
                                else d.with_degree(replica_degree))
            else:
                new_dims.append(d.with_degree(degrees[di]))
                di += 1
        if di != len(degrees):
            raise ValueError("degrees length mismatch")
        return ParallelTensorShape(tuple(new_dims), self.dtype)

    def data_parallel(self, degree: int) -> "ParallelTensorShape":
        """Shard dim 0 (the sample dim) by `degree`; everything else
        whole."""
        degrees = [1] * self.logical_rank
        if degrees:
            degrees[0] = degree
        return self.with_degrees(degrees, replica_degree=1)

    def __str__(self) -> str:
        parts = []
        for d in self.dims:
            if d.is_replica_dim:
                if d.degree > 1:
                    parts.append(f"r{d.degree}")
            elif d.degree > 1:
                parts.append(f"{d.size}/{d.degree}")
            else:
                parts.append(str(d.size))
        return f"[{', '.join(parts)}]:{self.dtype.value}"


_tensor_guid = itertools.count(1001)


class Tensor:
    """Frontend tensor handle: logical shape/dtype plus graph-edge info."""

    def __init__(self, shape: Sequence[int],
                 dtype: DataType = DataType.FLOAT, owner_layer=None,
                 owner_idx: int = 0, name: str = ""):
        self.guid: int = next(_tensor_guid)
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.dtype: DataType = DataType.from_any(dtype)
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.name = name or f"tensor_{self.guid}"

    def __repr__(self) -> str:
        return (f"Tensor({self.name}, shape={self.shape}, "
                f"dtype={self.dtype.value})")


class ParallelTensor:
    """A tensor inside the PCG: its shape, the op that produces it,
    whether it takes gradients, and the MachineView strategy assignment
    gives it."""

    def __init__(self, shape: ParallelTensorShape, owner_op=None,
                 owner_idx: int = 0, create_gradients: bool = True,
                 name: str = ""):
        self.guid: int = next(_tensor_guid)
        self.shape = shape
        self.owner_op = owner_op
        self.owner_idx = owner_idx
        self.create_gradients = create_gradients
        self.name = name or f"ptensor_{self.guid}"
        self.machine_view = None  # set by strategy.assign_views

    @property
    def dims(self) -> Tuple[ParallelDim, ...]:
        return self.shape.dims

    @property
    def dtype(self) -> DataType:
        return self.shape.dtype

    def __repr__(self) -> str:
        return (f"ParallelTensor({self.name}, {self.shape}, "
                f"view={self.machine_view})")
