"""Parallel tensor representation: the IR datatype of the port.

Counterpart of flexflow_tpu/tensor.py.  Pure Python: a logical tensor
whose dims each carry a partition degree, plus a trailing replica dim.
The ops' shape inference and weight specs are written against it.  On
one device every degree is 1; the replica-dim sharding is carried so
the shapes read the same as the reference's, and is unused.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence, Tuple

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


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    """Shape + dtype of a parallel tensor (hashable)."""

    dims: Tuple[ParallelDim, ...]
    dtype: DataType

    @classmethod
    def make(cls, shape: Sequence[int],
             dtype: DataType = DataType.FLOAT) -> "ParallelTensorShape":
        """Build from a plain logical shape (every degree 1), appending
        the replica dim."""
        dims = tuple(ParallelDim(s) for s in shape) + (
            ParallelDim(1, 1, is_replica_dim=True),)
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
    """A tensor inside the PCG: its shape and the op that produces it."""

    def __init__(self, shape: ParallelTensorShape, owner_op=None,
                 owner_idx: int = 0, name: str = ""):
        self.guid: int = next(_tensor_guid)
        self.shape = shape
        self.owner_op = owner_op
        self.owner_idx = owner_idx
        self.name = name or f"ptensor_{self.guid}"

    @property
    def dims(self) -> Tuple[ParallelDim, ...]:
        return self.shape.dims

    @property
    def dtype(self) -> DataType:
        return self.shape.dtype

    def __repr__(self) -> str:
        return f"ParallelTensor({self.name}, {self.shape})"
