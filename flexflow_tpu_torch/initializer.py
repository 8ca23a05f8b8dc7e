"""Weight initializers, seeded through a `torch.Generator`.

Counterpart of flexflow_tpu/initializer.py.  Each initializer is a
function of (generator, shape, dtype, device).  The draws are not the
reference's threefry values: weights cross between the packages through
get_weights/set_weights, never through a shared seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


class Initializer:
    def __call__(self, gen: torch.Generator, shape: Tuple[int, ...],
                 dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        raise NotImplementedError


def _uniform(gen, shape, lo, hi, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (lo + (hi - lo) * u).to(dtype)


@dataclasses.dataclass(frozen=True)
class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ConstantInitializer(Initializer):
    value: float = 0.0

    def __call__(self, gen, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class GlorotUniform(Initializer):
    """Glorot/Xavier uniform.  fan_out = dim 0 and fan_in = the product
    of the rest unless both fans are given (attention passes them)."""

    fan_in: Optional[int] = None
    fan_out: Optional[int] = None

    def __call__(self, gen, shape, dtype, device):
        if self.fan_in is not None and self.fan_out is not None:
            fan_in, fan_out = self.fan_in, self.fan_out
        elif len(shape) >= 2:
            receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
            fan_out = shape[0] * receptive
            fan_in = shape[1] * receptive
        else:
            fan_in = fan_out = math.prod(shape) if shape else 1
        scale = math.sqrt(6.0 / max(1, fan_in + fan_out))
        return _uniform(gen, shape, -scale, scale, dtype, device)


@dataclasses.dataclass(frozen=True)
class UniformInitializer(Initializer):
    minv: float = -0.05
    maxv: float = 0.05

    def __call__(self, gen, shape, dtype, device):
        return _uniform(gen, shape, self.minv, self.maxv, dtype, device)


class ArrayInitializer(Initializer):
    """A fixed host array: the values the torch frontend pins (a bare
    parameter's WeightOp, F.linear and F.conv2d weights)."""

    def __init__(self, array):
        self.array = np.asarray(array)

    def __call__(self, gen, shape, dtype, device):
        if tuple(self.array.shape) != tuple(shape):
            raise ValueError(f"ArrayInitializer shape {self.array.shape} != "
                             f"weight shape {tuple(shape)}")
        return torch.tensor(self.array, dtype=dtype, device=device)


DEFAULT_WEIGHT_INIT = GlorotUniform()
DEFAULT_BIAS_INIT = ZeroInitializer()
