"""Core enums and scalar types of the PyTorch port.

Counterpart of flexflow_tpu/fftype.py: the same enum names and values,
so a graph described in one package reads the same in the other.
`DataType` maps onto torch dtypes instead of jnp dtypes.  Only the
enums the serving, training and ResNet slices reach are carried.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BF16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def size_bytes(self) -> int:
        return self.torch_dtype.itemsize

    @classmethod
    def from_any(cls, value) -> "DataType":
        if isinstance(value, cls):
            return value
        if isinstance(value, torch.dtype):
            name = str(value).removeprefix("torch.")
        elif isinstance(value, str) and value == "bfloat16":
            name = value  # numpy has no bfloat16
        else:
            name = np.dtype(value).name
        for member in cls:
            if member.value == name:
                return member
        raise ValueError(f"unsupported dtype: {value!r}")


class ActiMode(enum.Enum):
    NONE = "none"
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"


class AggrMode(enum.Enum):
    NONE = "none"
    SUM = "sum"
    AVG = "avg"


class LossType(enum.Enum):
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg"
    MEAN_SQUARED_ERROR_SUM_REDUCE = "mean_squared_error_sum"
    IDENTITY = "identity"


class MetricsType(enum.Enum):
    ACCURACY = "accuracy"
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"


class CompMode(enum.Enum):
    TRAINING = "training"
    INFERENCE = "inference"


class OperatorType(enum.Enum):
    INPUT = "input"
    NOOP = "noop"
    CONV2D = "conv2d"
    LINEAR = "linear"
    EMBEDDING = "embedding"
    MULTIHEAD_ATTENTION = "multihead_attention"
    ELEMENT_BINARY = "element_binary"
    ELEMENT_UNARY = "element_unary"
    POOL2D = "pool2d"
    BATCH_NORM = "batch_norm"
    LAYER_NORM = "layer_norm"
    SOFTMAX = "softmax"
    FLAT = "flat"
    REDUCE_SUM = "reduce_sum"
    MEAN = "mean"


class OpUnary(enum.Enum):
    EXP = "exp"
    LOG = "log"
    SIN = "sin"
    COS = "cos"
    RELU = "relu"
    GELU = "gelu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    ELU = "elu"
    IDENTITY = "identity"
    RSQRT = "rsqrt"
    SQRT = "sqrt"
    ERF = "erf"
    FLOOR = "floor"
    POW = "pow"
    SCALAR_MULTIPLY = "scalar_multiply"
    SCALAR_ADD = "scalar_add"
    SCALAR_SUB = "scalar_sub"
    SCALAR_TRUE_DIV = "scalar_true_div"
    NEGATIVE = "negative"


class OpBinary(enum.Enum):
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    MAX = "max"
    MIN = "min"
    POW = "pow"
