"""Core enums and scalar types of the PyTorch port.

Counterpart of flexflow_tpu/fftype.py: the same enum names and values,
so a graph described in one package reads the same in the other.
`DataType` maps onto torch dtypes instead of jnp dtypes.  Only the
enums the serving, training, ResNet, layer-op, model-zoo,
sequence-model and search slices reach are carried.
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
    # the reference has no EXPAND: its Expand op is of type RESHAPE
    INPUT = "input"
    WEIGHT = "weight"
    NOOP = "noop"
    CONV2D = "conv2d"
    LINEAR = "linear"
    EMBEDDING = "embedding"
    MULTIHEAD_ATTENTION = "multihead_attention"
    BATCH_MATMUL = "batch_matmul"
    ELEMENT_BINARY = "element_binary"
    ELEMENT_UNARY = "element_unary"
    POOL2D = "pool2d"
    BATCH_NORM = "batch_norm"
    LAYER_NORM = "layer_norm"
    SOFTMAX = "softmax"
    CONCAT = "concat"
    SPLIT = "split"
    FLAT = "flat"
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    REVERSE = "reverse"
    PAD = "pad"
    REDUCE_SUM = "reduce_sum"
    MEAN = "mean"
    CAST = "cast"
    DROPOUT = "dropout"
    GATHER = "gather"
    TOPK = "topk"
    GROUP_BY = "group_by"
    AGGREGATE = "aggregate"
    AGGREGATE_SPEC = "aggregate_spec"
    CACHE = "cache"
    LSTM = "lstm"
    # size-changing replication and reduction in the reference's own
    # convention (d stacked copies along a dim; the fold-sum of d
    # slices): compute ops, not in the parallel set
    REPLICATE_STACK = "replicate_stack"
    REDUCTION_FOLD = "reduction_fold"
    FUSED = "fused"
    # the parallel ops (parallel/parallel_op.py)
    REPARTITION = "repartition"
    COMBINE = "combine"
    REPLICATE = "replicate"
    REDUCTION = "reduction"
    ALLTOALL = "all_to_all"
    PIPELINE = "pipeline"
    FUSED_PARALLEL = "fused_parallel"

    def is_parallel_op(self) -> bool:
        return self in _PARALLEL_OPS


_PARALLEL_OPS = frozenset({
    OperatorType.REPARTITION,
    OperatorType.COMBINE,
    OperatorType.REPLICATE,
    OperatorType.REDUCTION,
    OperatorType.ALLTOALL,
    OperatorType.PIPELINE,
    OperatorType.FUSED_PARALLEL,
})


class ParameterSyncType(enum.Enum):
    """How the simulator costs gradient sync (reference config.h:55-59):
    a ring all-reduce (NCCL) or a parameter server's flat 2·size/BW."""

    NONE = "none"
    PS = "ps"
    ALL_REDUCE = "all_reduce"


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
