"""flexflow_tpu_torch: the PyTorch and CUDA port of flexflow_tpu for an
NVIDIA H100.

The package keeps flexflow_tpu's module structure and names, imports
torch and never jax, and imports nothing of flexflow_tpu.  This slice
serves a GPT through the continuous paged-KV engine; the paged-attention
read side runs on a CUDA kernel written by hand for sm_90a
(csrc/paged_attention.cu).  Entry points run on "cuda" unless the caller
passes device="cpu".
"""
from .config import FFConfig
from .fftype import ActiMode, AggrMode, CompMode, DataType, OperatorType
from .model import FFModel
from .tensor import ParallelDim, ParallelTensor, ParallelTensorShape, Tensor

__all__ = ["FFConfig", "FFModel", "ActiMode", "AggrMode", "CompMode",
           "DataType", "OperatorType", "ParallelDim", "ParallelTensor",
           "ParallelTensorShape", "Tensor"]
