"""flexflow_tpu_torch: the PyTorch and CUDA port of flexflow_tpu for an
NVIDIA H100.

The package keeps flexflow_tpu's module structure and names, imports
torch and never jax, and imports nothing of flexflow_tpu.  It trains a
model on one GPU (compile, train_step, eval_step, fit; attention takes
the flash kernels of csrc/flash_attention.cu at long sequences) and
serves a GPT through the continuous paged-KV engine, whose read side
runs on csrc/paged_attention.cu; both are CUDA C++ written by hand for
sm_90a.  A run records its telemetry (obs/) and checkpoints its full
train state (checkpoint.py, resilience/), and trains under the
resilience supervisor (FFModel.fit_resilient).  Entry points run on "cuda"
unless the caller passes device="cpu".
"""
from .config import FFConfig
from .dataloader import SingleDataLoader
from .fftype import (ActiMode, AggrMode, CompMode, DataType, LossType,
                     MetricsType, OperatorType)
from .loss import Loss
from .metrics import Metrics, PerfMetrics
from .model import FFModel
from .obs import MetricsRegistry, RunTelemetry
from .optimizer import AdamOptimizer, SGDOptimizer
from .recompile import RecompileState
from .resilience import (FaultKind, FaultPlan, HungStepFault, RetryPolicy,
                         StepWatchdog, TrainingSupervisor)
from .tensor import ParallelDim, ParallelTensor, ParallelTensorShape, Tensor

__all__ = ["FFConfig", "FFModel", "ActiMode", "AggrMode", "AdamOptimizer",
           "CompMode", "DataType", "FaultKind", "FaultPlan", "HungStepFault",
           "Loss", "LossType", "Metrics", "MetricsRegistry", "MetricsType",
           "OperatorType", "ParallelDim", "ParallelTensor",
           "ParallelTensorShape", "PerfMetrics", "RecompileState",
           "RetryPolicy", "RunTelemetry", "SGDOptimizer", "SingleDataLoader",
           "StepWatchdog", "Tensor", "TrainingSupervisor"]
