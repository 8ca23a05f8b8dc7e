"""The resilience layer (flexflow_tpu/resilience/): deterministic fault
injection (faults.py), retry and backoff (retry.py), the asynchronous
checkpoint writer (async_writer.py) and the hung-step watchdog
(watchdog.py).  The offload tier and the training supervisor are still
to be ported (ROADMAP §1 items 7.6 and 7.7).
"""
from .async_writer import AsyncCheckpointWriter
from .faults import (
    BLOB_FAULT_KINDS,
    CheckpointWriteFault,
    DeviceLossFault,
    Fault,
    FaultKind,
    FaultPlan,
    HungStepFault,
    InjectedFault,
    PreemptionFault,
    StepFault,
)
from .retry import RetryPolicy
from .watchdog import HungStepTimeout, StepWatchdog

__all__ = [
    "AsyncCheckpointWriter",
    "BLOB_FAULT_KINDS",
    "CheckpointWriteFault",
    "DeviceLossFault",
    "Fault",
    "FaultKind",
    "FaultPlan",
    "HungStepFault",
    "HungStepTimeout",
    "InjectedFault",
    "PreemptionFault",
    "RetryPolicy",
    "StepFault",
    "StepWatchdog",
]
