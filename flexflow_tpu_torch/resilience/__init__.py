"""The resilience layer (flexflow_tpu/resilience/): deterministic fault
injection (faults.py).  Retry and backoff, the asynchronous checkpoint
writer, the hung-step watchdog, the offload tier and the training
supervisor are still to be ported (ROADMAP §1 item 7).
"""
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

__all__ = [
    "BLOB_FAULT_KINDS",
    "CheckpointWriteFault",
    "DeviceLossFault",
    "Fault",
    "FaultKind",
    "FaultPlan",
    "HungStepFault",
    "InjectedFault",
    "PreemptionFault",
    "StepFault",
]
