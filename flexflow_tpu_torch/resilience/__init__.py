"""The resilience layer (flexflow_tpu/resilience/): deterministic fault
injection (faults.py), retry and backoff (retry.py), the asynchronous
checkpoint writer (async_writer.py), the hung-step watchdog
(watchdog.py), the checkpoints' remote tier (offload.py) and the
training supervisor (supervisor.py, FFModel.fit_resilient).
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
from .offload import (CheckpointOffloader, RemoteCheckpointStore,
                      RemoteVerifyError, UploadReport, offloader_from_config)
from .retry import RetryPolicy
from .supervisor import (RestartBudgetExhausted, SupervisorReport,
                         TrainingSupervisor)
from .watchdog import HungStepTimeout, StepWatchdog

__all__ = [
    "AsyncCheckpointWriter",
    "BLOB_FAULT_KINDS",
    "CheckpointOffloader",
    "CheckpointWriteFault",
    "DeviceLossFault",
    "Fault",
    "FaultKind",
    "FaultPlan",
    "HungStepFault",
    "HungStepTimeout",
    "InjectedFault",
    "PreemptionFault",
    "RemoteCheckpointStore",
    "RemoteVerifyError",
    "RestartBudgetExhausted",
    "RetryPolicy",
    "StepFault",
    "StepWatchdog",
    "SupervisorReport",
    "TrainingSupervisor",
    "UploadReport",
    "offloader_from_config",
]
