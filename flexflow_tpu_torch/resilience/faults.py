"""Deterministic fault injection (flexflow_tpu/resilience/faults.py).

A `FaultPlan` is a seeded, replayable schedule of failures, so that a
recovery path is testable on the CPU without real hardware dying.  The
training supervisor that reacts to the step kinds is still to be ported
(ROADMAP §1 item 7); today the object-store kinds drive
store/blobstore.py's FaultyBlobStore.

Fault matrix (the reference supervisor's reactions):

  kind              raised as             supervisor reaction
  ----------------  --------------------  ----------------------------
  step_exception    StepFault             restore latest + retry
  host_preemption   PreemptionFault       restore latest + retry
  checkpoint_write  CheckpointWriteFault  count, keep training
  device_loss       DeviceLossFault       re-search surviving mesh,
                                          recompile, reshard-restore
  hung_step         HungStepFault         re-search + recompile the
                                          full mesh, reshard-restore
  nan_loss          (batch poisoned)      per the config's nan policy

Object-store fault matrix (FaultyBlobStore consumes these; a training
loop never sees them):

  kind                 effect
  -------------------  ---------------------------------------------
  blob_transient       one op raises BlobUnavailableError
  blob_partial_upload  one put lands truncated bytes
  blob_latency         one op sleeps delay_s
  blob_unavailable     `ops` consecutive ops raise

For blob kinds, `Fault.step` is the FaultyBlobStore operation index
(fire at or after the Nth blob op), not a training step: an upload's op
count is deterministic, so seeded plans replay exactly.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class FaultKind(str, enum.Enum):
    STEP_EXCEPTION = "step_exception"
    HOST_PREEMPTION = "host_preemption"
    CHECKPOINT_WRITE = "checkpoint_write"
    DEVICE_LOSS = "device_loss"
    # a wedged collective: the step's device sync never returns.  The
    # injected form raises at the step boundary so the supervisor's
    # hung-step classification (resilience/watchdog.py) is exercisable
    # without a real hang or a real timeout wait
    HUNG_STEP = "hung_step"
    # transient data corruption: the step's float inputs become NaN for
    # exactly one step, driving the loss non-finite (exercises
    # FFConfig.nan_policy end to end without faking metrics)
    NAN_LOSS = "nan_loss"
    # -- object-store faults (consumed by store.blobstore.FaultyBlobStore,
    #    never raised into the training loop; step = blob op index) ------
    BLOB_TRANSIENT = "blob_transient"
    BLOB_PARTIAL_UPLOAD = "blob_partial_upload"
    BLOB_LATENCY = "blob_latency"
    BLOB_UNAVAILABLE = "blob_unavailable"


#: FaultKinds handled by FaultyBlobStore rather than the supervisor
BLOB_FAULT_KINDS = frozenset({
    FaultKind.BLOB_TRANSIENT,
    FaultKind.BLOB_PARTIAL_UPLOAD,
    FaultKind.BLOB_LATENCY,
    FaultKind.BLOB_UNAVAILABLE,
})


class InjectedFault(RuntimeError):
    """Base of all injected failures (never raised by real code paths)."""

    kind: FaultKind

    def __init__(self, step: int, **payload):
        self.step = step
        self.payload = payload
        extra = f" {payload}" if payload else ""
        super().__init__(f"injected {self.kind.value} at step {step}{extra}")


class StepFault(InjectedFault):
    kind = FaultKind.STEP_EXCEPTION


class PreemptionFault(InjectedFault):
    kind = FaultKind.HOST_PREEMPTION


class CheckpointWriteFault(InjectedFault):
    kind = FaultKind.CHECKPOINT_WRITE


class DeviceLossFault(InjectedFault):
    kind = FaultKind.DEVICE_LOSS

    def __init__(self, step: int, survivors: int):
        super().__init__(step, survivors=survivors)
        self.survivors = int(survivors)


class HungStepFault(InjectedFault):
    kind = FaultKind.HUNG_STEP


_EXC_FOR_KIND = {
    FaultKind.STEP_EXCEPTION: StepFault,
    FaultKind.HOST_PREEMPTION: PreemptionFault,
    FaultKind.DEVICE_LOSS: DeviceLossFault,
    FaultKind.HUNG_STEP: HungStepFault,
}


@dataclasses.dataclass
class Fault:
    """One scheduled failure.  `step` is the supervisor step index the
    fault targets; `payload` carries kind-specific data (device_loss:
    {"survivors": n}).  A fault fires at most once — after a restore
    rewinds the step counter past it, replay does NOT re-fail (the
    transient is gone), which is exactly what makes recovery testable."""

    step: int
    kind: FaultKind
    payload: Dict = dataclasses.field(default_factory=dict)
    fired: bool = False


class FaultPlan:
    """A deterministic, seeded schedule of injected failures."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self.faults: List[Fault] = [
            f if isinstance(f, Fault) else Fault(**f) for f in faults
        ]

    # -- constructors ---------------------------------------------------
    @classmethod
    def single(cls, step: int, kind: FaultKind, **payload) -> "FaultPlan":
        return cls([Fault(step=step, kind=FaultKind(kind), payload=payload)])

    @classmethod
    def seeded(
        cls,
        seed: int,
        num_steps: int,
        kinds: Sequence[FaultKind] = (FaultKind.STEP_EXCEPTION,),
        count: int = 1,
        survivors: Optional[int] = None,
    ) -> "FaultPlan":
        """`count` faults at rng-chosen distinct steps in [1, num_steps).
        Same seed -> same plan, so a failing recovery run replays
        exactly.  device_loss faults require `survivors`."""
        if num_steps < 2:
            raise ValueError("need num_steps >= 2 to place faults")
        rng = np.random.RandomState(seed)
        count = min(count, num_steps - 1)
        steps = sorted(
            int(s) for s in rng.choice(
                np.arange(1, num_steps), size=count, replace=False
            )
        )
        faults = []
        for s in steps:
            kind = FaultKind(kinds[int(rng.randint(len(kinds)))])
            payload = {}
            if kind == FaultKind.DEVICE_LOSS:
                if survivors is None:
                    raise ValueError("device_loss faults need survivors=")
                payload["survivors"] = int(survivors)
            faults.append(Fault(step=s, kind=kind, payload=payload))
        return cls(faults)

    # -- injection points (called by the supervisor) --------------------
    def check_step(self, step: int) -> None:
        """Raise the scheduled failure for this exact step, once."""
        for f in self.faults:
            if f.fired or f.step != step or f.kind not in _EXC_FOR_KIND:
                continue
            f.fired = True
            raise _EXC_FOR_KIND[f.kind](step, **f.payload)

    def corrupt_batch(self, step: int, inputs: Dict[str, np.ndarray]):
        """Apply a one-shot nan_loss fault: poison every float input of
        this step's batch with NaN (a transient bad-data / bit-flip
        stand-in).  Returns the (possibly replaced) inputs dict."""
        for f in self.faults:
            if f.fired or f.step != step or f.kind != FaultKind.NAN_LOSS:
                continue
            f.fired = True
            return {
                k: (
                    np.full_like(v, np.nan)
                    if np.issubdtype(np.asarray(v).dtype, np.floating)
                    else v
                )
                for k, v in inputs.items()
            }
        return inputs

    def check_checkpoint(self, step: int) -> None:
        """Fail the first LOCAL checkpoint save attempted at or after
        the fault's step (cadence rarely lands exactly on it), once.
        Faults with payload target="remote" belong to the uploader path
        (check_offload) and are skipped here."""
        for f in self.faults:
            if f.fired or f.kind != FaultKind.CHECKPOINT_WRITE or step < f.step:
                continue
            if f.payload.get("target") == "remote":
                continue
            f.fired = True
            raise CheckpointWriteFault(step)

    def check_offload(self, step: int) -> None:
        """The uploader-path twin of check_checkpoint: fail the first
        remote mirror attempt at or after the fault's step, once.  Only
        CHECKPOINT_WRITE faults with payload target="remote" fire here —
        a plan can break the local write, the upload, or both
        independently."""
        for f in self.faults:
            if f.fired or f.kind != FaultKind.CHECKPOINT_WRITE or step < f.step:
                continue
            if f.payload.get("target") != "remote":
                continue
            f.fired = True
            raise CheckpointWriteFault(step, target="remote")

    def blob_faults(self) -> List[Fault]:
        """The plan's object-store faults (consumed by
        store.blobstore.FaultyBlobStore; the supervisor's own injection
        points ignore these kinds)."""
        return [f for f in self.faults if f.kind in BLOB_FAULT_KINDS]

    # -- introspection / replay -----------------------------------------
    def remaining(self) -> List[Fault]:
        return [f for f in self.faults if not f.fired]

    def to_json(self) -> str:
        return json.dumps(
            [
                {"step": f.step, "kind": f.kind.value, "payload": f.payload}
                for f in self.faults
            ]
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls(
            Fault(step=d["step"], kind=FaultKind(d["kind"]),
                  payload=dict(d.get("payload", {})))
            for d in json.loads(text)
        )
