"""obs: a run's telemetry (flexflow_tpu/obs/): tracing, metrics and
fidelity.

  * `trace`    - Chrome trace-event spans of the run's host side, and
                 `record_function(op.name)` op attribution in the
                 torch.profiler trace of a profile window;
  * `metrics`  - typed counters, gauges and histograms that take the
                 search's, the store's, the checkpoints' and fit's
                 numbers into one JSONL;
  * `fidelity` - the predicted against the measured step time.

`RunTelemetry` bundles them per FFModel, set up from FFConfig
(`trace_dir`, `telemetry`, `profile_steps`; `--trace-dir`,
`--telemetry`, `--profile-steps`).  Off is the default and costs the
step nothing: the tracer is the shared NULL_TRACER and `fit` makes no
span.  The profile window `[start, start + count)` of fit's steps runs
under `torch.profiler.profile` (the CPU and, on a card, CUDA
activities) where the reference ran `jax.profiler`, and is exported as
a Chrome trace into `trace_dir` (PROFILE_FILENAME); a run takes it
once, in the first fit that reaches it.  A captured step replays in the
window, and the export writes each replayed kernel's op, from the map
its warm-up recorded, into the kernel's `args["op"]` (attribution.py).
The request tracer of serving (the reference's obs/reqtrace.py) is not
ported yet (ROADMAP §1 item 8.4).
"""
from __future__ import annotations

import logging
import os
import time
import weakref
from typing import Dict, Optional, Tuple

from .fidelity import fidelity_record, report_fidelity
from .metrics import (MetricsRegistry, TelemetryLogHandler, emit_counters,
                      registry_of)
from .trace import NULL_TRACER, Tracer, span_allocations, tracer_of

#: seconds a profiler's recording is given, after the card is idle, on
#: each side of the work it records (settle)
PROFILE_SETTLE_S = 0.1

TRACE_FILENAME = "trace.json"
TELEMETRY_FILENAME = "run_telemetry.jsonl"
PROFILE_FILENAME = "torch_profile.json"


def parse_profile_steps(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """`start:count` -> (first step, one past the last); ValueError on a
    malformed spec."""
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) != 2:
        raise ValueError(f"profile_steps must be 'start:count', got {spec!r}")
    try:
        start, count = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"profile_steps must be 'start:count' integers, got {spec!r}"
        ) from None
    if start < 0 or count < 1:
        raise ValueError(
            f"profile_steps needs start >= 0 and count >= 1, got {spec!r}")
    return start, start + count


def settle() -> None:
    """Wait for the card, then PROFILE_SETTLE_S: a profiler's recording
    starts or stops here with no kernel in flight and none within that
    margin.  In a long run on the card a recording started just before
    a replay lost that replay's first ~30 kernels, and one started while
    the last step still ran took in its tail."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)


class RunTelemetry:
    """A run's tracer, metrics registry and artifact paths.  The
    registry always exists (the searches and the store fold their
    counters into it either way); the tracer, the profile window and the
    files only when enabled."""

    def __init__(self, trace_dir: Optional[str] = None,
                 enabled: Optional[bool] = None,
                 profile_steps: Optional[str] = None,
                 run_id: Optional[str] = None):
        self.trace_dir = trace_dir
        self.enabled = bool(trace_dir) if enabled is None else bool(enabled)
        self.run_id = run_id or f"run-{int(time.time())}-{os.getpid()}"
        self.metrics = MetricsRegistry()
        self.tracer = (Tracer(run_id=self.run_id) if self.enabled
                       else NULL_TRACER)
        self.profile_window = parse_profile_steps(profile_steps)
        #: the torch.profiler.profile of the last window (its events
        #: stay readable after the window closes)
        self.profiler = None
        #: the kernel-to-op map of a captured step (capture.py), and the
        #: counts of the window's attribution (attribution.py)
        self.kernel_ops = None
        self.attribution: Optional[Dict[str, int]] = None
        self._profiling = False
        self._profiled = False
        self._log_handler: Optional[TelemetryLogHandler] = None
        self._detach = None
        if self.enabled:
            # the library's log records land in the run's JSONL; an
            # unconfigured library logger is opened to INFO, and the
            # handler leaves at close() or when this object is collected
            self._log_handler = TelemetryLogHandler(self.metrics)
            lib_logger = logging.getLogger("flexflow_tpu_torch")
            lib_logger.addHandler(self._log_handler)
            if lib_logger.level == logging.NOTSET:
                lib_logger.setLevel(logging.INFO)
            self._detach = weakref.finalize(
                self, lib_logger.removeHandler, self._log_handler)

    @classmethod
    def from_config(cls, cfg) -> "RunTelemetry":
        return cls(trace_dir=getattr(cfg, "trace_dir", None),
                   enabled=(bool(getattr(cfg, "trace_dir", None))
                            or bool(getattr(cfg, "telemetry", False))),
                   profile_steps=getattr(cfg, "profile_steps", None))

    @property
    def profiles(self) -> bool:
        """Whether a profile window is configured (and has a trace_dir to
        export to)."""
        return self.profile_window is not None and self.trace_dir is not None

    @property
    def profiling(self) -> bool:
        """Whether a profile window is open (the executor's op scopes
        follow it)."""
        return self._profiling

    # -- the torch.profiler window ------------------------------------
    def on_step(self, step: int, kernel_ops=None) -> None:
        """Open the profiler at the window's first step and close it at
        its end (once a run); fit calls it before every step, and after
        its last, when telemetry is on, with the captured step's
        kernel-to-op map once its warm-up made one.  The profiler warms
        up over the step before the window (its schedule's warmup), and
        the recording starts and stops settled (`settle`)."""
        if not self.profiles or self._profiled:
            return
        if kernel_ops is not None:
            self.kernel_ops = kernel_ops
        start, stop = self.profile_window
        if self.profiler is None and step in (start - 1, start):
            import torch
            from torch.profiler import ProfilerActivity, profile, schedule

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            warmup = int(step < start)
            self.profiler = profile(activities=activities, schedule=schedule(
                wait=0, warmup=warmup, active=stop - start, repeat=1))
            self.profiler.start()
            if not warmup:
                self._open_window(step)
        elif self.profiler is not None and step == start \
                and not self._profiling:
            settle()
            self.profiler.step()  # the warm-up is over: record
            self._open_window(step)
        elif step >= stop and self._profiling:
            self._stop_profiler(step)

    def _open_window(self, step: int) -> None:
        settle()
        self._profiling = True
        self.tracer.instant("torch_profiler_start", cat="profile", step=step)

    def _stop_profiler(self, step: int) -> None:
        settle()
        self.profiler.stop()
        self._profiling = False
        self._profiled = True
        self.profiler.export_chrome_trace(self.profile_path)
        if self.kernel_ops:
            from .attribution import attribute_trace

            self.attribution = attribute_trace(self.profile_path,
                                               self.kernel_ops)
            self.tracer.instant("torch_profiler_stop", cat="profile",
                                step=step, **self.attribution)
        else:
            self.tracer.instant("torch_profiler_stop", cat="profile",
                                step=step)

    # -- artifacts ----------------------------------------------------
    def _path(self, name: str) -> Optional[str]:
        return os.path.join(self.trace_dir, name) if self.trace_dir else None

    @property
    def trace_path(self) -> Optional[str]:
        return self._path(TRACE_FILENAME)

    @property
    def telemetry_path(self) -> Optional[str]:
        return self._path(TELEMETRY_FILENAME)

    @property
    def profile_path(self) -> Optional[str]:
        return self._path(PROFILE_FILENAME)

    def flush(self) -> Dict[str, str]:
        """Write the artifacts: the Chrome trace (rewritten whole) and the
        telemetry JSONL (the newly drained records appended).  A window
        still open is closed first.  Nothing when disabled or without a
        trace_dir."""
        if self._profiling:  # a fit that ended inside the window
            self._stop_profiler(-1)
        if not self.enabled or not self.trace_dir:
            return {}
        os.makedirs(self.trace_dir, exist_ok=True)
        self.tracer.write(self.trace_path)
        self.metrics.write_jsonl(self.telemetry_path)
        return {"trace": self.trace_path, "telemetry": self.telemetry_path}

    def close(self) -> None:
        """Flush and detach the log handler (safe to call twice)."""
        self.flush()
        if self._detach is not None:
            self._detach()
        self._log_handler = None


__all__ = [
    "MetricsRegistry",
    "NULL_TRACER",
    "PROFILE_FILENAME",
    "RunTelemetry",
    "TELEMETRY_FILENAME",
    "TRACE_FILENAME",
    "Tracer",
    "emit_counters",
    "fidelity_record",
    "parse_profile_steps",
    "registry_of",
    "report_fidelity",
    "span_allocations",
    "tracer_of",
]
