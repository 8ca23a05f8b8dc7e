"""Timeline tracing (flexflow_tpu/obs/trace.py): Chrome trace-event
spans for a training run.

A run records host-side spans (compile and its phases, each step, the
batch's host-to-device copy, the epoch's device drain, checkpoint
writes) into a Chrome trace-event JSON that Perfetto and
chrome://tracing open directly.  Inside a `profile_steps` window each
op's launches also sit under `torch.profiler.record_function(op.name)`
(executor.py), so the torch.profiler trace of those steps attributes
the card's kernels to PCG op names, as the reference's
`jax.named_scope` does in its device profile.

Disabled costs nothing: the module-level NULL_TRACER is what every call
site holds when telemetry is off, and its `span()` returns one
preallocated no-op context manager, so the step's hot path makes no
span object (`span_allocations()` counts the real ones).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

# every real Span bumps it; the disabled path never makes one
_SPAN_ALLOCS = 0


def span_allocations() -> int:
    """How many Span objects this process has made."""
    return _SPAN_ALLOCS


class Span:
    """One B/E event pair, used as a context manager."""

    __slots__ = ("_tracer", "name", "cat", "args")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        global _SPAN_ALLOCS
        _SPAN_ALLOCS += 1
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._tracer._emit("B", self.name, self.cat, self.args)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._emit("E", self.name, self.cat, None)
        return False


class _NullSpan:
    """The one no-op span every disabled call site shares."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method returns at once and makes
    nothing."""

    enabled = False

    def span(self, name: str, cat: str = "run", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "run", **args) -> None:
        return None

    def write(self, path: str, extra_events=None) -> None:
        return None


NULL_TRACER = NullTracer()


class Tracer:
    """Records B/E span pairs and instant events, stamped in
    microseconds (the Chrome trace-event unit) with the pid and the
    thread id, so the async checkpoint writer's spans land on their own
    track."""

    enabled = True

    def __init__(self, run_id: Optional[str] = None):
        self.run_id = run_id
        self.events: List[Dict] = []
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _event(self, ph: str, name: str, cat: str,
               args: Optional[Dict]) -> Dict:
        ev = {"ph": ph, "name": name, "cat": cat, "ts": self._now_us(),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        return ev

    def _emit(self, ph: str, name: str, cat: str, args: Optional[Dict]):
        ev = self._event(ph, name, cat, args)
        with self._lock:
            self.events.append(ev)

    def span(self, name: str, cat: str = "run", **args) -> Span:
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "run", **args) -> None:
        ev = self._event("i", name, cat, args)
        ev["s"] = "t"  # thread-scoped
        with self._lock:
            self.events.append(ev)

    def write(self, path: str, extra_events=None) -> None:
        """The events as Chrome trace-event JSON, sorted by time,
        written to a temporary file and renamed over `path`;
        `extra_events` are merged in."""
        with self._lock:
            events = list(self.events)
        if extra_events:
            events.extend(extra_events)
        events.sort(key=lambda e: e["ts"])
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self.run_id:
            doc["otherData"] = {"run_id": self.run_id}
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)


def tracer_of(ff) -> "Tracer | NullTracer":
    """The model's tracer, or NULL_TRACER for anything without
    telemetry."""
    tel = getattr(ff, "telemetry", None)
    return tel.tracer if tel is not None else NULL_TRACER
