"""The hung-step watchdog (flexflow_tpu/resilience/watchdog.py): a
deadline on the step's device read.

A wedged collective does not raise: the host's read of the step's loss
never returns, and the run hangs where a crash would have started a
recovery.  `StepWatchdog.sync` runs the blocking read (the loss's
`.item()` after a step or a graph replay) on a worker thread and gives
up after `timeout_s` with `HungStepTimeout`.  One worker serves every
step, so a step pays a queue put and an event wait, not a thread start.
On a timeout the wedged worker is left behind (a daemon blocked in the
read; it exits if the read ever returns) and the next sync starts a
fresh one.  A disabled watchdog (timeout_s == 0, the default) calls the
function inline.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional


class HungStepTimeout(RuntimeError):
    """The step's device read outlived the watchdog's deadline (the
    injected twin is resilience.faults.HungStepFault)."""

    def __init__(self, step: Optional[int], timeout_s: float):
        self.step = step
        self.timeout_s = timeout_s
        where = f" at step {step}" if step is not None else ""
        super().__init__(f"device sync{where} exceeded the {timeout_s:g}s "
                         "step watchdog — treating the step as hung")


_STOP = object()


class StepWatchdog:
    """Runs blocking device reads under a deadline."""

    def __init__(self, timeout_s: float = 0.0):
        if timeout_s < 0:
            raise ValueError(f"timeout_s must be >= 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self._worker: Optional[threading.Thread] = None
        self._requests: Optional["queue.Queue"] = None

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    @staticmethod
    def _serve(requests: "queue.Queue") -> None:
        while True:
            item = requests.get()
            if item is _STOP:
                return
            fn, box, done = item
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 - sync() re-raises
                box["error"] = e
            finally:
                done.set()

    def _ensure_worker(self) -> "queue.Queue":
        if self._worker is None or not self._worker.is_alive():
            self._requests = queue.Queue()
            self._worker = threading.Thread(
                target=self._serve, args=(self._requests,), daemon=True,
                name="step-watchdog")
            self._worker.start()
        return self._requests

    def sync(self, fn: Callable[[], Any], step: Optional[int] = None) -> Any:
        """fn() (a blocking device read), or HungStepTimeout when it does
        not return within `timeout_s`.  Its exceptions pass unchanged; a
        disabled watchdog calls it inline."""
        if not self.enabled:
            return fn()
        requests = self._ensure_worker()
        box: dict = {}
        done = threading.Event()
        requests.put((fn, box, done))
        if not done.wait(self.timeout_s):
            # leave the wedged worker: it stops if its read ever returns,
            # and each request has its own box, so a late answer cannot
            # reach a newer sync
            requests.put(_STOP)
            self._worker = None
            raise HungStepTimeout(step, self.timeout_s)
        if "error" in box:
            raise box["error"]
        return box["result"]
