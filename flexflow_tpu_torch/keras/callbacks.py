"""Training callbacks of the port (flexflow_tpu/keras/callbacks.py):
Callback, LearningRateScheduler, VerifyMetrics (EpochVerifyMetrics with
each_epoch=True), EarlyStopping and ProgbarLogger.  FFModel.fit calls
on_train_begin, on_epoch_end with the epoch's PerfMetrics, and
on_train_end; a callback stops training by setting
ffmodel._stop_training."""
from __future__ import annotations

import sys
import time
from typing import Callable, Optional


class Callback:
    model = None  # set by Model.fit

    def on_train_begin(self, ffmodel):
        pass

    def on_epoch_end(self, ffmodel, epoch: int, metrics):
        pass

    def on_train_end(self, ffmodel):
        pass


class LearningRateScheduler(Callback):
    """schedule(epoch, current_lr) -> new_lr (reference
    callbacks.py LearningRateScheduler)."""

    def __init__(self, schedule: Callable[[int, float], float]):
        self.schedule = schedule

    def on_epoch_end(self, ffmodel, epoch: int, metrics):
        cur = ffmodel.optimizer.get_lr()
        new_lr = self.schedule(epoch + 1, cur)
        if new_lr != cur:
            ffmodel.set_learning_rate(new_lr)


class ProgbarLogger(Callback):
    """Per-epoch metrics line (the reference keras port relies on the
    C++ runtime's epoch printout; here it is an explicit callback so
    `verbose=False` fits stay quiet unless asked)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self._t0 = None

    def on_train_begin(self, ffmodel):
        self._t0 = time.perf_counter()

    def on_epoch_end(self, ffmodel, epoch: int, metrics):
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        print(f"epoch {epoch}: {metrics.summary()} [{dt:.1f}s elapsed]",
              file=self.stream)


class VerifyMetrics(Callback):
    """Assert a metric reaches a floor by the end of training
    (reference callbacks.py VerifyMetrics: its example scripts end
    with this check).  `each_epoch=True` is EpochVerifyMetrics: stop
    early once reached, fail only if never reached."""

    def __init__(self, monitor: str = "accuracy", floor: float = 0.9,
                 each_epoch: bool = False):
        self.monitor = monitor
        self.floor = floor
        self.each_epoch = each_epoch
        self._last: Optional[float] = None
        self._reached = False

    def on_train_begin(self, ffmodel):
        # a reused instance must re-verify: stale success from an
        # earlier fit() would mask a failing run
        self._last = None
        self._reached = False

    def on_epoch_end(self, ffmodel, epoch: int, metrics):
        self._last = float(getattr(metrics, self.monitor))
        if self.each_epoch and self._last >= self.floor:
            self._reached = True
            ffmodel._stop_training = True

    def on_train_end(self, ffmodel):
        if self._reached or (self._last is not None
                             and self._last >= self.floor):
            return
        raise AssertionError(
            f"{self.monitor} = {self._last} below required {self.floor}"
        )


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "accuracy", patience: int = 2,
                 mode: str = "max"):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0
        self.stopped_epoch: Optional[int] = None

    def on_epoch_end(self, ffmodel, epoch: int, metrics):
        val = getattr(metrics, self.monitor)
        better = (
            self.best is None
            or (val > self.best if self.mode == "max" else val < self.best)
        )
        if better:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                ffmodel._stop_training = True
