"""The port's loggers (flexflow_tpu/logger.py).

`RecursiveLogger` is indentation-scoped debug tracing over the standard
logging module: the Unity DP and the MCMC search log nested decisions
through `search_logger`, and their evaluation counters as one `k=v`
line (`counters`), which obs/metrics.py `emit_counters` also folds into
the run's metrics registry.  Every logger sits under
`flexflow_tpu_torch`, whose records a traced run's
`obs.TelemetryLogHandler` takes into run_telemetry.jsonl.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Iterator

# library convention: never touch the root logger; the application
# configures handlers
logging.getLogger("flexflow_tpu_torch").addHandler(logging.NullHandler())


class RecursiveLogger:
    def __init__(self, name: str = "flexflow_tpu_torch"):
        self._log = logging.getLogger(name)
        self._depth = 0

    @property
    def depth(self) -> int:
        return self._depth

    def _indent(self, msg: str, args) -> str:
        # pre-format so a literal '%' in msg can't break logging
        return "  " * self._depth + (msg % args if args else msg)

    def debug(self, msg: str, *args):
        if self._log.isEnabledFor(logging.DEBUG):
            self._log.debug("%s", self._indent(msg, args))

    def info(self, msg: str, *args):
        if self._log.isEnabledFor(logging.INFO):
            self._log.info("%s", self._indent(msg, args))

    @contextlib.contextmanager
    def enter(self, label: str = "") -> Iterator[None]:
        if label:
            self.debug("%s {", label)
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            if label:
                self.debug("}")

    def counters(self, label: str, mapping) -> None:
        """Log a flat counters mapping as one `k=v` line."""
        if not self._log.isEnabledFor(logging.INFO):
            return
        parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in mapping.items()]
        self.info("%s: %s", label, " ".join(parts))

    def set_level(self, level):
        self._log.setLevel(level)


search_logger = RecursiveLogger("flexflow_tpu_torch.search")

# the resilience supervisor (resilience/supervisor.py): restarts,
# retries, lost and skipped steps, checkpoint latency, through
# `counters`, as the search's evaluation counters are
resilience_logger = RecursiveLogger("flexflow_tpu_torch.resilience")

# on-card calibration (profiler.py, sim/calibrate.py) and the fidelity
# prediction: failures land here, and so in a traced run's telemetry
calib_logger = RecursiveLogger("flexflow_tpu_torch.calib")

# the strategy store (store/): hit and miss decisions, quarantined
# corrupt entries, survivable publish failures; all non-fatal, so the
# log line and the store/* counters are their only trace
store_logger = RecursiveLogger("flexflow_tpu_torch.store")
