"""The search's logger (flexflow_tpu/logger.py) and its counters line
(flexflow_tpu/obs/metrics.py emit_counters).

`RecursiveLogger` is indentation-scoped debug tracing over the standard
logging module: the Unity DP and the MCMC search log nested decisions
through `search_logger` and their evaluation counters as one `k=v`
line.  The port has no telemetry registry yet (ROADMAP §1.E), so the
counters go to the log line only.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict, Iterator

# library convention: never touch the root logger; the application
# configures handlers
logging.getLogger("flexflow_tpu_torch").addHandler(logging.NullHandler())


class RecursiveLogger:
    def __init__(self, name: str = "flexflow_tpu_torch"):
        self._log = logging.getLogger(name)
        self._depth = 0

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


search_logger = RecursiveLogger("flexflow_tpu_torch.search")

# the strategy store (store/): hit and miss decisions, quarantined
# corrupt entries, survivable publish failures; all non-fatal, so the
# log line is their only trace until the port has a metrics registry
store_logger = RecursiveLogger("flexflow_tpu_torch.store")


def emit_counters(logger: RecursiveLogger, label: str, mapping: Dict
                  ) -> None:
    """Log `mapping` as the search's counters line (the reference also
    folds it into its telemetry registry, which the port has not yet)."""
    logger.counters(label, mapping)
