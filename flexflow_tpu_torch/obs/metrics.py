"""Metrics registry (flexflow_tpu/obs/metrics.py): typed counters,
gauges and histograms, and a JSONL drain.

One registry per run takes the search's counters, the strategy store's,
the checkpoint managers' and fit's epoch metrics, and drains them to
`run_telemetry.jsonl` in the reference's schema (SCHEMA_VERSION), one
JSON object per line:

    {"schema": 1, "ts": <unix seconds>, "kind": "counter" | "gauge" |
     "histogram" | "event" | "fidelity" | "span", "name": <str>, ...}

    counter   -> {"value": int}
    gauge     -> {"value": float}
    histogram -> {"count", "sum", "min", "max", "mean"
                  [, "exemplar": {"value", "trace_id"}]}
    event     -> {"fields": {...}}   (log records, one-shot markers)
    fidelity  -> the obs/fidelity.py record as it is
    span      -> a finished request-trace span
"""
from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional

SCHEMA_VERSION = 1


class Counter:
    """A cumulative count that only grows."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def record(self) -> Dict:
        return {"kind": "counter", "name": self.name, "value": self.value}


class Gauge:
    """A scalar; the last write wins."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def record(self) -> Dict:
        return {"kind": "gauge", "name": self.name, "value": self.value}


class Histogram:
    """Count, sum, min and max of the observations.  An observation may
    carry an exemplar (a trace id): the histogram keeps the largest
    value's per drain window, and forgets it at the drain; count and sum
    stay cumulative."""

    __slots__ = ("name", "count", "sum", "min", "max",
                 "exemplar_value", "exemplar_trace")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.exemplar_value = float("-inf")
        self.exemplar_trace: Optional[str] = None

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if exemplar is not None and v > self.exemplar_value:
            self.exemplar_value = v
            self.exemplar_trace = exemplar

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset_exemplar(self) -> None:
        self.exemplar_value = float("-inf")
        self.exemplar_trace = None

    def record(self) -> Dict:
        rec = {"kind": "histogram", "name": self.name, "count": self.count,
               "sum": self.sum, "min": self.min if self.count else 0.0,
               "max": self.max if self.count else 0.0, "mean": self.mean}
        if self.exemplar_trace is not None:
            rec["exemplar"] = {"value": self.exemplar_value,
                               "trace_id": self.exemplar_trace}
        return rec


class MetricsRegistry:
    """Typed metrics by name, made at first use; a name asked for as
    another type raises TypeError."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._events: List[Dict] = []

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def remove(self, name: str) -> None:
        """Drop a metric whose subject is gone."""
        self._metrics.pop(name, None)

    def fold_counters(self, group: str, mapping: Dict) -> None:
        """A flat dict of cumulative totals (search_stats, PerfMetrics'
        fields) as gauges named `group/key`; booleans count as 0/1 and
        other non-numbers are skipped."""
        for k, v in mapping.items():
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                self.gauge(f"{group}/{k}").set(v)

    def event(self, name: str, **fields) -> None:
        """A one-shot record (a log line, a run marker)."""
        self._events.append({"kind": "event", "name": name,
                             "ts": time.time(), "fields": fields})

    def fidelity(self, record: Dict) -> None:
        """Attach a fidelity record (obs/fidelity.py)."""
        rec = dict(record)
        rec["kind"] = "fidelity"
        rec.setdefault("name", "fidelity")
        rec.setdefault("ts", time.time())
        self._events.append(rec)

    def span(self, record: Dict) -> None:
        """Attach a finished request-trace span; it drains once, like an
        event."""
        rec = dict(record)
        rec["kind"] = "span"
        rec.setdefault("ts", time.time())
        self._events.append(rec)

    def drain(self) -> List[Dict]:
        """The buffered events (cleared) and a snapshot of every
        metric, each stamped with the schema version and a time; a later
        drain snapshots the metrics again."""
        now = time.time()
        records: List[Dict] = []
        events, self._events = self._events, []
        for ev in events:
            ev.setdefault("ts", now)
            ev["schema"] = SCHEMA_VERSION
            records.append(ev)
        for name in sorted(self._metrics):
            metric = self._metrics[name]
            rec = metric.record()
            rec["ts"] = now
            rec["schema"] = SCHEMA_VERSION
            records.append(rec)
            if isinstance(metric, Histogram):
                metric.reset_exemplar()
        return records

    def write_jsonl(self, path: str) -> int:
        """Append the drained records to a JSONL file; returns how
        many."""
        records = self.drain()
        if not records:
            return 0
        with open(path, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        return len(records)


def _prom_name(name: str) -> str:
    """`serving/ttft_ms` -> `serving_ttft_ms`: anything outside
    [a-zA-Z0-9_:] becomes an underscore."""
    return "".join(ch if (ch.isalnum() or ch in "_:") else "_"
                   for ch in name)


def to_prometheus(registry: MetricsRegistry) -> str:
    """The registry as Prometheus text exposition.  A histogram renders
    as a summary (`_count`, `_sum`) with `_min` and `_max` gauges; its
    exemplar annotates `_count` in the OpenMetrics syntax."""
    lines: List[str] = []
    for name in sorted(registry._metrics):
        metric = registry._metrics[name]
        pname = _prom_name(name)
        if isinstance(metric, Counter):
            lines += [f"# TYPE {pname} counter", f"{pname} {metric.value}"]
        elif isinstance(metric, Gauge):
            lines += [f"# TYPE {pname} gauge", f"{pname} {metric.value}"]
        elif isinstance(metric, Histogram):
            lines.append(f"# TYPE {pname} summary")
            count_line = f"{pname}_count {metric.count}"
            if metric.exemplar_trace is not None:
                count_line += (f' # {{trace_id="{metric.exemplar_trace}"}}'
                               f" {metric.exemplar_value}")
            lines.append(count_line)
            lines.append(f"{pname}_sum {metric.sum}")
            lines.append(f"# TYPE {pname}_min gauge")
            lines.append(f"{pname}_min {metric.min if metric.count else 0.0}")
            lines.append(f"# TYPE {pname}_max gauge")
            lines.append(f"{pname}_max {metric.max if metric.count else 0.0}")
    return "\n".join(lines) + "\n"


def registry_of(ff) -> Optional[MetricsRegistry]:
    """The model's registry, or None for anything without telemetry."""
    tel = getattr(ff, "telemetry", None)
    return tel.metrics if tel is not None else None


def emit_counters(logger, label: str, mapping: Dict,
                  registry: Optional[MetricsRegistry] = None,
                  group: Optional[str] = None) -> None:
    """The logger's `label: k=v ...` counters line, as it always was,
    then the mapping folded into `registry` (when there is one) under
    `group` (by default the label with underscores for spaces)."""
    logger.counters(label, mapping)
    if registry is not None:
        registry.fold_counters(group or label.replace(" ", "_"), mapping)


class TelemetryLogHandler(logging.Handler):
    """Takes `flexflow_tpu_torch.*` log records (calibration failures,
    store decisions, checkpoint fallbacks) into the registry's events,
    so they land in run_telemetry.jsonl."""

    def __init__(self, registry: MetricsRegistry, level=logging.INFO):
        super().__init__(level=level)
        self.registry = registry

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.registry.event("log", logger=record.name,
                                level=record.levelname,
                                message=record.getMessage())
        except Exception:  # a telemetry fault never breaks the run
            self.handleError(record)
