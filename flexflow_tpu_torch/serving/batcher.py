"""Latency percentiles shared by the engine's stats (the helpers of
flexflow_tpu/serving/batcher.py; the batchers themselves are not in
the serving slice of the port)."""
from __future__ import annotations

import math
from typing import Dict


def percentile_summary(values, ps=(0.50, 0.95, 0.99)) -> Dict[str, float]:
    """n / p*_ms / mean_ms summary of latencies given in SECONDS,
    nearest-rank (the ceil(p*n)-th order statistic)."""
    lats = sorted(values)
    if not lats:
        return {"n": 0}
    out = {"n": len(lats)}
    for p in ps:
        i = min(len(lats) - 1, max(0, math.ceil(p * len(lats)) - 1))
        out[f"p{int(round(p * 100))}_ms"] = round(lats[i] * 1e3, 3)
    out["mean_ms"] = round(sum(lats) / len(lats) * 1e3, 3)
    return out


def latency_percentiles(latencies, lock) -> Dict[str, float]:
    """p50/p95/p99/mean (ms) over a ring buffer appended to by worker
    threads."""
    with lock:
        vals = list(latencies)
    return percentile_summary(vals)
