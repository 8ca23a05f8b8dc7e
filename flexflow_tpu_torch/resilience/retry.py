"""Retry and backoff (flexflow_tpu/resilience/retry.py): jittered
exponential backoff with a restart budget.  The jitter is a function of
(seed, attempt), so a supervised run replays the same delays."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RetryPolicy:
    """max_restarts: the restore-and-retry attempts a run may spend
    before the supervisor gives up.  backoff(attempt) is base_backoff *
    multiplier**(attempt - 1), at most max_backoff, times 1 +- jitter."""

    max_restarts: int = 3
    base_backoff: float = 0.1
    multiplier: float = 2.0
    max_backoff: float = 30.0
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}")
        if self.base_backoff < 0 or self.max_backoff < 0:
            raise ValueError("backoff times must be >= 0")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1, got {self.multiplier}")

    def admits(self, restarts: int) -> bool:
        """Whether the `restarts`-th restart is within the budget."""
        return restarts <= self.max_restarts

    def backoff(self, attempt: int) -> float:
        """Seconds to wait before the `attempt`-th retry (from 1)."""
        attempt = max(1, int(attempt))
        base = min(self.max_backoff,
                   self.base_backoff * self.multiplier ** (attempt - 1))
        if self.jitter == 0.0 or base == 0.0:
            return base
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + attempt) % (2 ** 32))
        return float(base * (1.0 + self.jitter * rng.uniform(-1.0, 1.0)))
