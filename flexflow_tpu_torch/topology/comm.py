"""Per-tier collective cost records (flexflow_tpu/topology/comm.py):
`CommCost` splits one collective's time and bytes between the tier
inside a node ("ici" in the reference's names) and the tier between
nodes ("dcn"); `ring_bytes` is a ring collective's per-device bytes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommCost:
    """One collective's cost, split by network tier."""

    ici_time: float = 0.0
    dcn_time: float = 0.0
    ici_bytes: float = 0.0  # ring bytes moved per device over ICI
    dcn_bytes: float = 0.0  # ring bytes moved per device over DCN

    @property
    def time(self) -> float:
        return self.ici_time + self.dcn_time

    def __add__(self, other: "CommCost") -> "CommCost":
        return CommCost(
            self.ici_time + other.ici_time,
            self.dcn_time + other.dcn_time,
            self.ici_bytes + other.ici_bytes,
            self.dcn_bytes + other.dcn_bytes,
        )


ZERO_COST = CommCost()


def ring_bytes(kind: str, size: float, n: int) -> float:
    """Per-device bytes a ring collective moves (the bandwidth-term
    bytes of the machine-model formulas)."""
    if n <= 1:
        return 0.0
    if kind == "allreduce":
        return 2.0 * (n - 1) / n * size
    return (n - 1) / n * size  # allgather / reducescatter / alltoall


__all__ = ["CommCost", "ZERO_COST", "ring_bytes"]
