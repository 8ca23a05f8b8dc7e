"""Migrate-vs-replay pricing of a KV handoff (the `MigrationCostModel`
of flexflow_tpu/serving/disagg.py).

The reference prices a hop with its TPU pod's ICI and DCN rates; the
port prices it with the card's: a handoff between two replicas on one
H100 moves each block device->host and host->device over PCIe Gen5
(`sim/machine_model.PCIE_GEN5_BW`, twice per block), and one over the
blob store crosses the InfiniBand NDR link of `GpuNodeModel`
(`IB_NDR_BW`, `IB_LAT`).  The formulas are the reference's.  The rest
of the reference's module (the disaggregated front, its roles and
`build_front`) waits for §1 item 8.4 of the roadmap.
"""
from __future__ import annotations

import math
from typing import Dict

from ..sim.machine_model import IB_LAT, IB_NDR_BW, PCIE_GEN5_BW, PCIE_LAT

# step time assumed before an engine has measured one (the reference's)
_DEFAULT_STEP_S = 5e-3


class MigrationCostModel:
    """Migrate vs prefill again:

      migrate_s    = hop_lat + block_bytes * new_blocks / hop_bw
                     + ceil(tail_tokens / C) * step_s
      reprefill_s  = ceil(prompt_len / C) * step_s

    C is the chunked-prefill width (1 without chunking), step_s the
    destination's measured per-dispatch EWMA, tail_tokens the sub-page
    remainder still to prefill after adoption.  The hop follows the
    fabric: "inproc" is a device->host read and a host->device write on
    one card (each block crosses PCIe twice, so half its rate), "blob"
    an InfiniBand hop.  Migrate wins iff new_blocks > 0 and
    migrate_s <= cost_cap * reprefill_s."""

    def __init__(self, cost_cap: float = 1.0, fabric_kind: str = "inproc"):
        if cost_cap <= 0:
            raise ValueError(
                f"migration cost cap must be > 0, got {cost_cap}")
        self.cost_cap = float(cost_cap)
        if fabric_kind == "blob":
            self.hop_bw, self.hop_lat = float(IB_NDR_BW), float(IB_LAT)
        else:
            self.hop_bw = float(PCIE_GEN5_BW / 2)
            self.hop_lat = float(2 * PCIE_LAT)

    def decide(self, *, prompt_len: int, new_blocks: int,
               page_size: int, block_bytes: int, chunk: int,
               step_s: float) -> Dict:
        """One routing decision for a prefix migration; returns the
        record stored on the request."""
        C = max(1, int(chunk))
        step = step_s if step_s > 0 else _DEFAULT_STEP_S
        reprefill_s = math.ceil(prompt_len / C) * step
        tail = prompt_len - (prompt_len // page_size) * page_size
        migrate_s = (self.hop_lat
                     + (block_bytes * new_blocks) / self.hop_bw
                     + math.ceil(tail / C) * step)
        migrate = (new_blocks > 0
                   and migrate_s <= self.cost_cap * reprefill_s)
        return {
            "decision": "migrate" if migrate else "reprefill",
            "new_blocks": int(new_blocks),
            "migrate_s": round(migrate_s, 6),
            "reprefill_s": round(reprefill_s, 6),
        }

    def decide_handoff(self, *, written: int, page_size: int,
                       block_bytes: int, chunk: int,
                       step_s: float) -> Dict:
        """Mid-decode handoff pricing: ship every written block (prompt
        and generated, the partial tail page included) vs replaying the
        written prefix as chunked prefill on the destination.  The
        migrate side has no tail-replay term (the verified tail block
        rides the resume record), while the replay side grows with the
        generated length."""
        C = max(1, int(chunk))
        step = step_s if step_s > 0 else _DEFAULT_STEP_S
        n_blocks = -(-written // page_size) if page_size > 0 else 0
        replay_s = math.ceil(written / C) * step
        handoff_s = (self.hop_lat
                     + (block_bytes * n_blocks) / self.hop_bw
                     + step)  # one adoption pass on the destination
        handoff = (n_blocks > 0
                   and handoff_s <= self.cost_cap * replay_s)
        return {
            "decision": "handoff" if handoff else "replay",
            "blocks": int(n_blocks),
            "handoff_s": round(handoff_s, 6),
            "replay_s": round(replay_s, 6),
        }
