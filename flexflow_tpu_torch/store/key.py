"""Store keys (flexflow_tpu/store/key.py): graph signature, mesh
fingerprint and simulator version.

A searched strategy is reusable exactly when three things match the
search that produced it:

  * the frontend graph it was searched for: ops, params, shapes, dtypes,
    edges, and the op and tensor names a Strategy's shard_configs and
    edge_ops bind to;
  * the machine it was placed onto: device count, node split, the
    machine model's identity and the device kind;
  * the simulator that ranked the candidates: cost-model version, the
    fitted calibration, the TASO catalog and every search-shaping field
    of the config.

Each component is a canonical JSON blob; the composed sha256 is the
entry's address in StrategyStore.  Digests are of effective inputs: the
calibration component hashes the constants a search would load
(sim/calibrate.load_overlap_constants), not raw file bytes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Optional


def _sha256_text(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def _sha256_json(obj) -> str:
    return _sha256_text(json.dumps(obj, sort_keys=True, default=str))


def _sha256_file(path: Optional[str]) -> Optional[str]:
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


# -- component fingerprints -------------------------------------------------

def graph_signature(graph) -> str:
    """Canonical hash of a frontend (degree-1) PCG, the reference's own.

    One record per op: name, type, params, shard, input tensor names,
    output (name, shape) pairs, sorted by op name: layer names are the
    identity strategies bind to, so two construction orders of one named
    graph hash alike, while any op, shape, dtype or edge change does
    not."""
    records = []
    for op in graph.topo_order():
        records.append({
            "name": op.name,
            "type": op.op_type.value,
            "params": repr(op.params),
            "shard": repr(op.shard) if getattr(op, "shard", None) else None,
            "inputs": [t.name for t in op.inputs],
            "outputs": [(t.name, str(t.shape)) for t in op.outputs],
        })
    records.sort(key=lambda r: r["name"])
    return _sha256_json(records)


def _device_kind(cfg) -> Dict[str, str]:
    """platform and device_kind of the config's device: "gpu" and the
    card's name on CUDA, "cpu" and "cpu" on the host."""
    import torch

    dev = torch.device(cfg.device)
    if dev.type == "cuda":
        return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "device_kind": "cpu"}


def _port_machine() -> str:
    """Digest of the device roofline the port's simulator prices with
    (sim/machine_model.H100_SXM: the spec of every GpuNodeModel file under
    sim/machines/ and of the model built without a file)."""
    from ..sim.machine_model import H100_SXM

    return _sha256_json({"package": "flexflow_tpu_torch",
                         "device": dataclasses.asdict(H100_SXM)})


def mesh_fingerprint(cfg, num_devices: int) -> Dict:
    """Identity of the hardware a strategy was placed onto: device
    count, node split, machine-model version and file digest, and the
    device of the config (not of the process: `cfg.device`).

    `port_machine` is the one field the reference lacks.  On the CPU both
    packages report platform and device_kind "cpu", and a store root may
    be shared by both; the port's simulator prices an H100, the
    reference's a TPU, so the field keeps a strategy the reference priced
    from being restored by the port for the same graph and config.

    On a multi-slice run (cfg.slices > 1) the slice count, the slice
    topology and the inter-node bandwidth and latency join the
    fingerprint; a single-slice run emits none of them."""
    out = {
        "num_devices": int(num_devices),
        "num_nodes": int(cfg.num_nodes),
        "machine_model_version": int(cfg.machine_model_version),
        "machine_model_file": _sha256_file(cfg.machine_model_file),
        **_device_kind(cfg),
        "port_machine": _port_machine(),
    }
    if int(cfg.slices) > 1:
        out["slices"] = int(cfg.slices)
        out["slice_topology"] = (str(cfg.slice_topology)
                                 if cfg.slice_topology else None)
        out["dcn_bandwidth"] = float(cfg.dcn_bandwidth)
        out["dcn_latency"] = float(cfg.dcn_latency)
    return out


def _calibration_digest(cfg) -> str:
    """Digest of the overlap constants a search on the config's device
    would load ("none" when absent or invalid: load_overlap_constants
    ignores those, so they must not split keys)."""
    from ..sim.calibrate import load_overlap_constants
    from ..sim.simulator import device_name

    fitted = load_overlap_constants(backend=device_name(cfg.device))
    if fitted is None:
        return "none"
    return _sha256_json(fitted)


def simulator_version(cfg) -> Dict:
    """Identity of the simulator and search configuration that ranked
    the candidates: the port's cost-model and measure-cache versions,
    the fitted calibration's digest, the TASO catalog's sha256, and
    every FFConfig field that shapes what the search returns."""
    from ..pcg.rewrite import catalog_fingerprint, catalog_for_config
    from ..sim.simulator import COST_MODEL_VERSION, OpCostModel

    path = catalog_for_config(cfg)
    try:
        catalog_sha = catalog_fingerprint(path)["sha256"] if path else None
    except OSError:
        catalog_sha = "unresolved"
    out = {
        "cost_model_version": COST_MODEL_VERSION,
        "measure_cache_version": OpCostModel.MEASURE_CACHE_VERSION,
        "calibration_digest": _calibration_digest(cfg),
        "calibrated": bool(cfg.should_calibrate()),
        "catalog_sha256": catalog_sha,
        "search": {
            "algo": cfg.search_algo,
            "budget": int(cfg.search_budget),
            "alpha": float(cfg.search_alpha),
            "propagate": bool(cfg.search_propagate),
            "only_data_parallel": bool(cfg.only_data_parallel),
            "enable_parameter_parallel": bool(cfg.enable_parameter_parallel),
            "enable_attribute_parallel": bool(cfg.enable_attribute_parallel),
            "enable_sample_parallel": bool(cfg.enable_sample_parallel),
            "overlap_backward_update": bool(cfg.search_overlap_backward_update),
            "parameter_sync": str(cfg.parameter_sync.value),
            "memory_search": bool(cfg.memory_search),
            "memory_lambda": float(cfg.memory_lambda),
            "memory_per_device": int(cfg.memory_per_device),
            "segment_size": int(cfg.simulator_segment_size),
            "rewrite_depth": int(cfg.rewrite_depth),
            "rewrite_max_variants": int(cfg.rewrite_max_variants),
            "remat": bool(cfg.remat),
            "zero_stage": int(cfg.zero_stage),
            "wus_axis": cfg.wus_axis,
            "seed": int(cfg.seed),
        },
    }
    # the grad-sync bucket prices the inter-node tier only, so, like the
    # mesh fingerprint's slice fields, it joins the key only there
    if int(cfg.slices) > 1:
        out["search"]["dcn_bucket_mb"] = float(cfg.dcn_bucket_mb)
    return out


# -- the composed key -------------------------------------------------------

@dataclasses.dataclass
class StoreKey:
    """Composed store key.  `digest` is the content address; the
    component dicts land in the entry's manifest, so that an operator can
    read why two entries differ."""

    graph: str         # graph_signature hex
    mesh: Dict         # mesh_fingerprint
    sim: Dict          # simulator_version

    @property
    def digest(self) -> str:
        return _sha256_json(
            {"graph": self.graph, "mesh": self.mesh, "sim": self.sim})

    def manifest_fields(self) -> Dict:
        return {
            "graph_signature": self.graph,
            "mesh": dict(self.mesh),
            "sim": json.loads(json.dumps(self.sim, default=str)),
        }


def store_key_for(cfg, graph, num_devices: int) -> StoreKey:
    """The key compile consults the store under: frontend graph x target
    mesh x simulator identity."""
    return StoreKey(
        graph=graph_signature(graph),
        mesh=mesh_fingerprint(cfg, num_devices),
        sim=simulator_version(cfg),
    )


def strategy_sha256(text: str) -> str:
    """Digest of a serialized strategy body (the manifest's integrity
    field)."""
    return _sha256_text(text)


__all__ = [
    "StoreKey",
    "graph_signature",
    "mesh_fingerprint",
    "simulator_version",
    "store_key_for",
    "strategy_sha256",
]
