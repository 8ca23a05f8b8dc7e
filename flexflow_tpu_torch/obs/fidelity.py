"""Simulator fidelity (flexflow_tpu/obs/fidelity.py): the predicted
against the measured step time.

After a traced `FFModel.fit`, the simulator's predicted step for the
compiled strategy is set beside the measured one in a fidelity record in
`run_telemetry.jsonl`, so that the cost model's drift on the card is a
tracked record, and the (predicted, measured) pairs are the data a
learned cost model trains on.  The prediction is made with the search's
own simulator (pcg/mcmc.make_search_simulator: the same fitted overlap
constants, parameter-sync mode, remat and ZeRO flags) over the port's
H100 machine model, so the record measures the costs the search ranked
its candidates with.  On a multi-slice run the record carries the
simulator's tier split (sim/simulator.py `comm_tiers`): the predicted
NVLink ("ici") and InfiniBand ("dcn") seconds and bytes, under the
reference's field names; a flat mesh puts every byte on "ici".
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

FIDELITY_SCHEMA = 1


def predicted_step(ff, segment_costs: Optional[
        Sequence[Tuple[Sequence[int], float]]] = None):
    """The SimResult of the compiled model's strategy on its devices,
    under the search's simulator configuration."""
    from ..pcg.mcmc import make_search_simulator
    from ..sim.machine_model import make_machine_model
    from ..sim.simulator import make_cost_model

    cfg = ff.config
    machine = make_machine_model(cfg, int(ff.strategy.total_devices))
    sim = make_search_simulator(cfg, machine, make_cost_model(cfg, machine))
    return sim.simulate(
        ff.operators, ff.strategy.mesh_axes, training=True,
        segment_costs=segment_costs, zero_stage=ff.strategy.zero_stage,
        placement=getattr(ff.strategy, "placement", None),
        remat_plan=getattr(ff.strategy, "remat", None))


def fidelity_record(ff, measured_step_s: float, steps_measured: int = 0,
                    source: str = "fit", segment_costs: Optional[
                        Sequence[Tuple[Sequence[int], float]]] = None,
                    sim_result=None) -> Dict:
    """The fidelity record (schema FIDELITY_SCHEMA) for a measured
    steady-state `measured_step_s` seconds per step.  `segment_costs`
    (measured regions) calibrate the prediction and are summarized
    under "regions"; `sim_result` is a caller's own SimResult, used
    instead of a second simulation."""
    res = (sim_result if sim_result is not None
           else predicted_step(ff, segment_costs=segment_costs))
    predicted_ms = res.total_time * 1e3
    measured_ms = measured_step_s * 1e3
    record: Dict = {
        "fidelity_schema": FIDELITY_SCHEMA,
        "source": source,
        "predicted_step_ms": round(predicted_ms, 4),
        "measured_step_ms": round(measured_ms, 4),
        "predicted_vs_measured": (round(predicted_ms / measured_ms, 4)
                                  if measured_ms > 0 else None),
        "predicted_compute_ms": round(res.compute_time * 1e3, 4),
        "predicted_comm_ms": round(res.comm_time * 1e3, 4),
        "predicted_sync_ms": round(res.sync_time * 1e3, 4),
        "mesh_axes": dict(ff.strategy.mesh_axes),
        "num_devices": int(ff.strategy.total_devices),
        "steps_measured": int(steps_measured),
        "calibrated": bool(segment_costs),
        "backend": ff.device.type,
    }
    tiers = getattr(res, "comm_tiers", None)
    if tiers:
        record["predicted_ici_ms"] = round(tiers.get("ici_time", 0.0) * 1e3,
                                           4)
        record["predicted_dcn_ms"] = round(tiers.get("dcn_time", 0.0) * 1e3,
                                           4)
        record["predicted_ici_bytes"] = int(tiers.get("ici_bytes", 0.0))
        record["predicted_dcn_bytes"] = int(tiers.get("dcn_bytes", 0.0))
        record["placement"] = getattr(ff.strategy, "placement", None)
    record["predicted_activation_bytes"] = int(
        getattr(res, "activation_bytes", 0.0))
    record["predicted_recompute_ms"] = round(
        getattr(res, "recompute_s", 0.0) * 1e3, 4)
    plan = getattr(ff.strategy, "remat", None)
    record["remat"] = ",".join(str(i) for i in plan) if plan else ""
    if segment_costs:
        regions: List[Dict] = [
            {"ops": len(guids), "measured_ms": round(cost * 1e3, 4)}
            for guids, cost in segment_costs]
        record["regions"] = regions
        record["region_ops_covered"] = sum(r["ops"] for r in regions)
    return record


def report_fidelity(ff, measured_step_s: float, steps_measured: int = 0,
                    source: str = "fit", segment_costs=None
                    ) -> Optional[Dict]:
    """Build the record and attach it to the model's registry (when
    telemetry is on), with the fidelity/* gauges, the comm/ici_bytes and
    comm/dcn_bytes counters and the comm/*_ms gauges.  Returns the
    record, or None when the prediction cannot be made: a diagnostic
    never fails a training run, and the failure is logged on the calib
    logger (so it lands in the run's telemetry)."""
    try:
        record = fidelity_record(ff, measured_step_s,
                                 steps_measured=steps_measured,
                                 source=source, segment_costs=segment_costs)
    except Exception as e:  # noqa: BLE001 - logged, see the docstring
        from ..logger import calib_logger

        calib_logger.info("fidelity prediction failed: %r", e)
        return None
    tel = getattr(ff, "telemetry", None)
    if tel is not None and tel.enabled:
        m = tel.metrics
        m.fidelity(record)
        m.gauge("fidelity/predicted_step_ms").set(record["predicted_step_ms"])
        m.gauge("fidelity/measured_step_ms").set(record["measured_step_ms"])
        if record["predicted_vs_measured"] is not None:
            m.gauge("fidelity/predicted_vs_measured").set(
                record["predicted_vs_measured"])
        if "predicted_ici_bytes" in record:
            m.counter("comm/ici_bytes").inc(record["predicted_ici_bytes"])
            m.counter("comm/dcn_bytes").inc(record["predicted_dcn_bytes"])
            m.gauge("comm/ici_ms").set(record["predicted_ici_ms"])
            m.gauge("comm/dcn_ms").set(record["predicted_dcn_ms"])
        m.counter("mem/activation_bytes").inc(
            record["predicted_activation_bytes"])
        m.counter("compute/recompute_s").inc(
            record["predicted_recompute_ms"] / 1e3)
    return record
