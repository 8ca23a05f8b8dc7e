"""Fit the simulator's cost scales and overlap constants from measured
step times (flexflow_tpu/sim/calibrate.py).

The simulator's prediction of a step is

    measured(s) ~= c·compute(s) + u·comm(s) + v·sync(s),

and `fit_cost_scales` solves it by non-negative least squares over the
same model compiled under different strategies: a one-device strategy
(comm = sync = 0) anchors c; data-, tensor- and mixed-parallel ones
separate u and v, which generalize (1 - overlap_fraction) and
(1 - sync_overlap_fraction).  On one card only the first kind can run,
so only c is fitted there and u, v keep their priors, and the runs that
separate c from the model's error are the same model at different
sizes (`calibrate_overlap` takes one builder per strategy).  The fit is saved
under the port's cache directory, keyed by the device it was measured
on (the card's name, or "cpu"), and the searches load it for that
device only.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def fit_cost_scales(
    records: Sequence[Tuple[float, float, float, float]],
) -> Dict[str, float]:
    """records: (measured_total, compute, comm, sync) seconds per
    strategy.  Solves nonneg least squares for (c, u, v); returns the
    scales plus the equivalent overlap constants (of = 1-u, sof = 1-v,
    may be negative when the machine model underestimates comm) and the
    mean relative prediction error after the fit."""
    A = np.asarray([[r[1], r[2], r[3]] for r in records], np.float64)
    b = np.asarray([r[0] for r in records], np.float64)
    x = np.array([1.0, 0.7, 0.3])  # priors: c=1, u=1-of, v=1-sof
    usable = np.abs(A).sum(axis=0) > 0
    if usable.any():
        sol, *_ = np.linalg.lstsq(A[:, usable], b, rcond=None)
        x[usable] = np.maximum(sol, 0.0)
    pred = A @ x
    rel = np.abs(pred - b) / np.maximum(b, 1e-12)
    return {
        "compute_scale": float(x[0]),
        "comm_scale": float(x[1]),
        "sync_scale": float(x[2]),
        "overlap_fraction": float(1.0 - x[1]),
        "sync_overlap_fraction": float(1.0 - x[2]),
        "mean_rel_error": float(rel.mean()),
        "max_rel_error": float(rel.max()),
        "num_strategies": len(records),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_step_time(ff, inputs, labels, iters: int = 12,
                      windows: int = 3) -> float:
    """Best-of-`windows` mean seconds of one train step: each window
    runs `iters` serial steps between two device synchronizations, after
    two warm-up steps."""
    for _ in range(2):
        ff.train_step(inputs, labels)
    _sync(ff.device)

    def window():
        t0 = time.perf_counter()
        for _ in range(iters):
            ff.train_step(inputs, labels)
        _sync(ff.device)
        return (time.perf_counter() - t0) / iters

    return min(window() for _ in range(windows))


def simulate_components(ff, strategy, machine,
                        cost_model) -> Tuple[float, float, float]:
    """(compute, comm, sync) seconds the simulator attributes to the
    compiled model under `strategy`: the regressors of the fit."""
    from .simulator import Simulator

    sim = Simulator(machine, cost_model)
    res = sim.simulate(ff.operators, strategy.mesh_axes, training=True)
    return res.compute_time, res.comm_time, res.sync_time


def calibrate_overlap(build, strategies, machine, cost_model, make_inputs,
                      iters: int = 12, windows: int = 3) -> Dict[str, float]:
    """Compile `build()` under each Strategy of `strategies`, measure its
    step time on the model's device, simulate its analytic components,
    and fit.

    build() -> a fresh un-compiled FFModel with layers added; its config
        names the device.  Or a sequence of such builders, one per
        strategy (the same model at several batch sizes, say).
    strategies: Strategy objects the port can run (one device today).
    make_inputs(ff) -> (inputs dict, labels) for ff.

    The fit carries `records`, its (measured, compute, comm, sync)
    seconds per run, so that a caller can hold a run out of the fit.
    """
    from ..optimizer import SGDOptimizer
    from .simulator import device_name

    builds = (list(build) if isinstance(build, (list, tuple))
              else [build] * len(strategies))
    if len(builds) != len(strategies):
        raise ValueError(f"{len(builds)} builders for "
                         f"{len(strategies)} strategies")
    records = []
    device = None
    for make, s in zip(builds, strategies):
        ff = make()
        ff.compile(optimizer=SGDOptimizer(lr=0.01), strategy=s)
        device = ff.device
        inputs, labels = make_inputs(ff)
        measured = measure_step_time(ff, inputs, labels, iters, windows)
        compute, comm, sync = simulate_components(ff, s, machine, cost_model)
        records.append((measured, compute, comm, sync))
    fit = fit_cost_scales(records)
    fit["measured_s"] = [r[0] for r in records]
    fit["records"] = [list(r) for r in records]
    # constants are device-specific (a CPU compute_scale is orders of
    # magnitude a card's); loaders refuse another device's
    fit["fitted_on"] = device_name(device) if device is not None \
        else "unknown"
    return fit


# -- persistence (beside the op-cost cache) --------------------------------

def overlap_constants_path() -> str:
    from .simulator import cache_dir

    base = cache_dir()
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, "overlap_constants.json")


def save_overlap_constants(fit: Dict[str, float],
                           path: Optional[str] = None) -> str:
    path = path or overlap_constants_path()
    with open(path, "w") as f:
        json.dump(fit, f, indent=1)
    return path


def load_overlap_constants(path: Optional[str] = None,
                           backend: Optional[str] = None) -> Optional[Dict]:
    """The fitted constants, only when they were fitted on `backend` (a
    device name as simulator.device_name gives it; default: the first
    card's, or "cpu" without one): a CPU compute_scale applied on a card
    would corrupt every ranking.  None when there is no valid file."""
    path = path or overlap_constants_path()
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    try:
        ok = (np.isfinite(d["compute_scale"]) and d["compute_scale"] >= 0
              and np.isfinite(d["comm_scale"]) and d["comm_scale"] >= 0
              and np.isfinite(d["sync_scale"]) and d["sync_scale"] >= 0)
    except (KeyError, TypeError):
        return None
    if not ok:
        return None
    if backend is None:
        from .simulator import device_name

        backend = device_name("cuda" if torch.cuda.is_available() else "cpu")
    if d.get("fitted_on") != backend:
        return None
    return d
