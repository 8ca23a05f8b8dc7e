"""Strategy search entry points (MCMC + Unity DP).

Reference: FFModel::mcmc_optimize (src/runtime/model.cc:3285-3356) and
the Unity GraphSearchHelper (src/runtime/substitution.cc:1898-2320).
The implementations live in pcg/mcmc.py and pcg/unity.py; this module
is the entry point FFModel.compile calls.
"""
from __future__ import annotations

from ..strategy import Strategy


def mcmc_search(model, num_devices: int) -> Strategy:
    from .mcmc import mcmc_optimize

    return mcmc_optimize(model, num_devices)


def unity_search(model, num_devices: int,
                 enable_pipeline: bool = True) -> Strategy:
    from .unity import unity_optimize

    return unity_optimize(model, num_devices,
                          enable_pipeline=enable_pipeline)
