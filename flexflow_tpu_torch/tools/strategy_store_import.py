"""Promote shipped strategy artifacts (examples/strategies/*.json) into
the port's StrategyStore (flexflow_tpu's
tools/strategy_store_import.py), so that a port compile with the same
config hits the store instead of searching.

The store is content-addressed by (graph signature, mesh fingerprint,
simulator version), so an import rebuilds the frontend graph each
artifact was searched for (JOBS: the reference's
scripts/search_strategies.py JOBS, built by the port's models/) and
computes the key under the config the consuming compile runs with:
batch, search budget 500 and the job's FFConfig flags, on `--device`.
The port's mesh fingerprint carries its own machine (`port_machine`)
and the device's kind (the card's name on CUDA), so a port compile on
the same device finds the entry, and a reference store's entry for the
same graph stays a miss.

Usage:
    python -m flexflow_tpu_torch.tools.strategy_store_import --store DIR
        [--strategies DIR] [-n 8] [--overwrite] [--device cuda|cpu]

`Strategy.load` / `import_strategy_file` keep working unchanged: the
store entry is an additional, verified, key-addressed copy.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _bert(ff, cfg):
    from ..models.transformer import build_bert

    build_bert(ff, batch_size=cfg.batch_size, seq_length=64, hidden_size=256,
               num_layers=4, num_heads=8, intermediate_size=1024)


def _inception(ff, cfg):
    from ..models.inception import build_inception_v3

    build_inception_v3(ff, batch_size=cfg.batch_size, image_size=75,
                       channel_scale=0.25)


def _dlrm(ff, cfg):
    from ..models.dlrm import build_dlrm

    build_dlrm(ff, batch_size=cfg.batch_size)


#: (artifact name, builder, batch, FFConfig overrides): the shipped
#: artifacts and the graphs they were searched for
JOBS = [
    ("bert_encoder", _bert, 16, {"enable_parameter_parallel": True}),
    ("inception_v3", _inception, 16, {}),
    ("dlrm", _dlrm, 16, {"enable_attribute_parallel": True}),
]


def job_config(name: str, device: str = "cuda", **overrides):
    """The FFConfig a JOBS artifact was searched under (budget 500 and
    the job's flags) on `device`: the config a consuming compile, or
    FFModel.search_strategy, must run with to hit the imported entry."""
    from ..config import FFConfig

    _, _, batch, cfg_kw = next(j for j in JOBS if j[0] == name)
    return FFConfig(batch_size=batch, search_budget=500, device=device,
                    **cfg_kw, **overrides)


def job_model(name: str, cfg):
    """An FFModel holding job `name`'s frontend graph under `cfg`
    (nothing compiled)."""
    from ..model import FFModel

    build = next(j for j in JOBS if j[0] == name)[1]
    ff = FFModel(cfg)
    build(ff, cfg)
    return ff


def import_default_jobs(store_root: str, strategies_dir: str,
                        num_devices: int, overwrite: bool = False,
                        device: str = "cuda"):
    """Promote each JOBS artifact; returns [(name, digest, written)]."""
    from ..store import StrategyStore, store_key_for

    store = StrategyStore(store_root)
    results = []
    for name, _, _, _ in JOBS:
        path = os.path.join(strategies_dir, f"{name}.json")
        if not os.path.exists(path):
            print(f"skip {name}: no artifact at {path}")
            continue
        cfg = job_config(name, device)
        ff = job_model(name, cfg)
        key = store_key_for(cfg, ff.layers, num_devices)
        written = store.import_strategy(
            key, path, created_at=time.time(), overwrite=overwrite,
            search_stats={"imported_job": name},
        )
        results.append((name, key.digest, written))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--store", required=True,
                   help="store root ($FLEXFLOW_TPU_TORCH_STORE_DIR of the "
                        "fleet)")
    p.add_argument("--strategies",
                   default=os.path.join(_REPO, "examples", "strategies"),
                   help="directory of shipped *.json artifacts")
    p.add_argument("-n", "--num-devices", type=int, default=8,
                   help="device count the artifacts were searched for")
    p.add_argument("--overwrite", action="store_true",
                   help="replace existing entries for matching keys")
    p.add_argument("--device", default="cuda",
                   help="the device of the compiles that consume the "
                        "entries (FFConfig.device; part of the key)")
    args = p.parse_args(argv)

    results = import_default_jobs(
        args.store, os.path.abspath(args.strategies), args.num_devices,
        overwrite=args.overwrite, device=args.device,
    )
    for name, digest, written in results:
        state = "imported" if written else "kept existing"
        print(f"{name}: {state} -> {digest[:16]}")
    if not results:
        print("nothing imported", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
