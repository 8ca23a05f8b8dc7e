"""Pipelines as a Strategy in the port over 8 ranks
(tests/test_pipeline_strategy.py): the Unity search's pipeline compiled
and trained, and a replay of `_dryrun_multichip_body`'s
pipeline-strategy and 1F1B legs.

The port runs in a spawned gloo group of 8 ranks
(tests/torch_dist_ranks.py), spawned once for the module; the reference
runs in this process on the 8-device CPU mesh, on the same numpy inputs,
with its weights copied into the port.  Helpers and tolerances are
tests/test_torch_pipeline_strategy.py's.
"""
import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_ranks as R  # noqa: E402
from test_torch_pipeline_strategy import (SGD, TOL, _pp_strategy,  # noqa: E402
                                          _ref_model, _steps, _xy,
                                          prime_stack)
from test_torch_simulator import simple_machines  # noqa: E402

import flexflow_tpu as RF  # noqa: E402
import flexflow_tpu_torch as PF  # noqa: E402
from flexflow_tpu.models.transformer import build_bert  # noqa: E402
from flexflow_tpu.parallel.pipeline import \
    make_pipelined_transformer_step as ref_transformer_step  # noqa: E402
from flexflow_tpu.strategy import Strategy as RStrategy  # noqa: E402
from flexflow_tpu_torch.models.transformer import \
    build_bert as t_build_bert  # noqa: E402
from flexflow_tpu_torch.optimizer import SGDOptimizer as TSGD  # noqa: E402
from flexflow_tpu_torch.pcg import unity as p_unity  # noqa: E402
from flexflow_tpu_torch.sim import simulator as p_sim  # noqa: E402
from flexflow_tpu_torch.strategy import Strategy  # noqa: E402


@pytest.fixture(scope="module")
def eight(devices8):
    """The Unity search's pipeline and _dryrun_multichip_body's pipeline
    legs, the reference's results and the 8-rank group's."""
    ref, cases = {}, {}
    rm, pm = simple_machines()
    from flexflow_tpu.pcg import unity as r_unity
    from flexflow_tpu.sim import simulator as r_sim

    ffr = RF.FFModel(RF.FFConfig(batch_size=2, num_devices=8))
    prime_stack(ffr)
    ref["best"] = r_unity.UnitySearch(ffr.layers, 8, rm,
                                      r_sim.OpCostModel(rm)).optimize()
    ffp = PF.FFModel(PF.FFConfig(device="cpu", batch_size=2))
    prime_stack(ffp)
    best = p_unity.UnitySearch(ffp.layers, 8, pm,
                               p_sim.OpCostModel(pm)).optimize()
    ref["port_best"] = best
    xs, ys = _xy(4, batch=2, hidden=31, classes=5)
    ff = _ref_model(prime_stack, devices8,
                    RStrategy.from_json(best.to_json()), batch=2)
    w = ff.get_weights()
    ref["unity"] = _steps(ff, xs, ys, 1)
    cases["unity"] = (R.train_steps, (prime_stack, best, w,
                                      [({"x": xs}, ys)], SGD))
    # the pipeline-strategy leg: BERT dp 2 x pp 4, 8 layers
    bpp = 8
    build = functools.partial(build_bert, batch_size=bpp, seq_length=8,
                              hidden_size=32, num_layers=8, num_heads=4,
                              intermediate_size=64)
    t_build = functools.partial(t_build_bert, batch_size=bpp, seq_length=8,
                                hidden_size=32, num_layers=8, num_heads=4,
                                intermediate_size=64)
    ff = RF.FFModel(RF.FFConfig(batch_size=bpp, num_devices=8))
    build(ff)
    ff.compile(optimizer=RF.SGDOptimizer(lr=0.01),
               loss_type=RF.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=_pp_strategy(RStrategy, 2, 4, 4), devices=devices8)
    xp = np.random.RandomState(2).randn(bpp, 8, 32).astype(np.float32)
    yp = np.random.RandomState(3).randint(0, 2, bpp).astype(np.int32)
    wp = ff.get_weights()
    ref["dry_pp"] = [float(ff.train_step({"input": xp}, yp)["loss"])]
    cases["dry_pp"] = (R.train_steps, (
        t_build, _pp_strategy(Strategy, 2, 4, 4), wp,
        [({"input": xp}, yp)], functools.partial(TSGD, lr=0.01)))
    # the 1F1B leg: the demo at dp 2 x pp 4
    from jax.sharding import Mesh

    import jax

    kw = dict(layers=4, hidden=16, ffn=32, num_heads=4, num_classes=4,
              num_microbatches=4, lr=0.1)
    init_fn, step_fn = ref_transformer_step(
        Mesh(np.array(devices8).reshape(2, 4), ("data", "pp")),
        schedule="1f1b", **kw)
    params = init_fn(seed=0)
    p0 = jax.tree.map(np.asarray, params)
    x1 = np.random.RandomState(4).randn(8, 8, 16).astype(np.float32)
    y1 = np.random.RandomState(5).randint(0, 4, 8).astype(np.int32)
    _, loss = step_fn(params, x1, y1)
    ref["dry_1f1b"] = [float(loss)]
    cases["dry_1f1b"] = (R.transformer_case,
                         (2, 4, kw, p0, x1, y1, 1, "1f1b"))
    names = list(cases)
    got = R.run_group(R.run_cases, 8, [cases[k] for k in names],
                      timeout=240)
    return ref, {k: [rank[i] for rank in got] for i, k in enumerate(names)}


def test_unity_search_emits_pipeline(eight):
    """With a prime hidden width (no tp options) and a batch smaller than
    the device count (no pure-dp factorization), the only viable
    8-device strategy over the H100 spec is GPipe: the port's search
    emits the reference's, and compile and a train step now run it."""
    ref, out = eight
    best = ref["port_best"]
    assert best.pipeline is not None, f"expected pp strategy, got {best}"
    assert best.mesh_axes.get("pipe") == best.pipeline["degree"]
    assert best.to_json() == ref["best"].to_json()
    for rank in out["unity"]:
        assert np.isfinite(rank["losses"]).all()
        np.testing.assert_allclose(rank["losses"], ref["unity"], **TOL)


@pytest.mark.parametrize("leg", ["dry_pp", "dry_1f1b"])
def test_dryrun_multichip_pipeline_legs_replay(eight, leg):
    """The reference body's pipeline-strategy leg (BERT at dp 2 x pp 4,
    4 microbatches) and 1F1B leg (the demo at dp 2 x pp 4) over 8
    ranks."""
    ref, out = eight
    losses = [rank["losses"] for rank in out[leg]]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], ref[leg], **TOL)
