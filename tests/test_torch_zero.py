"""The ZeRO ladder, data-parallel BatchNorm and remat of the port's
executor, against the reference on the CPU.

ZeRO stages 1-3 under Adam give stage 0's losses and weights, and the
reference's, through `fit` (each rank loading its shard of every batch);
a weight no axis of 8 divides falls back to the replicated update and
is counted, as tests/test_zero_ladder.py counts it.  A data-parallel
CNN's BatchNorm statistics span the global batch: the running
statistics and weights after 2 steps equal the reference's (per-rank
statistics of 2 samples would not).  Remat, on one process, gives the
same losses bit for bit.

The port runs in one spawned gloo group of 8 ranks
(tests/torch_dist_ranks.py), the reference on the 8-device CPU mesh,
on the same numpy inputs, with its weights copied into the port.
"""
import functools

import numpy as np
import pytest

import torch_dist_ranks as R
from flexflow_tpu import AdamOptimizer, FFConfig, FFModel, LossType
from flexflow_tpu import SGDOptimizer
from flexflow_tpu.strategy import data_parallel_strategy as ref_dp
from flexflow_tpu_torch.config import FFConfig as TFFConfig
from flexflow_tpu_torch.model import FFModel as TFFModel
from flexflow_tpu_torch.models.transformer import build_bert
from flexflow_tpu_torch.optimizer import AdamOptimizer as TAdam
from flexflow_tpu_torch.optimizer import SGDOptimizer as TSGD
from flexflow_tpu_torch.strategy import Strategy, data_parallel_strategy

# float32: the ranks' gradient sums (gloo) against XLA's, Adam at alpha
# 0.01 over 8 steps; the reference's own ladder test holds stage 3 to
# stage 0 at rtol 2e-5
TOL = dict(rtol=2e-5, atol=2e-5)
STAGES = (0, 1, 2, 3)
METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _zero_data():
    rng = np.random.RandomState(0)
    return (rng.randn(64, 32).astype(np.float32),
            rng.randint(0, 7, 64).astype(np.int32))


def _cnn_data():
    rng = np.random.RandomState(2)
    return [({"x": rng.randn(16, 3, 8, 8).astype(np.float32)},
             rng.randint(0, 4, 16).astype(np.int32)) for _ in range(2)]


@pytest.fixture(scope="module")
def group(devices8):
    ref, cases = {}, []
    # the ladder: the reference's MLP under Adam, fit over 2 epochs
    x, y = _zero_data()
    ff = FFModel(FFConfig(batch_size=16, num_devices=8, zero_stage=0))
    R.mlp_zero(ff)
    ff.compile(optimizer=AdamOptimizer(alpha=0.01),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=METRICS, strategy=ref_dp(8), devices=devices8, seed=0)
    w = ff.get_weights()
    ref["zero"] = [pm.sparse_cce_loss
                   for pm in ff.fit(x, y, epochs=2, verbose=False)]
    ref["zero_weights"] = ff.get_weights()
    for stage in STAGES:
        cases.append((R.fit_run, (R.mlp_zero, data_parallel_strategy(8), w,
                                  x, y, functools.partial(TAdam, alpha=0.01),
                                  {"zero_stage": stage}, 2, 16)))
    # the fallback leaf alone (tests/test_zero_ladder.py)
    ffl = FFModel(FFConfig(batch_size=16, num_devices=8, zero_stage=1))
    R.mlp_zero(ffl, hidden=0)
    ffl.compile(optimizer=SGDOptimizer(lr=0.05),
                loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                strategy=ref_dp(8), devices=devices8)
    ref["fallback"] = ffl.executor.zero_fallback_leaves()
    cases.append((R.fit_run, (functools.partial(R.mlp_zero, hidden=0),
                              data_parallel_strategy(8), ffl.get_weights(),
                              x, y, functools.partial(TSGD, lr=0.05),
                              {"zero_stage": 1}, 1, 16)))
    # the data-parallel CNN with BatchNorm, 2 SGD steps
    ffc = FFModel(FFConfig(batch_size=16, num_devices=8))
    R.cnn_bn(ffc)
    ffc.compile(optimizer=SGDOptimizer(lr=0.1),
                loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                strategy=ref_dp(8), devices=devices8, seed=3)
    wc = ffc.get_weights()
    batches = _cnn_data()
    ref["cnn"] = [float(ffc.train_step(*b)["loss"]) for b in batches]
    ref["cnn_weights"] = ffc.get_weights()
    ref["cnn_state"] = {op: {k: np.asarray(v) for k, v in e.items()}
                        for op, e in ffc._state.items()}
    cases.append((R.train_steps, (R.cnn_bn, data_parallel_strategy(8), wc,
                                  batches, functools.partial(TSGD, lr=0.1))))
    out = R.run_group(R.run_cases, 8, cases, timeout=240)
    return ref, out


@pytest.mark.parametrize("stage", STAGES)
def test_zero_stage_matches_stage0_and_reference(group, stage):
    ref, out = group
    got = out[0][stage]
    assert got["zero_stage"] == stage
    np.testing.assert_allclose(got["losses"], ref["zero"], **TOL)
    np.testing.assert_allclose(got["losses"], out[0][0]["losses"], **TOL)
    for op, entries in ref["zero_weights"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(got["weights"][op][k], v, rtol=1e-4,
                                       atol=1e-4)
    # every rank ends with the same gathered weights
    for rank in out[1:]:
        for op, entries in got["weights"].items():
            for k, v in entries.items():
                np.testing.assert_array_equal(rank[stage]["weights"][op][k],
                                              v)


def test_zero_shards_the_optimizer_state(group):
    """Adam's slots per rank: whole at stage 0, 1/8 at stages 1-3 but
    for the fallback leaf (the 7-wide bias)."""
    _, out = group
    full = out[0][0]["opt_bytes"]
    bias = 2 * 7 * 4  # m and v of head.bias, float32
    for stage in (1, 2, 3):
        assert out[0][stage]["opt_bytes"] == (full - bias) // 8 + bias
        assert out[0][stage]["fallback"] == ["head.bias"]
    assert out[0][0]["fallback"] == []


def test_fallback_leaves_counted_as_the_reference(group):
    ref, out = group
    assert ref["fallback"] == ["head.bias"]
    assert out[0][4]["fallback"] == ref["fallback"]


def test_data_parallel_batchnorm_uses_global_statistics(group):
    ref, out = group
    got = out[0][5]
    np.testing.assert_allclose(got["losses"], ref["cnn"], **TOL)
    for op, entries in ref["cnn_weights"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(got["weights"][op][k], v, **TOL)
    for op, entries in ref["cnn_state"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(got["state"][op][k], v, **TOL)


@pytest.mark.parametrize("how", ["config", "strategy"])
def test_remat_losses_bit_equal(how):
    """FFConfig.remat (every pure segment) or a strategy's remat plan:
    the segments run under torch.utils.checkpoint, and the losses are
    those of the plan with nothing selected, bit for bit."""
    rng = np.random.RandomState(0)
    batches = [({"input": rng.randn(4, 16, 32).astype(np.float32)},
                rng.randint(0, 2, 4).astype(np.int32)) for _ in range(2)]

    def run(**kw):
        cfg = {"remat": True} if how == "config" and kw else {}
        ff = TFFModel(TFFConfig(device="cpu", batch_size=4, **cfg))
        build_bert(ff, batch_size=4, seq_length=16, hidden_size=32,
                   num_layers=2, num_heads=4, intermediate_size=64)
        s = None
        if how == "strategy":
            s = Strategy(mesh_axes={"data": 1},
                         remat=kw.get("plan", []))
        ff.compile(strategy=s, seed=0)
        losses = [float(ff.train_step(*b)["loss"]) for b in batches]
        return ff, losses

    plain, want = run()
    ff, got = run(plan=[1, 2, 3, 4])
    assert got == want
    plan = ff.executor._remat_plan
    picked = [i for i, (*_, pure) in enumerate(plan) if pure]
    assert picked and (how == "config" or picked == [1, 2, 3, 4])
    assert plain.executor._remat_plan is None
