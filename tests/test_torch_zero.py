"""The ZeRO ladder, data-parallel BatchNorm and remat of the port's
executor, against the reference on the CPU.

ZeRO stages 1-3 under Adam give stage 0's losses and weights, and the
reference's, through `fit` (each rank loading its shard of every batch);
stage 2, whose backward reduce-scatters each grad as it is made
(parallel/zero.py ScatterBuckets), also gives stage 1's and the
reference's own stage 2's, and holds only the grads' shards (and the
fallback leaf's whole grad) once the backward ends, where stage 1 holds
them whole, with no .grad left on any weight; stage 3's prefetch gathers
each scattered weight once a step, the next op's before the current op
runs, and gives the losses of stage 3 with the inline gathers (under
remat) and the reference's stage 3;
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
    # stage 2 in the reference, as tests/test_weight_update_sharding.py's
    # test_ladder_stage_matches_replicated runs it
    ff2 = FFModel(FFConfig(batch_size=16, num_devices=8, zero_stage=2))
    R.mlp_zero(ff2)
    ff2.compile(optimizer=AdamOptimizer(alpha=0.01),
                loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=METRICS, strategy=ref_dp(8), devices=devices8, seed=0)
    ff2.set_weights(w)
    ref["zero2"] = [pm.sparse_cce_loss
                    for pm in ff2.fit(x, y, epochs=2, verbose=False)]
    ref["zero2_weights"] = ff2.get_weights()
    # stage 2's grads after one step, against stage 1's (cases 6, 7)
    for stage in (1, 2):
        cases.append((R.zero_grad_bytes, (
            R.mlp_zero, data_parallel_strategy(8), w, x[:16], y[:16],
            functools.partial(TAdam, alpha=0.01), stage)))
    # stage 3's prefetch over three ops, and the inline gathers under
    # remat (cases 8, 9), against the reference's stage 3
    ff3 = FFModel(FFConfig(batch_size=16, num_devices=8, zero_stage=3))
    R.mlp3_zero(ff3)
    ff3.compile(optimizer=AdamOptimizer(alpha=0.01),
                loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                strategy=ref_dp(8), devices=devices8, seed=0)
    w3 = ff3.get_weights()
    rng = np.random.RandomState(3)
    z3_batches = [({"x": rng.randn(16, 32).astype(np.float32)},
                   rng.randint(0, 8, 16).astype(np.int32)) for _ in range(2)]
    ref["zero3"] = [float(ff3.train_step(*b)["loss"]) for b in z3_batches]
    ref["zero3_weights"] = ff3.get_weights()
    for remat in (False, True):
        cases.append((R.zero3_prefetch, (
            R.mlp3_zero, data_parallel_strategy(8), w3, z3_batches,
            functools.partial(TAdam, alpha=0.01), remat)))
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


def test_stage2_matches_stage1_and_the_reference_stage2(group):
    """tests/test_weight_update_sharding.py::test_ladder_stage_matches_replicated
    at stage 2: the losses and weights of the port's stage 1 and of the
    reference's stage 2."""
    ref, out = group
    got, one = out[0][2], out[0][1]
    np.testing.assert_allclose(got["losses"], ref["zero2"], **TOL)
    np.testing.assert_allclose(got["losses"], one["losses"], **TOL)
    for op, entries in ref["zero2_weights"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(got["weights"][op][k], v, rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(got["weights"][op][k],
                                       one["weights"][op][k], **TOL)


def test_stage2_holds_only_grad_shards_after_the_backward(group):
    """tests/test_weight_update_sharding.py::test_stage2_grad_buffer_scattered:
    at stage 2 the grads the step holds once the backward ends are the
    1/8 shards (and the 7-wide fallback bias whole), the full grads
    were dropped as the backward made them (no .grad is left on any
    weight); stage 1 keeps no count (its grads are the whole ones the
    backward returns).  The tensors alive at the update's entry (a walk
    over the collector's objects, not a count from shapes) hold exactly
    the whole grads less the shards fewer bytes at stage 2 than at
    stage 1 (a shard that is a view of the summed bucket would keep it
    whole).  The same loss either way.  The device's own reading of
    this is chip_smoke.py's dp_zero2 leg."""
    _, out = group
    for rank in out:
        one, two = rank[6], rank[7]
        assert one["with_grad"] == two["with_grad"] == []
        full = one["full_grad_bytes"]
        assert two["full_grad_bytes"] == full
        assert one["grad_bytes"] == {}
        assert two["grad_bytes"]["peak"] >= two["grad_bytes"]["after_backward"]
        assert one["held_bytes"] - two["held_bytes"] == (
            full - two["grad_bytes"]["after_backward"]), (one, two)
        bias = 7 * 4  # head.bias, float32
        assert two["fallback"] == ["head.bias"]
        assert two["grad_bytes"]["after_backward"] == (full - bias) // 8 + bias
        assert "head.kernel" in two["shards"] and "fc.kernel" in two["shards"]
        assert abs(one["loss"] - two["loss"]) <= 1e-6


def test_stage3_prefetch_issues_the_next_gather_first(group):
    """One gather per scattered weight per step, each issued through the
    asynchronous form; op k+1's gathers before op k runs (the first
    op's before any runs); the losses and weights of stage 3 with the
    inline gathers (remat, where no gather is issued ahead) and the
    reference's stage 3."""
    ref, out = group
    for rank in out:
        pre, inline = rank[8], rank[9]
        assert not pre["remat_plan"] and inline["remat_plan"]
        scattered = pre["scattered"]
        assert len(scattered) == 6  # fc1, fc2, head: kernel and bias
        for step in pre["steps"]:
            log = step["log"]
            gathers = [k for kind, k in log if kind == "gather"]
            assert sorted(gathers) == scattered
            assert step["async_gathers"] == len(scattered)
            pos = {e: i for i, e in enumerate(log)}
            for this, nxt in (("fc1", "fc2"), ("fc2", "head")):
                assert pos[("gather", f"{nxt}.kernel")] < pos[("run", this)]
            assert pos[("gather", "fc1.kernel")] < pos[("run", "fc1")]
            assert pos[("gather", "head.kernel")] > pos[("run", "x")]
        for step in inline["steps"]:
            assert step["async_gathers"] == 0
        np.testing.assert_allclose(pre["losses"], inline["losses"], **TOL)
        np.testing.assert_allclose(pre["losses"], ref["zero3"], **TOL)
        for op, entries in ref["zero3_weights"].items():
            for k, v in entries.items():
                np.testing.assert_allclose(pre["weights"][op][k], v,
                                           rtol=1e-4, atol=1e-4)
                np.testing.assert_allclose(pre["weights"][op][k],
                                           inline["weights"][op][k], **TOL)


def test_stage3_eval_holds_at_most_two_ops_gathers(group):
    """In an eval_step at stage 3 (no autograd to keep the gathered
    weights), each op's gathers are freed at its use: when an op runs,
    only its own and the next op's gathers are alive, as the
    reference's double buffer holds them; with remat too (an eval runs
    the flat path)."""
    _, out = group
    nxt = {"fc1": "fc2", "fc2": "head", "head": None}
    for rank in out:
        for case in (rank[8], rank[9]):
            live = case["eval_live"]
            for op, after in nxt.items():
                allowed = {f"{op}.kernel", f"{op}.bias"}
                if after:
                    allowed |= {f"{after}.kernel", f"{after}.bias"}
                assert {f"{op}.kernel", f"{op}.bias"} <= set(live[op])
                assert set(live[op]) <= allowed, (op, live[op])
            assert live["head"] == ["head.bias", "head.kernel"]
