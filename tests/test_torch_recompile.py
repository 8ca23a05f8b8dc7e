"""The port's recompilation (flexflow_tpu_torch/recompile.py,
FFModel.recompile and recompile_on_condition) and the expert-activation
Cache op (ops/moe.py, FFModel.cache and use_cached, fit's cache taps)
against flexflow_tpu's: the 7 cases of tests/test_recompile.py, and the
Cache op's host ring and scores.

The reference's 8 -> 4 -> 2 virtual-device recompiles become, in the
port, a gloo group of 4 ranks (tests/torch_dist_ranks.py
recompile_group) re-formed onto 2 and then 1, held against the
reference on as many virtual devices.  Both packages start from the same
weights (the port's, set into the reference) and data: outputs, losses,
weights and op state agree within 1e-5 (float32 SGD: rtol 1e-5, atol
1e-5); what a recompile carries (weights, optimizer slots, op state, the
generator) is 0 apart across it in the port.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as G  # noqa: E402

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu.strategy import Strategy as RStrategy  # noqa: E402
from flexflow_tpu.strategy import \
    data_parallel_strategy as r_dp  # noqa: E402
from flexflow_tpu_torch.capture import capture_blockers  # noqa: E402
from flexflow_tpu_torch.checkpoint import state_arrays  # noqa: E402
from flexflow_tpu_torch.ops.moe import Cache, default_cache_score  # noqa: E402
from flexflow_tpu_torch.strategy import data_parallel_strategy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(build=G.sup_mlp, lr=0.05, momentum=0.0, strategy=None, **cfg):
    ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu", **cfg))
    build(ff)
    ff.compile(optimizer=P.SGDOptimizer(lr=lr, momentum=momentum),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"],
               strategy=strategy, seed=0)
    return ff


def _ref(weights, build=G.sup_mlp, devices=1, lr=0.05, momentum=0.0,
         strategy=None):
    devs = jax.devices("cpu")[:devices]
    ff = R.FFModel(R.FFConfig(batch_size=16, num_devices=devices))
    build(ff)
    ff.compile(optimizer=R.SGDOptimizer(lr=lr, momentum=momentum),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"],
               strategy=strategy, devices=devs)
    ff.set_weights(weights)
    return ff


def _data(n=64, seed=0, shape=(8,)):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32))


def _close(got, want):
    assert sorted(got) == sorted(want)
    for op in want:
        for k in want[op]:
            np.testing.assert_allclose(got[op][k], np.asarray(want[op][k]),
                                       err_msg=f"{op}.{k}", **TOL)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_trigger_alter_counter():
    fired = {"p": [], "r": []}
    for key, pkg, ff in (("p", P, _port()), ("r", R, None)):
        r = pkg.RecompileState(trigger_func=lambda m, k=key: len(fired[k]) < 2,
                               alter_func=lambda m, k=key: fired[k].append(1),
                               ff=ff)
        from importlib import import_module

        rc = import_module(f"{pkg.__name__}.recompile")
        got = [rc.recompile_on_condition(ff, r) for _ in range(3)]
        assert got == [True, True, False]
        assert r.recompilations == 2
    assert fired["p"] == fired["r"]


# -- across re-formed groups ---------------------------------------------------

@pytest.fixture(scope="module")
def group():
    x, y = _data(64, seed=0)
    xb, yb = _data(32, seed=0, shape=(4, 4, 4))
    xb = xb * 3 + 1
    mlp = _port().get_weights()
    bn = _port(G.bn_net, lr=0.01)
    ranks = G.run_group(G.recompile_group, 4, mlp, x, y, bn.get_weights(),
                        bn.get_state(), xb, yb, timeout=180.0)
    # the reference: 4 virtual devices, recompiled onto 2; then the BN
    # net on 2, recompiled onto 1
    r = _ref(mlp, devices=4)
    r.fit(x, y, epochs=1, verbose=False)
    before = np.asarray(r.forward({"x": x[:16]}))
    r.recompile(strategy=r_dp(2), devices=list(r.mesh.devices.flat)[:2])
    after = np.asarray(r.forward({"x": x[:16]}))
    r.fit(x, y, epochs=2, verbose=False)
    # (its running statistics start as the port's: mean 0, variance 1)
    rb = _ref(bn.get_weights(), G.bn_net, devices=2, lr=0.01)
    rb.fit(xb, yb, epochs=2, verbose=False)
    rb_state = {op: {k: np.asarray(v) for k, v in e.items()}
                for op, e in rb._state.items()}
    return {"ranks": ranks, "ref_forward": (before, after),
            "ref_weights": r.get_weights(), "ref_bn_state": rb_state}


def test_recompile_preserves_weights_and_outputs(group):
    """4 ranks -> data 2 on ranks 0-1: the same forward before and after
    (the reference's too), and training goes on as the reference's."""
    ranks = group["ranks"]
    assert [r["stayed"] for r in ranks] == [True, True, False, False]
    assert [r["compiled"] for r in ranks[2:]] == [False, False]
    ref_before, ref_after = group["ref_forward"]
    for r in ranks[:2]:
        assert r["world"] == 2
        before, after = r["forward"]
        np.testing.assert_allclose(after, before, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(before, ref_before, **TOL)
        np.testing.assert_allclose(after, ref_after, **TOL)
        _close(r["weights"], group["ref_weights"])


def test_recompile_preserves_bn_state_and_rng(group):
    """2 ranks -> rank 0 alone: BatchNorm's running statistics (equal to
    the reference's after the same two epochs) and the generator's state
    cross the recompile 0 apart."""
    bn = group["ranks"][0]["bn"]
    assert bn["world"] == 1 and bn["rng"]
    for op, entries in bn["before"].items():
        for k, v in entries.items():
            np.testing.assert_array_equal(bn["after"][op][k], v)
            np.testing.assert_allclose(v, group["ref_bn_state"][op][k], **TOL)
    leaves = [v for e in bn["before"].values() for v in e.values()]
    assert any(not np.allclose(v, 0.0) and not np.allclose(v, 1.0)
               for v in leaves)
    assert "bn" not in group["ranks"][1]


# -- on one process ----------------------------------------------------------------

def test_recompile_in_training_loop_via_cache_score():
    """A trigger watching a score recompiles once the score crosses its
    threshold; the state crosses 0 apart, and the run ends as the
    reference's (which recompiles onto 1 device too)."""
    x, y = _data(32, seed=1)
    ff = _port(momentum=0.9)
    ref = _ref(ff.get_weights(), momentum=0.9)
    for pkg, m in ((P, ff), (R, ref)):
        score = {"v": 0.0}

        def trigger(model, score=score):
            return score["v"] > 0.5 and rs.recompilations == 0

        def alter(model, pkg=pkg):
            if pkg is P:
                carried = state_arrays(model)
                model.recompile(strategy=data_parallel_strategy(1))
                _equal(state_arrays(model), carried)
            else:
                model.recompile(strategy=r_dp(1),
                                devices=list(model.mesh.devices.flat)[:1])

        rs = pkg.RecompileState(trigger, alter, m)
        for it in range(4):
            m.train_step({"x": x[:16]}, y[:16])
            score["v"] = it * 0.3
            m.recompile_on_condition(rs)
        assert rs.recompilations == 1
    assert ff.strategy.total_devices == 1
    _close(ff.get_weights(), ref.get_weights())


def _degree_one(strategy_cls, M=4):
    s = strategy_cls(mesh_axes={"data": 1})
    s.pipeline = {"degree": 1, "num_microbatches": M, "axis": "data",
                  "dp_axis": None}
    return s


def _blocks(ff):
    G.blocks(ff, width=32, classes=4)


def test_recompile_onto_pipeline_carries_weights():
    """Per-op weights (and the momentum slots) go onto a pipeline's
    stacked "__pipeline__" layout: the same forward, and training goes on
    as the reference's recompiled onto its one-stage pipeline."""
    x, y = _data(64, shape=(32,))
    ff = _port(_blocks, momentum=0.9)
    ref = _ref(ff.get_weights(), _blocks, momentum=0.9)
    ff.fit(x, y, epochs=1, verbose=False)
    ref.fit(x, y, epochs=1, verbose=False)
    w_before = ff.get_weights()
    before = ff.forward({"x": x[:16]}).numpy()
    ff.recompile(strategy=_degree_one(P.strategy.Strategy))
    ref.recompile(strategy=_degree_one(RStrategy),
                  devices=list(ref.mesh.devices.flat)[:1])
    assert set(ff.get_weights()) == {"__pipeline__", "head"}
    stacked = ff.get_weights()["__pipeline__"]
    for k in range(4):
        np.testing.assert_array_equal(stacked["0.kernel"][k],
                                      w_before[f"blk{k}"]["kernel"])
    np.testing.assert_allclose(ff.forward({"x": x[:16]}).numpy(), before,
                               rtol=2e-5, atol=2e-5)
    ff.fit(x, y, epochs=1, verbose=False)
    ref.fit(x, y, epochs=1, verbose=False)
    _close(ff.get_weights(), ref.get_weights())


def test_recompile_off_pipeline_carries_weights():
    x, y = _data(32, seed=1, shape=(32,))
    ff = _port(_blocks, strategy=_degree_one(P.strategy.Strategy))
    ff.train_step({"x": x[:16]}, y[:16])
    stacked = ff.get_weights()["__pipeline__"]
    before = ff.forward({"x": x[:16]}).numpy()
    ff.recompile(strategy=data_parallel_strategy(1))
    w = ff.get_weights()
    assert "__pipeline__" not in w
    for k in range(4):
        np.testing.assert_array_equal(w[f"blk{k}"]["kernel"],
                                      stacked["0.kernel"][k])
    np.testing.assert_allclose(ff.forward({"x": x[:16]}).numpy(), before,
                               rtol=2e-5, atol=2e-5)
    assert np.isfinite(float(ff.train_step({"x": x[:16]}, y[:16])["loss"]))


# -- the Cache op -------------------------------------------------------------------

def _cached(pkg, score_fn=None, num_batches=4):
    ff = pkg.FFModel(pkg.FFConfig(batch_size=8, **(
        {"device": "cpu"} if pkg is P else {"num_devices": 1})))
    x = ff.create_tensor([8, 8], name="x")
    t = ff.cache(x, num_batches=num_batches, score_fn=score_fn)
    t = ff.dense(t, 4)
    ff.softmax(t)
    kw = {} if pkg is P else {"devices": jax.devices("cpu")[:1]}
    ff.compile(optimizer=pkg.SGDOptimizer(lr=0.01), **kw)
    return ff


def test_cache_score_drives_recompile_trigger():
    """A model-level score_fn(ff) is polled after every fit batch; its
    history is bounded by num_batches and feeds a RecompileState."""
    x, y = _data(32)
    for pkg in (P, R):
        ff = _cached(pkg, score_fn=lambda m: 0.9)
        ff.fit(x, y, epochs=2, verbose=False)
        op = ff._cache_ops[0]
        assert op.trigger == pytest.approx(0.9)
        assert len(op.score_history) == 4
        r = pkg.RecompileState(lambda m: m._cache_ops[0].trigger > 0.5,
                               lambda m: None, ff)
        assert ff.recompile_on_condition(r)


@pytest.mark.parametrize("repeat", [True, False])
def test_cache_ring_and_default_score_match_the_reference(repeat):
    """The default (exact-match EMA) and a four-argument scorer fold the
    same batches into the same ring and scores as the reference, the
    taps one step late and flushed by recompile_on_condition."""
    x, y = _data(32)
    scorer = lambda s, a, c, vol: s + float(np.abs(a - c).mean())  # noqa
    hist = {}
    for pkg in (P, R):
        for name, fn in (("default", None), ("four", scorer)):
            ff = _cached(pkg, score_fn=fn, num_batches=4)
            ff.set_weights(_port_cache_weights())
            for e in range(3):
                for i in range(0, 32, 8):
                    # the same 4 batches each epoch (one per slot), or
                    # batches that never come back
                    ff.train_step({"x": x[i:i + 8] if repeat
                                   else x[i:i + 8] + 100 * e}, y[i:i + 8])
            ff.recompile_on_condition(pkg.RecompileState(
                lambda m: False, lambda m: None, ff))
            op = ff._cache_ops[0]
            hist[(pkg.__name__, name)] = (list(op.score_history),
                                          op.batch_ctr)
    for name in ("default", "four"):
        got, want = hist[("flexflow_tpu_torch", name)], \
            hist[("flexflow_tpu", name)]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        assert got[1] == want[1]
    assert (hist[("flexflow_tpu_torch", "default")][0][-1] > 0) == repeat


_CACHE_W = {}


def _port_cache_weights():
    if not _CACHE_W:
        _CACHE_W.update(_cached(P).get_weights())
    return _CACHE_W


def test_use_cached_replays_the_cached_batch():
    """use_cached(True) feeds the cached batch of the current slot in
    place of the input: the loss of a step on fresh data is the loss of
    the cached batch, as in the reference."""
    x, y = _data(16)
    losses = {}
    for pkg in (P, R):
        ff = _cached(pkg, num_batches=1)
        ff.set_weights(_port_cache_weights())
        ff.train_step({"x": x[:8]}, y[:8])
        ff.use_cached(True)
        m = ff.train_step({"x": x[8:]}, y[:8])
        losses[pkg.__name__] = float(np.asarray(m["loss"]))
        with pytest.raises(ValueError, match="no Cache op"):
            ff.use_cached(False, name="nope")
    assert losses["flexflow_tpu_torch"] == pytest.approx(
        losses["flexflow_tpu"], rel=1e-5)


def test_a_cache_op_keeps_the_step_eager():
    """Each tap reads its batch on the host, so capture_blockers names
    the op (here beside the CPU device); a graph without one does not
    name it."""
    ff = _cached(P)
    op = ff._cache_ops[0]
    assert isinstance(op, Cache)
    assert any(op.name in b for b in capture_blockers(ff.executor))
    assert not any("cache" in b for b in capture_blockers(_port().executor))
    assert default_cache_score(1.0, np.ones(3), np.ones(3), 3) == \
        pytest.approx(1.0)
