"""FFModel.compile(devices=...) and Keras Model.compile(devices=...) of
the port against flexflow_tpu's: the cases of
tests/test_keras_frontend.py and tests/test_recompile.py that pass
`devices`.

The reference runs each on devices8[:k]; the port on a gloo group of
k = 2 ranks (tests/torch_dist_ranks.py compile_devices_group: one group
for every case, spawned once), or for k = 1 with no group, or on the
group of 1 that compile(devices=[0]) re-forms.  Weights and data come
from numpy seeds: each model's weights are the reference's, set into
the port (convert.from_jax_weights through set_weights).  Tolerances
are those of tests/test_torch_keras.py (predict within 1e-5 of the
output's scale; epoch metric sums within rtol 1e-5, atol 1e-6; weights
after fit within 2e-5 under SGD) and tests/test_torch_recompile.py
(outputs and weights within rtol 1e-5, atol 1e-5; a recompile carries
its state 0 apart).  Also: a rank outside `devices` leaves the group,
and its fit and train_step raise; devices=[0, 1] without a group raises
ValueError naming the group, from compile, Keras compile and recompile
alike, and the model stays as it was.
"""
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as G  # noqa: E402

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu.keras as RK  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
import flexflow_tpu_torch.keras as PK  # noqa: E402
from flexflow_tpu.strategy import \
    data_parallel_strategy as r_dp  # noqa: E402
from flexflow_tpu_torch.checkpoint import state_arrays  # noqa: E402
from flexflow_tpu_torch.strategy import data_parallel_strategy  # noqa: E402

OUT_TOL, METRIC_RTOL, WEIGHT_TOL = 1e-5, 1e-5, 2e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return {op: {k: np.asarray(v) for k, v in e.items()}
            for op, e in tree.items()}


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _history_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["train_all"] == b["train_all"]
        assert a["train_correct"] == b["train_correct"]
        for f in ("cce_loss", "sparse_cce_loss", "mse_loss", "mae_loss"):
            np.testing.assert_allclose(a[f], b[f], rtol=METRIC_RTOL,
                                       atol=1e-6, err_msg=f)


def _weights_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for op, entries in want.items():
        for k, v in entries.items():
            np.testing.assert_allclose(got[op][k], np.asarray(v),
                                       err_msg=f"{op}.{k}", **tol)


def _keras_data():
    rng = np.random.RandomState(0)
    x = rng.randn(128, 16).astype(np.float32)
    mlp = (x, (x[:, 0] > 0).astype(np.int32))
    rng = np.random.RandomState(1)
    xa = rng.randn(64, 8).astype(np.float32)
    xb = rng.randn(64, 8).astype(np.float32)
    branches = ({"a": xa, "b": xb},
                ((xa.sum(1) + xb.sum(1)) > 0).astype(np.int32))
    (xl, yl), _ = PK.datasets.reuters.load_data(num_words=200, maxlen=16,
                                                num_samples=64)
    return {"mlp": mlp, "branches": branches,
            "lstm": (xl.astype(np.int32), yl.astype(np.int32))}


def _ref_keras(name, k):
    """The reference's Keras case `name` compiled on devices8[:k]."""
    build, batch, kw, _ = G.KERAS_CASES[name]
    m = build(RK, R.FFConfig(batch_size=batch, num_devices=k))
    m.compile(devices=jax.devices("cpu")[:k], **kw)
    return m


def _ref_keras_run(m, name, x, y):
    batch, epochs = G.KERAS_CASES[name][1], G.KERAS_CASES[name][3]
    first = ({k: v[:batch] for k, v in x.items()} if isinstance(x, dict)
             else x[:batch])
    pred = m.predict(first)
    hist = m.fit(x, y, epochs=epochs, verbose=False)
    return {"predict": pred, "history": G.history(hist),
            "weights": _np(m.ffmodel.get_weights()), "summary": m.summary()}


def _ref_mlp(devices, weights=None):
    """tests/test_recompile.py's _model on `devices`."""
    ff = R.FFModel(R.FFConfig(batch_size=16, num_devices=len(devices)))
    G.sup_mlp(ff)
    ff.compile(optimizer=R.SGDOptimizer(lr=0.05),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], devices=devices)
    if weights is not None:
        ff.set_weights(weights)
    return ff


def _recompile_data(n=64):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32))


@pytest.fixture(scope="module")
def group():
    """Every case of compile_devices_group on one gloo group of 2, and
    the reference's runs of the same cases on devices8[:2] (the Keras MLP
    compiled with devices=[0] also on devices8[:1])."""
    data = _keras_data()
    refs = {name: _ref_keras(name, 2) for name in G.KERAS_CASES}
    cases = {name: (_np(m.ffmodel.get_weights()),) + data[name]
             for name, m in refs.items()}
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 4).astype(np.float32)
    small_data = (xs, (xs[:, 0] > 0).astype(np.int32))
    small = _ref_keras_small()
    small_args = (_np(small.ffmodel.get_weights()),) + small_data
    x, y = _recompile_data()
    rmlp = _ref_mlp(jax.devices("cpu")[:2])
    recompile_args = (_np(rmlp.get_weights()), x, y)
    # the group runs while this process runs the reference
    box = {}

    def spawn():
        try:
            box["ranks"] = G.run_group(G.compile_devices_group, 2, cases,
                                       small_args, recompile_args,
                                       timeout=240.0)
        except BaseException as e:  # raised below, in the test's thread
            box["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        want = _reference_runs(refs, data, small, small_data, rmlp, x, y,
                               cases["mlp"][0])
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "want": want}


def _reference_runs(refs, data, small, small_data, rmlp, x, y, mlp_weights):
    """The reference's side of every case of the group fixture."""
    want = {"keras": {name: _ref_keras_run(m, name, *data[name])
                      for name, m in refs.items()}}
    lrs = []

    def sched(epoch, lr):
        lrs.append(lr)
        return lr * 0.5

    small.fit(*small_data, epochs=3, verbose=False,
              callbacks=[RK.LearningRateScheduler(sched)])
    stop = small.fit(*small_data, epochs=50, verbose=False,
                     callbacks=[RK.EarlyStopping(monitor="accuracy",
                                                 patience=1)])
    want["small"] = {"lrs": lrs, "early_stop_epochs": len(stop),
                     "weights": _np(small.ffmodel.get_weights())}
    fired = []
    r = R.RecompileState(trigger_func=lambda m: len(fired) < 2,
                         alter_func=lambda m: fired.append(1), ff=rmlp)
    triggers = [rmlp.recompile_on_condition(r) for _ in range(3)]
    rmlp.fit(x, y, epochs=1, verbose=False)
    before = np.asarray(rmlp.forward({"x": x[:16]}))
    rmlp.recompile(strategy=r_dp(2))  # compile's own devices
    want["recompile"] = {
        "triggers": triggers,
        "forward": (before, np.asarray(rmlp.forward({"x": x[:16]}))),
        "history": G.history(rmlp.fit(x, y, epochs=2, verbose=False)),
        "weights": _np(rmlp.get_weights())}
    one = _ref_keras("mlp", 1)
    one.ffmodel.set_weights(mlp_weights)
    want["leave"] = _ref_keras_run(one, "mlp", *data["mlp"])
    return want


def _ref_keras_small():
    m = G.keras_small(RK, R.FFConfig(batch_size=8, num_devices=2))
    m.compile(devices=jax.devices("cpu")[:2])
    return m


@pytest.mark.parametrize("name", sorted(G.KERAS_CASES))
def test_keras_compile_on_two_devices_like_reference(group, name):
    """tests/test_keras_frontend.py's MLP, two-branch model and LSTM
    classifier compiled with devices=[0, 1] on a group of 2 (the
    reference: devices8[:2]): predict, every epoch's metrics, the weights
    after fit, on both ranks."""
    want = group["want"]["keras"][name]
    for r in group["ranks"]:
        got = r["keras"][name]
        assert not got["left"]
        assert _scaled(got["predict"], want["predict"]) <= OUT_TOL
        _history_close(got["history"], want["history"])
        _weights_close(got["weights"], want["weights"], rtol=0,
                       atol=WEIGHT_TOL)
        assert got["summary"] == want["summary"]
    hist = group["ranks"][0]["keras"][name]["history"]
    if name == "mlp":
        assert group["ranks"][0]["keras"][name]["predict"].shape == (16, 4)
        assert (hist[-1]["train_correct"] / hist[-1]["train_all"]
                > hist[0]["train_correct"] / hist[0]["train_all"])


def test_lr_scheduler_and_early_stopping_on_two_devices(group):
    want = group["want"]["small"]
    assert want["lrs"] == [0.01, 0.005, 0.0025]
    assert want["early_stop_epochs"] < 50
    for r in group["ranks"]:
        got = r["small"]
        assert got["lrs"] == want["lrs"]
        assert got["early_stop_epochs"] == want["early_stop_epochs"]
        _weights_close(got["weights"], want["weights"], rtol=0,
                       atol=WEIGHT_TOL)


def test_recompile_keeps_compile_devices(group):
    """tests/test_recompile.py on devices [0, 1]: the trigger counter,
    and recompile(data 2) with devices=None keeps compile's devices (the
    group of 2): the same forward before and after (the reference's
    too), and training goes on as the reference's."""
    want = group["want"]["recompile"]
    for r in group["ranks"]:
        got = r["recompile"]
        assert got["triggers"] == want["triggers"] == [True, True, False]
        assert got["recompilations"] == 2
        assert got["stayed"] and got["world"] == 2
        before, after = got["forward"]
        np.testing.assert_allclose(after, before, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(before, want["forward"][0], **TOL)
        np.testing.assert_allclose(after, want["forward"][1], **TOL)
        _history_close(got["history"], want["history"])
        _weights_close(got["weights"], want["weights"], **TOL)


def test_rank_outside_devices_leaves_and_its_fit_raises(group):
    """The Keras MLP compiled with devices=[0] on the group of 2: rank 1
    leaves (no group, its fit and train_step raise RuntimeError saying
    so); rank 0 trains on the group of 1 it re-formed as the reference
    trains on devices8[:1]."""
    stay, left = (r["leave"] for r in group["ranks"])
    assert left["left"] and not left["in_group"]
    for err in left["errors"]:
        assert err is not None and "left the torch.distributed group" in err
    want = group["want"]["leave"]
    assert not stay["left"] and stay["in_group"] and stay["world"] == 1
    assert _scaled(stay["predict"], want["predict"]) <= OUT_TOL
    _history_close(stay["history"], want["history"])
    _weights_close(stay["weights"], want["weights"], rtol=0,
                   atol=WEIGHT_TOL)


# -- k = 1, no group --------------------------------------------------------------

def _port_mlp(devices):
    ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu"))
    G.sup_mlp(ff)
    ff.compile(optimizer=P.SGDOptimizer(lr=0.05),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], devices=devices)
    return ff


def test_recompile_onto_one_device_without_a_group():
    """tests/test_recompile.py's weights-and-outputs case at k = 1: the
    port with no group and devices=[0], the reference on devices8[:1]."""
    x, y = _recompile_data()
    ref = _ref_mlp(jax.devices("cpu")[:1])
    ff = _port_mlp([0])
    ff.set_weights(_np(ref.get_weights()))
    for m in (ff, ref):
        m.fit(x, y, epochs=1, verbose=False)
    before = ff.forward({"x": x[:16]}).numpy()
    ref_before = np.asarray(ref.forward({"x": x[:16]}))
    carried = state_arrays(ff)
    assert ff.recompile(strategy=data_parallel_strategy(1), devices=[0])
    ref.recompile(strategy=r_dp(1), devices=jax.devices("cpu")[:1])
    after = ff.forward({"x": x[:16]}).numpy()
    np.testing.assert_array_equal(after, before)
    for k, v in state_arrays(ff).items():
        np.testing.assert_array_equal(v, carried[k], err_msg=k)
    np.testing.assert_allclose(before, ref_before, **TOL)
    np.testing.assert_allclose(after, np.asarray(ref.forward({"x": x[:16]})),
                               **TOL)
    hist = ff.fit(x, y, epochs=2, verbose=False)
    ref.fit(x, y, epochs=2, verbose=False)
    assert np.isfinite(hist[-1].sparse_cce_loss)
    _weights_close(ff.get_weights(), ref.get_weights(), **TOL)


def test_bn_state_and_rng_cross_a_recompile_onto_devices():
    """tests/test_recompile.py's BatchNorm case at k = 1 (no group):
    BatchNorm's running statistics, equal to the reference's after the
    same two epochs, and the generator's state cross recompile(devices=
    [0]) 0 apart."""
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 4, 4, 4).astype(np.float32) * 3 + 1
    ys = rng.randint(0, 4, 32).astype(np.int32)
    ref = R.FFModel(R.FFConfig(batch_size=16, num_devices=1))
    G.bn_net(ref)
    ref.compile(optimizer=R.SGDOptimizer(lr=0.01),
                loss_type="sparse_categorical_crossentropy",
                devices=jax.devices("cpu")[:1])
    ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu"))
    G.bn_net(ff)
    ff.compile(optimizer=P.SGDOptimizer(lr=0.01),
               loss_type="sparse_categorical_crossentropy", devices=[0])
    ff.set_weights(_np(ref.get_weights()))
    for m in (ff, ref):
        m.fit(xs, ys, epochs=2, verbose=False)
    state, gen = ff.get_state(), ff._generator.get_state().clone()
    assert ff.recompile(strategy=data_parallel_strategy(1), devices=[0])
    assert torch.equal(ff._generator.get_state(), gen)
    for op, entries in state.items():
        for k, v in entries.items():
            np.testing.assert_array_equal(ff.get_state()[op][k], v)
            np.testing.assert_allclose(v, np.asarray(ref._state[op][k]),
                                       **TOL)
    leaves = [v for e in state.values() for v in e.values()]
    assert any(not np.allclose(v, 0.0) and not np.allclose(v, 1.0)
               for v in leaves)


def test_more_devices_than_a_missing_group_raise():
    """devices=[0, 1] with no group: ValueError naming the group, from
    FFModel.compile, Keras compile and recompile; never one device.  A
    recompile that raised leaves the compiled model as it was."""
    ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu"))
    G.sup_mlp(ff)
    with pytest.raises(ValueError, match="no torch.distributed group"):
        ff.compile(devices=[0, 1])
    assert ff.executor is None
    with pytest.raises(RuntimeError, match="compile"):
        ff.train_step({}, np.zeros(16, np.int32))
    m = G.keras_mlp(PK, P.FFConfig(batch_size=16, device="cpu"))
    with pytest.raises(ValueError, match="no torch.distributed group"):
        m.compile(devices=[0, 1])
    assert m.ffmodel is None
    ff = _port_mlp([0])
    x, y = _recompile_data(16)
    with pytest.raises(ValueError, match="no torch.distributed group"):
        ff.recompile(devices=[0, 1])
    with pytest.raises(ValueError, match="ranks of the torch.distributed"):
        ff.recompile(devices=["cuda:1"])
    assert np.isfinite(float(ff.train_step({"x": x}, y)["loss"]))
