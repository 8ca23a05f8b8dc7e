"""The port's durability layer against flexflow_tpu's
tests/test_durability.py: async verified saves, the crc32 manifest and
LATEST, the fallback past a torn or missing leaf and a stale LATEST,
retention that keeps the newest verified step, a failed async write
surfacing at drain, back-pressure, the compatibility error naming every
leaf, the checkpoint spans and counters, the hung-step watchdog,
check_step_health under each nan_policy (a NAN_LOSS fault through a real
step), RetryPolicy's backoff equal to the reference's.  On gloo groups
(tests/torch_dist_ranks.py): a per-op checkpoint restored onto a data 2
x pipe 2 pipeline and a pipeline's back onto per-op ops, weights and
momentum slots 0 apart; a data-parallel 4 ZeRO-2 run under Adam saved
with both managers and restored onto 2 ranks (ZeRO-1) and onto 1, 0
apart at the restore and within tests/test_torch_zero.py's tolerances
after training on.  The supervisor's tests wait for it (ROADMAP §1 item
7.7).
"""
import functools
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as R  # noqa: E402

import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu.resilience import retry as r_retry  # noqa: E402
from flexflow_tpu_torch.checkpoint import (  # noqa: E402
    CheckpointCompatibilityError, CheckpointManager, CheckpointVerifyError,
    LocalCheckpointManager)
from flexflow_tpu_torch.executor import (NonFiniteLossError,  # noqa: E402
                                         check_step_health)
from flexflow_tpu_torch.fftype import ActiMode  # noqa: E402
from flexflow_tpu_torch.resilience import (FaultKind, FaultPlan,  # noqa: E402
                                           HungStepTimeout, RetryPolicy,
                                           StepWatchdog)
from flexflow_tpu_torch.strategy import (Strategy,  # noqa: E402
                                         data_parallel_strategy)

# tests/test_torch_zero.py's: losses, and the weights under Adam
TOL = dict(rtol=2e-5, atol=2e-5)
ADAM_TOL = dict(rtol=1e-4, atol=1e-4)


def _model(seed=0, hidden=32, opt=None, **cfg):
    ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu", seed=seed, **cfg))
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, hidden, activation=ActiMode.RELU)
    t = ff.dense(t, 4)
    ff.softmax(t)
    ff.compile(optimizer=opt or P.SGDOptimizer(lr=0.05),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], seed=seed)
    return ff


def _data(n=128, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randint(0, 4, size=n).astype(np.int32))


def _weights_equal(a, b):
    assert sorted(a) == sorted(b)
    for op in a:
        for k in a[op]:
            np.testing.assert_array_equal(a[op][k], b[op][k],
                                          err_msg=f"{op}.{k}")


# -- async verified saves ----------------------------------------------------

def test_async_save_visible_after_drain(tmp_path):
    xs, ys = _data()
    ff = _model()
    ff.fit(xs, ys, epochs=1, verbose=False)
    mgr = LocalCheckpointManager(str(tmp_path / "a"))
    mgr.save(ff, step=5, wait=False)
    assert mgr.drain() == []
    assert mgr.latest_step() == 5 and mgr.latest_verified_step() == 5
    saved = ff.get_weights()
    ff.fit(xs, ys, epochs=1, verbose=False)
    assert mgr.restore(ff) == 5
    _weights_equal(ff.get_weights(), saved)
    mgr.close()


def test_async_snapshot_owns_its_memory(tmp_path, monkeypatch):
    """The writer runs after the next steps updated the weights in place:
    what it writes is the state at the save."""
    xs, ys = _data()
    ff = _model()
    mgr = LocalCheckpointManager(str(tmp_path / "o"))
    real = mgr._write_and_publish
    gate = []

    def late(*a, **k):
        while not gate:
            time.sleep(0.01)
        return real(*a, **k)

    monkeypatch.setattr(mgr, "_write_and_publish", late)
    saved = ff.get_weights()
    mgr.save(ff, step=1, wait=False)
    ff.fit(xs, ys, epochs=1, verbose=False)  # updates the tensors in place
    gate.append(True)
    assert mgr.drain() == []
    fresh = _model(seed=4)
    mgr.restore(fresh)
    _weights_equal(fresh.get_weights(), saved)


def test_manifest_written_and_latest_pointer(tmp_path):
    import zlib

    ff = _model()
    mgr = LocalCheckpointManager(str(tmp_path / "m"))
    mgr.save(ff, step=3)
    step_dir = mgr._path(3)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["manifest_version"] == 1 and manifest["step"] == 3
    total = 0
    with np.load(os.path.join(step_dir, "state.npz")) as data:
        assert set(data.files) == set(manifest["leaves"])
        for key, spec in manifest["leaves"].items():
            arr = np.ascontiguousarray(data[key])
            assert zlib.crc32(arr.view(np.uint8).reshape(-1)) == spec["crc32"]
            assert list(arr.shape) == spec["shape"]
            total += arr.nbytes
    assert manifest["total_bytes"] == total
    with open(os.path.join(str(tmp_path / "m"), "LATEST")) as f:
        assert int(f.read()) == 3


def _two_steps(tmp_path):
    xs, ys = _data()
    ff = _model()
    ff.fit(xs, ys, epochs=1, verbose=False)
    w1 = ff.get_weights()
    mgr = LocalCheckpointManager(str(tmp_path / "c"))
    mgr.save(ff, step=1)
    ff.fit(xs, ys, epochs=1, verbose=False)
    mgr.save(ff, step=2)
    ff.fit(xs, ys, epochs=1, verbose=False)  # diverge further
    return ff, mgr, w1


def _rewrite_npz(path, edit):
    with np.load(path) as data:
        flat = {k: np.array(data[k]) for k in data.files}
    edit(flat)
    np.savez(path, **flat)


@pytest.mark.parametrize("damage", ["bit_flip", "missing_leaf"])
def test_per_leaf_damage_falls_back_to_verified(tmp_path, damage):
    """A step whose npz still parses but whose bytes drifted, or lost a
    leaf, fails verification and restore falls back to the older step;
    LATEST is pointed at the step that restored."""
    ff, mgr, w1 = _two_steps(tmp_path)
    npz = os.path.join(mgr._path(2), "state.npz")

    def edit(flat):
        key = sorted(k for k in flat if flat[k].dtype == np.float32)[0]
        if damage == "bit_flip":
            flat[key].reshape(-1)[0] += 1.0
        else:
            del flat[key]

    _rewrite_npz(npz, edit)
    assert mgr.restore(ff) == 1
    _weights_equal(ff.get_weights(), w1)
    assert mgr.latest_verified_step() == 1
    with pytest.raises(CheckpointVerifyError):
        mgr.restore(ff, step=2)


def test_stale_latest_falls_back(tmp_path):
    """LATEST naming a step that is gone: latest_verified_step is None
    and restore takes the newest step there is."""
    ff, mgr, w1 = _two_steps(tmp_path)
    shutil.rmtree(mgr._path(2))
    with open(os.path.join(mgr.directory, "LATEST")) as f:
        assert int(f.read()) == 2
    assert mgr.latest_verified_step() is None
    assert mgr.restore(ff) == 1
    _weights_equal(ff.get_weights(), w1)


def test_manifest_missing_leaf_is_unverifiable(tmp_path):
    ff = _model()
    mgr = LocalCheckpointManager(str(tmp_path))
    mgr.save(ff, step=1)
    mpath = os.path.join(str(tmp_path), "step_00000001", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["leaves"][sorted(manifest["leaves"])[0]]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointVerifyError, match="missing from the"):
        mgr.restore(ff, step=1)


def test_prune_never_deletes_newest_verified(tmp_path):
    ff = _model()
    mgr = LocalCheckpointManager(str(tmp_path / "p"), max_to_keep=2)
    mgr.save(ff, step=1)
    for s in (2, 3, 4):  # newer steps of an older writer: never verified
        shutil.copytree(mgr._path(1), mgr._path(s))
        os.remove(os.path.join(mgr._path(s), "manifest.json"))
    mgr._prune()
    steps = mgr.all_steps()
    assert 1 in steps and steps[-2:] == [3, 4]
    assert mgr.latest_verified_step() == 1


def test_async_write_failure_surfaces_at_drain(tmp_path, monkeypatch):
    ff = _model()
    mgr = LocalCheckpointManager(str(tmp_path / "f"))
    monkeypatch.setattr(
        mgr, "_write_and_publish",
        lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    mgr.save(ff, step=1, wait=False)
    failures = mgr.drain()
    assert len(failures) == 1 and failures[0][0] == 1
    assert isinstance(failures[0][1], OSError)
    assert mgr.latest_step() is None
    mgr.close()


def test_failed_sync_save_raises(tmp_path, monkeypatch):
    ff = _model()
    mgr = LocalCheckpointManager(str(tmp_path / "s"))
    monkeypatch.setattr(
        mgr, "_verify_dir",
        lambda *a, **k: (_ for _ in ()).throw(CheckpointVerifyError("bad")))
    with pytest.raises(CheckpointVerifyError):
        mgr.save(ff, step=1)
    assert mgr.all_steps() == [] and mgr.latest_verified_step() is None
    assert not [n for n in os.listdir(mgr.directory)
                if n.startswith(".tmp-")]


def test_async_save_backpressure_bounds_queue(tmp_path, monkeypatch):
    ff = _model()
    mgr = LocalCheckpointManager(str(tmp_path / "bp"))
    mgr.MAX_PENDING_SAVES = 1
    real_write = mgr._write_and_publish

    def slow_write(*a, **k):
        time.sleep(0.15)
        return real_write(*a, **k)

    monkeypatch.setattr(mgr, "_write_and_publish", slow_write)
    mgr.save(ff, step=1, wait=False)
    t0 = time.perf_counter()
    mgr.save(ff, step=2, wait=False)  # the backlog is at the cap: waits
    assert time.perf_counter() - t0 > 0.1
    assert mgr._writer_obj().queue_depth <= 1
    assert mgr.drain() == []
    assert mgr.latest_verified_step() == 2
    mgr.close()


# -- restore-time layout validation --------------------------------------------

@pytest.mark.parametrize("kind", ["local", "dcp"])
def test_compatibility_error_names_mismatched_fields(tmp_path, kind):
    cls = LocalCheckpointManager if kind == "local" else CheckpointManager
    mgr = cls(str(tmp_path / "c"))
    mgr.save(_model(hidden=32), step=1)
    ff64 = _model(hidden=64)
    with pytest.raises(CheckpointCompatibilityError) as ei:
        mgr.restore(ff64, step=1)
    msg = str(ei.value)
    assert "incompatible" in msg and "dense_0" in msg and "shape" in msg
    assert "['opt_state']" not in msg  # plain SGD keeps no slot
    assert len(ei.value.mismatches) == 3  # dense_0.kernel, bias, dense_1
    if kind == "local":
        with pytest.raises(CheckpointCompatibilityError):
            mgr.restore(ff64)  # every step is incompatible
    adam = _model(hidden=32, opt=P.AdamOptimizer())
    with pytest.raises(CheckpointCompatibilityError) as ei:
        mgr.restore(adam, step=1)
    assert any("['opt_state']['t']" in m for m in ei.value.mismatches)


# -- observability -------------------------------------------------------------

def test_ckpt_spans_and_counters(tmp_path):
    xs, ys = _data()
    ff = _model(telemetry=True)
    ff.fit(xs, ys, epochs=1, verbose=False)
    mgr = LocalCheckpointManager(str(tmp_path / "t"))
    mgr.save(ff, step=1, wait=True)
    mgr.save(ff, step=2, wait=False)
    assert mgr.drain() == []
    begins = [e for e in ff.telemetry.tracer.events if e["ph"] == "B"]
    names = [e["name"] for e in begins]
    assert names.count("checkpoint_write") == 2
    assert names.count("snapshot") == 2
    assert names.count("flush") == 2  # inline, and on the writer's thread
    flush_tids = {e["tid"] for e in begins if e["name"] == "flush"}
    assert len(flush_tids) == 2
    reg = ff.telemetry.metrics
    hist = reg.histogram("resilience/ckpt_write_latency_s")
    assert hist.count == 2 and hist.sum > 0
    assert reg.gauge("resilience/ckpt_queue_depth").value == 0
    assert reg.gauge("resilience/ckpt_bytes").value > 0
    mgr.close()


# -- the watchdog and the step-health check ---------------------------------------

def test_watchdog_unit():
    wd = StepWatchdog(0.05)
    assert wd.enabled
    with pytest.raises(HungStepTimeout) as ei:
        wd.sync(lambda: time.sleep(5.0), step=7)
    assert ei.value.step == 7
    assert wd.sync(lambda: 42, step=8) == 42
    with pytest.raises(ValueError, match="boom"):
        wd.sync(lambda: (_ for _ in ()).throw(ValueError("boom")))
    off = StepWatchdog(0.0)
    assert not off.enabled and off.sync(lambda: "inline") == "inline"
    with pytest.raises(ValueError):
        StepWatchdog(-1.0)


def test_watchdog_recovers_after_timeout():
    wd = StepWatchdog(0.05)
    assert wd.sync(lambda: 1) == 1
    worker = wd._worker
    assert wd.sync(lambda: 2) == 2
    assert wd._worker is worker  # one worker serves every sync
    with pytest.raises(HungStepTimeout):
        wd.sync(lambda: time.sleep(5.0))
    assert wd.sync(lambda: 3) == 3
    assert wd._worker is not worker


def test_check_step_health_watchdog_times_out():
    class SlowLoss:
        def __float__(self):
            time.sleep(5.0)
            return 1.0

    t0 = time.perf_counter()
    with pytest.raises(HungStepTimeout):
        check_step_health({"loss": SlowLoss()}, step=3,
                          watchdog=StepWatchdog(0.05))
    assert time.perf_counter() - t0 < 1.0
    check_step_health({"loss": torch.tensor(1.0)}, step=3,
                      watchdog=StepWatchdog(5.0))


@pytest.mark.parametrize("policy", ["raise", "skip_step", "restore", "off",
                                    None])
def test_nan_loss_fault_under_each_policy(policy):
    """A NAN_LOSS fault poisons one step's batch; the real step's loss is
    NaN, and check_step_health raises NonFiniteLossError under every
    policy but "off" (and None), which read nothing."""
    xs, ys = _data(32)
    ff = _model()
    plan = FaultPlan.single(1, FaultKind.NAN_LOSS)
    for step in range(2):
        batch = plan.corrupt_batch(step, {"x": xs[16 * step:16 * step + 16]})
        m = ff.train_step(batch, ys[16 * step:16 * step + 16])
        if step == 0 or policy in ("off", None):
            check_step_health(m, step=step, nan_policy=policy,
                              watchdog=StepWatchdog(5.0))
            continue
        with pytest.raises(NonFiniteLossError) as ei:
            check_step_health(m, step=step, nan_policy=policy,
                              watchdog=StepWatchdog(5.0))
        assert ei.value.step == 1 and np.isnan(ei.value.loss)
    assert plan.remaining() == []


def test_retry_policy_matches_the_reference():
    for kw in ({}, {"seed": 3, "jitter": 0.25}, {"jitter": 0.0},
               {"base_backoff": 1.0, "max_backoff": 3.0}):
        got, want = RetryPolicy(**kw), r_retry.RetryPolicy(**kw)
        assert [got.backoff(a) for a in range(1, 8)] == \
            [want.backoff(a) for a in range(1, 8)]
        assert [got.admits(n) for n in range(6)] == \
            [want.admits(n) for n in range(6)]
    for bad in ({"max_restarts": -1}, {"jitter": 1.0}, {"multiplier": 0.5},
                {"base_backoff": -1.0}):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)
        with pytest.raises(ValueError):
            r_retry.RetryPolicy(**bad)


# -- gloo groups: pipelines and another mesh --------------------------------------

# partials of the port's classes: a spawned rank unpickles them without
# importing this module (which imports the reference)
_sgd = functools.partial(P.SGDOptimizer, lr=0.05, momentum=0.9)
_adam = functools.partial(P.AdamOptimizer, alpha=0.01)


def _pp_strategy(dp, pp, mb):
    s = Strategy(mesh_axes={"data": dp, "pipe": pp},
                 pipeline={"degree": pp, "num_microbatches": mb,
                           "axis": "pipe", "dp_axis": "data"})
    s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": dp})]
    return s


def _one(build, opt, seed=0, **cfg):
    ff = P.FFModel(P.FFConfig(device="cpu", **cfg))
    build(ff)
    ff.compile(optimizer=opt(), seed=seed)
    return ff


def _batches(n, in_dim, classes, seed):
    rng = np.random.RandomState(seed)
    return [({"x": rng.randn(16, in_dim).astype(np.float32)},
             rng.randint(0, classes, 16).astype(np.int32)) for _ in range(n)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    d = tmp_path_factory.mktemp("groups")
    out = {"dir": d}
    # a per-op checkpoint (one process) for the pipeline to restore
    per_op = _one(R.blocks, _sgd)
    for inputs, labels in _batches(2, 8, 4, seed=1):
        per_op.train_step(inputs, labels)
    LocalCheckpointManager(str(d / "per_op")).save(per_op, 2)
    out["per_op"] = R._global_state(per_op)
    init = _one(R.mlp_zero, _adam).get_weights()
    zb = _batches(4, 32, 7, seed=2)
    dirs4 = {"local": str(d / "z_local"), "dcp": str(d / "z_dcp")}
    cases = [
        (R.ckpt_case, (R.blocks, _pp_strategy(2, 2, 4), _sgd, []),
         {"restore": ("local", str(d / "per_op"))}),
        (R.ckpt_case, (R.blocks, _pp_strategy(2, 2, 4), _sgd,
                       _batches(2, 8, 4, seed=3)),
         {"save_at": 2, "dirs": {"local": str(d / "pp")}}),
        (R.ckpt_case, (R.mlp_zero, data_parallel_strategy(4), _adam, zb),
         {"cfg": {"zero_stage": 2}, "weights": init, "save_at": 2,
          "dirs": dirs4}),
    ]
    out["four"] = R.run_group(R.run_cases, 4, cases, timeout=150)
    out["two"] = R.run_group(R.run_cases, 2, [
        (R.ckpt_case, (R.mlp_zero, data_parallel_strategy(2), _adam, zb[2:]),
         {"cfg": {"zero_stage": 1}, "restore": (kind, path)})
        for kind, path in sorted(dirs4.items())], timeout=150)
    out["zero_batches"] = zb
    return out


def _state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _unstack(stacked, layers=4):
    """A pipeline state's `__pipeline__` leaves as per-op blk<i> leaves."""
    out = {}
    for key, arr in stacked.items():
        if "['__pipeline__']" not in key:
            out[key] = arr
            continue
        head, name = key.split("['__pipeline__']")
        j, w = name[2:-2].split(".")
        assert j == "0"
        for i in range(layers):
            out[f"{head}['blk{i}']['{w}']"] = arr[i]
    return out


def test_per_op_checkpoint_restores_onto_a_pipeline(groups):
    got = groups["four"][0][0]
    assert got["restored_step"] == 2
    assert any("['__pipeline__']" in k for k in got["restored"])
    _state_equal(_unstack(got["restored"]), groups["per_op"])


def test_pipeline_checkpoint_restores_onto_per_op_ops(groups):
    saved = groups["four"][0][1]["saved"]
    ff = _one(R.blocks, _sgd, seed=5)
    assert LocalCheckpointManager(str(groups["dir"] / "pp")).restore(ff) == 2
    _state_equal(R._global_state(ff), _unstack(saved))


def test_zero2_checkpoint_counts_its_fallback_leaf(groups):
    # head.bias (7) has no dim the data axis of 4 divides
    assert groups["four"][0][2]["fallback"] == 1


@pytest.mark.parametrize("kind", ["dcp", "local"])
@pytest.mark.parametrize("ranks", [2, 1])
def test_zero2_checkpoint_restores_onto_another_mesh(groups, ranks, kind):
    """Saved under data 4 at ZeRO-2 after 2 of 4 Adam steps: restored on
    2 ranks at ZeRO-1 and on one process, every leaf 0 apart from the
    saved global state; the 2 steps after it then land within the ZeRO
    tests' tolerances of the data-4 run's."""
    four = groups["four"][0][2]
    if ranks == 2:
        got = groups["two"][0][["dcp", "local"].index(kind)]
    else:
        ff = _one(R.mlp_zero, _adam, seed=9)
        cls = LocalCheckpointManager if kind == "local" else \
            CheckpointManager
        got = {"restored_step": cls(str(groups["dir"] / f"z_{kind}"))
               .restore(ff), "restored": R._global_state(ff), "losses": []}
        for inputs, labels in groups["zero_batches"][2:]:
            got["losses"].append(float(ff.train_step(inputs,
                                                     labels)["loss"]))
        got["final"] = R._global_state(ff)
    assert got["restored_step"] == 2
    _state_equal(got["restored"], four["saved"])
    np.testing.assert_allclose(got["losses"], four["losses"][2:], **TOL)
    for k, v in four["final"].items():
        np.testing.assert_allclose(got["final"][k], v, **ADAM_TOL,
                                   err_msg=k)
