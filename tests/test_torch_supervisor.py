"""The port's training supervisor (flexflow_tpu_torch/resilience/
supervisor.py, FFModel.fit_resilient) against flexflow_tpu's:
tests/test_resilience.py's non-slow cases, the supervisor cases of
tests/test_durability.py, tests/test_strategy_store.py::
test_supervisor_elastic_consults_store and tests/test_telemetry.py::
test_supervisor_emits_checkpoint_and_restart_spans.

Each scenario runs in both packages from the same weights (the port's,
set into the reference), the same data and the same fault plan (one
JSON, or the same signal at the same step): the reports' final_step,
counters and per-step losses, and the final weights, agree within 1e-5
(float32, SGD and Adam alike: rtol 1e-5, atol 1e-5), and a crash-restored
run of the port is 0 apart from the port's uninterrupted one.  The
reference runs on one virtual device, as the port's single process does;
its 8 -> 4 device losses become, in the port, a gloo group of 4 ranks
(tests/torch_dist_ranks.py) losing 2, held against the reference on 4
of its virtual devices losing 2.
"""
import functools
import json
import logging
import os
import signal
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as G  # noqa: E402

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu import resilience as r_res  # noqa: E402
from flexflow_tpu.executor import NonFiniteLossError as RNonFinite  # noqa: E402
from flexflow_tpu_torch import resilience as p_res  # noqa: E402
from flexflow_tpu_torch.checkpoint import \
    LocalCheckpointManager  # noqa: E402
from flexflow_tpu_torch.executor import NonFiniteLossError  # noqa: E402
from flexflow_tpu_torch.resilience import (Fault, FaultKind,  # noqa: E402
                                           FaultPlan, RestartBudgetExhausted,
                                           RetryPolicy, StepFault,
                                           TrainingSupervisor)

NO_SLEEP = lambda s: None  # noqa: E731
TOL = dict(rtol=1e-5, atol=1e-5)
# the supervisor's own counters (the reference's dict): compared exactly,
# but for the seconds
COUNTERS = ("steps_run", "restarts", "retries", "lost_steps",
            "skipped_steps", "checkpoints", "checkpoint_failures",
            "device_losses", "hung_steps", "emergency_saves", "re_searches",
            "re_search_store_hits")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR", str(tmp_path / "pc"))
    monkeypatch.setenv("FLEXFLOW_TPU_CACHE_DIR", str(tmp_path / "rc"))
    for var in ("FLEXFLOW_TPU_TORCH_STORE_DIR", "FLEXFLOW_TPU_STORE_DIR"):
        monkeypatch.delenv(var, raising=False)


def _sgd(pkg=P):
    return pkg.SGDOptimizer(lr=0.05)


def _adam(pkg=P):
    return pkg.AdamOptimizer(alpha=0.01)


def _port(seed=0, opt=None, **cfg):
    ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu", seed=seed, **cfg))
    G.sup_mlp(ff)
    ff.compile(optimizer=opt or _sgd(),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], seed=seed)
    return ff


def _ref(weights, devices=None, opt=None, **cfg):
    devices = devices or jax.devices("cpu")[:1]
    ff = R.FFModel(R.FFConfig(batch_size=16, num_devices=len(devices),
                              **cfg))
    G.sup_mlp(ff)
    ff.compile(optimizer=opt or _sgd(R),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], devices=devices)
    ff.set_weights(weights)
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


def _weights_close(got, want):
    assert sorted(got) == sorted(want)
    for op in want:
        for k in want[op]:
            np.testing.assert_allclose(got[op][k], np.asarray(want[op][k]),
                                       err_msg=f"{op}.{k}", **TOL)


def _same_report(p, r):
    assert p.final_step == r.final_step
    assert p.preempted == r.preempted
    assert {k: p.counters[k] for k in COUNTERS} == \
        {k: r.counters[k] for k in COUNTERS}
    np.testing.assert_allclose(p.losses, r.losses, **TOL)


def _plans(*faults):
    """The same fault plan in both packages (through its JSON)."""
    text = FaultPlan(faults).to_json()
    return FaultPlan.from_json(text), r_res.FaultPlan.from_json(text)


def _both(tmp_path, plans, num_steps, seed=0, data=None, port_cfg=None,
          ref_cfg=None, opt=(_sgd, _sgd), **sup):
    """One supervised run of each package from the port's weights:
    (port model, port report, reference model, reference report)."""
    xs, ys = data or _data()
    p = _port(seed, opt[0](), **(port_cfg or {}))
    r = _ref(p.get_weights(), opt=opt[1](R), **(ref_cfg or port_cfg or {}))
    rp = TrainingSupervisor(p, str(tmp_path / "p"), fault_plan=plans[0],
                            sleep=NO_SLEEP, **sup).run(xs, ys, num_steps)
    rr = r_res.TrainingSupervisor(r, str(tmp_path / "r"),
                                  fault_plan=plans[1], sleep=NO_SLEEP,
                                  **sup).run(xs, ys, num_steps)
    return p, rp, r, rr


def _clean(tmp_path, num_steps, seed=0, data=None, opt=_sgd, **sup):
    xs, ys = data or _data()
    ff = _port(seed, opt())
    rep = TrainingSupervisor(ff, str(tmp_path / "clean"), sleep=NO_SLEEP,
                             **sup).run(xs, ys, num_steps)
    return ff, rep


def _sigterm_at(plan, step, signum=signal.SIGTERM):
    orig = plan.check_step

    def check(s):
        if s == step:
            signal.raise_signal(signum)
        orig(s)

    plan.check_step = check
    return plan


# -- fault plan / retry policy -------------------------------------------

def test_fault_plan_seeded_deterministic_and_fires_once():
    a = FaultPlan.seeded(seed=3, num_steps=20, count=3)
    ref = r_res.FaultPlan.seeded(seed=3, num_steps=20, count=3)
    assert [(f.step, f.kind.value) for f in a.faults] == \
        [(f.step, f.kind.value) for f in ref.faults]
    assert len({f.step for f in a.faults}) == 3
    step = a.faults[0].step
    with pytest.raises(StepFault):
        a.check_step(step)
    a.check_step(step)  # fired: silent on the replay after a restore
    assert len(a.remaining()) == 2


def test_fault_plan_json_round_trip():
    plan = FaultPlan([
        Fault(step=4, kind=FaultKind.DEVICE_LOSS, payload={"survivors": 4}),
        Fault(step=7, kind=FaultKind.CHECKPOINT_WRITE)])
    back = FaultPlan.from_json(plan.to_json())
    assert [(f.step, f.kind, f.payload) for f in back.faults] == [
        (f.step, f.kind, f.payload) for f in plan.faults]
    ref = r_res.FaultPlan.from_json(plan.to_json())
    assert ref.to_json() == plan.to_json()


def test_fault_plan_corrupt_batch_poisons_floats_once():
    plan = FaultPlan.single(2, FaultKind.NAN_LOSS)
    inputs = {"x": np.ones((4, 3), np.float32),
              "idx": np.arange(4, dtype=np.int32)}
    out = plan.corrupt_batch(2, inputs)
    assert np.isnan(out["x"]).all()
    np.testing.assert_array_equal(out["idx"], inputs["idx"])
    assert not np.isnan(plan.corrupt_batch(2, inputs)["x"]).any()


def test_retry_policy_backoff_deterministic_capped():
    kw = dict(max_restarts=3, base_backoff=0.5, multiplier=2.0,
              max_backoff=2.0, jitter=0.25, seed=7)
    p, r = RetryPolicy(**kw), r_res.RetryPolicy(**kw)
    seq = [p.backoff(i) for i in (1, 2, 3, 6)]
    assert seq == [r.backoff(i) for i in (1, 2, 3, 6)]
    assert seq[3] <= 2.0 * 1.25
    assert p.admits(3) and not p.admits(4)
    with pytest.raises(ValueError):
        RetryPolicy(max_restarts=-1)


# -- crash-restore -----------------------------------------------------------

@pytest.mark.parametrize("kind", [FaultKind.STEP_EXCEPTION,
                                  FaultKind.HOST_PREEMPTION])
def test_crash_restore_bit_identical(tmp_path, kind):
    """A crash at step 5 restores step 4 and replays: 0 apart from the
    uninterrupted port run, and the reference's run alike."""
    clean, rc = _clean(tmp_path, 7, seed=11, checkpoint_every=2)
    p, rp, r, rr = _both(tmp_path, _plans(Fault(5, kind)), 7, seed=11,
                         checkpoint_every=2)
    _same_report(rp, rr)
    assert rp.final_step == 7 and rp.counters["restarts"] == 1
    assert rp.counters["retries"] == 1 and rp.counters["lost_steps"] == 1
    assert rp.losses == rc.losses  # a replay, not a drift
    _weights_equal(p.get_weights(), clean.get_weights())
    assert torch.equal(p._generator.get_state(), clean._generator.get_state())
    _weights_close(p.get_weights(), r.get_weights())
    assert [e["kind"] for e in rp.recoveries] == [
        "StepFault" if kind == FaultKind.STEP_EXCEPTION else
        "PreemptionFault"]


def test_seeded_fault_plan_run_bit_identical(tmp_path):
    data = _data(160)
    clean, _ = _clean(tmp_path, 10, seed=21, data=data, checkpoint_every=3)
    kinds = (FaultKind.STEP_EXCEPTION, FaultKind.HOST_PREEMPTION)
    plan = FaultPlan.seeded(seed=123, num_steps=10, count=2, kinds=kinds)
    plans = (plan, r_res.FaultPlan.from_json(plan.to_json()))
    p, rp, r, rr = _both(tmp_path, plans, 10, seed=21, data=data,
                         checkpoint_every=3)
    _same_report(rp, rr)
    assert rp.final_step == 10 and rp.counters["restarts"] == 2
    assert not plan.remaining()
    _weights_equal(p.get_weights(), clean.get_weights())
    _weights_close(p.get_weights(), r.get_weights())


def test_restart_budget_exhausted(tmp_path):
    xs, ys = _data()
    budget = dict(max_restarts=2, base_backoff=0.0)
    faults = [Fault(s, FaultKind.STEP_EXCEPTION) for s in (2, 3, 4)]
    plans = _plans(*faults)
    p = _port()
    sup = TrainingSupervisor(p, str(tmp_path / "p"), checkpoint_every=2,
                             fault_plan=plans[0], retry=RetryPolicy(**budget),
                             sleep=NO_SLEEP)
    with pytest.raises(RestartBudgetExhausted):
        sup.run(xs, ys, num_steps=8)
    ref = r_res.TrainingSupervisor(
        _ref(p.get_weights()), str(tmp_path / "r"), checkpoint_every=2,
        fault_plan=plans[1], retry=r_res.RetryPolicy(**budget),
        sleep=NO_SLEEP)
    with pytest.raises(r_res.RestartBudgetExhausted):
        ref.run(xs, ys, num_steps=8)
    assert sup.counters["retries"] == ref.counters["retries"] == 3


def test_backoff_delays_follow_policy(tmp_path):
    kw = dict(max_restarts=5, base_backoff=0.5, jitter=0.25, seed=3)
    delays = {"p": [], "r": []}
    xs, ys = _data()
    plans = _plans(*[Fault(s, FaultKind.STEP_EXCEPTION) for s in (2, 3)])
    p = _port()
    rep = TrainingSupervisor(p, str(tmp_path / "p"), checkpoint_every=2,
                             fault_plan=plans[0], retry=RetryPolicy(**kw),
                             sleep=delays["p"].append).run(xs, ys, 6)
    r_res.TrainingSupervisor(_ref(p.get_weights()), str(tmp_path / "r"),
                             checkpoint_every=2, fault_plan=plans[1],
                             retry=r_res.RetryPolicy(**kw),
                             sleep=delays["r"].append).run(xs, ys, 6)
    assert rep.final_step == 6
    policy = RetryPolicy(**kw)
    assert delays["p"] == [policy.backoff(1), policy.backoff(2)]
    assert delays["p"] == delays["r"]


@pytest.mark.parametrize("target", ["local", "verify"])
def test_checkpoint_write_fault_is_survived(tmp_path, monkeypatch, target):
    """A failed periodic save costs that save only: an injected
    CHECKPOINT_WRITE at step 3 (the save at 4 fails, the one at 6 lands),
    or a crc miss at the second save's write-time verification (the
    reference's test_sync_verify_failure_is_survivable)."""
    if target == "local":
        p, rp, r, rr = _both(tmp_path,
                             _plans(Fault(3, FaultKind.CHECKPOINT_WRITE)), 6,
                             checkpoint_every=2)
        assert 4 not in LocalCheckpointManager(str(tmp_path / "p")).all_steps()
    else:
        from flexflow_tpu import checkpoint as r_ckpt

        def flaky(pkg):
            real, calls = pkg.LocalCheckpointManager._verify_dir, {"n": 0}

            def verify(path, manifest=None):
                calls["n"] += 1
                if calls["n"] == 2:  # the second save's verification
                    raise pkg.CheckpointVerifyError("injected crc mismatch")
                return real(path, manifest)
            monkeypatch.setattr(pkg.LocalCheckpointManager, "_verify_dir",
                                staticmethod(verify))

        from flexflow_tpu_torch import checkpoint as p_ckpt

        flaky(p_ckpt)
        flaky(r_ckpt)
        p, rp, r, rr = _both(tmp_path, _plans(), 6, checkpoint_every=2)
    _same_report(rp, rr)
    assert rp.final_step == 6 and rp.counters["checkpoint_failures"] == 1
    assert rp.counters["restarts"] == 0
    assert LocalCheckpointManager(str(tmp_path / "p")).latest_step() == 6
    _weights_close(p.get_weights(), r.get_weights())


# -- nan_policy ----------------------------------------------------------------

def test_nan_policy_raise_propagates(tmp_path):
    xs, ys = _data()
    plans = _plans(Fault(3, FaultKind.NAN_LOSS))
    p = _port()
    with pytest.raises(NonFiniteLossError):
        TrainingSupervisor(p, str(tmp_path / "p"), checkpoint_every=2,
                           fault_plan=plans[0], sleep=NO_SLEEP).run(xs, ys, 6)
    with pytest.raises(RNonFinite):
        r_res.TrainingSupervisor(_ref(p.get_weights()), str(tmp_path / "r"),
                                 checkpoint_every=2, fault_plan=plans[1],
                                 sleep=NO_SLEEP).run(xs, ys, 6)


def test_nan_policy_skip_step_counts_and_continues(tmp_path):
    p, rp, r, rr = _both(tmp_path, _plans(Fault(3, FaultKind.NAN_LOSS)), 6,
                         port_cfg={"nan_policy": "skip_step"},
                         checkpoint_every=2)
    _same_report(rp, rr)
    assert rp.counters["skipped_steps"] == 1 and rp.counters["restarts"] == 0
    assert len(rp.losses) == 5 and all(np.isfinite(rp.losses))
    _weights_close(p.get_weights(), r.get_weights())


def test_skip_step_rollback_keeps_every_tensor_in_place(tmp_path):
    """skip_step's rollback writes into the live tensors (a captured
    step replays on them): the same tensors and storage before and after,
    and the state equal to the step's start."""
    xs, ys = _data()
    ff = _port(opt=P.AdamOptimizer(alpha=0.01))
    sup = TrainingSupervisor(ff, str(tmp_path), nan_policy="skip_step",
                             sleep=NO_SLEEP)
    from flexflow_tpu_torch.checkpoint import _state_leaves, state_arrays

    ptrs = [(id(t), t.data_ptr()) for _, t, _, _ in _state_leaves(ff)]
    before = state_arrays(ff)
    snap = sup._snapshot()
    ff.train_step({"x": xs[:16]}, ys[:16])
    sup._rollback(snap)
    assert [(id(t), t.data_ptr()) for _, t, _, _ in _state_leaves(ff)] == ptrs
    after = state_arrays(ff)
    assert sorted(after) == sorted(before)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_nan_policy_restore_recovers_bit_identical(tmp_path):
    clean, rc = _clean(tmp_path, 6, seed=5, checkpoint_every=2)
    p, rp, r, rr = _both(tmp_path, _plans(Fault(3, FaultKind.NAN_LOSS)), 6,
                         seed=5, port_cfg={"nan_policy": "restore"},
                         checkpoint_every=2)
    _same_report(rp, rr)
    assert rp.counters["restarts"] == 1 and rp.losses == rc.losses
    _weights_equal(p.get_weights(), clean.get_weights())
    _weights_close(p.get_weights(), r.get_weights())


def test_skip_then_restore_losses_stay_aligned(tmp_path):
    cfg = {"nan_policy": "skip_step"}
    xs, ys = _data()
    clean = _port(13, nan_policy="skip_step")
    rc = TrainingSupervisor(
        clean, str(tmp_path / "clean"), checkpoint_every=2,
        fault_plan=FaultPlan.single(2, FaultKind.NAN_LOSS),
        sleep=NO_SLEEP).run(xs, ys, 7)
    assert len(rc.losses) == 6
    p, rp, r, rr = _both(tmp_path, _plans(Fault(2, FaultKind.NAN_LOSS),
                                          Fault(5, FaultKind.STEP_EXCEPTION)),
                         7, seed=13, port_cfg=cfg, checkpoint_every=2)
    _same_report(rp, rr)
    assert rp.counters["skipped_steps"] == 1 and rp.counters["restarts"] == 1
    assert rp.losses == rc.losses
    _weights_equal(p.get_weights(), clean.get_weights())
    _weights_close(p.get_weights(), r.get_weights())


# -- async saves and the hung step (tests/test_durability.py) ---------------

def test_supervisor_async_crash_restore_bit_identical(tmp_path):
    clean, rc = _clean(tmp_path, 7, seed=21, checkpoint_every=2)
    cfg = {"checkpoint_async": True}
    p, rp, r, rr = _both(tmp_path, _plans(Fault(5, FaultKind.STEP_EXCEPTION)),
                         7, seed=21, port_cfg=cfg, checkpoint_every=2)
    _same_report(rp, rr)
    assert rp.counters["restarts"] == 1 and rp.losses == rc.losses
    _weights_equal(p.get_weights(), clean.get_weights())
    _weights_close(p.get_weights(), r.get_weights())
    assert LocalCheckpointManager(
        str(tmp_path / "p")).latest_verified_step() == 6


def test_hung_step_fault_recovers_bit_identical(tmp_path):
    """A HungStepFault: re-search, recompile (a fresh step) and restore,
    0 apart from the uninterrupted run."""
    clean, rc = _clean(tmp_path, 7, seed=11, checkpoint_every=2)
    p, rp, r, rr = _both(tmp_path, _plans(Fault(5, FaultKind.HUNG_STEP)), 7,
                         seed=11, checkpoint_every=2, step_timeout=30.0)
    _same_report(rp, rr)
    assert rp.counters["hung_steps"] == 1 and rp.counters["re_searches"] == 1
    assert rp.counters["device_losses"] == 0
    assert rp.losses == rc.losses
    _weights_equal(p.get_weights(), clean.get_weights())
    _weights_close(p.get_weights(), r.get_weights())
    assert "recompile_s" in rp.recoveries[0]


def test_hung_step_exhausts_restart_budget(tmp_path):
    xs, ys = _data()
    budget = dict(max_restarts=1, base_backoff=0.0)
    plans = _plans(*[Fault(s, FaultKind.HUNG_STEP) for s in (2, 3)])
    p = _port()
    sup = TrainingSupervisor(p, str(tmp_path / "p"), checkpoint_every=2,
                             fault_plan=plans[0], retry=RetryPolicy(**budget),
                             sleep=NO_SLEEP)
    with pytest.raises(RestartBudgetExhausted):
        sup.run(xs, ys, num_steps=6)
    ref = r_res.TrainingSupervisor(
        _ref(p.get_weights()), str(tmp_path / "r"), checkpoint_every=2,
        fault_plan=plans[1], retry=r_res.RetryPolicy(**budget),
        sleep=NO_SLEEP)
    with pytest.raises(r_res.RestartBudgetExhausted):
        ref.run(xs, ys, num_steps=6)
    assert sup.counters["hung_steps"] == ref.counters["hung_steps"] == 2


# -- preemption grace ------------------------------------------------------------

def test_sigterm_emergency_save_round_trip(tmp_path):
    """SIGTERM during step 3: the step finishes, the emergency checkpoint
    lands at 4, and a fresh model resumed from it ends 0 apart from the
    uninterrupted run; the reference does the same."""
    xs, ys = _data()
    clean, rc = _clean(tmp_path, 7, seed=3, checkpoint_every=100)
    p = _port(3)
    r = _ref(p.get_weights())
    rp = TrainingSupervisor(p, str(tmp_path / "p"), checkpoint_every=100,
                            fault_plan=_sigterm_at(FaultPlan(), 3),
                            sleep=NO_SLEEP).run(xs, ys, 7)
    rr = r_res.TrainingSupervisor(
        r, str(tmp_path / "r"), checkpoint_every=100,
        fault_plan=_sigterm_at(r_res.FaultPlan(), 3),
        sleep=NO_SLEEP).run(xs, ys, 7)
    _same_report(rp, rr)
    assert rp.preempted == "SIGTERM" and rp.final_step == 4
    assert rp.counters["emergency_saves"] == 1
    assert LocalCheckpointManager(
        str(tmp_path / "p")).latest_verified_step() == 4
    assert signal.getsignal(signal.SIGTERM) is not None
    p2 = _port(99)  # another init, overwritten by the resume
    rp2 = TrainingSupervisor(p2, str(tmp_path / "p"), checkpoint_every=100,
                             sleep=NO_SLEEP).run(xs, ys, 7, resume=True)
    assert rp2.final_step == 7 and rp2.preempted is None
    _weights_equal(p2.get_weights(), clean.get_weights())
    assert rp2.losses == rc.losses[4:]


def test_sigterm_during_final_step_still_checkpoints(tmp_path):
    xs, ys = _data()
    ff = _port()
    sup = TrainingSupervisor(ff, str(tmp_path), checkpoint_every=100,
                             fault_plan=_sigterm_at(FaultPlan(), 4),
                             sleep=NO_SLEEP)
    rep = sup.run(xs, ys, num_steps=5)
    assert rep.preempted == "SIGTERM" and rep.final_step == 5
    assert rep.counters["emergency_saves"] == 1
    assert sup.manager.latest_verified_step() == 5


def test_sigint_grace_and_async_drain(tmp_path):
    xs, ys = _data()
    ff = _port(checkpoint_async=True)
    sup = TrainingSupervisor(
        ff, str(tmp_path), checkpoint_every=2,
        fault_plan=_sigterm_at(FaultPlan(), 3, signal.SIGINT),
        sleep=NO_SLEEP)
    rep = sup.run(xs, ys, num_steps=8)
    assert rep.preempted == "SIGINT" and rep.final_step == 4
    assert rep.counters["emergency_saves"] == 1
    assert sup.manager.latest_verified_step() == 4
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler


def test_sigterm_host_loss_resumes_from_the_remote_tier(tmp_path):
    """The emergency step is mirrored; with the directory gone (a lost
    host), resume=True restores it from the remote tier and the run ends
    0 apart from the uninterrupted one."""
    import shutil

    xs, ys = _data()
    clean, rc = _clean(tmp_path, 7, seed=3, checkpoint_every=100)
    remote = f"file://{tmp_path}/remote"
    p = _port(3, remote_store=remote)
    rep = TrainingSupervisor(p, str(tmp_path / "d"), checkpoint_every=100,
                             fault_plan=_sigterm_at(FaultPlan(), 3),
                             sleep=NO_SLEEP).run(xs, ys, 7)
    assert rep.final_step == 4 and rep.counters["offload_uploads"] >= 1
    shutil.rmtree(tmp_path / "d")
    p2 = _port(99, remote_store=remote)
    rep2 = TrainingSupervisor(p2, str(tmp_path / "d"), checkpoint_every=100,
                              sleep=NO_SLEEP).run(xs, ys, 7, resume=True)
    assert rep2.final_step == 7
    assert p2.telemetry.metrics.counter(
        "resilience/offload_remote_restores").value == 1
    _weights_equal(p2.get_weights(), clean.get_weights())


# -- the device loss, the ZeRO-1 emergency save and the barrier on a group --

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """tests/torch_dist_ranks.py supervisor_group on 4 gloo ranks, the
    strategy store seeded with data 4 and data 2 (the re-search's key),
    and the reference's runs of the same cases on 4 virtual devices."""
    from flexflow_tpu_torch.store import cached_search
    from flexflow_tpu_torch.strategy import data_parallel_strategy

    root = str(tmp_path_factory.mktemp("sup_group"))
    os.environ["FLEXFLOW_TPU_TORCH_CACHE_DIR"] = os.path.join(root, "pc")
    xs, ys = _data(128, seed=4)
    weights = _port(4).get_weights()
    seed_cfg = P.FFConfig(device="cpu", batch_size=16, search_budget=8,
                          strategy_store=f"{root}/store")
    for n in (4, 2):
        ff = P.FFModel(seed_cfg)
        G.sup_mlp(ff)
        cached_search(ff, n, functools.partial(data_parallel_strategy, n))
    loss_plan = FaultPlan.single(4, FaultKind.DEVICE_LOSS,
                                 survivors=2).to_json()
    ranks = G.run_group(G.supervisor_group, 4, root, weights, xs, ys,
                        functools.partial(P.SGDOptimizer, lr=0.05),
                        functools.partial(P.AdamOptimizer, alpha=0.01),
                        loss_plan, timeout=240.0)
    devs = jax.devices("cpu")[:4]
    # the reference: the device loss, and the ZeRO-1 emergency save
    r = _ref(weights, devices=devs)
    rsup = r_res.TrainingSupervisor(
        r, f"{root}/ref_loss", checkpoint_every=2,
        fault_plan=r_res.FaultPlan.from_json(loss_plan), sleep=NO_SLEEP)
    rloss = rsup.run(xs, ys, 6)
    rloss_w = r.get_weights()
    assert rsup.manager.restore(r, step=4) == 4
    rz = _ref(weights, devices=devs, opt=_adam(R),
              weight_update_sharding=True, checkpoint_async=True)
    rzero = r_res.TrainingSupervisor(
        rz, f"{root}/ref_z", checkpoint_every=100,
        fault_plan=_sigterm_at(r_res.FaultPlan(), 3),
        sleep=NO_SLEEP).run(xs, ys, 8)
    yield {"ranks": ranks, "root": root,
           "ref_loss": (rloss, rloss_w, r.get_weights()),
           "ref_zero1": (rzero, rz.get_weights())}
    os.environ.pop("FLEXFLOW_TPU_TORCH_CACHE_DIR", None)


def test_device_loss_elastic_resume_data_parallel(group):
    """4 -> 2 at step 4: ranks 2-3 leave, ranks 0-1 form a group of 2,
    take data 2 and restore step 4 (lost_steps 0), and finish the run
    as the reference does on 4 virtual devices losing 2."""
    rloss, rloss_w, _ = group["ref_loss"]
    ranks = [g["loss"] for g in group["ranks"]]
    for r in ranks[2:]:
        assert r["left_group"] and r["final_step"] == 4
        assert r["counters"]["device_losses"] == 1
    for i, r in enumerate(ranks[:2]):
        assert not r["left_group"] and r["world"] == 2
        assert r["rank_after"] == i and r["devices"] == 2
        assert r["final_step"] == rloss.final_step == 6
        # the port's re-search is the store's (the reference has none)
        same = [k for k in COUNTERS if k != "re_search_store_hits"]
        assert {k: r["counters"][k] for k in same} == \
            {k: rloss.counters[k] for k in same}
        np.testing.assert_allclose(r["losses"], rloss.losses, **TOL)
        _weights_close(r["weights"], rloss_w)
        rec = r["recoveries"][0]
        assert rec["kind"] == "device_loss" and rec["restored_step"] == 4
        assert rec["reform_s"] > 0
    assert ranks[0]["counters"]["lost_steps"] == 0
    _weights_equal(ranks[0]["weights"], ranks[1]["weights"])


def test_device_loss_carries_trained_state(group):
    """The step-4 checkpoint the survivors restored holds the state the
    4-rank run reached: the reference's step 4 within 1e-5."""
    _, _, ref_w4 = group["ref_loss"]
    for r in group["ranks"][:2]:
        _weights_close(r["loss"]["weights_at_4"], ref_w4)


def test_supervisor_elastic_consults_store(group):
    """The survivors' re-search for 2 devices is answered by the store
    (the key the test seeded): the restored strategy runs, and the store
    keeps its two entries."""
    for r in group["ranks"][:2]:
        loss = r["loss"]
        assert loss["counters"]["re_searches"] == 1
        assert loss["counters"]["re_search_store_hits"] == 1
        assert loss["store_hit"] is True
        assert json.loads(loss["strategy"])["mesh_axes"] == {"data": 2}
    d = os.path.join(group["root"], "store", "strategies")
    assert len([n for n in os.listdir(d) if not n.startswith(".tmp-")]) == 2


def test_sigterm_zero1_sharded_slots_restore(group):
    """ZeRO-1 under Adam on data 4, SIGTERM during step 3 on every rank:
    the emergency save at 4 (weights as the reference's, within 1e-5)
    restores onto the 2 survivors at ZeRO-1, every leaf 0 apart."""
    rzero, rz_w = group["ref_zero1"]
    ranks = group["ranks"]
    for r in ranks:
        z = r["zero1"]
        assert z["preempted"] == "SIGTERM"
        assert z["final_step"] == rzero.final_step == 4
        assert z["counters"]["emergency_saves"] == 1
        _weights_close(z["weights"], rz_w)
    saved = ranks[0]["zero1"]["state"]
    restored = ranks[0]["zero1_restored"]
    assert restored["step"] == 4 and restored["zero_stage"] == 1
    assert sorted(restored["state"]) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(restored["state"][k], saved[k],
                                      err_msg=k)


def test_preemption_barrier_agrees_on_the_max_step(group):
    """Ranks 0-2 signalled during step 2, rank 3 during step 3: the ranks
    post 3, 3, 3 and 4, agree on 4 through the blob-store barrier, and
    all save step 4."""
    for r in group["ranks"]:
        b = r["barrier"]
        assert b["preempted"] == "SIGTERM"
        assert b["agreed_step"] == 4 and b["final_step"] == 4
        assert b["latest"] == 4 and b["counters"]["emergency_saves"] == 1


# -- fit_resilient, counters, spans ------------------------------------------

def test_fit_resilient_entrypoint(tmp_path):
    xs, ys = _data()
    cfg = dict(checkpoint_every=2, retry_backoff=0.0)
    p = _port(2, checkpoint_dir=str(tmp_path / "p"), **cfg)
    r = _ref(p.get_weights(), checkpoint_dir=str(tmp_path / "r"), **cfg)
    plans = _plans(Fault(2, FaultKind.STEP_EXCEPTION))
    rp = p.fit_resilient(xs, ys, epochs=1, fault_plan=plans[0])
    rr = r.fit_resilient(xs, ys, epochs=1, fault_plan=plans[1])
    _same_report(rp, rr)
    assert rp.final_step == 8 and rp.counters["restarts"] == 1
    assert len(rp.losses) == 8
    _weights_close(p.get_weights(), r.get_weights())


def test_fit_resilient_requires_directory():
    xs, ys = _data(32)
    with pytest.raises(ValueError, match="checkpoint directory"):
        _port().fit_resilient(xs, ys, epochs=1)


def test_supervisor_counters_logged(tmp_path, caplog):
    xs, ys = _data(64)
    sup = TrainingSupervisor(_port(), str(tmp_path), checkpoint_every=2,
                             sleep=NO_SLEEP)
    with caplog.at_level(logging.INFO, logger="flexflow_tpu_torch.resilience"):
        rep = sup.run(xs, ys, num_steps=4)
    assert rep.counters["checkpoints"] == 3  # the anchor, 2 and 4
    assert rep.counters["checkpoint_time_s"] > 0
    assert "supervisor:" in caplog.text and "restarts=0" in caplog.text
    assert "checkpoint_time_s=" in caplog.text


def test_supervisor_emits_checkpoint_and_restart_spans(tmp_path):
    td = str(tmp_path / "telem")
    xs, ys = _data(32)
    ff = _port(trace_dir=td, checkpoint_every=2, max_restarts=3,
               retry_backoff=0.0)
    rep = TrainingSupervisor(
        ff, str(tmp_path / "ckpt"),
        fault_plan=FaultPlan.single(3, FaultKind.STEP_EXCEPTION),
        sleep=NO_SLEEP).run(xs, ys, num_steps=2 * len(ys) // 16)
    assert rep.counters["restarts"] == 1
    with open(os.path.join(td, "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "B"}
    assert {"checkpoint_write", "restart"} <= names
    with open(os.path.join(td, "run_telemetry.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    gauges = {r["name"]: r["value"] for r in recs if r["kind"] == "gauge"}
    assert gauges["resilience/restarts"] == 1
    assert gauges["resilience/checkpoints"] >= 1
    assert any("restored step" in r["fields"]["message"] for r in recs
               if r["kind"] == "event" and r["name"] == "log")


def test_package_exports():
    assert P.FaultPlan is FaultPlan
    assert P.TrainingSupervisor is TrainingSupervisor
    assert P.RetryPolicy is RetryPolicy
    assert P.FaultKind is FaultKind
    assert p_res.RestartBudgetExhausted is RestartBudgetExhausted
    for name in ("SupervisorReport", "CheckpointOffloader",
                 "RemoteCheckpointStore", "offloader_from_config"):
        assert name in p_res.__all__
