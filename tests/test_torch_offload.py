"""The checkpoints' remote tier of the port (flexflow_tpu_torch/
resilience/offload.py, the managers' offloader= and remote=) against
flexflow_tpu's tests/test_offload.py.

The store-level cases run the same operations through both packages'
RemoteCheckpointStore and CheckpointOffloader, each on its own file://
store, and compare what they return and what the stores hold.  The
supervised cases train tests/test_resilience.py's MLP in both packages
from the same weights (the port's, set into the reference) under the
same blob fault plan: the reports' final_step and the offload counters
that do not count bytes agree, and the final weights agree within 1e-5
(float32 SGD and Adam: rtol 1e-5, atol 1e-5); restores from the remote
tier are 0 apart from the state that was mirrored.  A remote step the
port writes, from either manager, passes the reference's
RemoteCheckpointStore.verify_step.
"""
import io
import json
import os
import shutil
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as G  # noqa: E402

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu import distributed as r_dist  # noqa: E402
from flexflow_tpu.resilience import faults as r_faults  # noqa: E402
from flexflow_tpu.resilience import offload as r_off  # noqa: E402
from flexflow_tpu.resilience import retry as r_retry  # noqa: E402
from flexflow_tpu.resilience import supervisor as r_sup  # noqa: E402
from flexflow_tpu.store import blobstore as r_blob  # noqa: E402
from flexflow_tpu_torch import distributed as p_dist  # noqa: E402
from flexflow_tpu_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                           LocalCheckpointManager,
                                           state_arrays)
from flexflow_tpu_torch.resilience import faults as p_faults  # noqa: E402
from flexflow_tpu_torch.resilience import offload as p_off  # noqa: E402
from flexflow_tpu_torch.resilience import retry as p_retry  # noqa: E402
from flexflow_tpu_torch.resilience import supervisor as p_sup  # noqa: E402
from flexflow_tpu_torch.store import blobstore as p_blob  # noqa: E402

NO_SLEEP = lambda s: None  # noqa: E731
TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {"port": (p_off, p_blob, p_faults, p_retry, p_sup),
        "ref": (r_off, r_blob, r_faults, r_retry, r_sup)}
# the offload counters that count events, not bytes (the port's leaves
# are not the reference's: its generator is torch's, not a jax key)
EVENTS = ("offload_uploads", "offload_failures", "offload_retries",
          "offload_skipped", "offload_verify_failures", "offload_unavailable")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR", str(tmp_path / "pc"))
    monkeypatch.setenv("FLEXFLOW_TPU_CACHE_DIR", str(tmp_path / "rc"))


def _both(fn):
    """fn(off, blob, faults, retry, sup) for each package; the results
    must be equal, and are returned."""
    got = {name: fn(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def _files(step, **leaves):
    """One step's three files (the reference test's fake step): float32
    leaves of 8 elements, each with a constant value."""
    arrays = {f"['weights']['{k}']['k']": np.full(8, v, np.float32)
              for k, v in leaves.items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    manifest = {"manifest_version": 1, "step": step, "leaves": {
        k: {"crc32": zlib.crc32(np.ascontiguousarray(a).view(np.uint8)
                                .reshape(-1)),
            "bytes": int(a.nbytes), "shape": [8], "dtype": "float32"}
        for k, a in arrays.items()}}
    return {"state.npz": buf.getvalue(),
            "meta.json": json.dumps({"step": step}).encode(),
            "manifest.json": json.dumps(manifest).encode()}


def _listing(blob):
    return sorted(blob.list(""))


# -- the remote store -----------------------------------------------------------

def test_remote_store_upload_verify_advance(tmp_path):
    def run(off, blob, *_):
        r = off.RemoteCheckpointStore(blob.LocalBlobStore(
            str(tmp_path / off.__name__)))
        out = [r.list_steps(), r.latest_verified_step()]
        r.upload_step(2, _files(2, d=1.0))
        r.upload_step(4, _files(4, d=1.0))
        r.advance_latest(2)  # monotonic: an older step cannot regress it
        return out + [r.list_steps(), r.latest_verified_step(),
                      r.verify_step(4)["step"], _listing(r.blob)]

    assert _both(run)[:5] == [[], None, [2, 4], 4, 4]


def test_remote_store_partial_upload_never_advances_pointer(tmp_path):
    def run(off, blob, faults, *_):
        inner = blob.LocalBlobStore(str(tmp_path / off.__name__))
        r = off.RemoteCheckpointStore(inner)
        r.upload_step(2, _files(2, d=1.0))
        faulty = blob.FaultyBlobStore(inner, faults.FaultPlan.single(
            1, faults.FaultKind.BLOB_PARTIAL_UPLOAD), sleep=NO_SLEEP)
        with pytest.raises(off.RemoteVerifyError):
            off.RemoteCheckpointStore(faulty).upload_step(4, _files(4, d=1.0))
        return [faulty.counters["partial_uploads"], r.latest_verified_step(),
                r.list_steps(), inner.list("ckpt/step_00000004/")]

    assert _both(run) == [1, 2, [2], []]


def test_remote_store_prune_keeps_pointer_step(tmp_path):
    def run(off, blob, *_):
        r = off.RemoteCheckpointStore(blob.LocalBlobStore(
            str(tmp_path / off.__name__)))
        for s in (2, 4, 6, 8):
            r.upload_step(s, _files(s, d=float(s)))
        r.prune(keep=2)
        kept = r.list_steps()
        r.advance_latest(6, force=True)
        r.prune(keep=1)
        return [kept, r.list_steps()]

    assert _both(run) == [[6, 8], [6, 8]]


def test_upload_rejects_unmanifested_leaf(tmp_path):
    def run(off, blob, *_):
        store = off.RemoteCheckpointStore(blob.LocalBlobStore(
            str(tmp_path / off.__name__)))
        files = _files(3, d=1.0)
        with np.load(io.BytesIO(files["state.npz"])) as d:
            arrays = {k: d[k] for k in d.files}
        arrays["rogue"] = np.ones(3, np.float32)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        files["state.npz"] = buf.getvalue()
        with pytest.raises(off.RemoteVerifyError, match="rogue"):
            store.upload_step(3, files)
        return store.latest_verified_step()

    assert _both(run) is None


# -- delta mirrors ---------------------------------------------------------------

def test_delta_mirror_skips_unchanged_leaves(tmp_path):
    def run(off, blob, *_):
        r = off.RemoteCheckpointStore(blob.LocalBlobStore(
            str(tmp_path / off.__name__)))
        rep1 = r.upload_step(2, _files(2, a=1.0, b=5.0))
        rep2 = r.upload_step(4, _files(4, a=1.0, b=7.0), base_step=2,
                             base_manifest=rep1.manifest)
        with np.load(io.BytesIO(r.blob.get(r._step_prefix(4)
                                           + "state.npz"))) as data:
            remote_leaves = list(data.files)
        man = r.verify_step(4)
        files = r.download_step(4)
        with np.load(io.BytesIO(files["state.npz"])) as data:
            full = {k: data[k].tolist() for k in data.files}
        return [rep1.leaves_skipped, rep2.leaves_skipped,
                rep2.bytes_uploaded < rep1.bytes_uploaded, remote_leaves,
                man["leaves"]["['weights']['a']['k']"]["base_step"], full,
                json.loads(files["manifest.json"])]

    out = _both(run)
    assert out[:5] == [0, 1, True, ["['weights']['b']['k']"], 2]
    assert out[5]["['weights']['b']['k']"] == [7.0] * 8
    assert "base_step" not in out[6]["leaves"]["['weights']['a']['k']"]


def test_delta_mirror_prune_keeps_referenced_base(tmp_path):
    def run(off, blob, *_):
        r = off.RemoteCheckpointStore(blob.LocalBlobStore(
            str(tmp_path / off.__name__)))
        rep1 = r.upload_step(2, _files(2, a=1.0, b=5.0))
        r.upload_step(4, _files(4, a=1.0, b=7.0), base_step=2,
                      base_manifest=rep1.manifest)
        r.prune(keep=1)
        with np.load(io.BytesIO(r.download_step(4)["state.npz"])) as data:
            return [r.list_steps(), len(data.files)]

    assert _both(run) == [[2, 4], 2]


def test_delta_chain_reanchors_at_bound_and_flattens(tmp_path):
    def run(off, blob, *_):
        r = off.RemoteCheckpointStore(blob.LocalBlobStore(
            str(tmp_path / off.__name__)))
        rep = r.upload_step(0, _files(0, a=1.0, b=0.0))
        deltas, bases = [], []
        for i in range(1, off.MAX_DELTA_CHAIN + 3):
            rep = r.upload_step(2 * i, _files(2 * i, a=1.0, b=float(i)),
                                base_step=2 * (i - 1),
                                base_manifest=rep.manifest)
            deltas.append(rep.leaves_skipped > 0)
            bases.append(r._base_steps_of(2 * i))
        return [off.MAX_DELTA_CHAIN, deltas, bases]

    n, deltas, bases = _both(run)
    assert n == p_off.MAX_DELTA_CHAIN == 4
    assert deltas == [True] * n + [False, True]
    assert bases[:n] == [[0]] * n  # annotated straight to the anchor


def test_delta_mirror_prune_aborts_on_unreadable_manifest(tmp_path):
    def run(off, blob, *_):
        store = blob.LocalBlobStore(str(tmp_path / off.__name__))
        r = off.RemoteCheckpointStore(store)
        rep1 = r.upload_step(2, _files(2, a=1.0, b=5.0))
        r.upload_step(4, _files(4, a=1.0, b=7.0), base_step=2,
                      base_manifest=rep1.manifest)
        real = store.get

        def flaky(key):
            if key.endswith("step_00000004/manifest.json"):
                raise blob.BlobUnavailableError("store blip")
            return real(key)

        store.get = flaky
        try:
            removed = r.prune(keep=1)
        finally:
            store.get = real
        return [removed, r.list_steps()]

    assert _both(run) == [0, [2, 4]]


# -- the offloader ---------------------------------------------------------------

def test_offloader_counts_skipped_leaves(tmp_path):
    def run(off, blob, *_):
        r = off.RemoteCheckpointStore(blob.LocalBlobStore(
            str(tmp_path / off.__name__)))
        o = off.CheckpointOffloader(r, every=1, keep=3, sleep=NO_SLEEP)
        try:
            o.maybe_submit(2, _files(2, a=1.0, b=5.0))
            o.drain()
            o.maybe_submit(4, _files(4, a=1.0, b=7.0))
            o.drain()
        finally:
            o.close()
        return [o.counters["offload_uploads"],
                o.counters["offload_leaves_skipped"],
                r.latest_verified_step()]

    assert _both(run) == [2, 1, 4]


def test_force_resubmit_after_abandoned_upload(tmp_path):
    def run(off, blob, faults, retry, _):
        inner = blob.LocalBlobStore(str(tmp_path / off.__name__))
        faulty = blob.FaultyBlobStore(inner, faults.FaultPlan.single(
            1, faults.FaultKind.BLOB_TRANSIENT), sleep=NO_SLEEP)
        o = off.CheckpointOffloader(
            off.RemoteCheckpointStore(faulty),
            retry=retry.RetryPolicy(max_restarts=0, base_backoff=0.0),
            sleep=NO_SLEEP)
        files = _files(4, d=1.0)
        out = [o.maybe_submit(4, files)]
        o.drain()
        out += [o.counters["offload_failures"],
                off.RemoteCheckpointStore(inner).latest_verified_step(),
                o.maybe_submit(4, files, force=True)]
        o.drain()
        return out + [off.RemoteCheckpointStore(inner).latest_verified_step(),
                      o.maybe_submit(4, files, force=True)]

    assert _both(run) == [True, 1, None, True, 4, False]


def test_force_submit_skips_already_queued_duplicate(tmp_path):
    def run(off, blob, faults, retry, _):
        inner = blob.LocalBlobStore(str(tmp_path / off.__name__))
        o = off.CheckpointOffloader(
            off.RemoteCheckpointStore(inner),
            retry=retry.RetryPolicy(max_restarts=3, base_backoff=0.0),
            sleep=NO_SLEEP)
        files = _files(2, d=1.0)
        out = [o.maybe_submit(2, files), o.maybe_submit(2, files, force=True)]
        o.drain()
        return out + [o.counters["offload_uploads"],
                      off.RemoteCheckpointStore(inner).latest_verified_step()]

    assert _both(run) == [True, True, 1, 2]


def test_offloader_from_config_and_barrier_timeout(tmp_path):
    cfg = P.FFConfig(device="cpu", remote_store=f"file://{tmp_path}/r",
                     offload_every=2, remote_keep=5, barrier_timeout=2.5)
    o = p_off.offloader_from_config(cfg)
    assert (o.every, o.keep) == (2, 5)
    assert p_off.offloader_from_config(P.FFConfig(device="cpu")) is None
    assert p_off.offloader_from_config(P.FFConfig(
        device="cpu", remote_store="none")) is None
    sup = p_sup.TrainingSupervisor(_port(barrier_timeout=2.5),
                                   str(tmp_path / "c"), sleep=NO_SLEEP)
    assert sup.barrier_timeout == 2.5


# -- the preemption barrier -----------------------------------------------------

@pytest.mark.parametrize("dist_mod", [p_dist, r_dist], ids=["port", "ref"])
def test_preemption_barrier_units(tmp_path, dist_mod):
    """The reference's four barrier units, for each package's barrier on
    the port's store: one host is instant, the max of the posts, a
    cleared incarnation, the conservative timeout."""
    blob = p_blob.LocalBlobStore(str(tmp_path))
    assert dist_mod.preemption_barrier(blob, "run1", 7, host_id=0,
                                       num_hosts=1, sleep=NO_SLEEP) == 7
    assert blob.list("barrier/") == []
    for host, step in ((1, 6), (2, 6)):
        blob.put(f"barrier/run2/host_{host:05d}",
                 json.dumps({"host": host, "step": step}).encode())
    assert dist_mod.preemption_barrier(blob, "run2", 5, host_id=0,
                                       num_hosts=3, sleep=NO_SLEEP) == 6
    for host in (0, 1):
        blob.put(f"barrier/runX/host_{host:05d}",
                 json.dumps({"host": host, "step": 100}).encode())
    assert dist_mod.clear_preemption_barrier(blob, "runX") == 2
    assert dist_mod.preemption_barrier(blob, "runX", 500, host_id=0,
                                       num_hosts=2, timeout_s=0.05,
                                       poll_s=0.01) == 500


# -- through the supervisor --------------------------------------------------------

def _port(seed=0, opt=None, **cfg):
    ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu", seed=seed, **cfg))
    G.sup_mlp(ff)
    ff.compile(optimizer=opt or P.SGDOptimizer(lr=0.05),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], seed=seed)
    return ff


def _ref(weights, opt=None, **cfg):
    ff = R.FFModel(R.FFConfig(batch_size=16, num_devices=1, **cfg))
    G.sup_mlp(ff)
    ff.compile(optimizer=opt or R.SGDOptimizer(lr=0.05),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"],
               devices=jax.devices("cpu")[:1])
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


def _supervised(tmp_path, num_steps, blob_plan=None, fault_plan=None,
                every=2, offloader_kw=None, budget=3, drain_first=False):
    """The same supervised run in both packages, each mirroring to its own
    store (behind a FaultyBlobStore under `blob_plan`): {package: (model,
    report, inner store)}."""
    xs, ys = _data()
    p = _port()
    weights = p.get_weights()
    out = {}
    for name, (off, blob, faults, retry, sup) in PKGS.items():
        inner = blob.LocalBlobStore(str(tmp_path / name / "remote"))
        store = inner if blob_plan is None else blob.FaultyBlobStore(
            inner, faults.FaultPlan.from_json(blob_plan), sleep=NO_SLEEP)
        plan = (faults.FaultPlan.from_json(fault_plan) if fault_plan
                else faults.FaultPlan())
        o = off.CheckpointOffloader(
            off.RemoteCheckpointStore(store), fault_plan=plan,
            retry=retry.RetryPolicy(max_restarts=budget, base_backoff=0.0),
            sleep=NO_SLEEP, **(offloader_kw or {}))
        if drain_first:
            # every cadence point queued, none skipped for a full queue
            o.MAX_PENDING_UPLOADS = 1 << 20
        ff = p if name == "port" else _ref(weights)
        rep = sup.TrainingSupervisor(
            ff, str(tmp_path / name / "ckpt"), checkpoint_every=every,
            fault_plan=plan, offloader=o, sleep=NO_SLEEP).run(
                xs, ys, num_steps=num_steps)
        o.drain()
        out[name] = (ff, rep, inner)
    (pf, prep, _), (rf, rrep, _) = out["port"], out["ref"]
    assert prep.final_step == rrep.final_step == num_steps
    _weights_close(pf.get_weights(), rf.get_weights())
    return out


def test_supervised_run_mirrors_checkpoints(tmp_path):
    out = _supervised(tmp_path, 6, drain_first=True)
    for name, (off, *_rest) in PKGS.items():
        _, rep, inner = out[name]
        assert off.RemoteCheckpointStore(inner).latest_verified_step() == 6
        assert rep.counters["offload_uploads"] == 4  # 0, 2, 4, 6
        assert rep.counters["offload_failures"] == 0
        assert rep.counters["offload_bytes"] > 0
    assert {k: out["port"][1].counters[k] for k in EVENTS} == \
        {k: out["ref"][1].counters[k] for k in EVENTS}


def test_offload_cadence_and_keep(tmp_path):
    out = _supervised(tmp_path, 6, every=1, drain_first=True,
                      offloader_kw={"every": 2, "keep": 2})
    steps = {name: PKGS[name][0].RemoteCheckpointStore(inner).list_steps()
             for name, (_, _, inner) in out.items()}
    assert steps["port"][-2:] == steps["ref"][-2:] == [4, 6]
    # beyond those, only delta bases: the port's generator leaf does not
    # move without a random draw, so its steps 4 and 6 take it from 0,
    # where the reference's jax key is split every step
    remote = p_off.RemoteCheckpointStore(out["port"][2])
    bases = {b for s in steps["port"][-2:] for b in remote._base_steps_of(s)}
    assert set(steps["port"][:-2]) <= bases
    for _, rep, _ in out.values():
        assert rep.counters["offload_uploads"] == 4  # 0, 2, 4, 6 of 0-6


def test_unavailability_degrades_to_local_only(tmp_path):
    plan = p_faults.FaultPlan.single(1, p_faults.FaultKind.BLOB_UNAVAILABLE,
                                     ops=10_000).to_json()
    out = _supervised(tmp_path, 6, blob_plan=plan, budget=1,
                      drain_first=True)
    assert {k: out["port"][1].counters[k] for k in EVENTS} == \
        {k: out["ref"][1].counters[k] for k in EVENTS}
    rep = out["port"][1]
    assert rep.counters["offload_unavailable"] >= 1
    assert rep.counters["offload_uploads"] == 0
    assert LocalCheckpointManager(
        str(tmp_path / "port" / "ckpt")).latest_verified_step() == 6


def test_transient_upload_errors_retry_within_budget(tmp_path):
    plan = p_faults.FaultPlan([
        p_faults.Fault(1, p_faults.FaultKind.BLOB_TRANSIENT),
        p_faults.Fault(4, p_faults.FaultKind.BLOB_TRANSIENT)]).to_json()
    out = _supervised(tmp_path, 6, blob_plan=plan, drain_first=True)
    assert {k: out["port"][1].counters[k] for k in EVENTS} == \
        {k: out["ref"][1].counters[k] for k in EVENTS}
    rep, inner = out["port"][1], out["port"][2]
    assert rep.counters["offload_retries"] >= 1
    assert rep.counters["offload_failures"] == 0
    assert p_off.RemoteCheckpointStore(inner).latest_verified_step() == 6


def test_uploader_checkpoint_write_fault_retries(tmp_path):
    """A CHECKPOINT_WRITE fault with target "remote" fails the first
    upload at or after step 2 once; the upload retries, and no local save
    fails.  Every cadence point is queued (no skip for a full queue) and
    the offloader drained before the asserts, so they cannot race the
    upload thread."""
    plan = p_faults.FaultPlan([p_faults.Fault(
        2, p_faults.FaultKind.CHECKPOINT_WRITE,
        payload={"target": "remote"})]).to_json()
    out = _supervised(tmp_path, 6, fault_plan=plan, drain_first=True)
    for name, (off, *_rest) in PKGS.items():
        _, rep, inner = out[name]
        assert rep.counters["checkpoint_failures"] == 0
        assert rep.counters["offload_retries"] == 1
        assert off.RemoteCheckpointStore(inner).latest_verified_step() == 6


# -- restores from the remote tier ---------------------------------------------------

def _mirrored(tmp_path, num_steps=6, manager="local", opt=None):
    """A supervised port run mirroring every 2 steps to tmp_path/remote:
    (model, its state after the run, the blob store)."""
    blob = p_blob.LocalBlobStore(str(tmp_path / "remote"))
    ff = _port(opt=opt)
    off = p_off.CheckpointOffloader(p_off.RemoteCheckpointStore(blob),
                                    sleep=NO_SLEEP)
    off.MAX_PENDING_UPLOADS = 1 << 20
    xs, ys = _data()
    p_sup.TrainingSupervisor(ff, str(tmp_path / "ckpt"), checkpoint_every=2,
                             offloader=off, backend=manager,
                             sleep=NO_SLEEP).run(xs, ys, num_steps)
    return ff, state_arrays(ff), blob


def _state_equal(ff, want):
    got = state_arrays(ff)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_restore_prefers_local_falls_back_per_checkpoint(tmp_path):
    """A corrupt newest local step gives way to its own remote mirror,
    not to an older local step, and the mirror is written back into the
    directory."""
    ff, s6, blob = _mirrored(tmp_path)
    state = tmp_path / "ckpt" / "step_00000006" / "state.npz"
    raw = bytearray(state.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    state.write_bytes(bytes(raw))
    fresh = _port(seed=7)
    mgr = LocalCheckpointManager(str(tmp_path / "ckpt"),
                                 remote=p_off.RemoteCheckpointStore(blob))
    assert mgr.restore(fresh) == 6
    _state_equal(fresh, s6)
    assert fresh.telemetry.metrics.counter(
        "resilience/offload_remote_restores").value == 1
    assert LocalCheckpointManager(str(tmp_path / "ckpt")).restore(fresh) == 6


@pytest.mark.parametrize("manager", ["local", "dcp"])
def test_fresh_host_restores_from_remote_only(tmp_path, manager):
    """An empty directory on a new host restores the mirror's newest step
    (either manager: the DCP manager writes it in its own format)."""
    ff, s6, blob = _mirrored(tmp_path, manager=manager)
    cls = LocalCheckpointManager if manager == "local" else CheckpointManager
    mgr = cls(str(tmp_path / "fresh"), remote=p_off.RemoteCheckpointStore(blob))
    assert mgr.any_restorable()
    fresh = _port(seed=7)
    assert mgr.restore(fresh) == 6
    _state_equal(fresh, s6)
    assert mgr.all_steps() == [6]


def test_dcp_restore_prefers_newer_remote_step(tmp_path):
    """The DCP manager walks both tiers newest first: a stale local step 2
    does not win over the mirror's 6."""
    ff, s6, blob = _mirrored(tmp_path)
    other = _port(seed=1)
    mgr = CheckpointManager(str(tmp_path / "dc"),
                            remote=p_off.RemoteCheckpointStore(blob))
    mgr.save(other, step=2)
    assert mgr.restore(other) == 6
    _state_equal(other, s6)
    mgr.close()


@pytest.mark.parametrize("manager", ["local", "dcp"])
def test_port_remote_step_passes_the_reference_verify(tmp_path, manager):
    """Every step the port mirrors, delta steps included, passes the
    reference's verify_step, and the reference downloads it whole: its
    weight leaves are the port's."""
    ff, s6, _ = _mirrored(tmp_path, manager=manager,
                          opt=P.AdamOptimizer(alpha=0.01))
    ref_store = r_off.RemoteCheckpointStore(
        r_blob.LocalBlobStore(str(tmp_path / "remote")))
    steps = ref_store.list_steps()
    assert steps[-1] == 6 and ref_store.latest_verified_step() == 6
    for s in steps:
        assert ref_store.verify_step(s)["step"] == s
    with np.load(io.BytesIO(ref_store.download_step(6)["state.npz"])) as d:
        got = {k: d[k] for k in d.files}
    assert sorted(got) == sorted(s6)
    for k in s6:
        np.testing.assert_array_equal(got[k], s6[k], err_msg=k)


def test_host_loss_drill_bit_identical(tmp_path):
    """Train with the mirror under a transient upload fault, lose the
    directory, resume on a fresh one from the remote tier: 0 apart from
    an uninterrupted run, Adam's slots included."""
    xs, ys = _data()

    def model():
        return _port(opt=P.AdamOptimizer(alpha=0.01))

    ref = model()
    p_sup.TrainingSupervisor(ref, str(tmp_path / "ref"), checkpoint_every=0,
                             sleep=NO_SLEEP).run(xs, ys, 8)
    inner = p_blob.LocalBlobStore(str(tmp_path / "remote"))
    faulty = p_blob.FaultyBlobStore(inner, p_faults.FaultPlan.single(
        4, p_faults.FaultKind.BLOB_TRANSIENT), sleep=NO_SLEEP)

    def offloader(blob):
        return p_off.CheckpointOffloader(
            p_off.RemoteCheckpointStore(blob), sleep=NO_SLEEP,
            retry=P.RetryPolicy(max_restarts=3, base_backoff=0.0))

    a = model()
    rep_a = p_sup.TrainingSupervisor(a, str(tmp_path / "a"),
                                     checkpoint_every=2,
                                     offloader=offloader(faulty),
                                     sleep=NO_SLEEP).run(xs, ys, 6)
    assert rep_a.counters["offload_uploads"] >= 3
    shutil.rmtree(tmp_path / "a")
    b = model()
    rep_b = p_sup.TrainingSupervisor(b, str(tmp_path / "b"),
                                     checkpoint_every=2,
                                     offloader=offloader(inner),
                                     sleep=NO_SLEEP).run(xs, ys, 8,
                                                         resume=True)
    assert rep_b.final_step == 8 and rep_b.counters["restarts"] == 0
    _state_equal(b, state_arrays(ref))


def test_preemption_runs_forward_to_agreed_step(tmp_path, monkeypatch):
    """A rank behind the agreed emergency step steps forward to it before
    the save; the step lands in both tiers (as the reference's test)."""
    blob = p_blob.LocalBlobStore(str(tmp_path / "remote"))
    ff = _port()
    sup = p_sup.TrainingSupervisor(
        ff, str(tmp_path / "ckpt"), checkpoint_every=2, sleep=NO_SLEEP,
        offloader=p_off.CheckpointOffloader(p_off.RemoteCheckpointStore(blob),
                                            sleep=NO_SLEEP))
    at = []
    monkeypatch.setattr(sup, "_preempt_rendezvous",
                        lambda step: at.append(step) or step + 2)
    real, calls = ff.train_step, {"n": 0}

    def stepper(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            sup._preempt = "SIGTERM"
        return real(*a, **kw)

    monkeypatch.setattr(ff, "train_step", stepper)
    xs, ys = _data()
    rep = sup.run(xs, ys, num_steps=8)
    assert rep.preempted == "SIGTERM" and at == [2] and rep.final_step == 4
    assert sup.manager.latest_verified_step() == 4
    assert p_off.RemoteCheckpointStore(blob).latest_verified_step() == 4


def test_preemption_on_final_step_still_posts_barrier(tmp_path, monkeypatch):
    blob = p_blob.LocalBlobStore(str(tmp_path / "remote"))
    ff = _port()
    sup = p_sup.TrainingSupervisor(
        ff, str(tmp_path / "ckpt"), checkpoint_every=2, sleep=NO_SLEEP,
        offloader=p_off.CheckpointOffloader(p_off.RemoteCheckpointStore(blob),
                                            sleep=NO_SLEEP))
    at = []
    monkeypatch.setattr(sup, "_preempt_rendezvous",
                        lambda step: at.append(step) or step)
    real, calls = ff.train_step, {"n": 0}

    def stepper(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 4:
            sup._preempt = "SIGTERM"
        return real(*a, **kw)

    monkeypatch.setattr(ff, "train_step", stepper)
    xs, ys = _data()
    rep = sup.run(xs, ys, num_steps=4)
    assert rep.preempted == "SIGTERM" and rep.final_step == 4 and at == [4]
