"""The port's checkpoints (flexflow_tpu_torch/checkpoint.py) against
flexflow_tpu's tests/test_checkpoint.py: a save and restore round trip
with both managers (LocalCheckpointManager's npz and CheckpointManager's
torch.distributed.checkpoint), a resumed run 0 apart from the
uninterrupted one in weights, optimizer slots and Adam's step (sync and
async, SGD with momentum and Adam, with dropout on, on an MLP and a
2-layer BERT at hidden 64 on its dense branch), retention, the fallback
past a torn step, the ModelCheckpoint callback per epoch and every k
steps; and against the reference's own files: its `_verify_dir` checks a
port step directory and the port's checks one the reference wrote, and a
port checkpoint's weight leaves set into the reference model give the
port's loss within the training tests' 1e-5.  On the CPU every step is
eager (the captured step runs only on the card: tests/test_torch_gpu.py,
chip_smoke.py --phases resilience).
"""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu import checkpoint as r_ckpt  # noqa: E402
from flexflow_tpu_torch.checkpoint import (  # noqa: E402
    CheckpointManager, LocalCheckpointManager, ModelCheckpoint)
from flexflow_tpu_torch.fftype import ActiMode  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_bert  # noqa: E402

MANAGERS = {"local": LocalCheckpointManager, "dcp": CheckpointManager}
LOSS_ATOL = 1e-5  # tests/test_torch_training.py's ATOL
BERT = dict(batch_size=4, seq_length=16, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128, num_classes=2)
OPTIMIZERS = {
    "sgd_momentum": lambda: P.SGDOptimizer(lr=0.05, momentum=0.9),
    "adam": lambda: P.AdamOptimizer(alpha=0.01),
}


def _mlp(seed=0, opt="sgd_momentum", dropout=0.0, hidden=32):
    ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu", seed=seed))
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, hidden, activation=ActiMode.RELU)
    if dropout:
        t = ff.dropout(t, dropout)
    t = ff.dense(t, 4)
    ff.softmax(t)
    ff.compile(optimizer=OPTIMIZERS[opt](),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], seed=seed)
    return ff


def _bert(seed=0, opt="adam", dropout=0.1):
    ff = P.FFModel(P.FFConfig(batch_size=4, device="cpu", seed=seed))
    build_bert(ff, dropout=dropout, **BERT)
    ff.compile(optimizer=OPTIMIZERS[opt](),
               metrics=["accuracy", "sparse_categorical_crossentropy"],
               seed=seed)
    return ff


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randint(0, 4, size=n).astype(np.int32))


def _bert_data(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 16, 64).astype(np.float32),
            rng.randint(0, 2, (n, 1)).astype(np.int32))


def state_of(ff):
    """Every weight, optimizer slot and op-state entry and the
    generator's state, as numpy copies."""
    out = {f"w/{op}/{k}": v for op, e in ff.get_weights().items()
           for k, v in e.items()}
    for slot, sub in ff._opt_state.items():
        if isinstance(sub, dict):
            out.update({f"{slot}/{op}/{k}": v.detach().numpy().copy()
                        for op, e in sub.items() for k, v in e.items()})
        else:
            out[slot] = sub.numpy().copy()
    out["rng"] = ff._generator.get_state().numpy()
    return out


def assert_same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- round trip and resume --------------------------------------------------

@pytest.mark.parametrize("kind", sorted(MANAGERS))
def test_save_restore_round_trip(tmp_path, kind):
    ff = _mlp()
    xs, ys = _data()
    ff.fit(xs, ys, epochs=1, verbose=False)
    saved = state_of(ff)
    mgr = MANAGERS[kind](str(tmp_path / "c"))
    mgr.save(ff, step=1)
    assert mgr.latest_step() == 1 and mgr.latest_verified_step() == 1
    ff.fit(xs, ys, epochs=1, verbose=False)  # diverge
    tensors = [w for e in ff._weights.values() for w in e.values()]
    assert mgr.restore(ff) == 1
    assert_same_state(state_of(ff), saved)
    # restored in place: the step's tensors are the same objects
    assert [w for e in ff._weights.values() for w in e.values()] == tensors
    meta = mgr.restore_meta()
    assert meta["step"] == 1 and meta["num_devices"] == 1
    assert meta["zero_stage"] == 0 and meta["batch_size"] == 16
    mgr.close()


@pytest.mark.parametrize("wait", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("kind", sorted(MANAGERS))
@pytest.mark.parametrize("model,opt", [("mlp", "sgd_momentum"),
                                       ("mlp", "adam"), ("bert", "adam")])
def test_resumed_training_is_the_uninterrupted_run(tmp_path, model, opt,
                                                   kind, wait):
    """Train, save, train on; a fresh model (another init seed) restores
    and trains the same batches: weights, slots, Adam's step and the
    generator 0 apart, with dropout drawing from the restored
    generator."""
    if model == "mlp":
        build = lambda seed: _mlp(seed, opt, dropout=0.3)  # noqa: E731
        xs, ys = _data(64)
    else:
        build = lambda seed: _bert(seed, opt)  # noqa: E731
        xs, ys = _bert_data(16)
    a = build(11)
    a.fit(xs, ys, epochs=1, verbose=False)
    mgr = MANAGERS[kind](str(tmp_path / "c"))
    mgr.save(a, step=4, wait=wait)
    assert mgr.drain() == []
    a.fit(xs, ys, epochs=2, verbose=False)
    b = build(99)  # another init: every leaf must be overwritten
    assert MANAGERS[kind](str(tmp_path / "c")).restore(b) == 4
    b.fit(xs, ys, epochs=2, verbose=False)
    assert_same_state(state_of(b), state_of(a))
    mgr.close()


def test_local_manager_round_trip_and_retention(tmp_path):
    ff = _mlp()
    mgr = LocalCheckpointManager(str(tmp_path / "lc"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(ff, step=s)
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_verified_step() == 3


def test_dcp_manager_retention_and_layout(tmp_path):
    ff = _mlp()
    mgr = CheckpointManager(str(tmp_path / "oc"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(ff, step=s, wait=s != 2)
    assert mgr.drain() == []
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(mgr._path(3))) == ["manifest.json", "meta.json",
                                                "state"]
    leaf = mgr._verify_dir(mgr._path(3))["leaves"][
        "['weights']['dense_0']['kernel']"]
    assert (leaf["shape"], leaf["dtype"]) == ([8, 32], "float32")
    assert mgr.restore_meta(3)["step"] == 3
    mgr.close()


def test_local_manager_torn_latest_falls_back(tmp_path):
    ff = _mlp()
    xs, ys = _data()
    ff.fit(xs, ys, epochs=1, verbose=False)
    s1 = state_of(ff)
    mgr = LocalCheckpointManager(str(tmp_path / "lc"))
    mgr.save(ff, step=1)
    ff.fit(xs, ys, epochs=1, verbose=False)
    mgr.save(ff, step=2)
    with open(os.path.join(mgr._path(2), "state.npz"), "wb") as f:
        f.write(b"not a checkpoint")
    ff.fit(xs, ys, epochs=1, verbose=False)
    assert mgr.restore(ff) == 1
    assert_same_state(state_of(ff), s1)
    with pytest.raises(Exception):
        mgr.restore(ff, step=2)  # a step asked for by number is strict


def test_dcp_restore_falls_back_on_corrupt(tmp_path):
    import shutil

    ff = _mlp()
    xs, ys = _data()
    ff.fit(xs, ys, epochs=1, verbose=False)
    s1 = state_of(ff)
    mgr = CheckpointManager(str(tmp_path / "oc"))
    mgr.save(ff, step=1)
    ff.fit(xs, ys, epochs=1, verbose=False)
    mgr.save(ff, step=2)
    shutil.rmtree(os.path.join(mgr._path(2), "state"))
    ff.fit(xs, ys, epochs=1, verbose=False)
    assert mgr.restore(ff) == 1
    assert_same_state(state_of(ff), s1)
    with pytest.raises(Exception):
        mgr.restore(ff, step=2)
    mgr.close()


@pytest.mark.parametrize("kind", sorted(MANAGERS))
def test_model_checkpoint_callback_per_epoch(tmp_path, kind):
    ff = _mlp()
    xs, ys = _data()
    cb = ModelCheckpoint(str(tmp_path / "cb"), max_to_keep=2,
                         local=kind == "local")
    ff.fit(xs, ys, epochs=3, verbose=False, callbacks=[cb])
    mgr = MANAGERS[kind](str(tmp_path / "cb"))
    assert mgr.all_steps() == [1, 2]  # epochs 0, 1, 2: the last 2 kept
    assert mgr.latest_verified_step() == 2


def test_model_checkpoint_every_k_steps_resumes(tmp_path):
    """The slice's path on the CPU: FFConfig.checkpoint_every and
    checkpoint_dir drive an async local ModelCheckpoint; a fresh model
    restores the newest verified step and trains on, 0 apart from the
    run that was not interrupted."""
    xs, ys = _data(64)  # 4 steps an epoch
    d = str(tmp_path / "every")
    a = _mlp(3, "adam", dropout=0.3)
    a.config.checkpoint_every, a.config.checkpoint_dir = 3, d
    cb = ModelCheckpoint(async_save=True, local=True)
    a.fit(xs, ys, epochs=2, verbose=False, callbacks=[cb])
    mgr = LocalCheckpointManager(d)
    assert mgr.all_steps() == [3, 6] and mgr.latest_verified_step() == 6
    after8 = state_of(a)
    b = _mlp(7, "adam", dropout=0.3)
    b.config.checkpoint_every, b.config.checkpoint_dir = 3, d
    assert mgr.restore(b) == 6
    b.fit(xs[32:], ys[32:], epochs=1, verbose=False,
          callbacks=[ModelCheckpoint(local=True, initial_step=6)])
    assert_same_state(state_of(b), after8)
    assert mgr.latest_verified_step() == 6  # 2 steps: no new multiple of 3


@pytest.mark.parametrize("arg", ["offloader", "remote"])
def test_the_remote_tier_is_refused(tmp_path, arg):
    """The remote tier is no longer refused (resilience/offload.py): both
    managers take `offloader=` and `remote=`, as the reference's do, and
    an offloader's store serves their restores.  tests/
    test_torch_offload.py holds the tier against the reference."""
    from flexflow_tpu_torch.resilience.offload import (CheckpointOffloader,
                                                       RemoteCheckpointStore)
    from flexflow_tpu_torch.store.blobstore import LocalBlobStore

    remote = RemoteCheckpointStore(LocalBlobStore(str(tmp_path / "blob")))
    given = (CheckpointOffloader(remote) if arg == "offloader" else remote)
    for cls in (LocalCheckpointManager, CheckpointManager):
        mgr = cls(str(tmp_path / cls.__name__), **{arg: given})
        assert mgr.remote is remote
        assert mgr.offloader is (given if arg == "offloader" else None)
        assert not mgr.any_restorable()


# -- against the reference's files -------------------------------------------

def _ref_mlp():
    ff = R.FFModel(R.FFConfig(batch_size=16, num_devices=1, seed=0))
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 32, activation=R.ActiMode.RELU)
    t = ff.dense(t, 4)
    ff.softmax(t)
    ff.compile(optimizer=R.SGDOptimizer(lr=0.05, momentum=0.9),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"],
               devices=jax.devices("cpu")[:1], seed=0)
    return ff


def test_each_package_verifies_the_others_step_directory(tmp_path):
    xs, ys = _data()
    p = _mlp()
    p.fit(xs, ys, epochs=1, verbose=False)
    LocalCheckpointManager(str(tmp_path / "p")).save(p, step=1)
    r = _ref_mlp()
    r.fit(xs, ys, epochs=1, verbose=False)
    r_ckpt.LocalCheckpointManager(str(tmp_path / "r")).save(r, step=1)
    pdir = os.path.join(tmp_path, "p", "step_00000001")
    rdir = os.path.join(tmp_path, "r", "step_00000001")
    for d in (pdir, rdir):
        want = r_ckpt.LocalCheckpointManager._verify_dir(d)
        got = LocalCheckpointManager._verify_dir(d)
        assert got == want
    # the same layout: every file, the meta's fields, the weight keys
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(rdir))
    with open(os.path.join(pdir, "meta.json")) as f:
        pmeta = json.load(f)
    with open(os.path.join(rdir, "meta.json")) as f:
        rmeta = json.load(f)
    assert sorted(pmeta) == sorted(rmeta)
    with open(os.path.join(pdir, "manifest.json")) as f:
        pman = json.load(f)
    with open(os.path.join(rdir, "manifest.json")) as f:
        rman = json.load(f)
    assert sorted(pman) == sorted(rman)
    assert {k for k in pman["leaves"] if not k.startswith("['rng']")} == \
        {k for k in rman["leaves"] if not k.startswith("['rng']")}


def test_port_weight_leaves_give_the_reference_its_loss(tmp_path):
    """The weight leaves of a port checkpoint, set into the reference
    model, give the loss the port computes, within 1e-5."""
    xs, ys = _data()
    p = _mlp()
    p.fit(xs, ys, epochs=1, verbose=False)
    LocalCheckpointManager(str(tmp_path)).save(p, step=1)
    nested = {}
    with np.load(os.path.join(tmp_path, "step_00000001",
                              "state.npz")) as data:
        for key in data.files:
            toks = key[2:-2].split("']['")
            if toks[0] == "weights":
                nested.setdefault(toks[1], {})[toks[2]] = data[key]
    r = _ref_mlp()
    r.set_weights(nested)
    want = float(np.asarray(r.eval_step({"x": xs[:16]}, ys[:16])["loss"]))
    got = float(p.eval_step({"x": xs[:16]}, ys[:16])["loss"])
    assert got == pytest.approx(want, abs=LOSS_ATOL)


def test_a_failed_async_save_in_fit_raises_at_the_end(tmp_path, monkeypatch):
    """ModelCheckpoint's async saves fail on the writer's thread; the
    training goes on, and on_train_end raises with the failed steps."""
    xs, ys = _data(64)
    ff = _mlp()
    cb = ModelCheckpoint(str(tmp_path), async_save=True, every_steps=2,
                         local=True)
    monkeypatch.setattr(
        cb.manager, "_write_and_publish",
        lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(RuntimeError, match="step 2: OSError"):
        ff.fit(xs, ys, epochs=1, verbose=False, callbacks=[cb])
    assert cb.manager.all_steps() == []
