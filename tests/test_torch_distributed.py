"""The port's multi-GPU execution against the reference on the CPU:
`distributed.initialize` and the batch helpers, the lowering of views to
layouts, tensor parallelism (the ops of tests/test_parallelism.py and a
DP x TP BERT) and an 8-rank replay of `_dryrun_multichip_body`'s TP and
SP legs.

The port runs in spawned gloo groups (tests/torch_dist_ranks.py); the
reference runs in this process on the 8-device CPU mesh, on the same
numpy inputs, with its weights copied into the port.  Each group is
spawned once per module and runs all of its cases.
"""
import functools

import numpy as np
import pytest

import torch_dist_ranks as R
from flexflow_tpu import FFConfig, FFModel, LossType, SGDOptimizer
from flexflow_tpu.models.transformer import (bert_sp_strategy as ref_sp,
                                             bert_tp_strategy as ref_tp,
                                             build_bert)
from flexflow_tpu.ops.op import ShardConfig as RefShard
from flexflow_tpu.parallel.machine import view_to_spec as ref_view_to_spec
from flexflow_tpu.strategy import Strategy as RefStrategy
from flexflow_tpu.strategy import apply_strategy as ref_apply
from flexflow_tpu.strategy import assign_views as ref_assign
from flexflow_tpu_torch import distributed
from flexflow_tpu_torch.config import FFConfig as TFFConfig
from flexflow_tpu_torch.model import FFModel as TFFModel
from flexflow_tpu_torch.models.transformer import (bert_sp_strategy,
                                                   bert_tp_strategy)
from flexflow_tpu_torch.models.transformer import build_bert as t_build_bert
from flexflow_tpu_torch.ops.op import ShardConfig
from flexflow_tpu_torch.optimizer import SGDOptimizer as TSGD
from flexflow_tpu_torch.parallel.collectives import Layout
from flexflow_tpu_torch.parallel.machine import (DeviceMesh, _axis_groups,
                                                 view_to_spec)
from flexflow_tpu_torch.pcg.rewrite import cancel_all_inverse_parallel_ops
from flexflow_tpu_torch.strategy import (Strategy, apply_strategy,
                                         assign_views)

# losses and weights of the sharded steps against the reference's, both
# float32: the partial sums over ranks (gloo's ring) and XLA's sums run
# in other orders, ~1e-7 relative per step
TOL = dict(rtol=2e-5, atol=2e-5)

TINY_BERT = dict(seq_length=16, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128)


# -- distributed.initialize and the batch helpers ----------------------------

_ENV = ("FLEXFLOW_COORDINATOR", "FLEXFLOW_NUM_PROCS", "FLEXFLOW_PROC_ID",
        "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "MASTER_ADDR",
        "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda: calls[-1][1]["world_size"])
    return calls


def test_initialize_single_process_returns_false(clean_env):
    assert distributed.initialize(device="cpu") is False
    assert clean_env == []


def test_initialize_needs_a_coordinator(clean_env, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(device="cpu")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    monkeypatch.delenv("FLEXFLOW_NUM_PROCS")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(device="cpu")


@pytest.mark.parametrize("source", ["args", "flexflow", "ompi", "launcher"])
def test_initialize_resolution_order(clean_env, monkeypatch, source):
    env = {
        "flexflow": {"FLEXFLOW_COORDINATOR": "host0:1234",
                     "FLEXFLOW_NUM_PROCS": "4", "FLEXFLOW_PROC_ID": "2"},
        "ompi": {"FLEXFLOW_COORDINATOR": "host0:1234",
                 "OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "2"},
        "launcher": {"MASTER_ADDR": "host0", "MASTER_PORT": "1234",
                     "WORLD_SIZE": "4", "RANK": "2"},
        "args": {"MASTER_ADDR": "elsewhere", "WORLD_SIZE": "9",
                 "RANK": "7"},
    }[source]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = (("host0:1234", 4, 2) if source == "args" else ())
    assert distributed.initialize(*args, device="cpu") is True
    backend, kw = clean_env[-1]
    assert backend == "gloo"
    assert kw == {"init_method": "tcp://host0:1234", "world_size": 4,
                  "rank": 2}


def test_initialize_takes_nccl_by_default_and_gloo_when_named(clean_env,
                                                               monkeypatch):
    monkeypatch.setattr(distributed.torch.cuda, "set_device",
                        lambda i: clean_env.append(("device", i)))
    monkeypatch.setenv("LOCAL_RANK", "3")
    distributed.initialize("h:1", 8, 5)
    assert clean_env[-2] == ("device", 3) and clean_env[-1][0] == "nccl"
    distributed.initialize("h:1", 8, 5, local_device_ids=[0],
                           backend="gloo")
    assert clean_env[-2] == ("device", 0) and clean_env[-1][0] == "gloo"


def _mesh(axis_sizes, rank):
    return DeviceMesh(axis_sizes, rank, "cpu", {}, {})


def test_local_batch_slice_and_shard_host_batch():
    mesh = _mesh({"data": 2, "model": 2}, rank=3)  # coords data 1, model 1
    dp = Layout((("data",), ()))
    assert distributed.local_batch_slice(16, dp, mesh) == slice(8, 16)
    whole = Layout(((), ("model",)))
    assert distributed.local_batch_slice(16, whole, mesh) == slice(0, 16)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(15, dp, mesh)
    # one process: the whole batch
    assert distributed.local_batch_slice(16) == slice(0, 16)
    x = np.arange(32).reshape(16, 2)
    y = np.arange(16)
    got = distributed.shard_host_batch({"x": x, "y": y},
                                       {"x": dp, "y": whole}, mesh)
    np.testing.assert_array_equal(got["x"], x[8:])
    np.testing.assert_array_equal(got["y"], y)
    assert distributed.shard_host_batch({"x": x}, {"x": dp})["x"] is x


def test_mesh_is_c_order_like_the_reference():
    groups = _axis_groups({"data": 2, "model": 8})
    assert groups["data"][:2] == [[0, 8], [1, 9]]
    assert groups["model"] == [list(range(8)), list(range(8, 16))]
    mesh = _mesh({"data": 2, "model": 8}, rank=9)
    assert mesh.coords == {"data": 1, "model": 1}
    ref = np.arange(16).reshape(2, 8)  # make_mesh's reshape
    assert ref[mesh.coords["data"], mesh.coords["model"]] == 9


# -- the lowering of views -----------------------------------------------------

def spec_as_partition(spec):
    """A port spec in the reference's PartitionSpec entries (None, an
    axis name, or a tuple of names), trailing Nones dropped."""
    entries = [None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in spec]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@pytest.mark.parametrize("kind", ["tp", "sp"])
def test_view_lowering_matches_reference(kind):
    """For every tensor of a tiny BERT under bert_tp_strategy and
    bert_sp_strategy, the port's layout spec is the reference's
    PartitionSpec."""
    from flexflow_tpu.pcg.rewrite import cancel_all_inverse_parallel_ops as rc

    mine = (bert_tp_strategy(4, tp=2, num_layers=2) if kind == "tp"
            else bert_sp_strategy(4, sp=2))
    ref = (ref_tp(4, tp=2, num_layers=2) if kind == "tp"
           else ref_sp(4, sp=2))
    ff = TFFModel(TFFConfig(device="cpu"))
    t_build_bert(ff, batch_size=4, **TINY_BERT)
    g = cancel_all_inverse_parallel_ops(apply_strategy(ff.layers, mine))
    assign_views(g, mine.mesh_axes)
    ffr = FFModel(FFConfig())
    build_bert(ffr, batch_size=4, **TINY_BERT)
    gr = rc(ref_apply(ffr.layers, ref))
    ref_assign(gr, ref.mesh_axes)
    want = {pt.name: tuple(ref_view_to_spec(pt)) for op in gr.ops
            for pt in list(op.outputs) + list(op.weights)}
    got = {pt.name: spec_as_partition(view_to_spec(pt)) for op in g.ops
           for pt in list(op.outputs) + list(op.weights)}
    assert got == want
    assert any(a for spec in got.values() for a in spec)


# -- tensor parallelism in an 8-rank group, and the dry-run replay -------------

def _tp_strategy(cls, shard, dp, tp):
    s = cls(mesh_axes={"data": dp, "model": tp})
    s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": dp})]
    s.shard_configs["fc1"] = shard(channel=tp)
    return s


def _heads_strategy(cls, shard, name, **kw):
    s = cls(mesh_axes={"data": 2, "model": 4})
    s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": 2})]
    s.shard_configs[name] = shard(**kw)
    return s


def _ref_model(build, devices, strategy=None, seed=0, lr=0.01,
               batch=None):
    ff = FFModel(FFConfig(**({"batch_size": batch} if batch else {})))
    build(ff)
    ff.compile(optimizer=SGDOptimizer(lr=lr),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=strategy, devices=devices, seed=seed)
    return ff


def _builds(**kw):
    """The same BERT from the reference's builder and the port's."""
    return (functools.partial(build_bert, **kw),
            functools.partial(t_build_bert, **kw))


def _dryrun_tp():
    n, tp = 8, 2
    batch = 2 * (n // tp)
    builds = _builds(batch_size=batch, seq_length=16, hidden_size=64,
                     num_layers=2, num_heads=4, intermediate_size=128)
    x = np.random.RandomState(0).randn(batch, 16, 64).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 2, batch).astype(np.int32)
    return builds, batch, {"input": x}, y


def _dryrun_sp():
    n, sp = 8, 4
    bsp = max(2, n // sp)
    builds = _builds(batch_size=bsp, seq_length=8 * sp, hidden_size=32,
                     num_layers=1, num_heads=4, intermediate_size=64)
    x = np.random.RandomState(4).randn(bsp, 8 * sp, 32).astype(np.float32)
    y = np.random.RandomState(5).randint(0, 2, bsp).astype(np.int32)
    return builds, bsp, {"input": x}, y


@pytest.fixture(scope="module")
def eight(devices8):
    """The reference's results and the port's 8-rank group's, for every
    8-device case."""
    ref, cases = {}, []
    rng = np.random.RandomState(0)
    # the TP linear: forward and 3 SGD steps (test_parallelism.py)
    ff = _ref_model(R.mlp_tp, devices8, _tp_strategy(RefStrategy, RefShard,
                                                     4, 2), seed=11, lr=0.1)
    xs = np.random.RandomState(0).randn(16, 32).astype(np.float32)
    ys = np.random.RandomState(4).randint(0, 4, 16).astype(np.int32)
    w0 = ff.get_weights()
    ref["mlp_fwd"] = np.asarray(ff.forward({"x": xs}))
    ref["mlp_losses"] = [float(ff.train_step({"x": xs}, ys)["loss"])
                         for _ in range(3)]
    ref["mlp_weights"] = ff.get_weights()
    tp = _tp_strategy(Strategy, ShardConfig, 4, 2)
    cases.append((R.forward, (R.mlp_tp, tp, w0, {"x": xs})))
    cases.append((R.train_steps, (R.mlp_tp, tp, w0, [({"x": xs}, ys)] * 3,
                                  functools.partial(TSGD, lr=0.1))))
    # head-parallel attention and the attribute-parallel embedding
    for name, build, shard, feed in (
            ("attn", R.attention_heads, {"channel": 4},
             {"x": rng.randn(4, 16, 32).astype(np.float32)}),
            ("emb", R.embedding_attribute, {"attribute": 4},
             {"ids": rng.randint(0, 100, (16, 8)).astype(np.int32)})):
        key = "attn" if name == "attn" else "emb"
        ff = _ref_model(build, devices8,
                        _heads_strategy(RefStrategy, RefShard, key, **shard))
        ref[name] = np.asarray(ff.forward(feed))
        cases.append((R.forward, (build, _heads_strategy(
            Strategy, ShardConfig, key, **shard), ff.get_weights(), feed)))
    # _dryrun_multichip_body's TP and SP legs, one step each
    for name, ((build, t_build), batch, feed, y), strat, mine in (
            ("dry_tp", _dryrun_tp(), ref_tp(8, tp=2, num_layers=2),
             bert_tp_strategy(8, tp=2, num_layers=2)),
            ("dry_sp", _dryrun_sp(), ref_sp(8, sp=4),
             bert_sp_strategy(8, sp=4))):
        ff = _ref_model(build, devices8, strat, batch=batch)
        w = ff.get_weights()
        ref[name] = [float(ff.train_step(feed, y)["loss"])]
        cases.append((R.train_steps, (t_build, mine, w, [(feed, y)],
                                      functools.partial(TSGD, lr=0.01))))
    out = R.run_group(R.run_cases, 8, cases, timeout=240)
    return ref, out


def test_tensor_parallel_linear_matches_reference(eight):
    ref, out = eight
    for rank in out:
        np.testing.assert_allclose(rank[0], ref["mlp_fwd"], **TOL)


def test_tensor_parallel_training_matches_reference(eight):
    ref, out = eight
    got = out[0][1]
    np.testing.assert_allclose(got["losses"], ref["mlp_losses"], **TOL)
    for op, entries in ref["mlp_weights"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(got["weights"][op][k], v, rtol=5e-5,
                                       atol=5e-5)


def test_attention_head_parallel_matches_reference(eight):
    ref, out = eight
    for rank in out:
        np.testing.assert_allclose(rank[2], ref["attn"], **TOL)


def test_embedding_attribute_parallel_matches_reference(eight):
    ref, out = eight
    for rank in out:
        np.testing.assert_allclose(rank[3], ref["emb"], **TOL)


@pytest.mark.parametrize("leg,idx", [("dry_tp", 4), ("dry_sp", 5)])
def test_dryrun_multichip_legs_replay(eight, leg, idx):
    """The reference body's TP leg (dp 4 x tp 2, BERT hidden 64, 2
    layers) and SP leg (dp 2 x sp 4 ring attention) over 8 ranks."""
    ref, out = eight
    losses = [rank[idx]["losses"] for rank in out]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], ref[leg], **TOL)


# -- a DP x TP BERT over 2 SGD steps in a 4-rank group -----------------------

def test_dp_tp_bert_two_steps_match_reference(devices8):
    build, t_build = _builds(batch_size=8, **TINY_BERT)
    ff = _ref_model(build, devices8[:4], ref_tp(4, tp=2, num_layers=2),
                    batch=8)
    w = ff.get_weights()
    rng = np.random.RandomState(3)
    batches = [({"input": rng.randn(8, 16, 64).astype(np.float32)},
                rng.randint(0, 2, 8).astype(np.int32)) for _ in range(2)]
    ref_losses = [float(ff.train_step(*b)["loss"]) for b in batches]
    ref_w = ff.get_weights()
    ref_eval = float(ff.eval_step(*batches[0])["loss"])
    out = R.run_group(R.train_steps, 4, t_build,
                      bert_tp_strategy(4, tp=2, num_layers=2), w, batches,
                      functools.partial(TSGD, lr=0.01), timeout=180)
    for rank in out:
        np.testing.assert_allclose(rank["losses"], ref_losses, **TOL)
        np.testing.assert_allclose(rank["eval_loss"], ref_eval, **TOL)
    for op, entries in ref_w.items():
        for k, v in entries.items():
            np.testing.assert_allclose(out[0]["weights"][op][k], v, **TOL)


# -- redistribute and its adjoint over a 2 x 4 mesh --------------------------

MESH = {"a": 2, "b": 4}
# (src, dst) as (spec, partial axes): an all-to-all, slices and gathers
# over two axes, a reordered dim, reduce-scatters, an all-reduce, a
# to-partial and a swap of two dims' axes
REDIST = [
    (((("a",), (), ()), ()), (((), ("a",), ()), ())),
    ((((), (), ()), ()), ((("a", "b"), (), ()), ())),
    (((("a", "b"), (), ()), ()), (((), (), ()), ())),
    (((("b", "a"), (), ()), ()), ((("a", "b"), (), ()), ())),
    ((((), (), ()), ("a",)), (((), ("a",), ()), ())),
    ((((), (), ()), ("a", "b")), (((), (), ()), ())),
    (((("b",), (), ()), ("a",)), (((), (), ("a",)), ())),
    ((((), (), ()), ()), (((), (), ()), ("b",))),
    (((("a",), ("b",), ()), ()), (((("b",), ("a",), ()), ()))),
]


def _global(locals_, coords, spec, partial, shape):
    """The global tensor a layout's local tensors stand for: shards
    placed, partial axes summed, replicated copies averaged."""
    out = np.zeros(shape)
    used = {a for axes in spec for a in axes}
    dup = 1
    for a, n in MESH.items():
        if a not in used and a not in partial:
            dup *= n
    for loc, c in zip(locals_, coords):
        sl = []
        for d, axes in enumerate(spec):
            idx, n = 0, 1
            for a in axes:
                idx, n = idx * MESH[a] + c[a], n * MESH[a]
            size = shape[d] // n
            sl.append(slice(idx * size, (idx + 1) * size))
        out[tuple(sl)] += loc
    return out / dup


def test_redistribute_is_the_identity_and_its_backward_the_adjoint():
    """Every redistribution keeps the global tensor, and the grad it
    hands back stands, in the input's adjoint layout (sharded stays,
    replicated <-> partial), for the output's global grad."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 8, 4).astype(np.float32)
    g = rng.randn(8, 8, 4).astype(np.float32)
    out = R.run_group(R.redistribute_cases, 8, MESH, x, g, REDIST,
                      timeout=120)
    for i, ((s_spec, s_part), (d_spec, d_part)) in enumerate(REDIST):
        ys = [rank[i][0] for rank in out]
        grads = [rank[i][1] for rank in out]
        coords = [rank[i][2] for rank in out]
        np.testing.assert_allclose(
            _global(ys, coords, d_spec, set(d_part), x.shape), x,
            rtol=1e-6, atol=1e-6, err_msg=f"case {i} forward")
        used = {a for axes in s_spec for a in axes}
        adjoint = {a for a in MESH if a not in used and a not in s_part}
        np.testing.assert_allclose(
            _global(grads, coords, s_spec, adjoint, g.shape), g,
            rtol=1e-6, atol=1e-6, err_msg=f"case {i} backward")
