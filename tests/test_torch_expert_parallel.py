"""Expert parallelism in the port (tests/test_parallelism.py's MoE leg,
`__graft_entry__.py`'s expert leg): compile runs ShardConfig(expert=...)
strategies, and the search's, on a torch.distributed group.

The MoE graphs (the MoE MLP, a tiny MoE encoder, the MLP through
AggregateSpec) train under data parallelism (2 and 4), {expert: 4},
{data: 2, expert: 2} (the expert dim lands on the data axis: a true
all-to-all) and {data: 2, expert: 4}, with the ZeRO ladder, and under
the Unity and MCMC winners on the H100 spec; losses, weights and the
balance loss are held against the reference under the same strategy,
and each tensor's layout against the reference's view.

The port runs in spawned gloo groups (tests/torch_dist_ranks.py), one
each of 2, 4 and 8 ranks, spawned once for the module; the reference
runs in this process on the 8-device CPU mesh, on the same numpy inputs,
with its weights copied into the port.  Capacity factor 1 on the MLPs
makes capacity bind: pairs are dropped (checked on the first batch).
"""
import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_ranks as R  # noqa: E402
from test_torch_distributed import spec_as_partition  # noqa: E402
from test_torch_simulator import simple_machines  # noqa: E402

import flexflow_tpu as RF  # noqa: E402
import flexflow_tpu_torch as PF  # noqa: E402
from flexflow_tpu.ops.op import ShardConfig as RShard  # noqa: E402
from flexflow_tpu.parallel.machine import \
    view_to_spec as r_view_to_spec  # noqa: E402
from flexflow_tpu.strategy import Strategy as RStrategy  # noqa: E402
from flexflow_tpu.strategy import apply_strategy as r_apply  # noqa: E402
from flexflow_tpu.strategy import assign_views as r_views  # noqa: E402
from flexflow_tpu_torch.ops.op import ShardConfig  # noqa: E402
from flexflow_tpu_torch.optimizer import AdamOptimizer as TAdam  # noqa: E402
from flexflow_tpu_torch.optimizer import SGDOptimizer as TSGD  # noqa: E402
from flexflow_tpu_torch.parallel.machine import view_to_spec  # noqa: E402
from flexflow_tpu_torch.parallel.pipeline_plan import \
    plan_pipeline  # noqa: E402
from flexflow_tpu_torch.pcg import mcmc as p_mcmc  # noqa: E402
from flexflow_tpu_torch.pcg import unity as p_unity  # noqa: E402
from flexflow_tpu_torch.sim import simulator as p_sim  # noqa: E402
from flexflow_tpu_torch.strategy import (Strategy, apply_strategy,  # noqa
                                         assign_views)

TOL = dict(rtol=2e-5, atol=2e-5)
SGD = functools.partial(TSGD, lr=0.05)
ADAM = functools.partial(TAdam, alpha=1e-2)
STEPS = 2
MLP = functools.partial(R.moe_mlp, alpha=1.0)
MLP8 = functools.partial(R.moe_mlp, batch=8, num_exp=8)
ENC = R.moe_encoder


def strategy(cls, mesh, ep=0, names=(), shard=None):
    """`mesh`, the inputs split over data when it has that axis, and
    ShardConfig(expert=ep) on the named ops."""
    s = cls(mesh_axes=dict(mesh))
    if mesh.get("data", 1) > 1:
        s.edge_ops["__inputs__"] = [("repartition",
                                     {"dim": 0, "degree": mesh["data"]})]
    for n in names:
        s.shard_configs[n] = (shard or ShardConfig)(expert=ep)
    return s


def moe_names(layers=1):
    return [f"{k}_{i}" for i in range(layers)
            for k in ("group_by", "experts_dense")]


def _mlp_data(seed, batch=16, classes=4):
    rs = np.random.RandomState(seed)
    return ({"input": rs.randn(batch, 16).astype(np.float32)},
            rs.randint(0, classes, batch).astype(np.int32))


def _enc_data(seed, batch=8):
    rs = np.random.RandomState(seed)
    return ({"input": rs.randn(batch, 8, 16).astype(np.float32)},
            rs.randint(0, 4, (batch, 8)).astype(np.int32))


def reference(build, world, devices, rstrat, data, opt=None, batch=16):
    """The reference's weights, its balance losses on the first batch,
    its losses over the batches and its weights after them."""
    import jax

    ff = RF.FFModel(RF.FFConfig(batch_size=batch, num_devices=world))
    build(ff)
    ff.compile(optimizer=opt or RF.SGDOptimizer(lr=0.05),
               loss_type=RF.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=rstrat, devices=devices[:world], seed=0)
    w0 = ff.get_weights()
    put = {k: jax.device_put(v, ff.executor.input_shardings()[k])
           for k, v in data[0][0].items()}
    _, _, aux, _ = ff.executor.run_forward(ff._weights, ff._state, put,
                                           training=True, rng=None)
    losses = [float(ff.train_step(x, y)["loss"]) for x, y in data]
    return {"w0": w0, "aux": [float(a) for a in aux], "losses": losses,
            "after": ff.get_weights()}


def port_cases(key, build, pstrat, ref, data, opt=SGD):
    """The rank functions of one case: 2 steps (the last through fit)
    and the balance losses of a training forward on the first batch."""
    return {(key, "steps"): (R.train_steps, (build, pstrat, ref["w0"], data,
                                             opt), {"fit_last": True}),
            (key, "aux"): (R.balance_losses, (build, pstrat, ref["w0"],
                                              data[0][0]))}


def _run(world, cases):
    names = list(cases)
    got = R.run_group(R.run_cases, world, [cases[k] for k in names],
                      timeout=240)
    return {k: [rank[i] for rank in got] for i, k in enumerate(names)}


# (name, build, mesh, expert degree, the ops it names, data, batch)
CASES = {
    2: [("mlp_dp2", MLP, {"data": 2}, 0, (), _mlp_data, 16),
        ("enc_dp2", ENC, {"data": 2}, 0, (), _enc_data, 8)],
    4: [("mlp_dp4", MLP, {"data": 4}, 0, (), _mlp_data, 16),
        ("enc_dp4", ENC, {"data": 4}, 0, (), _enc_data, 8),
        ("mlp_ep4", MLP, {"expert": 4}, 4, moe_names(), _mlp_data, 16),
        ("enc_ep4", ENC, {"expert": 4}, 4, moe_names(2), _enc_data, 8),
        ("mlp_dp2_ep2", MLP, {"data": 2, "expert": 2}, 2, moe_names(),
         _mlp_data, 16),
        ("enc_dp2_ep2", ENC, {"data": 2, "expert": 2}, 2, moe_names(2),
         _enc_data, 8),
        ("spec_dp2_ep2", R.moe_spec, {"data": 2, "expert": 2}, 2,
         moe_names(), _mlp_data, 16)],
    8: [("graft", MLP8, {"data": 2, "expert": 4}, 4, moe_names(),
         functools.partial(_mlp_data, batch=8), 8),
        ("mlp_dp2_ep4", functools.partial(R.moe_mlp, num_exp=8, alpha=1.0),
         {"data": 2, "expert": 4}, 4, moe_names(), _mlp_data, 16)],
}


def _group(world, devices8, extra=None):
    refs, cases = {}, {}
    for name, build, mesh, ep, names, data_fn, batch in CASES[world]:
        data = [data_fn(s) for s in range(STEPS)]
        ref = reference(build, world, devices8,
                        strategy(RStrategy, mesh, ep, names, RShard), data,
                        batch=batch)
        refs[name] = ref
        cases.update(port_cases(name, build, strategy(Strategy, mesh, ep,
                                                      names), ref, data))
    if extra is not None:
        extra(refs, cases)
    return refs, _run(world, cases)


@pytest.fixture(scope="module")
def two(devices8):
    return _group(2, devices8)


@pytest.fixture(scope="module")
def four(devices8):
    return _group(4, devices8)


def _eight_extra(devices8):
    def add(refs, cases):
        # ZeRO stage 1 under Adam, against stage 0 and the reference
        data = [_mlp_data(s) for s in range(STEPS)]
        build = functools.partial(R.moe_mlp, num_exp=8, alpha=1.0)
        mesh = {"data": 2, "expert": 4}
        ref = reference(build, 8, devices8,
                        strategy(RStrategy, mesh, 4, moe_names(), RShard),
                        data, opt=RF.AdamOptimizer(alpha=1e-2))
        refs["adam"] = ref
        for stage in (0, 1, 2, 3):
            s = strategy(Strategy, mesh, 4, moe_names())
            s.zero_stage = stage
            cases[("zero", stage)] = (R.train_steps, (build, s, ref["w0"],
                                                      data, ADAM))
        # test_parallelism.py::test_moe_expert_parallel's forward
        rs = RStrategy(mesh_axes={"data": 2, "expert": 4})
        rs.edge_ops["__inputs__"] = [("repartition", {"dim": 0,
                                                      "degree": 2})]
        for n in ("group_by_0", "experts_dense_0"):
            rs.shard_configs[n] = RShard(expert=4)
        x = np.random.RandomState(5).randn(32, 16).astype(np.float32)
        ff = RF.FFModel(RF.FFConfig(batch_size=32, num_devices=8))
        _moe_forward_graph(ff)
        ff.compile(strategy=rs, devices=devices8, seed=4,
                   loss_type=RF.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        one = RF.FFModel(RF.FFConfig(batch_size=32))
        _moe_forward_graph(one)
        one.compile(devices=devices8[:1], seed=4,
                    loss_type=RF.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        one.set_weights(ff.get_weights())
        refs["fwd"] = (np.asarray(ff.forward({"x": x})),
                       np.asarray(one.forward({"x": x})))
        cases["fwd"] = (R.forward, (_moe_forward_graph,
                                    Strategy.from_json(rs.to_json()),
                                    ff.get_weights(), {"x": x}))
        # the searches' strategies for the tiny MoE MLPs
        for key, build_s, search in (
                ("unity", R.moe_mlp, _unity),
                ("mcmc", functools.partial(R.moe_mlp, num_exp=8), _mcmc)):
            best = search(build_s)
            refs[key + "_strategy"] = best
            data = [_mlp_data(10 + s) for s in range(STEPS)]
            refs[key] = reference(build_s, 8, devices8,
                                  RStrategy.from_json(best.to_json()), data)
            cases.update(port_cases(key, build_s, best, refs[key], data))
    return add


@pytest.fixture(scope="module")
def eight(devices8):
    return _group(8, devices8, _eight_extra(devices8))


def _moe_forward_graph(ff):
    """tests/test_parallelism.py::test_moe_expert_parallel's graph."""
    x = ff.create_tensor([32, 16], name="x")
    ff.moe(x, num_exp=4, num_select=2, expert_hidden_size=8, alpha=2.0)


def _unity(build):
    _, pm = simple_machines(8)
    ff = PF.FFModel(PF.FFConfig(device="cpu", batch_size=16))
    build(ff)
    return p_unity.UnitySearch(ff.layers, 8, pm,
                               p_sim.OpCostModel(pm)).optimize()


def _mcmc(build):
    _, pm = simple_machines(8)
    ff = PF.FFModel(PF.FFConfig(device="cpu", batch_size=16))
    build(ff)
    return p_mcmc.MCMCSearch(ff.layers, 8, lambda: p_sim.Simulator(pm),
                             budget=60, seed=0).optimize()


def _check_case(ref, out, key):
    """Losses, weights and balance losses of every rank against the
    reference's."""
    for rank in out[(key, "steps")]:
        assert np.isfinite(rank["losses"]).all()
        np.testing.assert_allclose(rank["losses"], ref["losses"], **TOL)
    w = out[(key, "steps")][0]["weights"]
    assert set(w) == set(ref["after"])
    for op, entries in ref["after"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(w[op][k], np.asarray(v), **TOL,
                                       err_msg=f"{key}: {op}.{k}")
    assert ref["aux"] and all(a > 0 for a in ref["aux"])
    for rank in out[(key, "aux")]:
        np.testing.assert_allclose(rank["aux"], ref["aux"], **TOL)


@pytest.mark.parametrize("key", ["mlp_dp2", "enc_dp2"])
def test_moe_trains_under_data_parallel_2(two, key):
    """The repair: a MoE graph under plain data parallelism (ExpertsDense
    planned by its class, not as a Linear), 2 SGD steps through fit,
    against the reference."""
    ref, out = two
    _check_case(ref[key], out, key)


@pytest.mark.parametrize("key", ["mlp_dp4", "enc_dp4", "mlp_ep4", "enc_ep4",
                                 "mlp_dp2_ep2", "enc_dp2_ep2",
                                 "spec_dp2_ep2"])
def test_moe_trains_under_expert_parallel_4(four, key):
    """Data 4, {expert: 4} (experts split, tokens replicated), {data: 2,
    expert: 2} (the expert dim on the data axis: tokens and experts both
    split over it) and AggregateSpec there: losses, weights and the
    balance loss over 2 steps."""
    ref, out = four
    _check_case(ref[key], out, key)


@pytest.mark.parametrize("key", ["graft", "mlp_dp2_ep4"])
def test_moe_trains_under_data_2_expert_4(eight, key):
    """`__graft_entry__.py`'s expert leg (8 experts at {data: 2, expert:
    4}, batch 8) and the same mesh at batch 16 with a binding capacity."""
    ref, out = eight
    _check_case(ref[key], out, key)


def test_moe_expert_parallel_forward(eight):
    """tests/test_parallelism.py::test_moe_expert_parallel replayed: the
    {data: 2, expert: 4} forward equals the reference's and one
    device's."""
    ref, out = eight
    sharded, one = ref["fwd"]
    np.testing.assert_allclose(sharded, one, **TOL)
    for rank in out["fwd"]:
        np.testing.assert_allclose(rank, sharded, **TOL)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_ladder_takes_expert_sharded_leaves(eight, stage):
    """The ZeRO ladder under Adam on {data: 2, expert: 4}: the expert
    kernels (sharded over expert) take the sharded update over data, and
    each stage trains stage 0's and the reference's losses and
    weights."""
    ref, out = eight
    z0, z1 = out[("zero", 0)][0], out[("zero", stage)][0]
    assert z1["zero_stage"] == stage
    assert not any(f.startswith("experts_dense") for f in z1["fallback"])
    assert z1["opt_bytes"] < z0["opt_bytes"]
    np.testing.assert_allclose(z1["losses"], z0["losses"], **TOL)
    np.testing.assert_allclose(z1["losses"], ref["adam"]["losses"], **TOL)
    for op, entries in ref["adam"]["after"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(z1["weights"][op][k], np.asarray(v),
                                       **TOL)
            np.testing.assert_allclose(z1["weights"][op][k],
                                       z0["weights"][op][k], **TOL)


@pytest.mark.parametrize("key", ["unity", "mcmc"])
def test_searched_moe_strategy_compiles_and_trains(eight, key):
    """The Unity and MCMC winners for the tiny MoE MLPs on the explicit
    H100 spec carry an expert axis; compile runs them on 8 ranks, and
    they train the reference's losses and weights under the same
    strategy."""
    ref, out = eight
    best = ref[key + "_strategy"]
    assert best.total_devices == 8 and best.mesh_axes.get("expert", 1) > 1
    _check_case(ref[key], out, key)


@pytest.mark.parametrize("key", ["mlp_dp4", "mlp_dp2_ep2"])
def test_capacity_binds_in_the_mlp_cases(four, key):
    """The MLP cases drop pairs at capacity factor 1 (so the global slot
    order decides which): the reference's weights on one device, the
    first batch's GroupBy assignment through the dispatch's keep rule."""
    from flexflow_tpu_torch.ops.moe_dispatch import dispatch_indices

    ref, _ = four
    ff = PF.FFModel(PF.FFConfig(device="cpu", batch_size=16))
    MLP(ff)
    ff.compile(seed=0)
    ff.set_weights(ref[key]["w0"])
    seen = []
    op = next(o for o in ff.operators.ops if o.op_type.name == "GROUP_BY")
    fwd = op.forward

    def watched(ins, ws, **kw):
        seen.append(ins[1])
        return fwd(ins, ws, **kw)

    op.forward = watched
    ff.forward(_mlp_data(0)[0])
    cap = op.outputs[0].shape.logical_shape[1]
    _, keep = dispatch_indices(seen[0], cap, op.params.n)
    assert 0 < int((~keep).sum()) < keep.numel()


def test_expert_collectives_move_rows(four):
    """The dispatch and combine move rows by the variable all-to-all and
    nothing else where the expert dim is on the token axis; with the
    tokens replicated ({expert: 4}) GroupBy moves nothing and Aggregate
    reduces its partial sum."""
    _, out = four
    for rank in out[("mlp_dp2_ep2", "aux")]:
        kinds = {k for (scope, k), v in rank["traffic"].items()
                 if scope in ("GroupBy", "Aggregate") and v}
        assert "all_to_all_v" in kinds and "all_reduce" in kinds
    for rank in out[("mlp_ep4", "aux")]:
        t = rank["traffic"]
        assert not any(v for (scope, _), v in t.items()
                       if scope == "GroupBy")
        assert t[("Aggregate", "all_reduce")] > 0


@pytest.mark.parametrize("mesh,ep,names", [
    ({"data": 2, "expert": 4}, 4, ("group_by_0", "experts_dense_0")),
    ({"data": 2, "expert": 2}, 2, ("group_by_0", "experts_dense_0")),
    ({"expert": 4}, 4, ("group_by_0", "experts_dense_0")),
    ({"data": 4}, 0, ()),
])
def test_views_equal_the_references(mesh, ep, names):
    """Each tensor's layout spec under the expert strategies equals the
    reference's `view_to_spec` (group_by and the expert kernel on
    'expert', on 'data' at {data: 2, expert: 2}, aggregate on 'data')."""
    build = functools.partial(R.moe_mlp, num_exp=8)
    fr = RF.FFModel(RF.FFConfig(batch_size=16))
    build(fr)
    rs = strategy(RStrategy, mesh, ep, names, RShard)
    rg = r_apply(fr.layers, rs)
    r_views(rg, rs.mesh_axes)
    fp = PF.FFModel(PF.FFConfig(device="cpu", batch_size=16))
    build(fp)
    ps = strategy(Strategy, mesh, ep, names)
    pg = apply_strategy(fp.layers, ps)
    assign_views(pg, ps.mesh_axes)
    want = {pt.name: tuple(r_view_to_spec(pt))
            for op in rg.ops for pt in list(op.outputs) + list(op.weights)}
    got = {pt.name: spec_as_partition(view_to_spec(pt))
           for op in pg.ops for pt in list(op.outputs) + list(op.weights)}
    assert got == want
    gb = next(op for op in pg.ops if op.name == "group_by_0").outputs[0]
    expect = {2: ("data",), 4: ("expert",), 0: ()}[ep]
    assert view_to_spec(gb)[0] == expect


def test_plan_pipeline_refuses_moe_blocks():
    """A pipeline over MoE encoder blocks raises, naming the ROADMAP
    item, at planning and at compile."""
    ff = PF.FFModel(PF.FFConfig(device="cpu", batch_size=8))
    R.moe_encoder(ff, layers=4)
    pipe = {"degree": 2, "num_microbatches": 2, "axis": "pipe",
            "dp_axis": None}
    with pytest.raises(ValueError, match="pipelined block.*ROADMAP"):
        plan_pipeline(ff.layers, pipe, {"pipe": 2})
    s = Strategy(mesh_axes={"pipe": 1}, pipeline=dict(pipe, degree=1))
    with pytest.raises(ValueError, match="pipelined block"):
        ff.compile(strategy=s)
