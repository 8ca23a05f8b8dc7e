"""The port's multi-slice hierarchy (tests/test_topology.py, outside its
rendezvous, store-key and fidelity groups): topology/hierarchy.py's
`SliceHierarchy` on H100 nodes and its placement helpers, placement as
a costed dimension of both searches, and the executor's two-level mesh
with the hierarchical gradient reduction.

Costs depend on the machine, so they are held against the reference's
`SliceHierarchy` built on a 1-D ring at the same explicit rates (its
ring runs both directions: an ICI link of half the NVLink rate is the
same bandwidth), or against the formulas; the placement helpers' and
the searches' outputs are compared directly.  The executor's cases run
in one spawned 8-rank gloo group (tests/torch_dist_ranks.py); the
reference runs in this process on the 8-device CPU mesh.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_ranks as R  # noqa: E402

import flexflow_tpu as RF  # noqa: E402
from flexflow_tpu.topology import hierarchy as RH  # noqa: E402
from flexflow_tpu_torch import FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.fftype import ActiMode  # noqa: E402
from flexflow_tpu_torch.pcg.evaluator import (IncrementalEvaluator,  # noqa
                                              strategy_signature)
from flexflow_tpu_torch.pcg.mcmc import MCMCSearch  # noqa: E402
from flexflow_tpu_torch.pcg.unity import UnitySearch  # noqa: E402
from flexflow_tpu_torch.sim.machine_model import GpuNodeModel  # noqa: E402
from flexflow_tpu_torch.sim.simulator import (OpCostModel,  # noqa: E402
                                              Simulator)
from flexflow_tpu_torch.strategy import (Strategy,  # noqa: E402
                                         data_parallel_strategy)
from flexflow_tpu_torch.topology.hierarchy import (  # noqa: E402
    SLICE_AXIS, SliceHierarchy, execution_mesh, expand_mesh_axes,
    hierarchy_from_config, legal_placements, parse_slice_topology,
    placement_stats, resolve_placement)

NVLINK, NV_LAT = 450e9, 1e-6


def _hier(dcn_bw=4e9, dcn_lat=2e-6, slices=2, topo=(4,)):
    return SliceHierarchy(topology=topo, slices=slices, ib_bw=dcn_bw,
                          ib_lat=dcn_lat)


def _ref_hier(dcn_bw=4e9, dcn_lat=2e-6, slices=2, topo=(4,)):
    """The reference's hierarchy at the port's rates: a 1-D ring whose
    links carry half NVLink's rate each way (its formulas count two)."""
    return RH.SliceHierarchy(topology=topo, slices=slices,
                             ici_bw_per_link=NVLINK / 2,
                             ici_latency=NV_LAT, dcn_bw_per_host=dcn_bw,
                             dcn_latency=dcn_lat)


# -- machine model -------------------------------------------------------

def test_hierarchical_allreduce_between_pure_bounds():
    """RS inside -> AR of the shard between -> AG inside costs more than
    an all-NVLink ring and less than an all-InfiniBand one."""
    m = _hier()
    size = 64 * 2**20
    for intra, inter in [(4, 2), (2, 4), (8, 2)]:
        n = intra * inter
        ici = m.tier_collective("allreduce", size, n).time
        dcn = m.tier_collective("allreduce", size, n, over_dcn=True).time
        hier = m.hierarchical_allreduce_time(size, intra, inter)
        assert ici < hier < dcn, (intra, inter, ici, hier, dcn)


def test_hierarchical_cost_degenerates_at_trivial_legs():
    m = _hier()
    size = 1 << 20
    assert m.hierarchical_cost("allreduce", size, 1, 2).time == \
        m.tier_collective("allreduce", size, 2, over_dcn=True).time
    assert m.hierarchical_cost("allreduce", size, 4, 1).time == \
        m.tier_collective("allreduce", size, 4).time


def test_collective_cost_tier_split_accounting():
    m = _hier()
    size = 8 * 2**20
    cc = m.collective_cost("allreduce", size, 8, cross=True)  # (4, 2)
    assert cc.dcn_bytes == pytest.approx(size / 4.0)
    assert cc.ici_bytes == pytest.approx(2 * 0.75 * size)
    flat = m.collective_cost("allreduce", size, 8, cross=False)
    assert flat.dcn_bytes == 0 and flat.dcn_time == 0
    assert flat.time < cc.time


def test_split_group_and_unfactorable_fallback():
    m = _hier(slices=2)
    assert m.split_group(8) == (4, 2)
    assert m.split_group(2) == (1, 2)
    assert m.split_group(3) == (1, 3)
    assert m.split_group(8) == _ref_hier(slices=2).split_group(8)


@pytest.mark.parametrize("kind", ["allreduce", "allgather", "reducescatter",
                                  "alltoall"])
@pytest.mark.parametrize("group,cross", [(2, False), (4, False), (8, True),
                                         (2, True), (6, True), (4, True)])
def test_costs_equal_the_reference_on_a_ring_at_the_same_rates(kind, group,
                                                               cross):
    """Every tier split, time and byte count of the port's hierarchy is
    the reference's on a 1-D ring at the same rates (groups inside a
    slice of at most 4, where the ring's all-to-all pays no bisection
    factor), with and without the grad-sync latency scale."""
    m, r = _hier(), _ref_hier()
    size = 3 * 2**20 + 12
    for scale in (1.0, 0.25):
        got = m.collective_cost(kind, size, group, cross=cross,
                                dcn_lat_scale=scale)
        want = r.collective_cost(kind, size, group, cross=cross,
                                 dcn_lat_scale=scale)
        for f in ("ici_time", "dcn_time", "ici_bytes", "dcn_bytes"):
            assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                    rel=1e-12), f


def test_multi_slice_torus_routing_hand_computed():
    from flexflow_tpu_torch.sim.network import (NetworkedMachineModel,
                                                multi_slice_torus)

    conn = multi_slice_torus((4,), slices=2)
    assert conn.shape == (8, 8)
    assert conn[0, 4] == 1 and conn[4, 0] == 1
    assert conn[0, 5] == 0
    m = NetworkedMachineModel(conn, link_bandwidth=1e9, link_latency=1e-6)
    size = 1 << 20
    assert np.isclose(m.p2p_time(size, 0, 1), 1e-6 + size / 1e9)
    assert np.isclose(m.p2p_time(size, 0, 4), 1e-6 + size / 1e9)
    assert np.isclose(m.p2p_time(size, 0, 5), 2e-6 + size / 1e9)


def test_flat_costs_unchanged_on_single_slice():
    """Inside a slice the hierarchy's costs are a GpuNodeModel's flat
    NVLink ones, exactly."""
    flat = GpuNodeModel(num_nodes=1, gpus_per_node=4)
    m = _hier(topo=(4,))
    size = 3 << 20
    for n in (2, 4):
        assert m.collective_cost("allreduce", size, n).time == \
            flat.axis_allreduce_time(size, n)
        assert m.collective_cost("allgather", size, n).time == \
            flat.axis_allgather_time(size, n)


# -- placement helpers ---------------------------------------------------

@pytest.mark.parametrize("axes,slices", [
    ({"data": 4, "model": 2}, 2), ({"data": 4, "model": 2}, 4),
    ({"data": 4, "model": 2}, 3), ({"data": 4, "model": 2}, 1),
    ({"model": 3}, 2), ({"model": 4, "data": 2}, 2), ({"data": 8}, 2)])
def test_placement_helpers_equal_the_reference(axes, slices):
    assert legal_placements(axes, slices) == RH.legal_placements(axes, slices)
    assert resolve_placement(axes, slices) == RH.resolve_placement(axes,
                                                                   slices)
    for p in axes:
        try:
            want = RH.expand_mesh_axes(axes, slices, p)
        except ValueError:
            with pytest.raises(ValueError):
                expand_mesh_axes(axes, slices, p)
            continue
        got = expand_mesh_axes(axes, slices, p)
        assert got == want and list(got[0]) == list(want[0])


def test_placement_helpers():
    axes = {"data": 4, "model": 2}
    assert legal_placements(axes, 2) == ["data", "model"]
    assert legal_placements(axes, 4) == ["data"]
    assert legal_placements(axes, 3) == []
    assert resolve_placement(axes, 2) == "data"
    assert resolve_placement({"model": 3}, 2) is None
    assert legal_placements(axes, 1) == []


def test_expand_mesh_axes_splits_and_reorders():
    exec_axes, hier = expand_mesh_axes({"data": 8}, 2, "data")
    assert exec_axes == {SLICE_AXIS: 2, "data": 4} and hier == "data"
    exec_axes, hier = expand_mesh_axes({"model": 2, "data": 4}, 2, "data")
    assert list(exec_axes) == [SLICE_AXIS, "model", "data"]
    assert exec_axes["data"] == 2 and hier == "data"
    exec_axes, hier = expand_mesh_axes({"model": 4, "data": 2}, 2, "data")
    assert list(exec_axes) == ["data", "model"]
    assert exec_axes["data"] == 2 and hier is None
    with pytest.raises(ValueError):
        expand_mesh_axes({"data": 3}, 2, "data")


@pytest.mark.parametrize("axes,slices,devices,placement,pipeline,want", [
    ({"data": 8}, 2, 8, None, None, ({SLICE_AXIS: 2, "data": 4}, "data")),
    ({"data": 8}, 3, 8, None, None, ({"data": 8}, None)),
    ({SLICE_AXIS: 2, "data": 4}, 2, 8, None, None,
     ({SLICE_AXIS: 2, "data": 4}, None)),
    ({"data": 4, "model": 2}, 2, 8, "expert", None,
     ({SLICE_AXIS: 2, "data": 2, "model": 2}, "data")),
    ({"data": 4, "model": 2}, 2, 8, "model", None,
     ({"model": 2, "data": 4}, None)),
    ({"model": 3}, 2, 6, None, None, ({"model": 3}, None)),
    ({"data": 2, "pipe": 4}, 2, 8, None, {"degree": 4},
     ({"data": 2, "pipe": 4}, None)),
    ({"data": 8}, 1, 8, None, None, ({"data": 8}, None)),
])
def test_execution_mesh_falls_back_as_the_reference_compile(
        axes, slices, devices, placement, pipeline, want):
    """The cases of flexflow_tpu/model.py:788-845: the expanded mesh, or
    flat when the devices do not split, the slice axis is taken, no
    axis divides, under a pipeline or at one slice; an illegal
    placement takes the default."""
    got = execution_mesh(axes, slices, devices, placement, pipeline)
    assert got == want and list(got[0]) == list(want[0])


def test_parse_slice_topology():
    assert parse_slice_topology("4x4") == (4, 4)
    assert parse_slice_topology("2,2,2") == (2, 2, 2)
    for bad in ("", "axb", "0,4", "-1"):
        with pytest.raises(ValueError):
            parse_slice_topology(bad)
        with pytest.raises(ValueError):
            RH.parse_slice_topology(bad)


def test_hierarchy_from_config_validates():
    cfg = FFConfig(device="cpu", slices=2, slice_topology="2,2")
    m = hierarchy_from_config(cfg, 8)
    assert m.slices == 2 and m.topology == (2, 2) and m.gpus_per_node == 4
    assert (m.ib_bw, m.ib_lat) == (50e9, 5e-6)
    with pytest.raises(ValueError):
        hierarchy_from_config(FFConfig(device="cpu", slices=3), 8)
    with pytest.raises(ValueError):
        hierarchy_from_config(FFConfig(device="cpu", slices=2,
                                       slice_topology="4x4"), 8)
    # a machine-model file gives one slice's NVLink and device
    from flexflow_tpu_torch.sim.machine_model import machine_file

    m = hierarchy_from_config(FFConfig(
        device="cpu", slices=2, dcn_bandwidth=1e9,
        machine_model_file=machine_file("hgx_h100_16")), 16)
    assert m.topology == (8,) and m.nvlink_bw == 450e9 and m.ib_bw == 1e9


def test_degraded_mesh_machine_model_degrades_to_flat():
    from flexflow_tpu_torch.sim.machine_model import make_machine_model

    m = make_machine_model(FFConfig(device="cpu", slices=3), 8)
    assert not isinstance(m, SliceHierarchy)
    m = make_machine_model(FFConfig(device="cpu", slices=2,
                                    slice_topology="4"), 4)
    assert not isinstance(m, SliceHierarchy)
    assert isinstance(make_machine_model(
        FFConfig(device="cpu", slices=2, slice_topology="4"), 8),
        SliceHierarchy)


# -- placement as a searched dimension -----------------------------------

def _wide_mlp(batch=1024, h=64, pkg="port"):
    if pkg == "port":
        ff = FFModel(FFConfig(device="cpu", batch_size=batch))
        act = ActiMode.RELU
    else:
        ff = RF.FFModel(RF.FFConfig(batch_size=batch))
        act = RF.ActiMode.RELU
    x = ff.create_tensor([batch, h], name="x")
    t = ff.dense(x, h, activation=act)
    t = ff.dense(t, h, activation=act)
    t = ff.dense(t, 8)
    ff.softmax(t)
    return ff


def test_placement_is_a_costed_dimension():
    """The same sharding under two placements costs differently, the
    data placement less (the tensor-parallel partial sums stay on
    NVLink), and the signature tells them apart."""
    graph = _wide_mlp().layers
    m = _hier()
    ev = IncrementalEvaluator(graph, Simulator(m))
    s = MCMCSearch(graph, 8, lambda: Simulator(m), budget=0)
    flags = {c.name: True for c in s.candidates if c.name != "dense_2"}
    r = {}
    for p in ("data", "model"):
        cand = s._build(4, 2, 1, flags, None, p)
        assert cand.placement == p
        r[p] = ev.evaluate(cand)
    assert r["data"].total_time != r["model"].total_time
    assert r["data"].total_time < r["model"].total_time
    base = data_parallel_strategy(8)
    sigs = {strategy_signature(dataclasses.replace(base, placement=p))
            for p in (None, "data")}
    assert len(sigs) == 2


def test_both_searches_choose_intra_slice_tp_and_hierarchical_reduction(
        monkeypatch):
    """2 slices, the tier between them 45x slower than the one inside:
    MCMC and Unity keep the tensor-parallel groups in a slice (the data
    axis crosses) and reduce hierarchically, as the reference's searches
    do in the same scenario on its ring."""
    import flexflow_tpu.pcg.unity as r_unity
    import flexflow_tpu_torch.pcg.unity as unity_mod
    from flexflow_tpu.pcg.mcmc import MCMCSearch as RMCMC
    from flexflow_tpu.sim.simulator import OpCostModel as ROpCost
    from flexflow_tpu.sim.simulator import Simulator as RSim

    ff, ffr = _wide_mlp(), _wide_mlp(pkg="ref")
    # test_topology.py's rates: ICI 90e9 a link (180e9 over its ring's
    # two directions), DCN 4e9 (45x slower)
    m = SliceHierarchy(topology=(4,), slices=2, nvlink_bw=180e9,
                       nvlink_lat=1e-6, ib_bw=4e9, ib_lat=2e-6)
    rm = RH.SliceHierarchy(topology=(4,), slices=2, dcn_bw_per_host=4e9,
                           dcn_latency=2e-6)
    got, want = {}, {}
    for out, layers, sim, search, mach in (
            (got, ff.layers, Simulator, MCMCSearch, m),
            (want, ffr.layers, RSim, RMCMC, rm)):
        mc = search(layers, 8, lambda: sim(mach), budget=100, seed=0)
        mc.factorizations = [(4, 2, 1)]
        out["mcmc"] = mc.optimize().search_stats
    for mod in (unity_mod, r_unity):
        monkeypatch.setattr(mod, "_factorizations",
                            lambda n, allow_expert=True: [(4, 2, 1)])
    ub = UnitySearch(ff.layers, 8, m, OpCostModel(m), enable_pipeline=False,
                     dcn_bucket_bytes=0).optimize()
    got["unity"] = ub.search_stats
    want["unity"] = r_unity.UnitySearch(
        ffr.layers, 8, rm, ROpCost(rm), enable_pipeline=False,
        dcn_bucket_bytes=0).optimize().search_stats
    for k in ("mcmc", "unity"):
        for f in ("placement", "hierarchical_reduction"):
            assert got[k][f] == want[k][f], (k, f)
        assert got[k]["placement"] == "data"
        assert got[k]["hierarchical_reduction"] is True
    res = IncrementalEvaluator(ff.layers, Simulator(m)).evaluate(ub)
    assert 0 < res.comm_tiers["dcn_bytes"] < res.comm_tiers["ici_bytes"]


def test_flat_machine_searches_carry_empty_placement():
    graph = _wide_mlp(batch=16).layers
    m = GpuNodeModel(num_nodes=1, gpus_per_node=8)
    best = MCMCSearch(graph, 8, lambda: Simulator(m), budget=10,
                      seed=0).optimize()
    assert best.search_stats["placement"] == ""
    assert best.search_stats["hierarchical_reduction"] is False
    assert best.placement is None


def test_placement_round_trips_serialization():
    s = data_parallel_strategy(8)
    s.placement = "data"
    s2 = Strategy.from_json(s.to_json())
    assert s2.placement == "data"
    assert strategy_signature(s) == strategy_signature(s2)
    assert RF.Strategy.from_json(s.to_json()).placement == "data"


def test_placement_stats_empty_for_pipeline_winners():
    kw = dict(mesh_axes={"data": 2, "pipe": 4},
              pipeline={"degree": 4, "num_microbatches": 8, "axis": "pipe",
                        "dp_axis": "data"})
    s, rs = Strategy(**kw), RF.Strategy(**kw)
    assert placement_stats(s, 2) == RH.placement_stats(rs, 2) == {
        "placement": "", "hierarchical_reduction": False}
    d, rd = data_parallel_strategy(8), RF.data_parallel_strategy(8)
    assert placement_stats(d, 2) == RH.placement_stats(rd, 2) == {
        "placement": "data", "hierarchical_reduction": True}


def test_wus_group_shrinks_to_intra_remainder():
    m = _hier()
    sim = Simulator(m, zero_stage=1)
    graph = _wide_mlp(batch=16).layers
    res = IncrementalEvaluator(graph, sim).evaluate(data_parallel_strategy(8))
    w = next(op for op in res.ops if op.weights).weights[0]
    assert sim.wus_group(w, {"data": 8}, placement="data") == 4
    assert sim.wus_group(w, {"data": 8}, placement=None) == 8


def test_flat_simulator_costs_ignore_the_placement():
    """Off a hierarchy the placement changes no cost: the flat machine's
    totals are those of a strategy without one."""
    graph = _wide_mlp(batch=16).layers
    m = GpuNodeModel(num_nodes=1, gpus_per_node=8)
    ev = IncrementalEvaluator(graph, Simulator(m))
    a = ev.evaluate(data_parallel_strategy(8))
    b = ev.evaluate(dataclasses.replace(data_parallel_strategy(8),
                                        placement="data"))
    assert a.total_time == b.total_time
    assert a.per_device_memory == b.per_device_memory


# -- the executor: the two-level mesh on 8 gloo ranks --------------------

@pytest.fixture(scope="module")
def slices8(devices8):
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 32).astype(np.float32)
    ys = rng.randint(0, 8, 64).astype(np.int32)
    ff = RF.FFModel(RF.FFConfig(batch_size=16, num_devices=8, slices=2))
    R.slice_mlp(ff)
    ff.compile(optimizer=RF.SGDOptimizer(lr=0.05),
               loss_type=RF.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=RF.data_parallel_strategy(8), devices=devices8,
               seed=0)
    ref = {"mesh": dict(zip(ff.mesh.axis_names, ff.mesh.devices.shape)),
           "hier_axis": ff.executor.hier_axis, "w0": ff.get_weights()}
    ff.fit(xs, ys, epochs=2, verbose=False)
    ref["after"] = ff.get_weights()
    dp = data_parallel_strategy(8)
    w0 = ref["w0"]
    cases = {
        "hier": (R.slice_fit, (dp, w0, xs, ys, {"slices": 2})),
        "flat": (R.slice_fit, (dp, w0, xs, ys, {"slices": 2}),
                 {"flat": True}),
        "plain": (R.slice_fit, (dp, None, xs, ys, {})),
        "one": (R.slice_fit, (dp, None, xs, ys, {"slices": 1})),
        "zero1": (R.slice_fit, (dp, w0, xs, ys, {"slices": 2,
                                                 "zero_stage": 1})),
    }
    # the MoE MLP over two slices: tokens on (slice, data), where the
    # MoE plans take one token axis and gather the rest
    import functools

    from flexflow_tpu.ops.op import ShardConfig as RShard
    from flexflow_tpu_torch.ops.op import ShardConfig
    from flexflow_tpu_torch.optimizer import SGDOptimizer as TSGD

    rs = np.random.RandomState(5)
    batches = [({"input": rs.randn(16, 16).astype(np.float32)},
                rs.randint(0, 4, 16).astype(np.int32)) for _ in range(2)]
    moe = functools.partial(R.moe_mlp, alpha=1.0)
    for key, mesh, ep in (("moe_dp8", {"data": 8}, 0),
                          ("moe_dp4_ep2", {"data": 4, "expert": 2}, 2)):
        rstrat, strat = (_moe_strategy(RF.Strategy, RShard, mesh, ep),
                         _moe_strategy(Strategy, ShardConfig, mesh, ep))
        ff = RF.FFModel(RF.FFConfig(batch_size=16, num_devices=8, slices=2))
        moe(ff)
        ff.compile(optimizer=RF.SGDOptimizer(lr=0.05),
                   loss_type=RF.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   strategy=rstrat, devices=devices8, seed=0)
        w = ff.get_weights()
        ref[key] = {"mesh": dict(zip(ff.mesh.axis_names,
                                     ff.mesh.devices.shape)),
                    "losses": [float(ff.train_step(x, y)["loss"])
                               for x, y in batches],
                    "after": ff.get_weights()}
        cases[key] = (R.train_steps, (moe, strat, w, batches,
                                      functools.partial(TSGD, lr=0.05),
                                      "sparse_categorical_crossentropy",
                                      {"batch_size": 16, "slices": 2}))
    names = list(cases)
    got = R.run_group(R.run_cases, 8, [cases[k] for k in names],
                      timeout=240)
    return ref, {k: [rank[i] for rank in got] for i, k in enumerate(names)}


def _moe_strategy(cls, shard, mesh, ep):
    s = cls(mesh_axes=dict(mesh))
    s.edge_ops["__inputs__"] = [("repartition",
                                 {"dim": 0, "degree": mesh["data"]})]
    if ep:
        for n in ("group_by_0", "experts_dense_0"):
            s.shard_configs[n] = shard(expert=ep)
    return s


def _close(a, b, **tol):
    for op, entries in b.items():
        for k, v in entries.items():
            np.testing.assert_allclose(a[op][k], v, err_msg=f"{op}.{k}",
                                       **tol)


def test_two_level_mesh_and_hier_axis(slices8):
    """slices=2 runs {data: 8} as {slice: 2, data: 4}, the reference's
    mesh and hier_axis; the strategy keeps its unexpanded axes."""
    ref, out = slices8
    r = out["hier"][0]
    assert list(r["mesh"]) == [SLICE_AXIS, "data"]
    assert r["mesh"] == ref["mesh"] == {SLICE_AXIS: 2, "data": 4}
    assert r["hier_axis"] == ref["hier_axis"] == "data"
    assert r["strategy_mesh"] == {"data": 8}


def test_hierarchical_reduction_matches_flat_on_same_global_mesh(slices8):
    """RS over the remainder -> AR between slices -> AG against the flat
    all-reduces on the same mesh: float32 reduction-order noise only
    (the reference's bar), and both the reference's weights.  Only the
    hierarchical run all-gathers in its update."""
    ref, out = slices8
    hier, flat = out["hier"][0], out["flat"][0]
    _close(hier["weights"], flat["weights"], rtol=2e-5, atol=2e-6)
    _close(hier["weights"], ref["after"], rtol=2e-5, atol=2e-5)
    assert hier["update_bytes"].get("all_gather", 0) > 0
    assert "all_gather" not in flat["update_bytes"]


def test_single_slice_execution_is_bit_identical_to_pre_topology(slices8):
    _, out = slices8
    one, plain = out["one"][0], out["plain"][0]
    assert one["mesh"] == plain["mesh"] == {"data": 8}
    assert one["hier_axis"] is None and plain["hier_axis"] is None
    for op, entries in plain["weights"].items():
        for k, v in entries.items():
            np.testing.assert_array_equal(one["weights"][op][k], v)
    assert one["update_bytes"] == plain["update_bytes"]


def test_multi_slice_with_zero_stage_shards_over_intra_axis(slices8):
    """ZeRO-1 on the two-level mesh shards the update over the
    remainder (hier_axis None: its reduce-scatter is the hierarchical
    form) and trains stage 0's weights."""
    _, out = slices8
    z = out["zero1"][0]
    assert z["wus_axis"] == "data" and z["hier_axis"] is None
    assert z["zero_stage"] == 1
    _close(z["weights"], out["hier"][0]["weights"], rtol=2e-5, atol=2e-6)


def test_a_slice_sized_placement_axis_takes_the_batch_as_the_reference():
    """Shared with the reference (ROADMAP §3): placing the model axis of
    {data: 2, model: 2} across 2 slices moves it first, {model: 2, data:
    2}, and the view normalizer, which gives dim 0 the first axis of
    its size, then puts the batch on "model" (the slice dim) and the
    heads on "data": the run is laid out as the data placement is.
    Both packages give the same views."""
    import functools

    from flexflow_tpu.models.transformer import build_bert as r_build
    from flexflow_tpu.models.transformer import bert_tp_strategy as r_tp
    from flexflow_tpu.parallel.machine import view_to_spec as r_spec
    from flexflow_tpu.pcg.rewrite import \
        cancel_all_inverse_parallel_ops as r_cancel
    from flexflow_tpu_torch.models.transformer import (bert_tp_strategy,
                                                       build_bert)
    from flexflow_tpu_torch.parallel.machine import view_to_spec
    from flexflow_tpu_torch.pcg.rewrite import \
        cancel_all_inverse_parallel_ops
    from flexflow_tpu_torch.strategy import apply_strategy, assign_views

    kw = dict(batch_size=4, seq_length=8, hidden_size=32, num_layers=1,
              num_heads=4, intermediate_size=64)
    exec_axes, hier = execution_mesh({"data": 2, "model": 2}, 2, 4, "model")
    assert list(exec_axes) == ["model", "data"] and hier is None
    ff = FFModel(FFConfig(device="cpu"))
    build_bert(ff, **kw)
    g = cancel_all_inverse_parallel_ops(
        apply_strategy(ff.layers, bert_tp_strategy(4, tp=2, num_layers=1)))
    assign_views(g, exec_axes)
    ffr = RF.FFModel(RF.FFConfig())
    functools.partial(r_build, **kw)(ffr)
    gr = r_cancel(RF.strategy.apply_strategy(ffr.layers,
                                             r_tp(4, tp=2, num_layers=1)))
    RF.strategy.assign_views(gr, exec_axes)
    got = {pt.name: tuple(a[0] if len(a) == 1 else a for a in
                          view_to_spec(pt) if a)
           for op in g.ops for pt in list(op.outputs) + list(op.weights)}
    want = {pt.name: tuple(a for a in r_spec(pt) if a is not None)
            for op in gr.ops for pt in list(op.outputs) + list(op.weights)}
    assert got == want
    assert got["attn_0.out0"] == ("model",) and got["attn_0.wq"] == ("data",)


@pytest.mark.parametrize("key", ["moe_dp8", "moe_dp4_ep2"])
def test_moe_over_two_slices_trains_as_the_reference(slices8, key):
    """The MoE MLP with FFConfig(slices=2), under data 8 and under data
    4 x expert 2 (the batch on (slice, data): the MoE plans take the
    tokens on the first axis and gather the others): 2 SGD steps to the
    reference's losses and weights on its two-level mesh."""
    ref, out = slices8
    assert ref[key]["mesh"][SLICE_AXIS] == 2
    for rank in out[key]:
        np.testing.assert_allclose(rank["losses"], ref[key]["losses"],
                                   rtol=2e-5, atol=2e-5)
    _close(out[key][0]["weights"], ref[key]["after"], rtol=2e-5, atol=2e-5)
