"""The port's search-side host code against flexflow_tpu's on the same
graphs, built by both packages from the same calls: the per-op cost and
search hooks (flops, memory_bytes, node_key, output degrees and
ShapeErrors under every op_options candidate and partitioned input),
the parallel ops' shape rules, assign_axes views, Strategy JSON in both
directions, the machine models, the simulator's totals and memory, the
incremental evaluator, and the task-graph event loops.  Both packages
get the same explicit DeviceSpec."""
import dataclasses
import enum
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu import tensor as r_tensor  # noqa: E402
from flexflow_tpu.fftype import ActiMode as RAct  # noqa: E402
from flexflow_tpu.models import moe as r_moe  # noqa: E402
from flexflow_tpu.models import resnet as r_resnet  # noqa: E402
from flexflow_tpu.models import transformer as r_tf  # noqa: E402
from flexflow_tpu.parallel import machine as r_machine  # noqa: E402
from flexflow_tpu.parallel import parallel_op as r_pop  # noqa: E402
from flexflow_tpu.pcg import evaluator as r_eval  # noqa: E402
from flexflow_tpu.pcg import mcmc as r_mcmc  # noqa: E402
from flexflow_tpu.pcg import substitution as r_sub  # noqa: E402
from flexflow_tpu.sim import machine_model as r_mm  # noqa: E402
from flexflow_tpu.sim import simulator as r_sim  # noqa: E402
from flexflow_tpu.sim import taskgraph as r_tg  # noqa: E402
from flexflow_tpu import strategy as r_strategy  # noqa: E402

from flexflow_tpu_torch import tensor as p_tensor  # noqa: E402
from flexflow_tpu_torch.fftype import ActiMode as PAct  # noqa: E402
from flexflow_tpu_torch.fftype import DataType as PDataType  # noqa: E402
from flexflow_tpu_torch.models import moe as p_moe  # noqa: E402
from flexflow_tpu_torch.models import resnet as p_resnet  # noqa: E402
from flexflow_tpu_torch.models import transformer as p_tf  # noqa: E402
from flexflow_tpu_torch.native import get_lib  # noqa: E402
from flexflow_tpu_torch.parallel import machine as p_machine  # noqa: E402
from flexflow_tpu_torch.parallel import parallel_op as p_pop  # noqa: E402
from flexflow_tpu_torch.pcg import evaluator as p_eval  # noqa: E402
from flexflow_tpu_torch.pcg import mcmc as p_mcmc  # noqa: E402
from flexflow_tpu_torch.pcg import substitution as p_sub  # noqa: E402
from flexflow_tpu_torch.sim import machine_model as p_mm  # noqa: E402
from flexflow_tpu_torch.sim import simulator as p_sim  # noqa: E402
from flexflow_tpu_torch.sim import taskgraph as p_tg  # noqa: E402
from flexflow_tpu_torch import strategy as p_strategy  # noqa: E402

REL = 1e-9

# one H100 SXM5, given to both packages explicitly (the reference's
# detected spec would be a TPU's on the CPU)
SPEC = dict(peak_flops=989.4e12, peak_flops_f32=66.9e12,
            hbm_bandwidth=3.35e12, hbm_capacity=80e9)


# -- the test graphs, one call sequence per package ------------------------

def _ff(pkg, **kw):
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.FFModel(pkg.FFConfig(**kw))


def build_mlp(pkg):
    act = RAct if pkg is R else PAct
    ff = _ff(pkg)
    t = ff.create_tensor([8, 64], name="x")
    for i in range(2):
        t = ff.dense(t, 64, activation=act.RELU, name=f"fc{i}")
    return ff


def build_bert(pkg):
    tf = r_tf if pkg is R else p_tf
    ff = _ff(pkg, batch_size=8)
    tf.build_bert(ff, batch_size=8, seq_length=32, hidden_size=64,
                  num_layers=4, num_heads=4, intermediate_size=256)
    return ff


def build_resnet(pkg):
    rn = r_resnet if pkg is R else p_resnet
    ff = _ff(pkg, batch_size=4)
    rn.build_resnet50(ff, batch_size=4, num_classes=10, image_size=32,
                      stage_blocks=(1, 1), base_channels=8)
    return ff


def build_moe(pkg):
    moe = r_moe if pkg is R else p_moe
    ff = _ff(pkg, batch_size=16)
    moe.build_moe_mlp(ff, batch_size=16, input_dim=32, num_classes=10,
                      num_exp=4, num_select=2, hidden_size=32)
    return ff


GRAPHS = {"mlp": build_mlp, "bert": build_bert, "resnet": build_resnet,
          "moe": build_moe}


def build_shapes(pkg):
    """Every shape op of the layer API, and BatchMatmul, on [4, 6, 8]
    activations (for the per-op hooks: not a model to search)."""
    ff = _ff(pkg)
    x = ff.create_tensor([4, 6, 8], name="x")
    idx = ff.create_tensor([4, 6, 8], dtype="int32", name="idx")
    t = ff.reshape(x, [24, 8], name="merge")
    t = ff.reshape(t, [4, 6, 8], name="split_back")
    e = ff.expand(ff.reshape(x, [4, 6, 8, 1], name="unsq"), [4, 6, 8, 2],
                  name="expand")
    ff.reduce_sum(e, [3], name="rsum")
    tt = ff.transpose(t, [0, 2, 1], name="transpose")
    ff.batch_matmul(t, tt, name="bmm")
    ff.reverse(t, 1, name="reverse")
    ff.pad(t, [[0, 0], [1, 1], [0, 2]], name="pad")
    a, b = ff.split(t, [2, 4], axis=1, name="split")
    c = ff.concat([b, a], axis=1, name="concat")
    ff.gather(c, idx, axis=2, name="gather")
    ff.mean(c, [1], keepdims=True, name="mean")
    return ff


def build_pair(name):
    return GRAPHS[name](R), GRAPHS[name](P)


def simple_machines(n=8):
    return (r_mm.SimpleMachineModel(1, n, device=r_mm.DeviceSpec(**SPEC)),
            p_mm.SimpleMachineModel(1, n, device=p_mm.DeviceSpec(**SPEC)))


def norm(v):
    """A package-neutral form of params, shapes and choices."""
    if isinstance(v, (r_tensor.ParallelTensorShape,
                      p_tensor.ParallelTensorShape)):
        return str(v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple((f.name, norm(getattr(v, f.name)))
                      for f in dataclasses.fields(v)))
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (tuple, list)):
        return tuple(norm(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, norm(x)) for k, x in v.items()))
    return v


def to_port_shape(shape):
    """The port's ParallelTensorShape with a reference shape's dims."""
    return p_tensor.ParallelTensorShape(
        tuple(p_tensor.ParallelDim(d.size, d.degree, d.is_replica_dim)
              for d in shape.dims), PDataType(shape.dtype.value))


def outcome(make):
    """('ok', outputs, weights, flops, bytes) or the exception raised."""
    try:
        op = make()
    except ValueError as e:  # ShapeError, or an indivisible ParallelDim
        return ("raise", type(e).__name__, str(e))
    return ("ok", tuple(str(t.shape) for t in op.outputs),
            tuple(str(w.shape) for w in op.weights), op.flops(),
            op.memory_bytes())


def input_variants(shapes):
    """The op's input shapes, then each input with one dim at degree 2,
    every input's same dim at degree 2, and input 0 replicated twice."""
    yield list(shapes)
    rank = shapes[0].logical_rank
    for k, s in enumerate(shapes):
        for i in range(s.logical_rank):
            if s.logical_shape[i] % 2 == 0:
                degs = [1] * s.logical_rank
                degs[i] = 2
                v = list(shapes)
                v[k] = s.with_degrees(degs)
                yield v
    for i in range(rank):
        if all(s.logical_rank == rank and s.logical_shape[i] % 2 == 0
               for s in shapes):
            degs = [1] * rank
            degs[i] = 2
            yield [s.with_degrees(degs) if s.logical_rank == rank else s
                   for s in shapes]
    yield [shapes[0].with_degrees([1] * rank, replica_degree=2)] + \
        list(shapes[1:])


MESHES = [{"data": 8}, {"data": 2, "model": 4}, {"model": 8},
          {"data": 2, "expert": 4}, {"model0": 2, "model1": 2}]


@pytest.mark.parametrize("graph", list(GRAPHS) + ["shapes"])
def test_per_op_hooks_match(graph):
    ref, port = ((build_shapes(R), build_shapes(P)) if graph == "shapes"
                 else build_pair(graph))
    r_ops, p_ops = ref.layers.topo_order(), port.layers.topo_order()
    assert [o.name for o in r_ops] == [o.name for o in p_ops]
    rx, px = r_sub.generate_all_pcg_xfers(), p_sub.generate_all_pcg_xfers()
    assert norm(rx) == norm(px)
    cases = 0
    for ro, po in zip(r_ops, p_ops):
        assert ro.op_type.value == po.op_type.value
        assert ro.flops() == po.flops(), ro.name
        assert ro.memory_bytes() == po.memory_bytes(), ro.name
        rk, pk = ro.node_key(), po.node_key()
        assert (rk[0].value, norm(rk[1]), norm(rk[2]), norm(rk[3])) == \
            (pk[0].value, norm(pk[1]), norm(pk[2]), norm(pk[3])), ro.name
        assert norm(ro.ctor_kwargs()) == norm(po.ctor_kwargs())
        assert ro.is_parallel_op() == po.is_parallel_op()
        if not ro.inputs:
            continue
        for mesh in MESHES:
            p_opts = p_sub.op_options(po, mesh, px, True, True)
            try:
                r_opts = r_sub.op_options(ro, mesh, rx, True, True)
                assert norm(r_opts) == norm(p_opts), (ro.name, mesh)
            except AttributeError as e:
                # the reference's _shard_limit reads out_channels of an
                # ExpertsDense (a LINEAR whose params name out_dim) and
                # raises; the port shards its out_dim, and the reference's
                # shape rule is held to the port's under those options
                assert type(ro).__name__ == "ExpertsDense", e
                assert "out_channels" in str(e)
                r_opts = [r_sub.XferChoice(
                    r_sub.ShardConfig(**dataclasses.asdict(c.shard)),
                    c.out_chain) for c in p_opts]
            shapes = [t.shape for t in ro.inputs]
            for choice in r_opts:
                shard = choice.shard
                p_shard = p_sub.ShardConfig(**dataclasses.asdict(shard))
                for v in input_variants(shapes):
                    got = [outcome(lambda: type(ro)(
                        ro.params, [r_tensor.ParallelTensor(s) for s in v],
                        name=ro.name, shard=shard, **ro.ctor_kwargs())),
                        outcome(lambda: type(po)(
                            po.params,
                            [p_tensor.ParallelTensor(to_port_shape(s))
                             for s in v],
                            name=po.name, shard=p_shard,
                            **po.ctor_kwargs()))]
                    assert got[0] == got[1], (ro.name, mesh, shard, v)
                    cases += 1
    assert cases > 100


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_graph_helpers_match(graph, tmp_path):
    """consumers, in_edges, compute_ops, hash_key and the dot export
    (guids renumbered by topological position) of both packages."""
    import re

    ref, port = build_pair(graph)
    rg, pg = ref.layers, port.layers

    def names(ops):
        return [o.name for o in ops]

    for ro, po in zip(rg.topo_order(), pg.topo_order()):
        assert names(rg.consumers(ro)) == names(pg.consumers(po))
        assert po.with_shard(po.shard) is po.shard
    assert {k.name: names(v) for k, v in rg.in_edges().items()} == \
        {k.name: names(v) for k, v in pg.in_edges().items()}
    assert names(rg.compute_ops()) == names(pg.compute_ops())
    assert [(k[0].value, norm(k[1]), norm(k[2]), norm(k[3]))
            for k in rg.hash_key()] == \
        [(k[0].value, norm(k[1]), norm(k[2]), norm(k[3]))
         for k in pg.hash_key()]
    dots = []
    for g, name in ((rg, "r.dot"), (pg, "p.dot")):
        g.export_dot(str(tmp_path / name), include_costs=True,
                     cost_fn=lambda op: op.flops())
        pos = {op.guid: i for i, op in enumerate(g.ops)}
        text = (tmp_path / name).read_text()
        dots.append(re.sub(r"\bn(\d+)\b",
                           lambda m: f"n{pos[int(m.group(1))]}", text))
    assert dots[0] == dots[1] and dots[0].startswith("digraph PCG {")


def _pop_cases():
    base = [([8, 16, 32], [1, 1, 1], 1), ([8, 16, 32], [2, 4, 1], 2),
            ([6, 10], [3, 1], 4)]
    kinds = [("repartition", {"dim": 1, "degree": 2}),
             ("repartition", {"dim": 0, "degree": 4}),
             ("repartition", {"dim": -1, "degree": 3}),
             ("combine", {"dim": 0, "degree": 2}),
             ("combine", {"dim": 1, "degree": 4}),
             ("replicate", {"degree": 2}),
             ("reduction", {"degree": 2}),
             ("reduction", {"degree": 3}),
             ("all_to_all", {"from_dim": 0, "to_dim": 1, "degree": 2}),
             ("all_to_all", {"from_dim": 1, "to_dim": 2, "degree": 4}),
             ("fused", {"ops": [["combine", {"dim": 0, "degree": 2}],
                                ["repartition", {"dim": 1, "degree": 2}]]})]
    for shape, degs, rep in base:
        for kind, params in kinds:
            yield shape, degs, rep, kind, params


def test_parallel_op_shape_rules_and_views_match():
    seen = 0
    for shape, degs, rep, kind, params in _pop_cases():
        rs = r_tensor.ParallelTensorShape.make(shape, degrees=degs,
                                               replica_degree=rep)
        got = []
        for tmod, pop, strat, shp in (
                (r_tensor, r_pop, r_strategy, rs),
                (p_tensor, p_pop, p_strategy, to_port_shape(rs))):
            def make():
                p = strat._PARAM_CLASSES[kind](**params)
                return pop.PARALLEL_OP_KINDS[kind](p, [tmod.ParallelTensor(
                    shp)], name=f"{kind}_t")
            got.append(outcome(make))
        assert got[0] == got[1], (shape, degs, rep, kind, params)
        seen += got[0][0] == "ok"
    assert seen > 10
    # the compute ops with real work: StackReplicate and FoldReduce
    x = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    rs = r_tensor.ParallelTensorShape.make([4, 6])
    for rcls, pcls, params, want in (
            ("StackReplicate", "StackReplicate", (1, 3),
             np.concatenate([x] * 3, axis=1)),
            ("FoldReduce", "FoldReduce", (1, 2), x[:, :3] + x[:, 3:])):
        rop = getattr(r_pop, rcls)(getattr(r_pop, rcls + "Params")(*params),
                                   [r_tensor.ParallelTensor(rs)])
        pop = getattr(p_pop, pcls)(getattr(p_pop, pcls + "Params")(*params),
                                   [p_tensor.ParallelTensor(
                                       to_port_shape(rs))])
        assert str(rop.outputs[0].shape) == str(pop.outputs[0].shape)
        assert rop.flops() == pop.flops()
        ry = np.asarray(rop.forward([x], [])[0])
        py = pop.forward([torch.from_numpy(x)], [])[0].numpy()
        np.testing.assert_allclose(py, ry, rtol=0, atol=1e-6)
        np.testing.assert_allclose(py, want, rtol=0, atol=1e-6)
    # views: assign_axes over shapes and meshes
    for mesh in MESHES + [{"data": 2, "model": 2, "expert": 2}]:
        for shape, degs, rep in (([8, 16], [2, 4], 1), ([8, 16], [1, 4], 2),
                                 ([8, 16, 32], [2, 1, 2], 2),
                                 ([8, 16], [8, 1], 1), ([8], [4], 2)):
            rs = r_tensor.ParallelTensorShape.make(shape, degrees=degs,
                                                   replica_degree=rep)
            got = []
            for mach, shp in ((r_machine, rs), (p_machine, to_port_shape(rs))):
                try:
                    view = mach.assign_axes(shp, mesh)
                    mach.validate_view(view, shp, mesh)
                    got.append(("ok", view.axes, str(view)))
                except ValueError as e:
                    got.append(("raise", str(e)))
            assert got[0] == got[1], (mesh, shape, degs, rep)


def _strategies():
    s1 = r_strategy.data_parallel_strategy(8)
    s2 = r_strategy.Strategy(
        mesh_axes={"data": 2, "model": 4},
        shard_configs={"fc0": r_sub.ShardConfig(channel=4),
                       "fc1": r_sub.ShardConfig(reduction=4)},
        edge_ops={"fc0.out0": [("combine", {"dim": 1, "degree": 4})],
                  "__inputs__": [("repartition", {"dim": 0, "degree": 2})]},
        rewrites=[["fuse_linear_activation", 0]], zero_stage=2,
        pipeline={"degree": 2, "num_microbatches": 4, "axis": "pipe",
                  "dp_axis": "data"}, remat=[0, 3])
    s3 = dataclasses.replace(s2, remat=None, zero_stage=None, pipeline=None,
                             placement="data")
    return [s1, s2, s3]


def test_strategy_json_crosses_both_ways(tmp_path):
    for i, rs in enumerate(_strategies()):
        text = rs.to_json()
        ps = p_strategy.Strategy.from_json(text)
        assert ps.to_json() == text
        assert ps.total_devices == rs.total_devices
        path = tmp_path / f"s{i}.json"
        ps.save(str(path))
        back = r_strategy.Strategy.load(str(path))
        assert back.to_json() == text
        rs.save(str(path))
        assert p_strategy.Strategy.load(str(path)).to_json() == text


def test_simple_machine_costs_match():
    for nodes, per in ((1, 8), (2, 4)):
        rm = r_mm.SimpleMachineModel(nodes, per,
                                     device=r_mm.DeviceSpec(**SPEC))
        pm = p_mm.SimpleMachineModel(nodes, per,
                                     device=p_mm.DeviceSpec(**SPEC))
        assert rm.num_devices() == pm.num_devices()
        assert rm.ps_link() == pm.ps_link()
        for size in (1, 4096, 3 << 20):
            for group in ([0], [0, 1], list(range(per)),
                          list(range(nodes * per)), [0, per]):
                for fn in ("allreduce_time", "allgather_time",
                           "reducescatter_time", "alltoall_time"):
                    assert getattr(rm, fn)(size, group) == \
                        getattr(pm, fn)(size, group), (fn, size, group)
            for src, dst in ((0, 0), (0, 1), (0, nodes * per - 1)):
                assert rm.p2p_time(size, src, dst) == \
                    pm.p2p_time(size, src, dst)


def test_gpu_node_model_closed_form(tmp_path):
    m = p_mm.GpuNodeModel.from_file(p_mm.machine_file("hgx_h100_8"))
    assert m.num_devices() == 8 and m.version == 2
    dev = m.device()
    assert (dev.peak_flops, dev.peak_flops_f32, dev.hbm_bandwidth,
            dev.hbm_capacity) == (989.4e12, 66.9e12, 3.35e12, 80e9)
    nv, ib = 450e9, 50e9
    S = 64 << 20
    for n in (2, 4, 8):
        assert m.axis_allreduce_time(S, n) == pytest.approx(
            2 * (n - 1) / n * S / nv + 2 * (n - 1) * 1e-6, rel=1e-12)
        assert m.axis_allgather_time(S, n) == pytest.approx(
            (n - 1) / n * S / nv + (n - 1) * 1e-6, rel=1e-12)
        # a crossbar: no bisection penalty on the all-to-all
        assert m.axis_alltoall_time(S, n) == m.axis_allgather_time(S, n)
        assert m.allreduce_time(S, list(range(n))) == pytest.approx(
            m.axis_allreduce_time(S, n), rel=1e-12)
    assert m.axis_allreduce_time(S, 1) == 0.0
    assert m.axis_allreduce_time(S, 4, spans_nodes=True) == pytest.approx(
        2 * 3 / 4 * S / ib + 6 * 5e-6, rel=1e-12)
    assert m.p2p_time(S, 0, 7) == pytest.approx(1e-6 + S / nv)
    two = p_mm.GpuNodeModel.from_file(p_mm.machine_file("hgx_h100_16"))
    assert two.num_devices() == 16
    # a group larger than a node rides the GPUs' NICs
    assert two.axis_allreduce_time(S, 16) == pytest.approx(
        2 * 15 / 16 * S / ib + 30 * 5e-6, rel=1e-12)
    assert two.allgather_time(S, [0, 8]) == pytest.approx(
        S / 2 / ib + 5e-6, rel=1e-12)
    assert two.allgather_time(S, [0, 7]) == pytest.approx(
        S / 2 / nv + 1e-6, rel=1e-12)
    assert two.p2p_time(S, 0, 8) == pytest.approx(5e-6 + S / ib)
    # mesh axes map onto GPUs in C order: an axis spans nodes when its
    # stride times its length passes a node
    assert m.node_spanning_axes({"data": 8}) == frozenset()
    assert m.node_spanning_axes({"data": 2, "model": 4}) == frozenset()
    for mesh, spans in (({"data": 16}, {"data"}),
                        ({"data": 2, "model": 8}, {"data"}),
                        ({"data": 4, "model": 4}, {"data"}),
                        ({"model": 8, "data": 2}, {"model"}),
                        ({"data": 8, "model": 2}, {"data"}),
                        ({"a": 2, "b": 2, "c": 4}, {"a"}),
                        ({"data": 16, "model": 1}, {"data"}),
                        ({"model": 1, "data": 16}, {"data"})):
        assert two.node_spanning_axes(mesh) == frozenset(spans), mesh
    cfg = P.FFConfig(device="cpu", machine_model_version=2, num_nodes=2)
    built = p_mm.make_machine_model(cfg, 16)
    assert isinstance(built, p_mm.GpuNodeModel)
    assert (built.num_nodes, built.gpus_per_node) == (2, 8)
    cfg0 = P.FFConfig(device="cpu")
    assert isinstance(p_mm.make_machine_model(cfg0, 8),
                      p_mm.SimpleMachineModel)


def _sim_strategies(graph):
    """Data-parallel 8, channel- and reduction-sharded Linears, a ZeRO
    stage and a remat plan, in the reference's Strategy."""
    S = r_strategy.Strategy
    dp = r_strategy.data_parallel_strategy(8)
    names = [op.name for op in graph.topo_order()
             if op.op_type.value == "linear"]
    a, b = names[0], names[1]
    tp = S(mesh_axes={"data": 2, "model": 4},
           shard_configs={a: r_sub.ShardConfig(channel=4),
                          b: r_sub.ShardConfig(reduction=4)},
           edge_ops={"__inputs__": [("repartition",
                                      {"dim": 0, "degree": 2})]})
    ch = S(mesh_axes={"data": 2, "model": 4},
           shard_configs={a: r_sub.ShardConfig(channel=4)},
           edge_ops={"__inputs__": [("repartition",
                                      {"dim": 0, "degree": 2})],
                     f"{a}.out0": [("combine", {"dim": -1, "degree": 4})]})
    z = dataclasses.replace(dp, zero_stage=2)
    rm = dataclasses.replace(dp, remat=[0, 1])
    return [("dp8", dp, {}), ("tp", tp, {}), ("channel", ch, {}),
            ("zero2", z, {"zero_stage": 2}), ("remat", rm,
                                               {"remat_plan": [0, 1]}),
            ("zero3", dp, {"zero_stage": 3})]


@pytest.mark.parametrize("graph", ["mlp", "bert"])
def test_simulator_totals_and_memory_match(graph):
    ref, port = build_pair(graph)
    rm, pm = simple_machines()
    rsim, psim = r_sim.Simulator(rm), p_sim.Simulator(pm)
    for name, rs, kw in _sim_strategies(ref.layers):
        ps = p_strategy.Strategy.from_json(rs.to_json())
        rg = r_strategy.apply_strategy(ref.layers, rs)
        r_strategy.assign_views(rg, rs.mesh_axes)
        pg = p_strategy.apply_strategy(port.layers, ps)
        p_strategy.assign_views(pg, ps.mesh_axes)
        for training in (True, False):
            a = rsim.simulate(rg, rs.mesh_axes, training=training, **kw)
            b = psim.simulate(pg, ps.mesh_axes, training=training, **kw)
            for f in ("total_time", "compute_time", "comm_time",
                      "sync_time"):
                assert getattr(b, f) == pytest.approx(
                    getattr(a, f), rel=REL), (name, training, f)
            assert b.per_device_memory == pytest.approx(
                a.per_device_memory, rel=REL), (name, training)
            assert a.total_time > 0


def _random_moves(mcmc_mod, graph, sim_factory, n_moves=40, seed=7):
    """A seeded MCMC-like move sequence over one package's MCMCSearch:
    single-op ShardConfig flips and mesh refactorizations, with
    revisits."""
    search = mcmc_mod.MCMCSearch(graph, 8, sim_factory, budget=0)
    rng = random.Random(seed)
    dp, tp, ep = 8, 1, 1
    flags = {}
    out = [search._build(dp, tp, ep, flags)]
    for _ in range(n_moves):
        if rng.random() < 0.2 or not search.candidates:
            dp, tp, ep = rng.choice(search.factorizations)
        else:
            c = rng.choice(search.candidates)
            flags[c.name] = not flags.get(c.name, False)
        out.append(search._build(dp, tp, ep, dict(flags)))
    return out


@pytest.mark.parametrize("stage", [0, 2])
def test_incremental_evaluator_delta_equals_full(stage):
    ref, port = build_pair("bert")
    rm, pm = simple_machines()
    ev_d = p_eval.IncrementalEvaluator(
        port.layers, p_sim.Simulator(pm, zero_stage=stage), use_cache=True)
    ev_f = p_eval.IncrementalEvaluator(
        port.layers, p_sim.Simulator(pm, zero_stage=stage), use_cache=False)
    ev_r = r_eval.IncrementalEvaluator(
        ref.layers, r_sim.Simulator(rm, zero_stage=stage), use_cache=True)
    p_moves = _random_moves(p_mcmc, port.layers,
                            lambda: p_sim.Simulator(pm))
    r_moves = _random_moves(r_mcmc, ref.layers, lambda: r_sim.Simulator(rm))
    legal = 0
    for ps, rs in zip(p_moves, r_moves):
        assert ps.to_json() == rs.to_json()
        d, f, r = ev_d.evaluate(ps), ev_f.evaluate(ps), ev_r.evaluate(rs)
        assert (d is None) == (f is None) == (r is None)
        if d is None:
            continue
        legal += 1
        for fld in ("total_time", "compute_time", "comm_time", "sync_time"):
            assert getattr(d, fld) == getattr(f, fld)
            assert getattr(d, fld) == pytest.approx(getattr(r, fld), rel=REL)
        assert d.per_device_memory == f.per_device_memory
        assert d.per_device_memory == pytest.approx(r.per_device_memory,
                                                    rel=REL)
    assert legal > 10
    assert ev_d.stats.delta_evals > 0 and ev_d.stats.memo_hits > 0


def _random_taskgraph(tg_mod, machine, rng, num_tasks, num_devices=4):
    b = tg_mod.TaskGraphBuilder(num_devices, machine)
    tids = []
    for _ in range(num_tasks):
        deps = []
        if tids:
            for d in rng.choice(len(tids), size=min(2, len(tids)),
                                replace=False):
                deps.append(tids[int(d)])
        t = b.add_task(float(rng.rand()) * 1e-3,
                       int(rng.randint(num_devices)), deps)
        if tids and rng.rand() < 0.5:
            b.add_edge(tids[int(rng.randint(len(tids)))], t,
                       float(rng.rand()) * 1e6,
                       int(rng.randint(num_devices)),
                       int(rng.randint(num_devices)))
        tids.append(t)
    return b.finalize()


def test_event_loops_native_python_and_reference_agree():
    assert get_lib() is not None  # g++ is part of the toolchain here
    from flexflow_tpu_torch.native import BUILD_DIR, library_path

    assert library_path().parent == BUILD_DIR
    assert BUILD_DIR.name == "_build" and library_path().exists()
    rm, pm = simple_machines(4)
    for trial in range(6):
        r_graph = _random_taskgraph(r_tg, rm, np.random.RandomState(trial),
                                    30 + 10 * trial)
        p_graph = _random_taskgraph(p_tg, pm, np.random.RandomState(trial),
                                    30 + 10 * trial)
        mk_n, busy_n = p_tg.simulate_native(p_graph)
        mk_p, busy_p = p_tg.simulate_python(p_graph)
        mk_r, busy_r = r_tg.simulate_python(r_graph)
        assert mk_n == mk_p == mk_r, trial
        np.testing.assert_array_equal(busy_n, busy_p)
        np.testing.assert_array_equal(busy_n, busy_r)
    # a whole PCG through the TaskGraphSimulator, both loops and packages
    ref, port = build_pair("bert")
    rm, pm = simple_machines(8)
    for rs in (r_strategy.data_parallel_strategy(8),
               _sim_strategies(ref.layers)[1][1]):
        ps = p_strategy.Strategy.from_json(rs.to_json())
        rg = r_strategy.apply_strategy(ref.layers, rs)
        r_strategy.assign_views(rg, rs.mesh_axes)
        pg = p_strategy.apply_strategy(port.layers, ps)
        p_strategy.assign_views(pg, ps.mesh_axes)
        a = r_tg.TaskGraphSimulator(rm, force_python=True).simulate(
            rg, rs.mesh_axes)
        b = p_tg.TaskGraphSimulator(pm).simulate(pg, ps.mesh_axes)
        c = p_tg.TaskGraphSimulator(pm, force_python=True).simulate(
            pg, ps.mesh_axes)
        assert b.breakdown["native"] == 1.0 and c.breakdown["native"] == 0.0
        assert b.total_time == c.total_time
        assert b.total_time == pytest.approx(a.total_time, rel=REL)
    # on an HGX node model each GPU sends through its NVLink port to a
    # GPU of its node and through its NIC to a GPU of another node
    two = p_mm.GpuNodeModel(num_nodes=2, gpus_per_node=2)
    b = p_tg.TaskGraphBuilder(4, two)
    assert b._link_bw == [450e9, 50e9] * 4
    assert (b.route(0, 1), b.route(1, 2), b.route(3, 0), b.route(2, 3)) == (
        [0], [3], [7], [4])


class _FreeCompute(p_sim.OpCostModel):
    """Every op computes in no time: the makespan is the collectives'."""

    def cost(self, op):
        return p_sim.CostMetrics()


@pytest.mark.parametrize("mesh", [{"data": 2, "model": 8},
                                  {"data": 4, "model": 4}],
                         ids=["2x8", "4x4"])
def test_cross_node_data_allreduce_rides_infiniband(mesh):
    """Two HGX nodes, a Linear channel-sharded over `model`: its weight
    is replicated over `data`, whose groups ({0, 8}, ... or
    {0, 4, 8, 12}, ...) span the nodes, so the gradient all-reduce is
    priced at InfiniBand's rate, in the analytic simulator and in the
    event simulator alike."""
    two = p_mm.GpuNodeModel.from_file(p_mm.machine_file("hgx_h100_16"))
    ff = _ff(P, batch_size=16)
    x = ff.create_tensor([16, 64], name="x")
    ff.dense(x, 64, use_bias=False, name="fc")
    st = p_strategy.Strategy(
        mesh_axes=dict(mesh),
        shard_configs={"fc": p_sub.ShardConfig(channel=mesh["model"])},
        edge_ops={"__inputs__": [("repartition",
                                  {"dim": 0, "degree": mesh["data"]})]})
    g = p_strategy.apply_strategy(ff.layers, st)
    p_strategy.assign_views(g, mesh)
    fc = next(op for op in g.ops if op.name == "fc")
    (w,) = fc.weights
    assert p_sim.replica_axes(w) == {"data"}
    assert [len(x) for x in p_tg.mesh_groups(mesh, {"data"})] == \
        [mesh["data"]] * mesh["model"]
    assert p_tg.mesh_groups(mesh, {"data"})[0] == list(
        range(0, 16, 16 // mesh["data"]))
    sb, n = w.shape.shard_bytes(), mesh["data"]
    ib = two.axis_allreduce_time(sb, n, spans_nodes=True)
    assert ib == pytest.approx(2 * (n - 1) / n * sb / 50e9
                               + 2 * (n - 1) * 5e-6, rel=1e-12)
    assert ib > 5 * two.axis_allreduce_time(sb, n)  # not NVLink's price
    sim = p_sim.Simulator(two)
    terms = sim.op_terms(fc, mesh)
    assert terms.grad_sync == pytest.approx(ib, rel=1e-12)
    assert terms.dcn_xfer == pytest.approx(ib, rel=1e-12)
    assert terms.ici_xfer == 0.0
    # the event loop's makespan is the analytic all-reduce: every ring
    # phase waits on a NIC hop
    ev = p_tg.TaskGraphSimulator(two, _FreeCompute(two)).simulate(g, mesh)
    assert ev.total_time == pytest.approx(ib, rel=1e-9)
