"""The port's strategy search against flexflow_tpu's: the Unity DP and
the MCMC search pick the same Strategy (mesh axes, shard configs,
rewrites, ZeRO stage, remat, pipeline) at the same predicted cost on the
same graphs; compile with search_budget > 0 trains what the unsearched
compile trains, runs a strategy over more devices, a ZeRO stage or a
remat plan in a group of the right size, and a pipeline; the profiler times ops on the CPU and
returns None only for an op that cannot run on its own; calibration,
and the search and store flags."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_simulator import (GRAPHS, P, REL, build_pair,  # noqa: E402
                                  simple_machines)

from flexflow_tpu.pcg import mcmc as r_mcmc  # noqa: E402
from flexflow_tpu.pcg import unity as r_unity  # noqa: E402
from flexflow_tpu.sim import calibrate as r_cal  # noqa: E402
from flexflow_tpu.sim import simulator as r_sim  # noqa: E402
from flexflow_tpu_torch import profiler  # noqa: E402
from flexflow_tpu_torch.fftype import ActiMode  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_bert  # noqa: E402
from flexflow_tpu_torch.ops.attention import (  # noqa: E402
    MultiHeadAttention, MultiHeadAttentionParams)
from flexflow_tpu_torch.ops.dense import Linear, LinearParams  # noqa: E402
from flexflow_tpu_torch.pcg import mcmc as p_mcmc  # noqa: E402
from flexflow_tpu_torch.pcg import rewrite as p_rewrite  # noqa: E402
from flexflow_tpu_torch.pcg import unity as p_unity  # noqa: E402
from flexflow_tpu_torch.sim import calibrate as p_cal  # noqa: E402
from flexflow_tpu_torch.sim import machine_model as p_mm  # noqa: E402
from flexflow_tpu_torch.sim import simulator as p_sim  # noqa: E402
from flexflow_tpu_torch.strategy import (Strategy,  # noqa: E402
                                         data_parallel_strategy)
from flexflow_tpu_torch.tensor import (ParallelTensor,  # noqa: E402
                                       ParallelTensorShape)


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Each test's measured costs and fitted constants in its own dir."""
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR",
                       str(tmp_path / "cache"))


def _same_strategy(rs, ps):
    """The port's strategy is the reference's: every serialized field
    (mesh axes, shard configs, edge ops, rewrites, pipeline, ZeRO stage,
    placement, remat)."""
    assert json.loads(ps.to_json()) == json.loads(rs.to_json())


@pytest.mark.parametrize("graph,kw", [
    ("mlp", {}), ("bert", {}), ("resnet", {}),
    ("mlp", {"enable_parameter_parallel": True}),
    ("bert", {"zero_stages": (0, 1, 2, 3), "remat_search": True,
              "memory_budget": 2 << 20}),
], ids=["mlp", "bert", "resnet", "mlp-param", "bert-memory"])
def test_unity_search_matches_reference(graph, kw):
    ref, port = build_pair(graph)
    rm, pm = simple_machines()
    rs = r_unity.UnitySearch(ref.layers, 8, rm, r_sim.OpCostModel(rm),
                             budget=20, **kw)
    ps = p_unity.UnitySearch(port.layers, 8, pm, p_sim.OpCostModel(pm),
                             budget=20, **kw)
    if "memory_budget" in kw:
        r_best, p_best = rs.optimize_with_memory(), ps.optimize_with_memory()
    else:
        r_best, p_best = rs.optimize(), ps.optimize()
    _same_strategy(r_best, p_best)
    assert p_best.total_devices == 8
    assert p_best.search_cost == pytest.approx(r_best.search_cost, rel=REL)
    for k in ("evals", "segment_evals", "term_misses", "op_cost_hits"):
        assert p_best.search_stats[k] == r_best.search_stats[k], k


def test_unity_search_on_the_moe_graph():
    """The reference's Unity search cannot run the MoE MLP: its
    merge_parallel rule and its op_options read out_channels of an
    ExpertsDense, whose params name out_dim.  The port skips the merge
    for it and shards its out_dim; the strategy it picks costs the same
    under the reference search's evaluator as under the port's."""
    from flexflow_tpu.strategy import Strategy as RStrategy

    ref, port = build_pair("moe")
    rm, pm = simple_machines()
    rs = r_unity.UnitySearch(ref.layers, 8, rm, r_sim.OpCostModel(rm),
                             budget=20)
    with pytest.raises((TypeError, AttributeError), match="out_channels"):
        rs.optimize()
    best = p_unity.UnitySearch(port.layers, 8, pm, p_sim.OpCostModel(pm),
                               budget=20).optimize()
    assert best.total_devices == 8
    # the reference search's own evaluator (its simulator settings)
    fresh = r_unity.UnitySearch(ref.layers, 8, rm, r_sim.OpCostModel(rm),
                                budget=20)
    res = fresh._evaluator().evaluate(RStrategy.from_json(best.to_json()))
    assert best.search_cost > 0 and res.total_time > 0
    mine = p_unity.UnitySearch(port.layers, 8, pm, p_sim.OpCostModel(pm),
                               budget=20)._evaluator().evaluate(best)
    for f in ("total_time", "compute_time", "comm_time", "sync_time",
              "per_device_memory"):
        assert getattr(mine, f) == pytest.approx(getattr(res, f), rel=REL)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_mcmc_search_matches_reference(graph):
    ref, port = build_pair(graph)
    rm, pm = simple_machines()
    rs = r_mcmc.MCMCSearch(ref.layers, 8, lambda: r_sim.Simulator(rm),
                           budget=60, seed=3)
    ps = p_mcmc.MCMCSearch(port.layers, 8, lambda: p_sim.Simulator(pm),
                           budget=60, seed=3)
    r_best, p_best = rs.optimize(), ps.optimize()
    _same_strategy(r_best, p_best)
    assert ps.best_iteration == rs.best_iteration
    assert [c for _, c in ps.history] == pytest.approx(
        [c for _, c in rs.history], rel=REL)
    assert ps.evaluate(p_best) == pytest.approx(rs.evaluate(r_best),
                                                rel=REL)


def test_unity_entry_over_the_hgx_node_file():
    """unity_search through the config, over the committed 8-GPU HGX
    H100 node file: an 8-device strategy from the analytic costs (no
    measurement on the CPU), whose JSON loads back equal."""
    from flexflow_tpu_torch.pcg.search import mcmc_search, unity_search

    ff = P.FFModel(P.FFConfig(device="cpu", batch_size=8, search_budget=20,
                              machine_model_file=p_mm.machine_file(
                                  "hgx_h100_8")))
    build_bert(ff, batch_size=8, seq_length=32, hidden_size=64, num_layers=4,
               num_heads=4, intermediate_size=256)
    best = unity_search(ff, 8)
    assert best.total_devices == 8 and best.search_cost > 0
    assert best.search_stats["zero_stage"] == 0
    assert Strategy.from_json(best.to_json()).to_json() == best.to_json()
    again = mcmc_search(ff, 8)
    assert again.total_devices == 8


def test_unity_over_two_hgx_nodes_prices_the_node_boundary():
    """Over the 2-node file the search lays every collective onto its
    mesh axes' GPUs, in the DP, the evaluator and the event re-rank
    alike; data parallelism over 16 GPUs pays InfiniBand for its
    gradient all-reduce, and the same graph over one node does not."""
    from flexflow_tpu_torch.pcg.search import unity_search

    ff = P.FFModel(P.FFConfig(device="cpu", batch_size=16, search_budget=20,
                              machine_model_file=p_mm.machine_file(
                                  "hgx_h100_16")))
    build_bert(ff, batch_size=16, seq_length=32, hidden_size=64,
               num_layers=2, num_heads=4, intermediate_size=256)
    best = unity_search(ff, 16)
    assert best.total_devices == 16 and best.search_cost > 0
    two = p_mm.GpuNodeModel.from_file(p_mm.machine_file("hgx_h100_16"))
    one = p_mm.GpuNodeModel(num_nodes=1, gpus_per_node=16)
    dp = data_parallel_strategy(16)
    times = {}
    for name, m in (("two", two), ("one", one)):
        ev = p_unity.UnitySearch(ff.layers, 16, m, p_sim.OpCostModel(m),
                                 budget=20)._evaluator()
        times[name] = ev.evaluate(dp)
    assert times["two"].comm_tiers["dcn_time"] > 0
    assert times["one"].comm_tiers["dcn_time"] == 0
    # the same bytes, at 50e9 in place of 450e9 B/s per GPU
    assert (times["two"].comm_tiers["dcn_bytes"]
            == times["one"].comm_tiers["ici_bytes"])
    assert times["two"].total_time > times["one"].total_time


def _tiny_bert(budget=0, **kw):
    ff = P.FFModel(P.FFConfig(device="cpu", batch_size=4,
                              search_budget=budget, **kw))
    build_bert(ff, batch_size=4, seq_length=16, hidden_size=32, num_layers=2,
               num_heads=4, intermediate_size=64)
    return ff


def _losses(ff, steps=3):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    y = rng.integers(0, 2, (4,)).astype(np.int32)
    return [float(ff.train_step({"input": x}, y)["loss"])
            for _ in range(steps)]


@pytest.mark.parametrize("algo", ["unity", "mcmc"])
def test_compile_with_search_trains_the_unsearched_losses(algo, tmp_path):
    plain = _tiny_bert().compile()
    out = tmp_path / "s.json"
    searched = _tiny_bert(budget=10, search_algo=algo,
                          export_strategy_file=str(out)).compile()
    assert plain.strategy.to_json() == data_parallel_strategy(1).to_json()
    assert searched.strategy.total_devices == 1
    assert searched.strategy.search_stats["search_s"] > 0
    assert Strategy.load(str(out)).to_json() == searched.strategy.to_json()
    assert _losses(searched) == _losses(plain)


def test_imported_strategy_replays_its_rewrites(tmp_path):
    """A one-device strategy with a rewrite, from a file: the rewrite is
    replayed (the ReLU folds into its Linear), the strategy applied
    (degree-1 parallel ops run as the identity), and the losses are the
    unrewritten graph's."""
    def mlp(**kw):
        ff = P.FFModel(P.FFConfig(device="cpu", **kw))
        t = ff.create_tensor([8, 16], name="x")
        t = ff.dense(t, 32, name="fc0")
        t = ff.relu(t, name="act0")
        ff.dense(t, 4, activation=ActiMode.NONE, name="fc1")
        return ff

    s = data_parallel_strategy(1)
    s.rewrites = [["fuse_linear_activation", 0]]
    path = tmp_path / "rw.json"
    s.save(str(path))
    plain = mlp().compile()
    rewritten = mlp(import_strategy_file=str(path)).compile()
    names = [op.name for op in rewritten.operators.ops]
    assert "act0" not in names and "repartition_x.out0" in names
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.integers(0, 4, (8,)).astype(np.int32)
    for _ in range(3):
        a = float(plain.train_step({"x": x}, y)["loss"])
        b = float(rewritten.train_step({"x": x}, y)["loss"])
        assert a == b


def _batches(n=3):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    y = rng.integers(0, 2, (4,)).astype(np.int32)
    return [({"input": x}, y)] * n


@pytest.fixture(scope="module")
def two_ranks():
    """data_parallel_strategy(2), and the same with ZeRO stage 1, trained
    in a 2-rank gloo group (tests/torch_dist_ranks.py)."""
    import functools

    import torch_dist_ranks as R
    from flexflow_tpu_torch.optimizer import SGDOptimizer

    build = functools.partial(build_bert, batch_size=4, seq_length=16,
                              hidden_size=32, num_layers=2, num_heads=4,
                              intermediate_size=64)
    zero = data_parallel_strategy(2)
    zero.zero_stage = 1
    opt = functools.partial(SGDOptimizer, lr=0.01, weight_decay=1e-4)
    cases = [(R.train_steps, (build, s, None, _batches(), opt))
             for s in (data_parallel_strategy(2), zero)]
    return R.run_group(R.run_cases, 2, cases, timeout=120)


@pytest.mark.parametrize("what", ["devices", "pipeline", "zero", "remat"])
def test_compile_raises_for_what_the_executor_lacks(what, tmp_path,
                                                    request):
    """Of the four strategies the one-card executor refused, none does
    now: more devices than the group raises a size mismatch, and in a
    group of the right size the strategy trains, as ZeRO stage 1 does; a
    remat plan and a pipeline of degree 1 train on one process.  Each
    trains the one-process losses."""
    plain = _losses(_tiny_bert().compile())
    s = data_parallel_strategy(1)
    if what == "pipeline":
        s.pipeline = {"degree": 1, "num_microbatches": 2, "axis": "data",
                      "dp_axis": None}
        out = tmp_path / "export.json"
        ff = _tiny_bert(export_strategy_file=str(out)).compile(strategy=s)
        assert Strategy.load(str(out)).to_json() == s.to_json()
        assert ff.executor.pipeline_plan.num_blocks == 2
        assert set(ff.get_weights()) == {"__pipeline__", "classifier"}
        # the blocks draw the one-process weights: the losses are its own
        np.testing.assert_allclose(_losses(ff), plain, rtol=2e-5, atol=2e-5)
        return
    if what == "remat":
        s.remat = [1]  # segment 0 holds the input op, which runs inline
        ff = _tiny_bert().compile(strategy=s)
        assert [i for i, seg in enumerate(ff.executor._remat_plan)
                if seg[-1]] == [1]
        assert _losses(ff) == plain
        assert _losses(_tiny_bert(remat=True).compile()) == plain
        return
    if what == "devices":
        with pytest.raises(ValueError, match="4 devices.*group has 1 rank"):
            _tiny_bert().compile(strategy=data_parallel_strategy(4))
    else:
        # the config's own stage with no group: no axis to shard over
        ff = _tiny_bert(zero_stage=2).compile()
        assert ff.executor.zero_stage == 0 and _losses(ff) == plain
    got = request.getfixturevalue("two_ranks")[0][what == "zero"]
    np.testing.assert_allclose(got["losses"], plain, rtol=2e-6, atol=2e-6)
    assert got["zero_stage"] == (1 if what == "zero" else 0)


def test_profiler_on_the_cpu(capsys):
    x = ParallelTensor(ParallelTensorShape.make([64, 256]))
    lin = Linear(LinearParams(256), [x], name="fc")
    t = profiler.measure_op_forward(lin, device="cpu", repeats=2, chain=2)
    assert t is not None and t > 0
    # a sequence-sharded attention runs only as ring attention, which is
    # the multi-GPU executor's: it cannot run on its own
    q = ParallelTensor(ParallelTensorShape.make([2, 8, 16], degrees=[1, 2, 1]))
    attn = MultiHeadAttention(MultiHeadAttentionParams(16, 2), [q, q, q],
                              name="attn")
    measurer = profiler.make_measure_fn(device="cpu", repeats=1, chain=1)
    assert measurer(attn) is None and measurer(lin) > 0
    assert measurer.unmeasurable == ["attn"] and measurer.measured == 1
    # the graph's source has no input: nothing to time
    src = _tiny_bert().layers.source_ops()[0]
    assert profiler.measure_op_forward(src, device="cpu") is None

    class Broken(Linear):
        def forward(self, inputs, weights, **kw):
            raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        measurer(Broken(LinearParams(256), [x], name="broken"))
    rows = profiler.profile_operators(_tiny_bert().compile(), repeats=1)
    assert rows and all(r["fwd_ms"] > 0 for r in rows
                        if r["type"] != "INPUT")
    rows.append(dict(rows[0], name="unmeasurable", fwd_ms=None))
    profiler.print_profile(rows)
    total = capsys.readouterr().out.splitlines()[-1]
    assert total.startswith("TOTAL") and (
        f"({len(rows) - 1} measured / {len(rows)} total ops, 1 excluded)"
        in total)


def test_measured_cost_model_on_the_cpu(tmp_path):
    """search_calibrate on: cost() of an op above MEASURE_MIN_FLOPS takes
    its measured forward, keyed by the device's name, and persists."""
    cache = tmp_path / "costs.json"
    cfg = P.FFConfig(device="cpu", search_calibrate=True,
                     op_cost_cache_file=str(cache))
    machine = p_mm.SimpleMachineModel(1, 8)
    cm = p_sim.make_cost_model(cfg, machine)
    assert cm.device_key == "cpu"
    x = ParallelTensor(ParallelTensorShape.make([64, 256]))
    lin = Linear(LinearParams(256), [x], name="fc")
    cost = cm.cost(lin)
    assert cm.measured_hits == 1 and cost.forward_time > 0
    assert cost.backward_time == pytest.approx(2 * cost.forward_time)
    cm.save_persistent()
    keys = list(json.loads(cache.read_text()))
    assert len(keys) == 1 and keys[0].startswith("v2|cpu|")
    # a fresh model reads the measurement back instead of timing again
    again = p_sim.make_cost_model(cfg, machine)
    again.measure_fn = None
    assert p_sim.OpCostModel(machine, cache_path=str(cache),
                             device_key="cpu")._persistent
    assert not p_sim.make_cost_model(
        P.FFConfig(device="cpu"), machine).measure_fn


def test_unmeasurable_op_takes_its_twins_measured_scale():
    """A measured search keeps every cost on the card's scale: an op the
    measure fn cannot run (a sequence-sharded attention) takes its
    analytic time times measured/analytic of its block twin, one
    device's query block against the whole sequence's keys; without a
    measure fn the analytic roofline stands."""
    machine = p_mm.SimpleMachineModel(1, 8)
    plain = p_sim.OpCostModel(machine)
    calls = []

    def measure(op):  # an op 7x slower than its roofline, when it runs
        calls.append(op)
        if any(d.degree > 1 for t in op.inputs for d in t.shape.dims):
            return None
        return 7.0 * plain._analytic(op).forward_time

    q = ParallelTensor(ParallelTensorShape.make([2, 128, 64],
                                                degrees=[1, 2, 1]))
    attn = MultiHeadAttention(MultiHeadAttentionParams(64, 4), [q, q, q],
                              name="attn")
    assert attn.flops() >= p_sim.OpCostModel.MEASURE_MIN_FLOPS
    cm = p_sim.OpCostModel(machine, measure_fn=measure)
    cost = cm.cost(attn)
    want = 7.0 * plain.cost(attn).forward_time
    assert cost.forward_time == pytest.approx(want, rel=1e-12)
    assert cost.backward_time == pytest.approx(
        p_sim.backward_ratio(attn) * want, rel=1e-12)
    # the op, then its twin: the query block, the whole keys and values
    assert [[t.shape.shard_shape for t in c.inputs] for c in calls] == [
        [(2, 64, 64)] * 3, [(2, 64, 64), (2, 128, 64), (2, 128, 64)]]
    assert all(d.degree == 1 for t in calls[1].inputs for d in t.shape.dims)
    cm.cost(attn)
    st = cm.stats()
    assert (st["scaled_calls"], st["scaled_ops"], st["measured_calls"]) == (
        2, ["attn"], 0)
    # an op that is its own twin, and cannot run, stays analytic
    whole = MultiHeadAttention(
        MultiHeadAttentionParams(64, 4),
        [ParallelTensor(ParallelTensorShape.make([2, 128, 64]))] * 3,
        name="whole")
    never = p_sim.OpCostModel(machine, measure_fn=lambda op: None)
    assert never.cost(whole).forward_time == plain.cost(whole).forward_time
    assert never.cost(attn).forward_time == plain.cost(attn).forward_time


def test_calibration_on_the_cpu():
    records = [(0.01, 0.008, 0.002, 0.001), (0.02, 0.01, 0.006, 0.003),
               (0.015, 0.012, 0.0, 0.002), (0.03, 0.02, 0.004, 0.008)]
    assert p_cal.fit_cost_scales(records) == r_cal.fit_cost_scales(records)
    machine = p_mm.SimpleMachineModel(1, 1)
    cm = p_sim.OpCostModel(machine)

    def make_inputs(ff):
        rng = np.random.default_rng(0)
        return ({"input": rng.standard_normal((4, 16, 32)).astype(
            np.float32)}, rng.integers(0, 2, (4,)).astype(np.int32))

    fit = p_cal.calibrate_overlap(_tiny_bert, [data_parallel_strategy(1)],
                                  machine, cm, make_inputs, iters=1,
                                  windows=1)
    assert fit["fitted_on"] == "cpu" and fit["compute_scale"] > 0
    assert fit["num_strategies"] == 1 and fit["max_rel_error"] < 1e-9
    path = p_cal.save_overlap_constants(fit)
    assert path.startswith(os.environ["FLEXFLOW_TPU_TORCH_CACHE_DIR"])
    assert p_cal.load_overlap_constants(backend="cpu") == fit
    assert p_cal.load_overlap_constants(backend="NVIDIA H100") is None
    # the segment-granularity calibration of a compiled model
    ff = _tiny_bert().compile()
    regions = profiler.measure_segment_costs(ff, device="cpu", chain=1,
                                             repeats=1, max_regions=4)
    assert regions and all(t > 0 for _, t in regions)
    res = p_sim.Simulator(machine).simulate(ff.operators, {"data": 1},
                                            segment_costs=regions)
    assert res.total_time > 0


def test_calibration_over_several_sizes(tmp_path):
    """One builder per run: the fit spans the model at two batch sizes,
    and every run's record comes back for a held-out check."""
    machine = p_mm.SimpleMachineModel(1, 1)
    cm = p_sim.OpCostModel(machine)

    def build(batch):
        def make():
            ff = P.FFModel(P.FFConfig(device="cpu", batch_size=batch))
            build_bert(ff, batch_size=batch, seq_length=16, hidden_size=32,
                       num_layers=1, num_heads=4, intermediate_size=64)
            return ff
        return make

    def make_inputs(ff):
        b = ff.config.batch_size
        rng = np.random.default_rng(b)
        return ({"input": rng.standard_normal((b, 16, 32)).astype(
            np.float32)}, rng.integers(0, 2, (b,)).astype(np.int32))

    one = data_parallel_strategy(1)
    fit = p_cal.calibrate_overlap([build(2), build(4)], [one, one], machine,
                                  cm, make_inputs, iters=1, windows=1)
    assert fit["num_strategies"] == 2 and len(fit["records"]) == 2
    (m2, c2, _, _), (m4, c4, _, _) = fit["records"]
    assert c4 > c2 > 0 and m2 > 0 and m4 > 0
    assert fit["measured_s"] == [m2, m4]
    with pytest.raises(ValueError, match="builders"):
        p_cal.calibrate_overlap([build(2)], [one, one], machine, cm,
                                make_inputs)


def test_edge_chain_that_cancels_on_one_card_trains_the_plain_losses():
    """A one-device strategy whose edge chain shards a tensor two ways
    and gathers it back: apply_strategy inserts the pair, compile
    cancels it, and the steps are the plain graph's."""
    s = data_parallel_strategy(1)
    s.edge_ops["ffn1_0.out0"] = [("repartition", {"dim": 1, "degree": 2}),
                                 ("combine", {"dim": 1, "degree": 2})]
    from flexflow_tpu_torch.strategy import apply_strategy

    applied = apply_strategy(_tiny_bert().layers, s)
    assert sorted(op.op_type.name for op in applied.ops
                  if op.is_parallel_op() and op.params.degree > 1) == [
        "COMBINE", "REPARTITION"]
    ff = _tiny_bert().compile(strategy=s)
    assert all(op.params.degree == 1 for op in ff.operators.ops
               if op.is_parallel_op())
    assert _losses(ff) == _losses(_tiny_bert().compile())


def test_no_catalog_by_default_and_six_built_in_rules():
    assert p_rewrite.catalog_for_config(P.FFConfig(device="cpu")) is None
    assert len(p_rewrite.rules_for_config(P.FFConfig(device="cpu"))) == 6


def test_search_config_flags_match_the_reference():
    from flexflow_tpu.config import FFConfig as JaxConfig

    argv = ["--budget", "7", "--alpha", "0.2", "--search-algo", "mcmc",
            "--no-propagate", "--no-search-eval-cache",
            "--enable-parameter-parallel", "--enable-attribute-parallel",
            "--enable-sample-parallel", "--overlap", "--parameter-sync",
            "ps", "--rewrite-depth", "3", "--rewrite-max-variants", "16",
            "--search-calibrate", "--op-cost-cache", "/tmp/c.json",
            "--memory-search", "--machine-model-version", "2",
            "--machine-model-file", "m.json", "--simulator-segment-size",
            "99", "--zero-stage", "2", "--wus-axis", "model", "--remat",
            "--export-strategy", "e.json", "--import-strategy", "i.json",
            "--nodes", "2", "-ll:fsize", "1024",
            "--substitution-json", "none", "--only-data-parallel",
            "--slices", "2", "--dcn-bandwidth=1e9", "--dcn-latency", "2e-5",
            "--slice-topology", "2x4", "--dcn-bucket-mb", "8",
            "--fusion"]
    mine, ref = P.FFConfig.from_args(argv), JaxConfig.from_args(argv)
    fields = ("search_budget", "search_alpha", "search_algo",
              "search_propagate", "search_eval_cache",
              "enable_parameter_parallel", "enable_attribute_parallel",
              "enable_sample_parallel", "search_overlap_backward_update",
              "rewrite_depth", "rewrite_max_variants", "search_calibrate",
              "op_cost_cache_file", "memory_search", "machine_model_version",
              "machine_model_file", "simulator_segment_size", "zero_stage",
              "wus_axis", "remat", "export_strategy_file",
              "import_strategy_file", "num_nodes", "memory_per_device",
              "substitution_json", "only_data_parallel", "memory_lambda",
              "slices", "dcn_bandwidth", "dcn_latency", "slice_topology",
              "dcn_bucket_mb", "perform_fusion")
    for f in fields:
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.parameter_sync.value == ref.parameter_sync.value
    defaults = P.FFConfig.from_args([]), JaxConfig.from_args([])
    h100 = ("memory_per_device", "dcn_bandwidth", "dcn_latency")
    for f in fields:
        if f not in h100:
            assert getattr(defaults[0], f) == getattr(defaults[1], f), f
    # one H100's HBM, where the reference's default is a v5e's 16 GiB,
    # and InfiniBand NDR between nodes (hgx_h100_16.json: 50e9 B/s per
    # GPU, 5 us), where the reference's are a TPU's DCN (25e9, 10 us)
    assert defaults[0].memory_per_device == 80_000_000_000
    assert (defaults[0].dcn_bandwidth, defaults[0].dcn_latency) == (50e9,
                                                                    5e-6)
    assert P.FFConfig(device="cpu").slices == 1
    assert not P.FFConfig(device="cpu").should_calibrate()
    assert P.FFConfig(device="cpu").resolve_num_devices() == 1
    assert mine.perform_fusion and not defaults[0].perform_fusion
    # the store flags parse to the reference's fields
    store = ("strategy_store", "compilation_cache", "remote_store")
    for argv in (["--strategy-store", "s", "--compilation-cache",
                  "--remote-store", "file:///r"],
                 ["--no-strategy-store", "--compilation-cache", "k",
                  "--no-remote-store"], []):
        mine, ref = P.FFConfig.from_args(argv), JaxConfig.from_args(argv)
        for f in store:
            assert getattr(mine, f) == getattr(ref, f), (argv, f)
    assert P.FFConfig.from_args(["--compilation-cache"]).compilation_cache \
        == "auto"
    # the multi-slice fields parse and validate as the reference's
    assert P.FFConfig(slices=2).slices == JaxConfig(slices=2).slices == 2
    for bad in ({"slices": 0}, {"dcn_bandwidth": 0.0},
                {"dcn_latency": -1.0}, {"slice_topology": "axb"},
                {"dcn_bucket_mb": 0.0}):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            P.FFConfig(**bad)
    with pytest.raises(ValueError, match="search_algo"):
        P.FFConfig(search_algo="greedy")
