"""Pipelines as a Strategy in the port (tests/test_pipeline_strategy.py):
compile plans a strategy's pipeline and the executor runs it.  dp 2 x
pp 2 against the reference and against one device with the stacked
weights carried over, a pipe-only mesh, the JSON round trip, remat equal
to no remat, the Unity search's pipeline compiled and trained, the
weight layouts both ways, the ZeRO ladder under a pipeline and dropout
in the region by its rules (the Unity search's pipeline and the replay
of `_dryrun_multichip_body`'s pipeline legs, over 8 ranks, are in
tests/test_torch_pipeline_search.py).

The port runs in a spawned gloo group of 4 ranks
(tests/torch_dist_ranks.py), spawned once for the module; the reference
runs in this process on the 8-device CPU mesh, on the same numpy inputs,
with its weights copied into the port.
"""
import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_ranks as R  # noqa: E402
from test_torch_simulator import simple_machines  # noqa: E402

import flexflow_tpu as RF  # noqa: E402
import flexflow_tpu_torch as PF  # noqa: E402
from flexflow_tpu.models.transformer import build_bert  # noqa: E402
from flexflow_tpu.strategy import Strategy as RStrategy  # noqa: E402
from flexflow_tpu_torch.models.transformer import \
    build_bert as t_build_bert  # noqa: E402
from flexflow_tpu_torch.optimizer import AdamOptimizer as TAdam  # noqa: E402
from flexflow_tpu_torch.optimizer import SGDOptimizer as TSGD  # noqa: E402
from flexflow_tpu_torch.parallel.pipeline_plan import \
    plan_pipeline  # noqa: E402
from flexflow_tpu_torch.pcg import unity as p_unity  # noqa: E402
from flexflow_tpu_torch.sim import simulator as p_sim  # noqa: E402
from flexflow_tpu_torch.strategy import (Strategy,  # noqa: E402
                                         data_parallel_strategy)

TOL = dict(rtol=2e-5, atol=2e-5)
STEPS = 5
TINY_BERT = dict(seq_length=16, hidden_size=32, num_heads=4,
                 intermediate_size=64)


def stacked(ff, layers=4, batch=16, hidden=32, classes=4):
    """tests/test_pipeline_strategy.py's MLP of identical blocks, with
    either package's FFModel."""
    relu = R._relu(ff)
    x = ff.create_tensor([batch, hidden], name="x")
    t = x
    for i in range(layers):
        t = ff.dense(t, hidden, activation=relu, name=f"blk{i}")
    t = ff.dense(t, classes, name="head")
    ff.softmax(t)


def prime_stack(ff):
    """The Unity test's graph: width 31 (no tensor-parallel degree) and
    batch 2 (no data-parallel 8)."""
    stacked(ff, layers=8, batch=2, hidden=31, classes=5)


def _pp_strategy(cls, dp, pp, M, zero=None):
    axes = {"data": dp, "pipe": pp} if dp > 1 else {"pipe": pp}
    s = cls(mesh_axes=axes,
            pipeline={"degree": pp, "num_microbatches": M, "axis": "pipe",
                      "dp_axis": "data" if dp > 1 else None})
    if dp > 1:
        s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": dp})]
    s.zero_stage = zero
    return s


def _ref_model(build, devices, strategy=None, batch=16, opt=None):
    ff = RF.FFModel(RF.FFConfig(batch_size=batch, num_devices=len(devices)))
    build(ff)
    ff.compile(optimizer=opt or RF.SGDOptimizer(lr=0.05),
               loss_type=RF.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=strategy, devices=devices, seed=0)
    return ff


def _port_model(build, strategy=None, batch=16, opt=None, **cfg):
    ff = PF.FFModel(PF.FFConfig(device="cpu", batch_size=batch, **cfg))
    build(ff)
    ff.compile(optimizer=opt or TSGD(lr=0.05), strategy=strategy, seed=0)
    return ff


def _unstack(w, names):
    """Per-op weights from a stacked tree, block l onto names[l]."""
    out = {k: dict(v) for k, v in w.items() if k != "__pipeline__"}
    for key, arr in w["__pipeline__"].items():
        _, wname = key.split(".", 1)
        for name, row in zip(names, arr):
            out.setdefault(name, {})[wname] = row
    return out


def _xy(seed, batch=16, hidden=32, classes=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, hidden).astype(np.float32),
            rs.randint(0, classes, size=(batch,)).astype(np.int32))


def _bert_xy(seed, batch, seq=16, hidden=32):
    rs = np.random.RandomState(seed)
    return ({"input": rs.randn(batch, seq, hidden).astype(np.float32)},
            rs.randint(0, 2, batch).astype(np.int32))


def _steps(ff, x, y, n, name="x"):
    return [float(ff.train_step({name: x}, y)["loss"]) for _ in range(n)]


SGD = functools.partial(TSGD, lr=0.05)
ADAM = functools.partial(TAdam, alpha=1e-2)


@pytest.fixture(scope="module")
def four(devices8):
    """The reference's results and the 4-rank group's."""
    ref, cases = {}, {}
    x, y = _xy(0)
    # dp 2 x pp 2: the reference's weights (stacked), forward, 5 steps
    ff = _ref_model(stacked, devices8[:4], _pp_strategy(RStrategy, 2, 2, 4))
    w = ff.get_weights()
    ref["w0"] = w
    ref["fwd"] = np.asarray(ff.forward({"x": x}))
    ref["losses"] = _steps(ff, x, y, STEPS)
    ref["after"] = ff.get_weights()
    pp22 = _pp_strategy(Strategy, 2, 2, 4)
    batches = [({"x": x}, y)] * STEPS
    cases["fwd"] = (R.forward, (stacked, pp22, w, {"x": x}))
    cases["steps"] = (R.train_steps, (stacked, pp22, w, batches, SGD))
    cases["remat"] = (R.train_steps, (stacked, pp22, w, batches, SGD,
                                      "sparse_categorical_crossentropy",
                                      {"remat": True}))
    # a pipe-only mesh
    x4, y4 = _xy(1)
    ff = _ref_model(stacked, devices8[:4], _pp_strategy(RStrategy, 1, 4, 4))
    ref["pipe_w"] = ff.get_weights()
    ref["pipe_losses"] = _steps(ff, x4, y4, 2)
    cases["pipe"] = (R.train_steps, (stacked, _pp_strategy(Strategy, 1, 4, 4),
                                     ref["pipe_w"], [({"x": x4}, y4)] * 2,
                                     SGD))
    # the ZeRO ladder under Adam: stages 0, 1 and 3 against the reference
    ff = _ref_model(stacked, devices8[:4], _pp_strategy(RStrategy, 2, 2, 4),
                    opt=RF.AdamOptimizer(alpha=1e-2))
    ref["adam_losses"] = _steps(ff, x, y, 3)
    ref["adam_after"] = ff.get_weights()
    for stage in (0, 1, 3):
        cases[("zero", stage)] = (
            R.train_steps, (stacked, _pp_strategy(Strategy, 2, 2, 4, stage),
                            w, [({"x": x}, y)] * 3, ADAM))
    # a BERT of 4 layers, dp 2 x pp 2, from the port's own seed-0 weights
    bert = functools.partial(t_build_bert, batch_size=8, num_layers=4,
                             **TINY_BERT)
    cases["bert"] = (R.train_steps, (bert, _pp_strategy(Strategy, 2, 2, 2),
                                     None, [_bert_xy(2, 8)] * 2, SGD))
    # dropout in the region: pipe 4 (a block per rank)
    drop = functools.partial(t_build_bert, batch_size=4, num_layers=4,
                             dropout=0.25, **TINY_BERT)
    cases["dropout"] = (R.train_steps, (drop, _pp_strategy(Strategy, 1, 4, 2),
                                        None, [_bert_xy(3, 4)] * 2, SGD))
    # the batch over both axes of {data: 2, model: 2} (a factored view)
    ff = _ref_model(stacked, devices8[:4], _factored(RStrategy))
    ref["factored_w"] = ff.get_weights()
    ref["factored_losses"] = _steps(ff, x, y, 2)
    ref["factored_after"] = ff.get_weights()
    cases["factored"] = (R.train_steps, (stacked, _factored(Strategy),
                                         ref["factored_w"],
                                         [({"x": x}, y)] * 2, SGD))
    names = list(cases)
    got = R.run_group(R.run_cases, 4, [cases[k] for k in names],
                      timeout=240)
    return ref, {k: [rank[i] for rank in got] for i, k in enumerate(names)}


def _factored(cls):
    """The inputs' dim 0 at degree 4 over {data: 2, model: 2}: a view
    over both axes."""
    s = cls(mesh_axes={"data": 2, "model": 2})
    s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": 4})]
    return s


def test_pp_strategy_matches_reference_and_single_device(four):
    """dp 2 x pp 2 GPipe training matches the reference's pipeline and
    the port's one-device model step for step, with the stacked weights
    carried over."""
    ref, out = four
    w = out["steps"][0]["weights"]
    assert set(w) == {"__pipeline__", "head"}
    assert w["__pipeline__"]["0.kernel"].shape == (4, 32, 32)
    for rank in out["fwd"]:
        np.testing.assert_allclose(rank, ref["fwd"], **TOL)
    for rank in out["steps"]:
        np.testing.assert_allclose(rank["losses"], ref["losses"], **TOL)
    for op, entries in ref["after"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(w[op][k], v, **TOL)
    one = _port_model(stacked)
    one.set_weights(_unstack(ref["w0"], [f"blk{i}" for i in range(4)]))
    x, y = _xy(0)
    np.testing.assert_allclose(one.forward({"x": x}).numpy(), ref["fwd"],
                               **TOL)
    losses = _steps(one, x, y, STEPS)
    np.testing.assert_allclose(out["steps"][0]["losses"], losses, **TOL)
    assert losses[-1] < losses[0]
    after = one.get_weights()
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(
            w["__pipeline__"][f"0.{k}"],
            np.stack([after[f"blk{i}"][k] for i in range(4)]), **TOL)


def test_pp_strategy_pipe_only_mesh(four):
    """pp without a data axis (mesh {'pipe': 4})."""
    ref, out = four
    for rank in out["pipe"]:
        assert np.isfinite(rank["losses"]).all()
        np.testing.assert_allclose(rank["losses"], ref["pipe_losses"], **TOL)


def test_pp_remat_matches_non_remat(four):
    """Remat through the region (a checkpoint per block) computes what
    the plain GPipe step computes, step for step."""
    _, out = four
    la, lb = out["steps"][0]["losses"], out["remat"][0]["losses"]
    np.testing.assert_allclose(lb, la, **TOL)
    assert la[-1] < la[0]
    for k, v in out["steps"][0]["weights"]["__pipeline__"].items():
        np.testing.assert_allclose(
            out["remat"][0]["weights"]["__pipeline__"][k], v, **TOL)


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_ladder_with_a_pipeline(four, stage):
    """The stacked leaves take the sharded update at stages 1 and 3 (and
    stay whole at 3, where the other leaves are scattered): the same
    losses and weights as stage 0 and the reference, with half of stage
    0's Adam slots on each rank of a data axis of 2."""
    ref, out = four
    zero, base = out[("zero", stage)][0], out[("zero", 0)][0]
    assert zero["zero_stage"] == stage and zero["fallback"] == []
    assert zero["opt_bytes"] * 2 == base["opt_bytes"]
    np.testing.assert_allclose(zero["losses"], base["losses"], **TOL)
    np.testing.assert_allclose(zero["losses"], ref["adam_losses"], **TOL)
    for op, entries in ref["adam_after"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(zero["weights"][op][k], v, **TOL)


def test_pipelined_bert_matches_one_device_bert(four):
    """A 4-layer BERT at dp 2 x pp 2 from the port's seed-0 weights: the
    weights drawn are the one-device model's (each block op draws its
    own, in topological order), and two steps and eval match it."""
    _, out = four
    ff = _port_model(functools.partial(t_build_bert, batch_size=8,
                                       num_layers=4, **TINY_BERT), batch=8)
    feed, y = _bert_xy(2, 8)
    losses = _steps(ff, feed["input"], y, 2, "input")
    got = out["bert"][0]
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    np.testing.assert_allclose(got["eval_loss"],
                               float(ff.eval_step(feed, y)["loss"]), **TOL)
    plan = plan_pipeline(ff.operators, _pp_strategy(
        Strategy, 2, 2, 2).pipeline, {"data": 2, "pipe": 2})
    names = [[op.name for op in blk] for blk in plan.blocks]
    after = ff.get_weights()
    for key, arr in got["weights"]["__pipeline__"].items():
        j, k = key.split(".", 1)
        np.testing.assert_allclose(
            arr, np.stack([after[blk[int(j)]][k] for blk in names]), **TOL)
    for op in ("classifier",):
        for k, v in after[op].items():
            np.testing.assert_allclose(got["weights"][op][k], v, **TOL)


def _degree_one(build, batch, M, **cfg):
    s = data_parallel_strategy(1)
    s.pipeline = {"degree": 1, "num_microbatches": M, "axis": "data",
                  "dp_axis": None}
    return _port_model(build, s, batch=batch, **cfg)


def test_region_dropout_does_not_depend_on_the_stage_count(four):
    """Dropout in a block draws from a generator seeded by one draw of
    the step's, its template op and its block: the pipe-4 group trains
    the losses of the same pipeline on one stage, and they differ from
    the losses without dropout."""
    _, out = four
    build = functools.partial(t_build_bert, batch_size=4, num_layers=4,
                              dropout=0.25, **TINY_BERT)
    ff = _degree_one(build, 4, 2)
    feed, y = _bert_xy(3, 4)
    losses = _steps(ff, feed["input"], y, 2, "input")
    np.testing.assert_allclose(out["dropout"][0]["losses"], losses, **TOL)
    plain = _degree_one(functools.partial(
        t_build_bert, batch_size=4, num_layers=4, **TINY_BERT), 4, 2)
    assert _steps(plain, feed["input"], y, 1, "input")[0] != losses[0]


def test_region_dropout_seeds_by_block_and_repeats_under_remat(
        monkeypatch):
    """Each block's attention gets its own seed, the same for every
    microbatch; a rematerialized block redraws with that seed, so remat
    trains the losses of no remat; eval draws nothing."""
    build = functools.partial(t_build_bert, batch_size=4, num_layers=4,
                              dropout=0.25, **TINY_BERT)
    runs = {}
    for remat in (False, True):
        ff = _degree_one(build, 4, 2, remat=remat)
        template = ff.executor.pipeline_plan.blocks[0]
        attn = next(op for op in template
                    if op.op_type.name == "MULTIHEAD_ATTENTION")
        seen = []
        forward = attn.forward

        def recording(ins, ws, training=False, generator=None, _f=forward,
                      _seen=seen):
            _seen.append(None if generator is None
                         else generator.initial_seed())
            return _f(ins, ws, training=training, generator=generator)

        monkeypatch.setattr(attn, "forward", recording)
        feed, y = _bert_xy(3, 4)
        runs[remat] = _steps(ff, feed["input"], y, 2, "input")
        # 2 steps x 2 microbatches x 4 blocks, twice under remat
        assert len(seen) == 16 * (2 if remat else 1)
        step0 = seen[:len(seen) // 2]
        per_block = {}
        for i, s in enumerate(step0[:8]):  # the forward of step 0
            per_block.setdefault(i % 4, set()).add(s)
        assert all(len(v) == 1 for v in per_block.values())
        assert len({next(iter(v)) for v in per_block.values()}) == 4
        assert set(step0) == {next(iter(v)) for v in per_block.values()}
        seen.clear()
        ff.eval_step(feed, y)
        assert seen and set(seen) == {None}
    np.testing.assert_allclose(runs[True], runs[False], **TOL)


def test_pp_plan_validation_errors():
    ff = PF.FFModel(PF.FFConfig(device="cpu", batch_size=16))
    stacked(ff, layers=3)
    with pytest.raises(ValueError, match="not divisible"):
        plan_pipeline(ff.layers, {"degree": 2, "num_microbatches": 4,
                                  "axis": "pipe", "dp_axis": None},
                      {"pipe": 2})
    ff2 = PF.FFModel(PF.FFConfig(device="cpu", batch_size=8))
    x = ff2.create_tensor([8, 16], name="x")
    ff2.softmax(ff2.dense(x, 32, name="a"))
    with pytest.raises(ValueError, match="block"):
        plan_pipeline(ff2.layers, {"degree": 2, "num_microbatches": 2,
                                   "axis": "pipe", "dp_axis": None},
                      {"pipe": 2})


def test_pp_strategy_json_roundtrip(tmp_path):
    """Both ways, and across the packages."""
    s = _pp_strategy(Strategy, 2, 2, 8)
    p = tmp_path / "pp.json"
    s.save(str(p))
    s2 = Strategy.load(str(p))
    assert s2.pipeline == s.pipeline and s2.mesh_axes == s.mesh_axes
    r = RStrategy.load(str(p))
    assert r.pipeline == s.pipeline and r.to_json() == s.to_json()


def test_adapt_weight_layout_both_ways(devices8):
    """Per-op weights stacked for a pipeline, and stacked ones unstacked
    for a model without one, as the reference maps them."""
    ref_pp = _ref_model(stacked, devices8[:4],
                        _pp_strategy(RStrategy, 2, 2, 4))
    ref_one = _ref_model(stacked, devices8[:1])
    per_op = ref_one.get_weights()
    stacked_w = ref_pp.get_weights()
    mine_pp = _degree_one(stacked, 16, 4)
    mine_one = _port_model(stacked)
    for a, b in ((mine_pp._adapt_weight_layout(per_op),
                  ref_pp._adapt_weight_layout(per_op)),
                 (mine_one._adapt_weight_layout(stacked_w),
                  ref_one._adapt_weight_layout(stacked_w))):
        assert {k: sorted(v) for k, v in a.items()} == \
            {k: sorted(v) for k, v in b.items()}
        for op, entries in b.items():
            for k, v in entries.items():
                np.testing.assert_array_equal(a[op][k], np.asarray(v))
    # a layout that already fits passes as it is
    assert mine_one._adapt_weight_layout(per_op) is per_op
    # and set_weights takes either: the stacked tree on a one-device model
    mine_one.set_weights(stacked_w)
    got = mine_one.get_weights()
    np.testing.assert_array_equal(got["blk2"]["kernel"],
                                  stacked_w["__pipeline__"]["0.kernel"][2])
    with pytest.raises(ValueError, match="block layers"):
        mine_one.set_weights({"__pipeline__": {
            "0.kernel": np.zeros((3, 32, 32), np.float32)},
            "head": per_op["head"]})


def test_compile_runs_factored_views_as_the_reference(four):
    """The batch at degree 4 over {data: 2, model: 2}, a dim over two
    mesh axes that compile refused before factored views were ported,
    trains 2 SGD steps to the reference's losses and weights."""
    ref, out = four
    for rank in out["factored"]:
        np.testing.assert_allclose(rank["losses"], ref["factored_losses"],
                                   **TOL)
    got = out["factored"][0]["weights"]
    for op, entries in ref["factored_after"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(got[op][k], v, **TOL)


def test_compile_still_refuses_factored_views():
    """The one factored view the port still refuses, as the reference
    does (its ring asserts one sequence axis): ring attention over two
    mesh axes raises at the op's plan, naming ROADMAP §1 item 1."""
    from flexflow_tpu_torch.parallel.machine import DeviceMesh
    from flexflow_tpu_torch.parallel.spmd import layout_of, plan_op
    from flexflow_tpu_torch.strategy import apply_strategy, assign_views

    ff = PF.FFModel(PF.FFConfig(device="cpu", batch_size=2))
    t_build_bert(ff, batch_size=2, num_layers=1, **TINY_BERT)
    f = Strategy(mesh_axes={"seq0": 2, "seq1": 2})
    f.edge_ops["__inputs__"] = [("repartition", {"dim": 1, "degree": 4})]
    g = apply_strategy(ff.layers, f)
    assign_views(g, f.mesh_axes)
    attn = next(op for op in g.ops if op.name == "attn_0")
    assert len(attn.inputs[0].machine_view.axes[1]) == 2
    mesh = DeviceMesh(f.mesh_axes, 0, "cpu", {}, {})
    with pytest.raises(NotImplementedError,
                       match="more than one mesh axis.*ROADMAP §1 item 1"):
        plan_op(attn, mesh, [layout_of(t) for t in attn.inputs])


def test_compile_runs_an_expert_degree_on_a_dense_op_as_the_reference(
        devices8):
    """ShardConfig(expert=2) on a dense op (blk0) of a one-device
    strategy: the reference ignores the degree (a Linear has no expert
    dim) and trains; the port, which refused every expert sharding
    before expert parallelism, now compiles it and trains the same
    losses and weights."""
    from flexflow_tpu.ops.op import ShardConfig as RShard
    from flexflow_tpu.strategy import data_parallel_strategy as r_dp
    from flexflow_tpu_torch.ops.op import ShardConfig

    rs = r_dp(1)
    rs.shard_configs["blk0"] = RShard(expert=2)
    ref = _ref_model(stacked, devices8[:1], rs)
    w = ref.get_weights()
    x, y = _xy(0)
    want = _steps(ref, x, y, 2)
    s = data_parallel_strategy(1)
    s.shard_configs["blk0"] = ShardConfig(expert=2)
    ff = _port_model(stacked, s)
    ff.set_weights(w)
    np.testing.assert_allclose(_steps(ff, x, y, 2), want, **TOL)
    for op, entries in ref.get_weights().items():
        for k, v in entries.items():
            np.testing.assert_allclose(ff.get_weights()[op][k], v, **TOL)


def test_pipeline_candidates_are_the_reference_searchs():
    """`UnitySearch.pipeline_candidates` (what chip_smoke.py's pp_searched
    leg takes the cheapest of) prices the reference search's pipeline
    candidates at the same cost, cheapest first, each with its event
    re-rank figure."""
    from flexflow_tpu.pcg import unity as r_unity
    from flexflow_tpu.sim import simulator as r_sim

    rm, pm = simple_machines(4)
    ffr = RF.FFModel(RF.FFConfig(batch_size=8, num_devices=4))
    build_bert(ffr, batch_size=8, num_layers=4, **TINY_BERT)
    ffp = PF.FFModel(PF.FFConfig(device="cpu", batch_size=8))
    t_build_bert(ffp, batch_size=8, num_layers=4, **TINY_BERT)
    ref = {(s.to_json(), obj) for s, obj, _ in r_unity.UnitySearch(
        ffr.layers, 4, rm, r_sim.OpCostModel(rm))._pp_candidates(0.0)}
    got = p_unity.UnitySearch(ffp.layers, 4, pm, p_sim.OpCostModel(pm)
                              ).pipeline_candidates()
    assert len(got) == len(ref) >= 3
    assert [c[0] for c in got] == sorted(c[0] for c in got)
    assert {(s.to_json(), obj) for obj, _, s in got} == ref
    assert all(s.pipeline and e is not None and e > 0 for _, e, s in got)
