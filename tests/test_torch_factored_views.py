"""Factored per-op views in the port (tests/test_per_op_views.py and
`_dryrun_multichip_body`'s per-op-views leg): strategies whose views
shard one dim over several mesh axes, so that ops run at different
degrees on factored axes ({model0, model1}) in one program.

The port runs in spawned gloo groups (tests/torch_dist_ranks.py), one of
8 ranks and one of 4, each spawned once for the module; the reference
runs in this process on the 8-device CPU mesh, on the same numpy
inputs, with its weights copied into the port.  The cases: the
mixed-degree MLP (fa at channel 2 on model1, fb at channel 4 on
model1 + model0) forward and 2 SGD steps, the dry run's strategy, the
port's Unity winner for test_per_op_views.py's narrow and wide graph
over 8 H100s (a factored mesh with mixed degrees), a 2-layer BERT with
attention at channel 4 and the first FFN at channel 2 or 4, and the one
factored view that stays refused (ring attention over two axes).  Every
tensor's spec against the reference's `view_to_spec` is in
tests/test_torch_factored_specs.py.
"""
import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_ranks as R  # noqa: E402

import flexflow_tpu as RF  # noqa: E402
from flexflow_tpu.models.transformer import build_bert  # noqa: E402
from flexflow_tpu.ops.op import ShardConfig as RShard  # noqa: E402
from flexflow_tpu.strategy import Strategy as RStrategy  # noqa: E402
from flexflow_tpu_torch import FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models.transformer import \
    build_bert as t_build_bert  # noqa: E402
from flexflow_tpu_torch.ops.op import ShardConfig  # noqa: E402
from flexflow_tpu_torch.optimizer import SGDOptimizer as TSGD  # noqa: E402
from flexflow_tpu_torch.pcg.unity import UnitySearch  # noqa: E402
from flexflow_tpu_torch.sim.machine_model import (GpuNodeModel,  # noqa: E402
                                                  machine_file)
from flexflow_tpu_torch.sim.simulator import OpCostModel  # noqa: E402
from flexflow_tpu_torch.strategy import Strategy  # noqa: E402

# float32 on both sides; the partial sums over ranks (gloo's ring) and
# XLA's run in other orders
TOL = dict(rtol=2e-5, atol=2e-5)
BERT = dict(seq_length=8, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64)
DRY = dict(width=32, a=64, b=128)
STEPS = 2


def narrow_wide(ff):
    """test_per_op_views.py:69's graph: 1026 = 2 x 513 shards at degree
    2 only, 4096 at 4 and 8."""
    relu = R._relu(ff)
    x = ff.create_tensor([16, 2048], name="x")
    t = ff.dense(x, 1026, activation=relu, name="narrow")
    t = ff.dense(t, 4096, activation=relu, name="wide")
    t = ff.dense(t, 4, name="head")
    ff.softmax(t)


def unity_winner():
    """The port's Unity search for narrow_wide on 8 GPUs of
    hgx_h100_8.json: the cheapest candidate of one graph variant."""
    ff = FFModel(FFConfig(device="cpu", batch_size=16))
    narrow_wide(ff)
    m = GpuNodeModel.from_file(machine_file("hgx_h100_8"))
    search = UnitySearch(ff.layers, 8, m, OpCostModel(m),
                         rewrite_max_variants=1, event_rerank=False)
    collector = []
    search._optimize_graph(0.0, collector)
    return min(collector, key=lambda c: c[0])[1]


def _ref_model(build, devices, strategy, batch, lr):
    ff = RF.FFModel(RF.FFConfig(batch_size=batch, num_devices=len(devices)))
    build(ff)
    ff.compile(optimizer=RF.SGDOptimizer(lr=lr),
               loss_type=RF.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=strategy, devices=devices, seed=0)
    return ff


def _xy(seed, batch, width, classes=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, width).astype(np.float32),
            rs.randint(0, classes, batch).astype(np.int32))


def _ref_run(ff, feed, y, ref, key):
    ref[key + "_w0"] = ff.get_weights()
    ref[key + "_losses"] = [float(ff.train_step(feed, y)["loss"])
                            for _ in range(STEPS)]
    ref[key + "_after"] = ff.get_weights()


def train_r0(rank, world, *args):
    """train_steps, with the weights kept on rank 0 only."""
    out = R.train_steps(rank, world, *args)
    if rank:
        out["weights"] = None
    return out


@pytest.fixture(scope="module")
def eight(devices8):
    ref, cases = {}, {}
    # the mixed-degree MLP: forward, then 2 SGD steps
    x, y = _xy(0, 8, 16)
    y = np.random.RandomState(1).randint(0, 4, 8).astype(np.int32)
    ff = _ref_model(R.mixed_mlp, devices8,
                    R.mixed_strategy(RStrategy, RShard), 8, 0.05)
    ref["mlp_fwd"] = np.asarray(ff.forward({"x": x}))
    _ref_run(ff, {"x": x}, y, ref, "mlp")
    mixed = R.mixed_strategy(Strategy, ShardConfig)
    cases["mlp_fwd"] = (R.forward, (R.mixed_mlp, mixed, ref["mlp_w0"],
                                    {"x": x}))
    cases["mlp"] = (train_r0, (R.mixed_mlp, mixed, ref["mlp_w0"],
                               [({"x": x}, y)] * STEPS,
                               functools.partial(TSGD, lr=0.05)))
    # the dry run's per-op-views leg
    dry = functools.partial(R.mixed_mlp, **DRY)
    xd = np.random.RandomState(8).randn(8, 32).astype(np.float32)
    yd = np.random.RandomState(9).randint(0, 4, 8).astype(np.int32)
    ff = _ref_model(dry, devices8, R.mixed_strategy(RStrategy, RShard), 8,
                    0.01)
    _ref_run(ff, {"x": xd}, yd, ref, "dry")
    cases["dry"] = (train_r0, (dry, mixed, ref["dry_w0"],
                               [({"x": xd}, yd)] * STEPS,
                               functools.partial(TSGD, lr=0.01)))
    # the port's Unity winner, under the reference too
    best = unity_winner()
    ref["unity_strategy"] = best
    xu, yu = _xy(2, 16, 2048)
    ff = _ref_model(narrow_wide, devices8, RStrategy.from_json(best.to_json()),
                    16, 0.01)
    _ref_run(ff, {"x": xu}, yu, ref, "unity")
    cases["unity"] = (train_r0, (narrow_wide, best, ref["unity_w0"],
                                 [({"x": xu}, yu)] * STEPS,
                                 functools.partial(TSGD, lr=0.01)))
    names = list(cases)
    got = R.run_group(R.run_cases, 8, [cases[k] for k in names],
                      timeout=300)
    return ref, {k: [rank[i] for rank in got] for i, k in enumerate(names)}


def _bert_strategies(ffn1):
    return (R.bert_factored(RStrategy, RShard, BERT["num_layers"], 4, ffn1),
            R.bert_factored(Strategy, ShardConfig, BERT["num_layers"], 4,
                            ffn1))


@pytest.fixture(scope="module")
def four(devices8):
    ref, cases = {}, {}
    rs = np.random.RandomState(3)
    feed = {"input": rs.randn(4, 8, 32).astype(np.float32)}
    y = rs.randint(0, 2, 4).astype(np.int32)
    for ffn1 in (2, 4):
        rstrat, strat = _bert_strategies(ffn1)
        ff = _ref_model(functools.partial(build_bert, batch_size=4, **BERT),
                        devices8[:4], rstrat, 4, 0.01)
        _ref_run(ff, feed, y, ref, f"bert{ffn1}")
        cases[f"bert{ffn1}"] = (train_r0, (
            functools.partial(t_build_bert, batch_size=4, **BERT), strat,
            ref[f"bert{ffn1}_w0"], [(feed, y)] * STEPS,
            functools.partial(TSGD, lr=0.01)))
    # the sequence over {seq0, seq1}: ring attention over two axes
    ring = Strategy(mesh_axes={"seq0": 2, "seq1": 2})
    ring.edge_ops["__inputs__"] = [("repartition", {"dim": 1, "degree": 4})]
    cases["ring"] = (R.compile_error, (
        functools.partial(t_build_bert, batch_size=4, **BERT), ring))
    names = list(cases)
    got = R.run_group(R.run_cases, 4, [cases[k] for k in names],
                      timeout=240)
    return ref, {k: [rank[i] for rank in got] for i, k in enumerate(names)}


def _check_training(ref, out, key):
    for rank in out[key]:
        np.testing.assert_allclose(rank["losses"], ref[key + "_losses"],
                                   **TOL)
    got = out[key][0]["weights"]
    for op, entries in ref[key + "_after"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(got[op][k], v, **TOL,
                                       err_msg=f"{key} {op}.{k}")
    assert ref[key + "_losses"][1] != ref[key + "_losses"][0]


def test_mixed_degree_mlp_forward_matches_reference(eight):
    ref, out = eight
    for rank in out["mlp_fwd"]:
        np.testing.assert_allclose(rank, ref["mlp_fwd"], **TOL)


@pytest.mark.parametrize("key", ["mlp", "dry", "unity"])
def test_factored_strategies_train_as_the_reference(eight, key):
    """2 SGD steps of the mixed-degree MLP, the dry run's strategy and
    the port's Unity winner: every rank's losses and the gathered
    weights equal the reference's."""
    _check_training(*eight, key)


@pytest.mark.parametrize("ffn1", [2, 4])
def test_bert_factored_mixes_train_as_the_reference(four, ffn1):
    """A 2-layer BERT under {model0: 2, model1: 2}: attention heads on
    model1 + model0 and ffn1 at channel 2 (on model1) or 4."""
    _check_training(*four, f"bert{ffn1}")


def test_unity_writes_a_factored_mesh_with_mixed_degrees(eight):
    """On 8 H100s of hgx_h100_8.json the port's Unity puts the narrow
    layer (1026 wide: degree 2 only) and the wide one on different
    degrees of a factored mesh, as the reference's does on its pod."""
    best = eight[0]["unity_strategy"]
    assert any(k.startswith("model0") for k in best.mesh_axes), best.mesh_axes
    degrees = {k: v.channel for k, v in best.shard_configs.items()
               if v.channel > 1}
    assert len(set(degrees.values())) >= 2, degrees


def test_compile_refuses_ring_attention_over_two_axes(four):
    """The sequence over {seq0, seq1} is ring attention over two axes,
    which neither package runs (the reference's ring asserts one
    sequence axis): compile raises on every rank, naming ROADMAP §1
    item 1."""
    _, out = four
    for msg in out["ring"]:
        assert msg is not None and "ROADMAP §1 item 1" in msg, msg
