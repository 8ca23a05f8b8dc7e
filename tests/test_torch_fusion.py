"""The --fusion compile pass of the port (pcg/rewrite.py
`fuse_activations`, FFConfig.perform_fusion) against flexflow_tpu's on
the CPU.

The pass folds each activation that follows a linear or conv2d into the
producer's activation slot, to a fixpoint, and leaves alone a match
that touches an op or tensor the strategy names.  On the same layer
graphs (the MLP of tests/test_config_flags.py and a small CNN) both
packages give the same fused graph: op names, types, activations and
count; a strategy edge chain on the ReLU's output keeps the ReLU, as
tests/test_config_flags.py::test_perform_fusion_respects_strategy_references
has it.  A fused model trains to the reference's fused losses and
weights (float32, the same formulas in other summation orders: 1e-5),
and to the port's own unfused ones.  ResNet-50's BatchNorm plan keeps
its 53 P1 applies with fusion on (no conv2d there feeds an activation
directly).  chip_smoke.py's small ViT through both torch.fx importers
with fusion on folds each block's GELU into fc1 in both packages (the
same op names and types) and trains to the reference's losses and to
the port's unfused ones (1e-5).  `--fusion` parses to perform_fusion in
both packages.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.config import FFConfig as JaxConfig  # noqa: E402
from flexflow_tpu.pcg.rewrite import \
    fuse_activations as jax_fuse  # noqa: E402
from flexflow_tpu.torch_frontend.model import \
    PyTorchModel as JaxPyTorchModel  # noqa: E402
from flexflow_tpu_torch.executor import plan_bn_applies  # noqa: E402
from flexflow_tpu_torch.pcg.layout import assign_layouts  # noqa: E402
from flexflow_tpu_torch.pcg.rewrite import fuse_activations  # noqa: E402
from flexflow_tpu_torch.strategy import data_parallel_strategy  # noqa: E402
from flexflow_tpu_torch.torch_frontend import PyTorchModel  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ATOL = 1e-5
BATCH = 8


def _mlp_relu(P, cfg):
    """tests/test_config_flags.py's MLP: fc1, a ReLU of its own, fc2,
    softmax."""
    ff = P.FFModel(cfg)
    x = ff.create_tensor([BATCH, 16], name="x")
    t = ff.dense(x, 32, name="fc1")
    t = ff.relu(t)
    t = ff.dense(t, 4, name="fc2")
    ff.softmax(t)
    return ff


def _cnn(P, cfg):
    """conv -> relu -> conv -> sigmoid -> pool -> flat -> dense -> tanh
    -> dense: two conv2d folds and one linear fold."""
    ff = P.FFModel(cfg)
    x = ff.create_tensor([BATCH, 3, 8, 8], name="x")
    t = ff.relu(ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="c1"))
    t = ff.sigmoid(ff.conv2d(t, 4, 3, 3, 1, 1, 1, 1, name="c2"))
    t = ff.pool2d(t, 2, 2, 2, 2, name="pool")
    t = ff.flat(t, name="flat")
    t = ff.tanh(ff.dense(t, 16, name="fc1"))
    ff.dense(t, 4, name="fc2")
    return ff


BUILDERS = {"mlp": _mlp_relu, "cnn": _cnn}


def _describe(graph):
    """(name, type, activation) of every op but the parallel ops (the
    reference's compile applies a data-parallel strategy of degree 1,
    whose input repartition the port's compile of the layer graph does
    not insert)."""
    return sorted((op.name, op.op_type.value,
                   str(getattr(op.params, "activation", "")).split(".")[-1])
                  for op in graph.ops if not op.is_parallel_op())


def _configs(**kw):
    return (J.FFConfig(batch_size=BATCH, num_devices=1, **kw),
            T.FFConfig(batch_size=BATCH, device="cpu", **kw))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_fuse_activations_gives_the_reference_graph(name):
    jcfg, tcfg = _configs()
    jf, tf = BUILDERS[name](J, jcfg), BUILDERS[name](T, tcfg)
    want, got = jax_fuse(jf.layers), fuse_activations(tf.layers)
    assert _describe(got) == _describe(want)
    assert len(got.ops) == len(want.ops) < len(tf.layers.ops)
    assert not any(op.op_type.value == "element_unary" for op in got.ops)
    # the layer graph itself is left as it was
    assert len(tf.layers.ops) == len(jf.layers.ops)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_fuse_activations_leaves_protected_names(name):
    jcfg, tcfg = _configs()
    jf, tf = BUILDERS[name](J, jcfg), BUILDERS[name](T, tcfg)
    acts = [op for op in tf.layers.ops if op.op_type.value == "element_unary"]
    # protect the first activation's output tensor and the last producer
    protected = {acts[0].outputs[0].name, acts[-1].inputs[0].owner_op.name}
    want = jax_fuse(jf.layers, protected)
    got = fuse_activations(tf.layers, protected)
    assert _describe(got) == _describe(want)
    kept = {op.name for op in got.ops if op.op_type.value == "element_unary"}
    assert kept == {acts[0].name, acts[-1].name}


def test_compile_with_fusion_folds_as_the_reference():
    """test_perform_fusion_folds_activations, in both packages."""
    jcfg, tcfg = _configs(perform_fusion=True)
    jf, tf = _mlp_relu(J, jcfg), _mlp_relu(T, tcfg)
    jf.compile(optimizer=J.SGDOptimizer(lr=0.01),
               devices=jax.devices("cpu")[:1])
    tf.compile(optimizer=T.SGDOptimizer(lr=0.01))
    assert _describe(tf.operators) == _describe(jf.operators)
    fused = next(op for op in tf.operators.ops if op.name == "fc1")
    assert fused.params.activation == T.ActiMode.RELU
    assert not any(op.op_type.value == "element_unary"
                   for op in tf.operators.ops)


def test_compile_with_fusion_keeps_what_the_strategy_names():
    """test_perform_fusion_respects_strategy_references on one device: an
    edge chain on the ReLU's output (a repartition and a combine, which
    compile cancels) keeps the ReLU."""
    _, tcfg = _configs(perform_fusion=True)
    tf = _mlp_relu(T, tcfg)
    relu_out = next(op for op in tf.layers.ops
                    if op.op_type.value == "element_unary").outputs[0].name
    s = data_parallel_strategy(1)
    s.edge_ops[relu_out] = [("repartition", {"dim": 0, "degree": 2}),
                            ("combine", {"dim": 0, "degree": 2})]
    tf.compile(optimizer=T.SGDOptimizer(lr=0.01), strategy=s)
    assert any(op.op_type.value == "element_unary"
               for op in tf.operators.ops)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_fused_model_trains_as_the_reference(name):
    """3 SGD steps with fusion on in both packages from the same
    weights: losses and weights within 1e-5; the port's fused losses
    equal its unfused ones within 1e-5."""
    jcfg, tcfg = _configs(perform_fusion=True)
    jf, tf = BUILDERS[name](J, jcfg), BUILDERS[name](T, tcfg)
    jf.compile(optimizer=J.SGDOptimizer(lr=0.05),
               devices=jax.devices("cpu")[:1])
    tf.compile(optimizer=T.SGDOptimizer(lr=0.05))
    _, ucfg = _configs()
    uf = BUILDERS[name](T, ucfg)
    uf.compile(optimizer=T.SGDOptimizer(lr=0.05))
    w = jf.get_weights()
    tf.set_weights(w)
    uf.set_weights(w)
    rng = np.random.RandomState(0)
    shape = [d for d in tf.layers.source_ops()[0].outputs[0].shape
             .logical_shape]
    for _ in range(3):
        feed = {"x": rng.randn(*shape).astype(np.float32)}
        y = rng.randint(0, 4, BATCH).astype(np.int32)
        want = float(jf.train_step(feed, y)["loss"])
        got = float(tf.train_step(feed, y)["loss"])
        plain = float(uf.train_step(feed, y)["loss"])
        assert abs(got - want) <= ATOL and abs(got - plain) <= ATOL
    jw = jf.get_weights()
    for op, entries in tf.get_weights().items():
        for k, v in entries.items():
            np.testing.assert_allclose(v, np.asarray(jw[op][k]), atol=ATOL,
                                       rtol=0)


def test_resnet50_keeps_53_applies_with_fusion():
    """The example's ResNet-50 graph through the port's importer, fused:
    the reference's fused graph, and the BatchNorm plan's 53 applies."""
    import sys
    from pathlib import Path

    from flexflow_tpu.torch_frontend.model import \
        PyTorchModel as JaxPyTorchModel
    from flexflow_tpu_torch.torch_frontend import PyTorchModel

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"
                           / "python" / "pytorch"))
    from resnet50_search import ResNet50

    torch.manual_seed(0)
    module = ResNet50(classes=1000)
    graphs = []
    for P, Importer in ((J, JaxPyTorchModel), (T, PyTorchModel)):
        kw = {"num_devices": 1} if P is J else {"device": "cpu"}
        ff = P.FFModel(P.FFConfig(batch_size=2, **kw))
        x = ff.create_tensor([2, 3, 224, 224], name="input")
        (out,) = Importer(module).torch_to_ff(ff, [x])
        ff.softmax(out)
        graphs.append(ff.layers)
    want, got = jax_fuse(graphs[0]), fuse_activations(graphs[1])
    assert _describe(got) == _describe(want)
    plans = plan_bn_applies(got, assign_layouts(got)[0])
    assert len(plans) == 53
    assert sum(p.residual is not None for p in plans.values()) == 16


def _vit(P, Importer, module, fusion):
    """module through a torch.fx importer, compiled (SGD lr 0.1) with
    or without the fusion pass, weights copied from the module."""
    kw = {"num_devices": 1} if P is J else {"device": "cpu"}
    ff = P.FFModel(P.FFConfig(batch_size=4, perform_fusion=fusion, **kw))
    x = ff.create_tensor([4, 3, 32, 32], name="x0")
    pt = Importer(module)
    pt.torch_to_ff(ff, [x])
    ck = {"devices": jax.devices("cpu")[:1]} if P is J else {}
    ff.compile(optimizer=P.SGDOptimizer(lr=0.1), **ck)
    pt.copy_weights(ff)
    return ff


def test_small_vit_fuses_and_trains_as_the_reference():
    _, SmallViT = chip_smoke.vit_modules()
    torch.manual_seed(0)
    module = SmallViT()
    jf = _vit(J, JaxPyTorchModel, module, True)
    tf = _vit(T, PyTorchModel, module, True)
    uf = _vit(T, PyTorchModel, module, False)
    got = _describe(tf.operators)
    assert got == _describe(jf.operators)
    # each block's GELU, and nothing else, is folded into its fc1
    plain = _describe(uf.operators)
    folded = {n for n, _, _ in plain} - {n for n, _, _ in got}
    assert folded == {"blocks_0_act", "blocks_1_act"}
    assert len(got) == len(plain) - 2
    assert sum("GELU" in a.upper() for _, _, a in got) == 2
    rng = np.random.RandomState(1)
    for _ in range(2):
        feed = {"x0": rng.randn(4, 3, 32, 32).astype(np.float32)}
        y = rng.randint(0, 10, 4).astype(np.int32)
        want = float(jf.train_step(feed, y)["loss"])
        fused = float(tf.train_step(feed, y)["loss"])
        plain = float(uf.train_step(feed, y)["loss"])
        assert abs(fused - want) <= ATOL and abs(fused - plain) <= ATOL


def test_fusion_flag_parses_as_the_reference():
    assert T.FFConfig.from_args(["--fusion"]).perform_fusion
    assert JaxConfig.from_args(["--fusion"]).perform_fusion
    assert not T.FFConfig.from_args([]).perform_fusion
    assert not T.FFConfig().perform_fusion
