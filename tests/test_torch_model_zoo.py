"""The port's native model zoo against flexflow_tpu's on the CPU.

Every builder of `models/` (ResNet-50, ResNeXt-50, Inception-v3, DLRM,
XDL, CANDLE-Uno, MLP_Unify, the MoE MLP and encoder, AlexNet, the
Transformer) at tests/test_model_zoo.py's tiny sizes (AlexNet at the
64 px its example uses, the Transformer at 2 layers, hidden 16) through
both packages with the same weights: the forward, then the metrics of
2 SGD steps and every weight after them.  The full-width graphs (built,
not compiled) have the reference's op names, types, output shapes and
weight shapes.  The tiny Inception-v3 converts between NCHW and NHWC
exactly where the reference's layout pass does: once at the input and
once before the head, every branch join staying channels_last.  Also:
the npz weight files load across the packages both ways,
get_parameter, set_learning_rate in the middle of training, and the
reference's manual step surface.

Tolerances, float32 on the CPU (the same formulas in other summation
orders, XLA's against oneDNN's and ATen's): forward outputs 1e-5 of
their scale max(1, max|ref|), losses and metric sums 1e-5, weights
2e-5 after 2 steps (at lr 0.01; CANDLE-Uno's and the Transformer's
sums run over 16-60 products per output)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu.models as JM  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
import flexflow_tpu_torch.models as TM  # noqa: E402
from flexflow_tpu import checkpoint as JC  # noqa: E402
from flexflow_tpu.pcg.layout import \
    assign_layouts as jax_layouts  # noqa: E402
from flexflow_tpu_torch import checkpoint as TC  # noqa: E402
from flexflow_tpu_torch.pcg.layout import assign_layouts  # noqa: E402

OUT_TOL, LOSS_TOL, WEIGHT_TOL = 1e-5, 1e-5, 2e-5
BATCH = 8
SCE = ("sparse_categorical_crossentropy", ("accuracy",))
MSE = ("mean_squared_error_avg", ("mean_squared_error",))


def _classes(n, shape=(BATCH,)):
    return lambda rng: rng.randint(0, n, size=shape).astype(np.int32)


def _images(px):
    return lambda rng: {"input": rng.randn(BATCH, 3, px, px).astype(
        np.float32)}


def _sparse(vocabs, dense=None):
    def make(rng):
        x = {f"sparse_input_{i}": rng.randint(0, v, size=(BATCH, 1)).astype(
            np.int32) for i, v in enumerate(vocabs)}
        if dense:
            x["dense_input"] = rng.randn(BATCH, dense).astype(np.float32)
        return x
    return make


def _features(**dims):
    return lambda rng: {k: rng.randn(*((BATCH,) + d)).astype(np.float32)
                        for k, d in dims.items()}


def _regress(*shape):
    return lambda rng: rng.rand(*((BATCH,) + shape)).astype(np.float32)


# builder name -> (tiny kwargs, loss and metrics, inputs, labels)
TINY = {
    "build_resnet50": (dict(batch_size=BATCH, num_classes=4, image_size=32,
                            stage_blocks=(1, 1), base_channels=8),
                       SCE, _images(32), _classes(4)),
    "build_resnext50": (dict(batch_size=BATCH, num_classes=4,
                             image_size=32, stage_blocks=(1, 1), groups=4,
                             base_channels=8),
                        SCE, _images(32), _classes(4)),
    "build_inception_v3": (dict(batch_size=BATCH, num_classes=4,
                                image_size=75, channel_scale=1 / 16),
                           SCE, _images(75), _classes(4)),
    "build_dlrm": (dict(batch_size=BATCH, embedding_size=(50, 60, 70),
                        sparse_feature_size=8, dense_feature_dim=8,
                        mlp_bot=[8, 8], mlp_top=[16, 2]),
                   MSE, _sparse((50, 60, 70), dense=8), _regress(2)),
    "build_xdl": (dict(batch_size=BATCH, embedding_size=(40, 40),
                       sparse_feature_size=8, mlp_dims=[16, 2]),
                  MSE, _sparse((40, 40)), _regress(2)),
    "build_candle_uno": (dict(batch_size=BATCH, input_dims=[12, 20, 8],
                              dense_layers=[16, 16],
                              dense_feature_layers=[16, 16]),
                         MSE, _features(input_0=(12,), input_1=(20,),
                                        input_2=(8,)), _regress(1)),
    "build_mlp_unify": (dict(batch_size=BATCH, input_dim=16,
                             hidden_dims=[32, 32, 4]),
                        SCE, _features(input1=(16,), input2=(16,)),
                        _classes(4)),
    "build_moe_mlp": (dict(batch_size=BATCH, input_dim=16, num_classes=4,
                           num_exp=4, num_select=2, hidden_size=16),
                      SCE, _features(input=(16,)), _classes(4)),
    "build_moe_encoder": (dict(batch_size=BATCH, seq_length=8,
                               hidden_size=16, num_layers=1, num_heads=4,
                               num_exp=4, num_select=2, num_classes=4),
                          SCE, _features(input=(8, 16)),
                          _classes(4, (BATCH, 8))),
    "build_alexnet": (dict(batch_size=BATCH, num_classes=4, image_size=64),
                      SCE, _images(64), _classes(4)),
    "build_transformer": (dict(batch_size=BATCH, seq_length=8,
                               hidden_size=16, num_layers=2, num_heads=4),
                          MSE, _features(input=(8, 16)), _regress(8, 1)),
}

# the full-width graphs: the builders' defaults, AlexNet at its
# example's 64 px
FULL = {name: {} for name in TINY}
FULL["build_alexnet"] = dict(image_size=64)


def _pair(name, kwargs, loss, metrics, lr=0.01):
    jf = J.FFModel(J.FFConfig(batch_size=BATCH, num_devices=1))
    getattr(JM, name)(jf, **kwargs)
    jf.compile(optimizer=J.SGDOptimizer(lr=lr), loss_type=loss,
               metrics=list(metrics), devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=BATCH, device="cpu"))
    getattr(TM, name)(tf, **kwargs)
    tf.compile(optimizer=T.SGDOptimizer(lr=lr), loss_type=loss,
               metrics=list(metrics))
    tf.set_weights(jf.get_weights())
    return jf, tf


def _assert_weights(tf, jf, atol=WEIGHT_TOL):
    want, got = jf.get_weights(), tf.get_weights()
    assert sorted(got) == sorted(want)
    for op, entries in want.items():
        for k, v in entries.items():
            np.testing.assert_allclose(got[op][k], np.asarray(v), rtol=0,
                                       atol=atol, err_msg=f"{op}.{k}")


def _assert_metrics(got, want):
    assert sorted(got) == sorted(k for k in want if not k.startswith("__"))
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(np.asarray(want[k])),
                                   rtol=0, atol=LOSS_TOL, err_msg=k)


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_builder_trains_like_reference(name):
    kwargs, (loss, metrics), inputs, labels = TINY[name]
    jf, tf = _pair(name, kwargs, loss, metrics)
    rng = np.random.RandomState(1)
    feed = inputs(rng)
    got = tf.forward(feed).numpy()
    want = np.asarray(jf.forward(feed))
    assert got.shape == want.shape
    assert _scaled(got, want) <= OUT_TOL
    for _ in range(2):
        feed, y = inputs(rng), labels(rng)
        _assert_metrics(tf.train_step(feed, y), jf.train_step(feed, y))
    _assert_weights(tf, jf)


def _graph(P, M, name, kwargs):
    ff = P.FFModel(P.FFConfig(batch_size=64, num_devices=1)
                   if P is J else P.FFConfig(batch_size=64, device="cpu"))
    getattr(M, name)(ff, **kwargs)
    return [(op.name, op.op_type.value,
             [o.shape.logical_shape for o in op.outputs],
             [o.shape.dtype.value for o in op.outputs],
             [(s.name, s.shape.logical_shape) for s in op.weight_specs])
            for op in ff.layers.topo_order()]


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_graph_matches_reference(name):
    got = _graph(T, TM, name, FULL[name])
    want = _graph(J, JM, name, FULL[name])
    assert got == want
    assert len(got) > 5


def _conversions(graph, t_layout, op_layout, nhwc):
    """{(op name, input index): "to_nhwc" | "to_nchw"} of the layout
    copies an executor makes: a 4-D input of an NHWC op that is stored
    logical, and an NHWC-stored input of a logical op."""
    out = {}
    for op in graph.topo_order():
        want = op_layout.get(op.guid)
        for i, t in enumerate(op.inputs):
            if t.shape.logical_rank != 4:
                continue
            stored = t_layout.get(t.guid)
            if want == nhwc and stored != nhwc:
                out[(op.name, i)] = "to_nhwc"
            elif want is None and stored == nhwc:
                out[(op.name, i)] = "to_nchw"
    return out


def test_tiny_inception_converts_layouts_where_the_reference_does():
    from flexflow_tpu.pcg.layout import NHWC as JNHWC
    from flexflow_tpu_torch.pcg.layout import NHWC

    kwargs = TINY["build_inception_v3"][0]
    jf, tf = _pair("build_inception_v3", kwargs, *SCE)
    got = _conversions(tf.layers, *assign_layouts(tf.layers), NHWC)
    want = _conversions(jf.layers, *jax_layouts(jf.layers), JNHWC)
    assert got == want
    assert sorted(got.values()) == ["to_nchw", "to_nhwc"]
    first = tf.layers.topo_order()[1]
    assert got[(first.name, 0)] == "to_nhwc"
    concats = [op for op in tf.layers.ops
               if op.op_type == T.OperatorType.CONCAT]
    assert len(concats) == 11
    assert all(tf.executor.op_layout[op.guid] == NHWC for op in concats)
    # the run: every join emits a channels_last tensor
    seen = []
    for op in concats:
        fwd = op.forward

        def watched(ins, ws, _fwd=fwd, **kw):
            outs = _fwd(ins, ws, **kw)
            seen.append(outs[0].is_contiguous(
                memory_format=torch.channels_last))
            return outs

        op.forward = watched
    x = np.random.RandomState(2).randn(BATCH, 3, 75, 75).astype(np.float32)
    out = tf.forward({"input": x}).numpy()
    assert seen == [True] * 11
    assert _scaled(out, np.asarray(jf.forward({"input": x}))) <= OUT_TOL


def test_split_between_channels_last_edges_runs_nhwc():
    """conv -> split over channels -> two convs: the Split executes
    NHWC and each part is a compact channels_last tensor; the outputs
    are the reference's."""
    from flexflow_tpu_torch.pcg.layout import NHWC

    def build(P, ff):
        x = ff.create_tensor([2, 3, 8, 8], name="input")
        t = ff.conv2d(x, 6, 3, 3, 1, 1, 1, 1, name="c0")
        a, b = ff.split(t, [2, 4], axis=1, name="split")
        a = ff.conv2d(a, 3, 1, 1, name="ca")
        b = ff.pool2d(b, 2, 2, 2, 2, name="pb")
        b = ff.conv2d(b, 3, 1, 1, name="cb")
        return ff.flat(ff.concat([ff.pool2d(a, 2, 2, 2, 2, name="pa"), b],
                                 axis=1, name="cat"), name="flat")

    jf = J.FFModel(J.FFConfig(batch_size=2, num_devices=1))
    build(J, jf)
    jf.compile(loss_type="mean_squared_error_avg",
               metrics=["mean_squared_error"],
               devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    build(T, tf)
    tf.compile(loss_type="mean_squared_error_avg",
               metrics=["mean_squared_error"])
    tf.set_weights(jf.get_weights())
    ops = {op.name: op for op in tf.layers.ops}
    assert tf.executor.op_layout[ops["split"].guid] == NHWC
    assert tf.executor.op_layout[ops["cat"].guid] == NHWC
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    six = np.random.RandomState(4).randn(2, 6, 8, 8).astype(np.float32)
    cl = torch.from_numpy(six).contiguous(memory_format=torch.channels_last)
    parts = ops["split"].forward([cl], [])
    assert [p.is_contiguous(memory_format=torch.channels_last)
            for p in parts] == [True, True]
    assert _scaled(tf.forward({"input": x}).numpy(),
                   np.asarray(jf.forward({"input": x}))) <= OUT_TOL


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_npz_weights_load_across_packages(tmp_path, direction):
    kwargs, (loss, metrics), inputs, labels = TINY["build_dlrm"]
    jf, tf = _pair("build_dlrm", kwargs, loss, metrics)
    rng = np.random.RandomState(4)
    feed, y = inputs(rng), labels(rng)
    # move the port's weights off the reference's before the round trip
    tf.train_step(feed, y)
    path = str(tmp_path / "w.npz")
    if direction == "jax_to_torch":
        JC.save_weights_npz(jf, path)
        TC.load_weights_npz(tf, path)
    else:
        TC.save_weights_npz(tf, path)
        JC.load_weights_npz(jf, path)
    with np.load(path) as data:
        assert "embedding_0/weight" in data.files
        assert all(k.count("/") == 1 for k in data.files)
    src, dst = (jf, tf) if direction == "jax_to_torch" else (tf, jf)
    want = src.get_weights()
    got = dst.get_weights()
    for op, entries in want.items():
        for k, v in entries.items():
            np.testing.assert_array_equal(np.asarray(got[op][k]),
                                          np.asarray(v))


def test_npz_load_checks_names(tmp_path):
    kwargs, (loss, metrics), _, _ = TINY["build_xdl"]
    _, tf = _pair("build_xdl", kwargs, loss, metrics)
    path = str(tmp_path / "w.npz")
    np.savez(path, **{"nosuch/weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="nosuch"):
        TC.load_weights_npz(tf, path)


def test_get_parameter_is_a_copy_of_the_weight():
    kwargs, (loss, metrics), inputs, labels = TINY["build_candle_uno"]
    jf, tf = _pair("build_candle_uno", kwargs, loss, metrics)
    got = tf.get_parameter("tower_1_0", "kernel")
    np.testing.assert_array_equal(got, jf.get_parameter("tower_1_0",
                                                        "kernel"))
    rng = np.random.RandomState(5)
    tf.train_step(inputs(rng), labels(rng))
    assert not np.array_equal(got, tf.get_parameter("tower_1_0", "kernel"))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_set_learning_rate_mid_training_matches_reference(opt):
    kwargs, (loss, metrics), inputs, labels = TINY["build_mlp_unify"]
    make = {"sgd": lambda P: P.SGDOptimizer(lr=0.05, momentum=0.9),
            "adam": lambda P: P.AdamOptimizer(alpha=0.01)}[opt]
    jf = J.FFModel(J.FFConfig(batch_size=BATCH, num_devices=1))
    JM.build_mlp_unify(jf, **kwargs)
    jf.compile(optimizer=make(J), loss_type=loss, metrics=list(metrics),
               devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=BATCH, device="cpu"))
    TM.build_mlp_unify(tf, **kwargs)
    tf.compile(optimizer=make(T), loss_type=loss, metrics=list(metrics))
    tf.set_weights(jf.get_weights())
    rng = np.random.RandomState(6)
    for step in range(4):
        if step == 2:
            for ff in (jf, tf):
                ff.set_learning_rate(0.2 if opt == "sgd" else 0.05)
            assert tf.optimizer.get_lr() == jf.optimizer.get_lr()
        feed, y = inputs(rng), labels(rng)
        _assert_metrics(tf.train_step(feed, y), jf.train_step(feed, y))
    _assert_weights(tf, jf, atol=1e-4 if opt == "adam" else WEIGHT_TOL)


def test_manual_step_surface_is_the_references():
    kwargs, (loss, metrics), _, _ = TINY["build_mlp_unify"]
    _, tf = _pair("build_mlp_unify", kwargs, loss, metrics)
    assert tf.init_operators() is None
    assert tf.zero_gradients() is None
    assert tf.update() is None
    with pytest.raises(RuntimeError, match="train_step"):
        tf.backward()
    opt = T.AdamOptimizer(alpha=0.1)
    assert opt.get_lr() == 0.1 and opt.next_step({"t": 1}) == {"t": 1}
    opt.set_lr(0.5)
    assert opt.alpha == 0.5
