"""The port's ONNX frontend (flexflow_tpu_torch.onnx_frontend) against
flexflow_tpu.onnx_frontend on the CPU.

protowire: the port's encoder writes the reference encoder's bytes for
the same graph (a narrow ResNet-18 in torch's export node sequence,
through onnx_frontend.module_to_onnx, and the reference test's MLP), and each
decoder reads the other's.  ONNXModel: the narrow ResNet-18 (widths
8-64, 32 px, 10 classes, running statistics moved off their init)
imported by both packages, copy_weights in each; the eval-mode forward
against the reference and against the torch module, then 2 SGD steps
against the reference (losses, weights, running statistics).  Also the
MLP of tests/test_onnx_frontend.py against numpy, the handler-coverage
graph (Pad, Cast, Unsqueeze, Squeeze, Shape, Range, Constant), and the
BatchNorm apply plan (P1) of the ONNX-imported ResNet-18 and ResNet-50:
the same fused chains as the torch.fx import.

Batch 8: at 32 px ResNet-18's last stage is 1x1, so its training-mode
BatchNorms normalize over the batch alone; over 4 samples a channel's
variance can sit near eps, and one SGD step then carries the packages'
~1e-7 rounding differences into the weights at ~5e-5 in both
directions alike (measured); over 8 the steps agree to ~1e-6.

Tolerances, float32: forwards within 1e-5 of the output's scale
max(1, max|ref|) against the reference (oneDNN's and XLA's convolutions
sum in other orders, ~1e-7 relative), 1e-4 against the torch module in
eval mode (torch folds BatchNorm in another order); losses and metric
sums (over the batch) 1e-5 of max(1, |ref|); weights and running
statistics 2e-5 after 2 steps at lr 0.01."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as nn  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.onnx_frontend import ONNXModel as JONNX  # noqa: E402
from flexflow_tpu.onnx_frontend import protowire as jpw  # noqa: E402
from flexflow_tpu_torch.onnx_frontend import (  # noqa: E402
    ONNXModel, module_to_onnx)
from flexflow_tpu_torch.onnx_frontend import protowire as pw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

OUT_TOL, TORCH_TOL, LOSS_TOL, WEIGHT_TOL = 1e-5, 1e-4, 1e-5, 2e-5
B, PX, CLASSES = 8, 32, 10


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(nn.Conv2d(cin, cout, 1, stride,
                                                bias=False),
                                      nn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.down is None else self.down(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + idt)


class NarrowResNet18(nn.Module):
    """ResNet-18's stem, 4 stages of 2 BasicBlocks and head, at widths
    8, 16, 32, 64."""

    def __init__(self, classes=CLASSES, w=8):
        super().__init__()
        self.conv1 = nn.Conv2d(3, w, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(w)
        self.relu = nn.ReLU()
        self.pool = nn.MaxPool2d(3, 2, 1)
        blocks, cin = [], w
        for cout, s in ((w, 1), (2 * w, 2), (4 * w, 2), (8 * w, 2)):
            blocks += [BasicBlock(cin, cout, s), BasicBlock(cout, cout, 1)]
            cin = cout
        self.blocks = nn.Sequential(*blocks)
        self.avg = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(cin, classes)

    def forward(self, x):
        x = self.pool(self.relu(self.bn1(self.conv1(x))))
        x = self.blocks(x)
        return self.fc(torch.flatten(self.avg(x), 1))


@pytest.fixture(scope="module")
def resnet():
    torch.manual_seed(0)
    m = NarrowResNet18()
    with torch.no_grad():  # running statistics off their init
        m.train()
        for _ in range(2):
            m(torch.randn(4, 3, PX, PX))
    return m.eval()


def test_protowire_bytes_equal_the_reference_encoders(resnet):
    shape = (B, 3, PX, PX)
    got = module_to_onnx(resnet, shape)
    assert got == module_to_onnx(resnet, shape, pw=jpw)
    mine, ref = pw.load_model(got), jpw.load_model(got)
    ops = [n.op_type for n in mine.graph.node]
    assert ops == [n.op_type for n in ref.graph.node]
    assert ops[:4] == ["Conv", "BatchNormalization", "Relu", "MaxPool"]
    assert ops[-3:] == ["GlobalAveragePool", "Flatten", "Gemm"]
    assert ops.count("Conv") == 20 and ops.count("Add") == 8
    for a, b in zip(mine.graph.initializer, ref.graph.initializer):
        assert a.name == b.name
        np.testing.assert_array_equal(a.array, b.array)
    # the MLP of tests/test_onnx_frontend.py through both encoders
    rng = np.random.RandomState(0)
    inits = {"w1": rng.randn(16, 8).astype(np.float32),
             "b1": rng.randn(16).astype(np.float32),
             "w2": rng.randn(4, 16).astype(np.float32)}
    wires = []
    for P in (pw, jpw):
        nodes = [P.encode_node("Gemm", ["x", "w1", "b1"], ["h"], name="fc1",
                               transB=1),
                 P.encode_node("Relu", ["h"], ["hr"], name="relu1"),
                 P.encode_node("Gemm", ["hr", "w2"], ["y"], name="fc2",
                               transB=1, alpha=0.5),
                 P.encode_node("Softmax", ["y"], ["p"], name="sm", axis=-1)]
        wires.append(P.encode_model(nodes, ["x"], ["p"], inits))
    assert wires[0] == wires[1]


def test_wire_tensor_edge_cases():
    t = pw._vi(1, 3) + pw._vi(2, 6)  # dims=[3], INT32 in int32_data
    for v in (-2, 0, 7):
        t += pw._vi(5, v)
    t += pw._ld(8, b"neg")
    np.testing.assert_array_equal(pw._parse_tensor(t).array,
                                  jpw._parse_tensor(t).array)
    bits = np.asarray([1.5, -0.25], np.float16).view(np.uint16)
    t2 = pw._vi(1, 2) + pw._vi(2, 10)
    for b in bits:
        t2 += pw._vi(5, int(b))
    np.testing.assert_array_equal(pw._parse_tensor(t2).array,
                                  np.asarray([1.5, -0.25], np.float16))
    t3 = pw._vi(2, 1) + pw._ld(9, np.float32(3.5).tobytes())
    parsed = pw._parse_tensor(t3)
    assert parsed.array.shape == () and float(parsed.array) == 3.5


def _import(P, onnx_cls, wire, lr=0.01):
    if P is J:
        ff = J.FFModel(J.FFConfig(batch_size=B, num_devices=1))
    else:
        ff = T.FFModel(T.FFConfig(batch_size=B, device="cpu"))
    x = ff.create_tensor([B, 3, PX, PX], name="input")
    m = onnx_cls(wire)
    (out,) = m.apply(ff, [x])
    kw = {"devices": jax.devices("cpu")[:1]} if P is J else {}
    ff.compile(optimizer=P.SGDOptimizer(lr=lr),
               loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy", "sparse_categorical_crossentropy"], **kw)
    m.copy_weights(ff)
    return ff


def _jax_state(jf):
    return {op: {k: np.asarray(v) for k, v in e.items()}
            for op, e in jf._state.items()}


def test_resnet18_imported_by_both_packages(resnet):
    wire = module_to_onnx(resnet, (B, 3, PX, PX))
    jf, tf = _import(J, JONNX, wire), _import(T, ONNXModel, wire)
    want_w, got_w = jf.get_weights(), tf.get_weights()
    assert sorted(got_w) == sorted(want_w)
    for op, e in want_w.items():
        for k, v in e.items():
            np.testing.assert_array_equal(got_w[op][k], np.asarray(v))
    want_s, got_s = _jax_state(jf), tf.get_state()
    for op, e in want_s.items():
        for k, v in e.items():
            np.testing.assert_array_equal(got_s[op][k], v)
    bn = resnet.blocks[3].bn2
    name = next(op for op in got_s if "blocks_3_bn2" in op)
    np.testing.assert_array_equal(got_s[name]["running_var"],
                                  bn.running_var.numpy())
    rng = np.random.RandomState(0)
    x = rng.randn(B, 3, PX, PX).astype(np.float32)
    got = tf.forward({"input": x}).numpy()
    assert _scaled(got, np.asarray(jf.forward({"input": x}))) <= OUT_TOL
    with torch.no_grad():
        want = resnet(torch.from_numpy(x)).numpy()
    assert _scaled(got, want) <= TORCH_TOL
    for _ in range(2):
        x = rng.randn(B, 3, PX, PX).astype(np.float32)
        y = rng.randint(0, CLASSES, B).astype(np.int32)
        tm, jm = tf.train_step({"input": x}, y), jf.train_step({"input": x}, y)
        for k in tm:
            assert _scaled(float(tm[k]), jm[k]) <= LOSS_TOL, k
    want_w, got_w = jf.get_weights(), tf.get_weights()
    for op, e in want_w.items():
        for k, v in e.items():
            np.testing.assert_allclose(got_w[op][k], np.asarray(v), rtol=0,
                                       atol=WEIGHT_TOL, err_msg=f"{op}.{k}")
    want_s, got_s = _jax_state(jf), tf.get_state()
    for op, e in want_s.items():
        for k, v in e.items():
            np.testing.assert_allclose(got_s[op][k], v, rtol=0,
                                       atol=WEIGHT_TOL, err_msg=f"{op}.{k}")


def _plan_counts(ff):
    from flexflow_tpu_torch.executor import plan_bn_applies
    from flexflow_tpu_torch.pcg.layout import assign_layouts

    t_layout, _ = assign_layouts(ff.layers)
    counts = {"res_relu": 0, "relu": 0, "none": 0}
    for plan in plan_bn_applies(ff.layers, t_layout).values():
        kind = ("res_relu" if plan.residual is not None
                else "relu" if plan.relu else "none")
        counts[kind] += 1
    return counts


def test_bn_apply_plan_of_onnx_resnets(resnet):
    """Every BatchNorm of the ONNX import runs through P1, fused as in
    the fx import: ResNet-18's 8 second-conv BatchNorms with their
    block's residual and ReLU, 9 with the ReLU, 3 downsamples alone;
    ResNet-50's chip_smoke.RESNET_BN."""
    ff = T.FFModel(T.FFConfig(batch_size=B, device="cpu"))
    ONNXModel(module_to_onnx(resnet, (B, 3, PX, PX))).apply(
        ff, [ff.create_tensor([B, 3, PX, PX], name="input")])
    assert _plan_counts(ff) == {"res_relu": 8, "relu": 9, "none": 3}
    _, ResNet50, _ = chip_smoke.resnet_modules()
    wire = module_to_onnx(ResNet50(), (2, 3, 224, 224))
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    (out,) = ONNXModel(wire).apply(
        ff, [ff.create_tensor([2, 3, 224, 224], name="input")])
    assert out.shape.logical_shape == (2, 1000)
    assert _plan_counts(ff) == chip_smoke.RESNET_BN
    assert sum(op.op_type.value == "conv2d" for op in ff.layers.ops) == 53


def test_onnx_mlp_forward_matches_numpy_and_trains():
    rng = np.random.RandomState(0)
    w1 = rng.randn(16, 8).astype(np.float32)
    b1 = rng.randn(16).astype(np.float32)
    w2 = rng.randn(4, 16).astype(np.float32)
    nodes = [pw.encode_node("Gemm", ["x", "w1", "b1"], ["h"], name="fc1",
                            transB=1),
             pw.encode_node("Relu", ["h"], ["hr"], name="relu1"),
             pw.encode_node("Gemm", ["hr", "w2"], ["y"], name="fc2",
                            transB=1),
             pw.encode_node("Softmax", ["y"], ["p"], name="sm", axis=-1)]
    data = pw.encode_model(nodes, ["x"], ["p"],
                           {"w1": w1, "b1": b1, "w2": w2})
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu"))
    om = ONNXModel(data)
    om.apply(ff, [ff.create_tensor([8, 8], name="x")])
    ff.compile(optimizer=T.SGDOptimizer(lr=0.01),
               loss_type="sparse_categorical_crossentropy")
    om.copy_weights(ff)
    x = rng.randn(8, 8).astype(np.float32)
    logits = np.maximum(x @ w1.T + b1, 0) @ w2.T
    want = np.exp(logits - logits.max(-1, keepdims=True))
    want /= want.sum(-1, keepdims=True)
    assert _scaled(ff.forward({"x": x}).numpy(), want) <= OUT_TOL
    y = rng.randint(0, 4, 8).astype(np.int32)
    l0 = float(ff.train_step({"x": x}, y)["loss"])
    for _ in range(20):
        l1 = float(ff.train_step({"x": x}, y)["loss"])
    assert l1 < l0


def test_handler_coverage_ops_like_reference():
    nodes = [
        pw.encode_node("Constant", [], ["pads"],
                       value=np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int64)),
        pw.encode_node("Pad", ["input", "pads"], ["p"], mode="constant"),
        pw.encode_node("Cast", ["p"], ["c"], to=1),
        pw.encode_node("Unsqueeze", ["c"], ["u"], axes=[4]),
        pw.encode_node("Squeeze", ["u"], ["s"], axes=[4]),
        pw.encode_node("Shape", ["s"], ["shp"]),
        pw.encode_node("Range", ["zero", "four", "one"], ["r"]),
    ]
    inits = {"zero": np.array(0, np.int64), "four": np.array(4, np.int64),
             "one": np.array(1, np.int64)}
    wire = pw.encode_model(nodes, [("input", [2, 3, 4, 4])],
                           ["s", "shp", "r"], inits)
    outs = []
    for P, cls, extra in ((T, ONNXModel, {"device": "cpu"}),
                          (J, JONNX, {"num_devices": 1})):
        ff = P.FFModel(P.FFConfig(batch_size=2, **extra))
        x = ff.create_tensor([2, 3, 4, 4], name="input")
        outs.append(cls(wire).apply(ff, [x]))
    (s, shp, r), (js, jshp, jr) = outs
    assert tuple(s.shape.logical_shape) == (2, 3, 6, 6) == \
        tuple(js.shape.logical_shape)
    np.testing.assert_array_equal(shp, jshp)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(r, [0, 1, 2, 3])
    bad = pw.encode_model([pw.encode_node("Celu", ["input"], ["o"])],
                          ["input"], ["o"], {})
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    with pytest.raises(ValueError, match="unsupported ONNX op: Celu"):
        ONNXModel(bad).apply(ff, [ff.create_tensor([2, 3], name="input")])


def test_onnx_model_reads_a_path(tmp_path, resnet):
    path = tmp_path / "resnet.onnx"
    path.write_bytes(module_to_onnx(resnet, (B, 3, PX, PX)))
    ff = T.FFModel(T.FFConfig(batch_size=B, device="cpu"))
    from flexflow_tpu_torch.onnx_frontend import onnx_to_flexflow

    m, (out,) = onnx_to_flexflow(
        str(path), ff, [ff.create_tensor([B, 3, PX, PX], name="input")])
    assert out.shape.logical_shape == (B, CLASSES)
    assert len(m.initializers) == 20 + 4 * 20 + 2
