"""The torch.fx importer of the port on transformers written in plain
PyTorch, against flexflow_tpu's importer on the CPU.

- chip_smoke.py's SmallViT (32 px, patch 8, hidden 64, 2 layers, 4
  heads, HF's eager attention idiom, dropout 0) through both importers
  with copy_weights: the weights as copied, the logits in eval and
  training mode, then the losses and every weight after 2 SGD steps, in
  float32 and in bfloat16 against the float32 reference.
- The full ViT-B/16 graph (built, not compiled): the reference's op
  names, types and shapes, and the op counts chip_smoke.py asserts.
- A conv -> flatten(2) -> transpose graph: the conv runs in
  channels_last and the Reshape gets logical NCHW.
- The idioms of the reference frontend's own tests
  (tests/test_torch_frontend.py: view/permute, the shape nodes, F.linear
  and F.conv2d with pinned weights, the MHA tuple unpack with a
  scalar-first division, a frozen buffer) through both importers.
- The stock HF BertEncoder (2 layers, hidden 128) through the port
  against torch's own forward.

Tolerances.  float32 through both importers: 1e-5 on logits and losses
and 2e-5 on weights after 2 steps (XLA's and ATen's GEMMs sum in other
orders).  bfloat16: each op rounds its output to 8 significant bits,
at other places in the two frameworks, so logits and losses get 2e-2,
and after 2 steps each port weight may lie at most twice as far from
the float32 reference as the reference's own bfloat16 run, plus 2^-8.
Against torch itself the port, like the reference, computes GELU in its
tanh form (jax.nn.gelu's default) where nn.GELU is exact: 1e-3 relative
and 5e-4 absolute, the reference's own HF alignment tolerance.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn as nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.torch_frontend.model import \
    PyTorchModel as JaxPyTorchModel  # noqa: E402
from flexflow_tpu_torch.pcg.layout import NHWC, assign_layouts  # noqa: E402
from flexflow_tpu_torch.torch_frontend import PyTorchModel  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ViT, SmallViT = chip_smoke.vit_modules()
MODEL_TOL = {"float32": {"out": 1e-5, "loss": 1e-5, "weights": 2e-5},
             "bfloat16": {"out": 2e-2, "loss": 2e-2}}
BF16_NOISE_FACTOR, BF16_NOISE_FLOOR = 2.0, 2.0 ** -8
TORCH_RTOL, TORCH_ATOL = 1e-3, 5e-4


def _pair(module, shapes, compute_dtype="float32",
          loss="SPARSE_CATEGORICAL_CROSSENTROPY", train=True):
    """module through both importers, compiled (SGD lr 0.1) and with
    copy_weights: (reference FFModel, port FFModel)."""
    batch = shapes[0][0]
    models = []
    for P, Importer in ((J, JaxPyTorchModel), (T, PyTorchModel)):
        kw = {"num_devices": 1} if P is J else {"device": "cpu"}
        ff = P.FFModel(P.FFConfig(batch_size=batch,
                                  compute_dtype=compute_dtype, **kw))
        ts = [ff.create_tensor(list(s), name=f"x{i}")
              for i, s in enumerate(shapes)]
        pt = Importer(module)
        pt.torch_to_ff(ff, ts)
        ck = {"devices": jax.devices("cpu")[:1]} if P is J else {}
        ff.compile(optimizer=P.SGDOptimizer(lr=0.1, weight_decay=0.1),
                   loss_type=getattr(P.LossType, loss),
                   comp_mode=(P.CompMode.TRAINING if train
                              else P.CompMode.INFERENCE), **ck)
        pt.copy_weights(ff)
        models.append(ff)
    return models


def _state(ff):
    return {op: {k: np.asarray(v) for k, v in e.items()}
            for op, e in (ff._state or {}).items()}


def _assert_trees(got, want, tol, what):
    assert sorted(got) == sorted(want)
    for op, entries in want.items():
        assert sorted(got[op]) == sorted(entries), op
        for k, v in entries.items():
            err = float(np.abs(got[op][k] - np.asarray(v)).max())
            assert err <= tol, f"{what} {op}.{k}: {err} > {tol}"


def _two_steps(ff, x, y):
    return [float(ff.train_step({"x0": x[s:s + 4]}, y[s:s + 4])["loss"])
            for s in (4, 8)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_small_vit_matches_reference(compute_dtype):
    tol = MODEL_TOL[compute_dtype]
    torch.manual_seed(0)
    module = SmallViT()
    jf, tf = _pair(module, [(4, 3, 32, 32)], compute_dtype)
    _assert_trees(tf.get_weights(), jf.get_weights(), 0.0, "weights")
    rng = np.random.RandomState(1)
    x = rng.randn(12, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 12).astype(np.int32)
    want = np.asarray(jf.forward({"x0": x[:4]}))
    assert np.abs(tf.forward({"x0": x[:4]}).numpy() - want).max() \
        <= tol["out"]
    with torch.no_grad():  # training mode: every Dropout at rate 0
        tout, _ = tf.executor.run_forward(
            tf._weights, tf._state, {"x0": torch.from_numpy(x[:4])},
            training=True, generator=tf._generator)
    assert np.abs(tout.numpy() - want).max() <= tol["out"]
    lj, lt = _two_steps(jf, x, y), _two_steps(tf, x, y)
    assert np.abs(np.subtract(lt, lj)).max() <= tol["loss"]
    if compute_dtype == "float32":
        _assert_trees(tf.get_weights(), jf.get_weights(), tol["weights"],
                      "weights")
        return
    j32, _ = _pair(module, [(4, 3, 32, 32)])
    _two_steps(j32, x, y)
    ref16, ref32 = jf.get_weights(), j32.get_weights()
    got = tf.get_weights()
    for op, entries in ref32.items():
        for k, v in entries.items():
            err = float(np.abs(got[op][k] - v).max())
            noise = float(np.abs(ref16[op][k] - v).max())
            assert err <= BF16_NOISE_FACTOR * noise + BF16_NOISE_FLOOR, \
                f"{op}.{k}"


def test_small_vit_matches_torch():
    torch.manual_seed(3)
    module = SmallViT().eval()
    _, tf = _pair(module, [(4, 3, 32, 32)])
    x = np.random.RandomState(3).randn(4, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        want = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tf.forward({"x0": x}).numpy(), want,
                               rtol=TORCH_RTOL, atol=TORCH_ATOL)


def test_vit_b16_graph_matches_reference_and_counts():
    """Full width (hidden 768, 12 layers, 12 heads, MLP 3072, 224 px,
    1000 classes), built through both importers without compiling: the
    same op names, types and output shapes, and chip_smoke.VIT_OPS."""
    torch.manual_seed(0)
    module = ViT()
    graphs = []
    for P, Importer in ((J, JaxPyTorchModel), (T, PyTorchModel)):
        kw = {"num_devices": 1} if P is J else {"device": "cpu"}
        ff = P.FFModel(P.FFConfig(batch_size=2, **kw))
        x = ff.create_tensor([2, 3, 224, 224], name="input")
        (out,) = Importer(module).torch_to_ff(ff, [x])
        assert out.shape.logical_shape == (2, 1000)
        graphs.append(ff)
    desc = [{op.name: (op.op_type.value,
                       [o.shape.logical_shape for o in op.outputs])
             for op in ff.layers.ops} for ff in graphs]
    assert desc[0] == desc[1]
    assert chip_smoke.op_counts(graphs[1]) == chip_smoke.VIT_OPS
    assert chip_smoke.op_counts(graphs[0]) == chip_smoke.VIT_OPS
    pos = next(op for op in graphs[1].layers.ops
               if op.op_type.value == "weight")
    assert pos.weight_specs[0].shape.logical_shape == (1, 196, 768)
    assert pos.num_trainable_weights() == 1


class _PatchTokens(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 4, 4)

    def forward(self, x):
        return self.conv(x).flatten(2).transpose(1, 2)


def test_conv_flatten_takes_logical_nchw():
    """The conv runs channels_last; flatten(2) is a Reshape, which gets
    the logical NCHW tensor, so the tokens come out in torch's order."""
    torch.manual_seed(4)
    module = _PatchTokens()
    jf, tf = _pair(module, [(2, 3, 16, 16)], train=False)
    t_layout, op_layout = assign_layouts(tf.layers)
    by_type = {op.op_type.value: op for op in tf.layers.ops}
    assert op_layout.get(by_type["conv2d"].guid) == NHWC
    assert by_type["reshape"].guid not in op_layout
    assert by_type["transpose"].guid not in op_layout
    assert by_type["reshape"].outputs[0].shape.logical_shape == (2, 8, 16)
    x = np.random.RandomState(4).randn(2, 3, 16, 16).astype(np.float32)
    got = tf.forward({"x0": x}).numpy()
    np.testing.assert_allclose(got, np.asarray(jf.forward({"x0": x})),
                               rtol=0, atol=1e-5)
    with torch.no_grad():
        want = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- the reference frontend's idioms (tests/test_torch_frontend.py) ----------

class _ViewPermute(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(12, 12)

    def forward(self, x):  # x: [b, 3, 4]
        b = x.size(0)
        h = self.fc(x.reshape(b, 12))
        return h.view(b, 4, 3).permute(0, 2, 1).flatten()


class _ShapeNodes(nn.Module):
    def forward(self, x):  # x: [b, 6, 10]
        a = x[:, 1:5, :]
        c = a.unsqueeze(1).expand(-1, 3, -1, -1)
        e = c.sum(1).unsqueeze(2).squeeze(2)
        p1, p2 = torch.chunk(e, 2, dim=1)
        return (p1 * p2).flatten(1)


class _Functional(nn.Module):
    def __init__(self):
        super().__init__()
        self.w1 = nn.Parameter(torch.randn(20, 12) * 0.1)
        self.b1 = nn.Parameter(torch.zeros(20))
        self.wc = nn.Parameter(torch.randn(8, 4, 3, 3) * 0.1)

    def forward(self, x, img):
        h = F.relu(F.linear(x, self.w1, self.b1))
        c = F.conv2d(img, self.wc, stride=1, padding=1)
        return h.sum(1) + c.mean([1, 2, 3])


class _MHAUnpack(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(16, 2, batch_first=True)

    def forward(self, x):
        out, _ = self.attn(x, x, x)
        return 2.0 / (out * out + 1.0)


class _FrozenBuffer(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8, 8)
        self.register_buffer("scale", torch.full((8,), 3.0))

    def forward(self, x):
        return self.fc(x) * self.scale


IDIOMS = {
    "view_permute": (_ViewPermute, [(8, 3, 4)]),
    "shape_nodes": (_ShapeNodes, [(8, 6, 10)]),
    "functional_linear_conv": (_Functional, [(8, 12), (8, 4, 6, 6)]),
    "mha_tuple_unpack": (_MHAUnpack, [(4, 6, 16)]),
    "frozen_buffer": (_FrozenBuffer, [(4, 8)]),
}


@pytest.mark.parametrize("idiom", sorted(IDIOMS))
def test_reference_frontend_idioms_import_as_the_reference(idiom):
    """Forward against the reference's import and torch; then 3 SGD
    steps (weight decay 0.1) of an MSE on the output: losses and every
    weight and state entry against the reference.  The frozen buffer
    stays in the op state at its value."""
    cls, shapes = IDIOMS[idiom]
    torch.manual_seed(7)
    module = cls()
    jf, tf = _pair(module, shapes, loss="MEAN_SQUARED_ERROR_AVG_REDUCE")
    rng = np.random.RandomState(8)
    feed = {f"x{i}": rng.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}
    want = np.asarray(jf.forward(feed))
    got = tf.forward(feed).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        ref = module(*[torch.from_numpy(v) for v in feed.values()]).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    y = rng.randn(*want.shape).astype(np.float32)
    for _ in range(3):
        lj = float(jf.train_step(feed, y)["loss"])
        lt = float(tf.train_step(feed, y)["loss"])
        assert abs(lj - lt) <= 1e-5
    _assert_trees(tf.get_weights(), jf.get_weights(), 2e-5, "weights")
    _assert_trees(tf.get_state(), _state(jf), 2e-5, "state")
    if idiom == "frozen_buffer":
        (buf,) = [e["value"] for e in tf.get_state().values()]
        assert np.array_equal(buf, np.full(8, 3.0, np.float32))


class _EncoderOnly(nn.Module):
    def __init__(self, enc):
        super().__init__()
        self.enc = enc

    def forward(self, x):
        return self.enc(x).last_hidden_state


def test_hf_bert_encoder_imports_and_matches_torch():
    """The stock HF BertEncoder (eager attention: view, transpose,
    matmul, softmax, GELU, LayerNorm and the shape arithmetic of its
    trace), 2 layers of hidden 128, 8 heads: the port against torch and
    against the reference's import."""
    bert = pytest.importorskip("transformers.models.bert.modeling_bert")
    cfg = bert.BertConfig(hidden_size=128, num_hidden_layers=2,
                          num_attention_heads=8, intermediate_size=512,
                          vocab_size=128, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0,
                          attn_implementation="eager")
    torch.manual_seed(0)
    module = _EncoderOnly(bert.BertEncoder(cfg).eval())
    jf, tf = _pair(module, [(4, 12, 128)], train=False)
    x = np.random.RandomState(0).randn(4, 12, 128).astype(np.float32)
    got = tf.forward({"x0": x}).numpy()
    np.testing.assert_allclose(got, np.asarray(jf.forward({"x0": x})),
                               rtol=0, atol=1e-5)
    with torch.no_grad():
        want = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TORCH_RTOL, atol=TORCH_ATOL)
