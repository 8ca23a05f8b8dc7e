"""The sequence-model slice of the port against flexflow_tpu on the CPU:
the LSTM op, the NMT builder and its greedy decoding.

The LSTM is held op by op: the same seeded inputs and weights through
the reference's lax.scan and the port's loop, for both
return_sequences, and the autograd grads over the input, kernel and
bias against jax.vjp with the same random cotangents.  The NMT
(embeddings, 1-2 LSTM layers a side, the dot-product attention) goes
through both packages with the reference's weights (carried by
convert.from_jax_weights): the forward, the metrics of 2 SGD steps,
every weight after them, and greedy_decode's tokens.

Tolerances, over the output's scale max(1, max|ref|), float32: 1e-5
for the LSTM's outputs and grads (the port hoists the input half of the
gate product into one GEMM, so each gate pre-activation sums its
d + h products in two parts instead of one; ~1e-7 at these widths, and
BPTT over 5-6 steps stays well inside), 1e-5 for the NMT's forward,
losses and metric sums, 2e-5 for weights after 2 steps at lr 0.1.
Greedy tokens must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.models.nmt import build_nmt as jax_build_nmt  # noqa: E402
from flexflow_tpu.models.nmt import \
    greedy_decode as jax_greedy_decode  # noqa: E402
from flexflow_tpu_torch.models import build_nmt, greedy_decode  # noqa: E402
from flexflow_tpu_torch.ops.op import ShapeError  # noqa: E402

TOL, LOSS_TOL, WEIGHT_TOL = 1e-5, 1e-5, 2e-5


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _lstm_pair(b, s, d, h, return_sequences):
    jf = J.FFModel(J.FFConfig(batch_size=b, num_devices=1))
    tf = T.FFModel(T.FFConfig(batch_size=b, device="cpu"))
    outs = []
    for ff in (jf, tf):
        x = ff.create_tensor([b, s, d], name="x")
        outs.append(ff.lstm(x, h, return_sequences=return_sequences,
                            name="lstm"))
    jt, tt = outs
    assert jt.shape.logical_shape == tt.shape.logical_shape
    assert [(w.name, w.shape.logical_shape) for w in jt.owner_op.weight_specs] \
        == [(w.name, w.shape.logical_shape) for w in tt.owner_op.weight_specs]
    assert tt.owner_op.op_type.value == jt.owner_op.op_type.value == "lstm"
    return jt.owner_op, tt.owner_op


@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_forward_and_grads_match_reference(return_sequences):
    b, s, d, h = 3, 6, 5, 8
    jop, top = _lstm_pair(b, s, d, h, return_sequences)
    rng = np.random.RandomState(0)
    x = rng.randn(b, s, d).astype(np.float32)
    kernel = (rng.randn(d + h, 4 * h) * 0.3).astype(np.float32)
    bias = (rng.randn(4 * h) * 0.1).astype(np.float32)

    def jfwd(x, kernel, bias):
        return jop.forward([x], [kernel, bias])[0]

    want, vjp = jax.vjp(jfwd, jnp.asarray(x), jnp.asarray(kernel),
                        jnp.asarray(bias))
    cot = rng.randn(*want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    tx, tk, tb = (torch.tensor(a, requires_grad=True)
                  for a in (x, kernel, bias))
    (got,) = top.forward([tx], [tk, tb])
    assert tuple(got.shape) == tuple(want.shape)
    assert _scaled(got.detach().numpy(), want) <= TOL
    tgrads = torch.autograd.grad(got, [tx, tk, tb], torch.from_numpy(cot))
    for g, w in zip(tgrads, jgrads):
        assert _scaled(g.numpy(), w) <= TOL
    if not return_sequences:
        # the last step of the full sequence
        _, tseq = _lstm_pair(b, s, d, h, True)
        (full,) = tseq.forward([tx], [tk, tb])
        torch.testing.assert_close(full[:, -1], got, rtol=0, atol=0)


def test_lstm_initial_bias_is_the_references():
    """Zeros with the forget block at 1, in both packages; the kernel is
    GlorotUniform over [d + h, 4h] (its draws are the port's own)."""
    weights = []
    for P, extra in ((J, {"num_devices": 1}), (T, {"device": "cpu"})):
        ff = P.FFModel(P.FFConfig(batch_size=2, **extra))
        x = ff.create_tensor([2, 3, 4], name="x")
        ff.dense(ff.lstm(x, 6, return_sequences=False, name="lstm"), 2)
        kw = {"devices": jax.devices("cpu")[:1]} if P is J else {}
        ff.compile(**kw)
        weights.append(ff.get_weights()["lstm"])
    jw, tw = weights
    np.testing.assert_array_equal(tw["bias"], np.asarray(jw["bias"]))
    assert tw["bias"][6:12].tolist() == [1.0] * 6
    assert tw["bias"].sum() == 6.0
    limit = np.sqrt(6.0 / (10 + 24))
    assert tw["kernel"].shape == (10, 24)
    assert np.abs(tw["kernel"]).max() <= limit


def test_lstm_refuses_what_the_reference_refuses():
    for P, extra in ((J, {"num_devices": 1}), (T, {"device": "cpu"})):
        ff = P.FFModel(P.FFConfig(batch_size=2, **extra))
        x = ff.create_tensor([2, 4], name="x")
        with pytest.raises(Exception, match="batch, seq, d"):
            ff.lstm(x, 4)
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    with pytest.raises(ShapeError):
        ff.lstm(ff.create_tensor([2, 4], name="x"), 4)


NMT = dict(batch_size=4, src_len=6, tgt_len=5, src_vocab=17, tgt_vocab=13,
           embed_dim=8, hidden_size=12)


def _nmt_pair(num_layers, attention, lr=0.1):
    kw = dict(NMT, num_layers=num_layers, attention=attention)
    jf = J.FFModel(J.FFConfig(batch_size=4, num_devices=1))
    jax_build_nmt(jf, **kw)
    jf.compile(optimizer=J.SGDOptimizer(lr=lr),
               loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy", "sparse_categorical_crossentropy"],
               devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=4, device="cpu"))
    build_nmt(tf, **kw)
    tf.compile(optimizer=T.SGDOptimizer(lr=lr),
               loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy", "sparse_categorical_crossentropy"])
    tf.set_weights(jf.get_weights())
    return jf, tf


def _nmt_batch(rng):
    src = rng.randint(0, NMT["src_vocab"], (4, NMT["src_len"])).astype(
        np.int32)
    tgt = rng.randint(0, NMT["tgt_vocab"], (4, NMT["tgt_len"])).astype(
        np.int32)
    y = rng.randint(0, NMT["tgt_vocab"], (4, NMT["tgt_len"])).astype(
        np.int32)
    return {"src": src, "tgt": tgt}, y


@pytest.mark.parametrize("num_layers,attention", [(1, False), (2, True)])
def test_nmt_two_sgd_steps_match_reference(num_layers, attention):
    jf, tf = _nmt_pair(num_layers, attention)
    names = [op.name for op in tf.layers.topo_order()]
    assert names == [op.name for op in jf.layers.topo_order()]
    assert ("attn_weights" in names) == attention
    rng = np.random.RandomState(1)
    feed, _ = _nmt_batch(rng)
    got, want = tf.forward(feed).numpy(), np.asarray(jf.forward(feed))
    assert got.shape == want.shape == (4, 5, 13)
    assert _scaled(got, want) <= TOL
    for _ in range(2):
        feed, y = _nmt_batch(rng)
        tm, jm = tf.train_step(feed, y), jf.train_step(feed, y)
        assert sorted(tm) == sorted(k for k in jm if not k.startswith("__"))
        for k in tm:
            assert abs(float(tm[k]) - float(np.asarray(jm[k]))) <= LOSS_TOL, k
    want_w, got_w = jf.get_weights(), tf.get_weights()
    for op, entries in want_w.items():
        for k, v in entries.items():
            np.testing.assert_allclose(got_w[op][k], np.asarray(v), rtol=0,
                                       atol=WEIGHT_TOL, err_msg=f"{op}.{k}")


def test_greedy_decode_tokens_equal_the_references():
    jf, tf = _nmt_pair(1, True)
    rng = np.random.RandomState(2)
    for _ in range(3):  # move the weights off their init first
        feed, y = _nmt_batch(rng)
        jf.train_step(feed, y)
        tf.train_step(feed, y)
    src = rng.randint(0, NMT["src_vocab"], (4, NMT["src_len"])).astype(
        np.int32)
    got = greedy_decode(tf, src, bos_id=1)
    want = jax_greedy_decode(jf, src, bos_id=1)
    assert got.dtype == np.int32 and got.shape == (4, 5)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 1).all()


def test_nmt_at_luong_widths_builds_the_references_graph():
    """The chip phase's configuration (4 LSTM layers a side, 1000 cells,
    1000-dim embeddings, 50 000-word vocabularies, 50 tokens, batch
    128), built but not compiled: the reference's names and shapes, and
    ~216 M parameters."""
    kw = dict(batch_size=128, src_len=50, tgt_len=50, src_vocab=50000,
              tgt_vocab=50000, embed_dim=1000, hidden_size=1000,
              num_layers=4)
    graphs = []
    for P, extra, build in ((J, {"num_devices": 1}, jax_build_nmt),
                            (T, {"device": "cpu"}, build_nmt)):
        ff = P.FFModel(P.FFConfig(batch_size=128, **extra))
        build(ff, **kw)
        graphs.append([(op.name, op.op_type.value,
                        [o.shape.logical_shape for o in op.outputs],
                        [(s.name, s.shape.logical_shape)
                         for s in op.weight_specs])
                       for op in ff.layers.topo_order()])
    assert graphs[0] == graphs[1]
    n = sum(int(np.prod(shape)) for _, _, _, specs in graphs[1]
            for _, shape in specs)
    assert 215e6 < n < 217e6
    assert graphs[1][-1][2] == [(128, 50, 50000)]
