"""The port's training slice against flexflow_tpu's: a small build_bert
(2 layers, hidden 64, 4 heads, FFN 128, batch 4, seq 16) in both
packages with the JAX weights copied in, trained step by step with SGD
(plain, momentum, nesterov, weight decay) and Adam on the flash branch
(flash_min_seq=0) and the dense branch (the default); eval_step; one
shuffled epoch of fit; and the pieces alone: Mean, the five losses,
Metrics.compute, PerfMetrics, the shuffle order and the config flags.

Tolerances, float32 on the CPU: the two packages run the same formulas
in other summation orders (XLA's fused kernels against PyTorch's), so
losses, metric sums and weights agree to 1e-5 absolute on values of
order 1 and below, after every step.  Adam's weights get 1e-4, 5% of
its step size alpha = 0.002: Adam divides each gradient element by the
root of its own square, so its first step moves a weight by about
alpha whatever the gradient's size, and for an element whose gradient
is small the last bits of float32 rounding move that step (seen: 2.7e-5
after step 1, unchanged by steps 2 and 3)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.dataloader import \
    shuffle_indices as jax_shuffle  # noqa: E402
from flexflow_tpu.loss import compute_loss as jax_loss  # noqa: E402
from flexflow_tpu.models.transformer import \
    build_bert as jax_bert  # noqa: E402
from flexflow_tpu_torch.dataloader import (  # noqa: E402
    _py_shuffle, shuffle_indices)
from flexflow_tpu_torch.loss import compute_loss  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_bert  # noqa: E402

ATOL = 1e-5
ADAM_WEIGHT_ATOL = 1e-4
BERT = dict(batch_size=4, seq_length=16, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128, num_classes=2)
METRICS = ("accuracy", "sparse_categorical_crossentropy")

OPTIMIZERS = {
    "sgd": lambda P: P.SGDOptimizer(lr=0.05),
    "sgd_momentum": lambda P: P.SGDOptimizer(lr=0.05, momentum=0.9),
    "sgd_nesterov": lambda P: P.SGDOptimizer(lr=0.05, momentum=0.9,
                                             nesterov=True),
    "sgd_weight_decay": lambda P: P.SGDOptimizer(lr=0.05, momentum=0.9,
                                                 weight_decay=0.01),
    "adam": lambda P: P.AdamOptimizer(alpha=0.002, weight_decay=0.01),
}


def _pair(opt="sgd", flash_min_seq=2048, dropout=0.0):
    """The same BERT in both packages, the port holding the JAX weights."""
    jf = J.FFModel(J.FFConfig(batch_size=4, num_devices=1,
                              flash_min_seq=flash_min_seq))
    jax_bert(jf, dropout=dropout, **BERT)
    jf.compile(optimizer=OPTIMIZERS[opt](J), metrics=METRICS,
               devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=4, device="cpu",
                              flash_min_seq=flash_min_seq))
    build_bert(tf, dropout=dropout, **BERT)
    tf.compile(optimizer=OPTIMIZERS[opt](T), metrics=METRICS)
    tf.set_weights(jf.get_weights())
    return jf, tf


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 16, 64).astype(np.float32)
    y = rng.randint(0, 2, (n, 1)).astype(np.int32)
    return x, y


def _assert_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(np.asarray(want[k])),
                                   rtol=0, atol=ATOL, err_msg=k)


def _assert_weights(tf, jf, atol=ATOL):
    want = jf.get_weights()
    got = tf.get_weights()
    for op, entries in want.items():
        for k, v in entries.items():
            np.testing.assert_allclose(got[op][k], np.asarray(v), rtol=0,
                                       atol=atol, err_msg=f"{op}.{k}")


def test_bert_weights_round_trip_exactly():
    jf, tf = _pair()
    want, got = jf.get_weights(), tf.get_weights()
    assert sorted(got) == sorted(want)
    assert {"attn_1", "ffn1_1", "ffn_ln_1", "classifier"} <= set(got)
    for op, entries in want.items():
        assert sorted(got[op]) == sorted(entries)
        for k, v in entries.items():
            np.testing.assert_array_equal(got[op][k], np.asarray(v))


@pytest.mark.parametrize("branch", ["flash", "dense"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_steps_match_reference(opt, branch):
    """Three steps: losses, metrics and every weight after each step."""
    jf, tf = _pair(opt, flash_min_seq=0 if branch == "flash" else 2048)
    attn = [op for op in tf.operators.ops
            if op.op_type == T.OperatorType.MULTIHEAD_ATTENTION]
    assert {op._flash_min_seq for op in attn} == \
        {0 if branch == "flash" else 2048}
    x, y = _data(12)
    for i in range(3):
        feed = {"input": x[4 * i:4 * i + 4]}
        lab = y[4 * i:4 * i + 4]
        _assert_metrics(tf.train_step(feed, lab), jf.train_step(feed, lab))
        _assert_weights(tf, jf, ADAM_WEIGHT_ATOL if opt == "adam" else ATOL)


def test_flash_branch_runs_the_flash_function(monkeypatch):
    """flash_min_seq=0 sends every layer through mha_flash (forward and
    backward), the default sends none."""
    from flexflow_tpu_torch.ops import attention

    calls = []
    real = attention.mha_flash
    monkeypatch.setattr(attention, "mha_flash",
                        lambda *a: calls.append(1) or real(*a))
    x, y = _data(4)
    for fms, want in ((0, BERT["num_layers"]), (2048, 0)):
        calls.clear()
        tf = T.FFModel(T.FFConfig(batch_size=4, device="cpu",
                                  flash_min_seq=fms))
        build_bert(tf, **BERT)
        tf.compile()
        tf.train_step({"input": x}, y)
        assert len(calls) == want


def test_eval_step_and_fit_match_reference():
    """eval_step's metrics and loss, then one shuffled epoch of fit: the
    same batch order, the same PerfMetrics, the same weights."""
    jf, tf = _pair("sgd_momentum")
    x, y = _data(12, seed=1)
    feed = {"input": x[:4]}
    _assert_metrics(tf.eval_step(feed, y[:4]), jf.eval_step(feed, y[:4]))
    got = tf.fit(x, y, epochs=1, shuffle=True, verbose=False)
    want = jf.fit(x, y, epochs=1, shuffle=True, verbose=False)
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert (g.train_all, g.train_correct) == (w.train_all, w.train_correct)
    assert g.train_all == 12
    np.testing.assert_allclose(g.sparse_cce_loss, w.sparse_cce_loss,
                               rtol=0, atol=ATOL)
    _assert_weights(tf, jf)
    _assert_metrics(tf.eval_step(feed, y[:4]), jf.eval_step(feed, y[:4]))


def test_fit_callbacks_and_stop():
    class Stop:
        def __init__(self):
            self.seen = []

        def on_train_begin(self, model):
            self.seen.append("begin")

        def on_epoch_end(self, model, epoch, pm):
            self.seen.append(epoch)
            model._stop_training = True

        def on_train_end(self, model):
            self.seen.append("end")

    tf = T.FFModel(T.FFConfig(batch_size=4, device="cpu", epochs=3))
    build_bert(tf, **BERT)
    tf.compile()
    cb = Stop()
    x, y = _data(8)
    hist = tf.fit(x, y, callbacks=[cb], verbose=False)
    assert cb.seen == ["begin", 0, "end"] and len(hist) == 1
    assert hist[0].train_all == 8


def test_attention_dropout_draws_from_the_generator():
    """The dense branch's dropout: the same generator seed gives the
    same step, training differs from the dropout-free forward, and
    eval_step (training=False) draws nothing."""
    x, y = _data(4)
    losses = []
    for _ in range(2):
        tf = T.FFModel(T.FFConfig(batch_size=4, device="cpu", seed=3))
        build_bert(tf, dropout=0.5, **BERT)
        tf.compile(seed=0)
        before = tf._generator.get_state()
        ev = tf.eval_step({"input": x}, y)
        assert torch.equal(tf._generator.get_state(), before)
        losses.append((float(tf.train_step({"input": x}, y)["loss"]),
                       float(ev["loss"])))
    assert losses[0] == losses[1]
    assert losses[0][0] != losses[0][1]


def test_mean_op_matches_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 7).astype(np.float32)
    for axes, keep in (([1], False), ([0, 2], True), ([-1], False)):
        outs = []
        for P, ff in ((J, J.FFModel(J.FFConfig(batch_size=3,
                                               num_devices=1))),
                      (T, T.FFModel(T.FFConfig(batch_size=3,
                                               device="cpu")))):
            t = ff.create_tensor([3, 5, 7], name="x")
            op = ff.mean(t, axes=axes, keepdims=keep, name="m").owner_op
            arr = (jax.numpy.asarray(x) if P is J else torch.from_numpy(x))
            outs.append((op.outputs[0].shape.logical_shape,
                         np.asarray(op.forward([arr], [])[0])))
        assert outs[0][0] == outs[1][0]
        np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=0,
                                   atol=ATOL)


def _loss_case(loss, rng):
    logits = rng.randn(6, 5).astype(np.float32)
    if loss == "sparse_categorical_crossentropy":
        return logits, rng.randint(0, 5, (6, 1)).astype(np.int32)
    if loss == "categorical_crossentropy":
        return logits, np.eye(5, dtype=np.float32)[rng.randint(0, 5, 6)]
    return logits, rng.randn(6, 5).astype(np.float32)


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("loss", [t.value for t in T.LossType])
def test_losses_match_reference(loss, from_logits):
    rng = np.random.RandomState(5)
    logits, labels = _loss_case(loss, rng)
    if not from_logits:
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    got = compute_loss(T.LossType(loss), torch.from_numpy(logits),
                       torch.from_numpy(labels), from_logits)
    want = jax_loss(J.LossType(loss), jax.numpy.asarray(logits),
                    jax.numpy.asarray(labels), from_logits)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("one_hot", [False, True])
def test_metrics_compute_and_perf_metrics_match_reference(one_hot):
    rng = np.random.RandomState(6)
    probs = rng.dirichlet(np.ones(4), 8).astype(np.float32)
    ids = rng.randint(0, 4, 8).astype(np.int32)
    labels = (np.eye(4, dtype=np.float32)[ids] if one_hot
              else ids[:, None])
    # each cross-entropy metric with its own label form
    skip = (T.MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY if one_hot
            else T.MetricsType.CATEGORICAL_CROSSENTROPY)
    names = [m.value for m in T.MetricsType if m != skip]
    got = T.Metrics(T.LossType.IDENTITY, names).compute(
        torch.from_numpy(probs), torch.from_numpy(labels))
    want = J.Metrics(J.LossType.IDENTITY, names).compute(
        jax.numpy.asarray(probs), jax.numpy.asarray(labels))
    _assert_metrics(got, want)
    tp, jp = T.PerfMetrics(), J.PerfMetrics()
    for _ in range(3):
        tp.accumulate(got)
        jp.accumulate(want)
    tp.finalize(), jp.finalize()
    for f in J.PerfMetrics._FIELDS:
        np.testing.assert_allclose(getattr(tp, f), getattr(jp, f), rtol=0,
                                   atol=ATOL, err_msg=f)
    assert tp.summary().split()[0] == jp.summary().split()[0]


@pytest.mark.parametrize("n,seed", [(12, 0), (12, 2), (97, 5)])
def test_shuffle_order_matches_reference(n, seed):
    np.testing.assert_array_equal(shuffle_indices(n, seed),
                                  jax_shuffle(n, seed))
    np.testing.assert_array_equal(_py_shuffle(n, seed),
                                  jax_shuffle(n, seed))


def test_train_step_needs_a_training_compile():
    tf = T.FFModel(T.FFConfig(batch_size=4, device="cpu"))
    build_bert(tf, **BERT)
    tf.compile(comp_mode=T.CompMode.INFERENCE)
    assert not any(w.requires_grad for e in tf._weights.values()
                   for w in e.values())
    x, y = _data(4)
    with pytest.raises(RuntimeError, match="TRAINING"):
        tf.train_step({"input": x}, y)
    assert tf.forward({"input": x}).shape == (4, 2)
