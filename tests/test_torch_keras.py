"""The port's Keras frontend (flexflow_tpu_torch.keras) against
flexflow_tpu.keras on the CPU: tests/test_keras_frontend.py's models
and checks, mirrored.

Each model is built through both packages' layer classes (explicit
layer names, so the weights cross by name), compiled, given the
reference's weights (convert.from_jax_weights), then held to the
reference: predict's output, every epoch's metrics over fit, and every
weight after it.  Dropout is compared at rate 0 (the port's draws are
not jax's threefry).  Also: the callbacks (learning-rate schedule,
early stopping, VerifyMetrics), the dataset loaders (the synthetic
arrays and flags, the CIFAR-10 tarball parse of the vendored shard) and
the preprocessing helpers give the reference's results.

Tolerances, float32: predict within 1e-5 of the output's scale
max(1, max|ref|); epoch metric sums within rtol 1e-5 (losses summed
over the epoch's batches); weights after fit within 2e-5 under SGD and
1e-4 under Adam (whose update divides by sqrt(v) + eps and so carries
the gradients' relative rounding into the step at full size)."""
import os
import random
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu.keras as JK  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
import flexflow_tpu_torch.keras as TK  # noqa: E402

OUT_TOL, METRIC_RTOL = 1e-5, 1e-5
WEIGHT_TOL = {"sgd": 2e-5, "adam": 1e-4}
SHARD = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                     "cifar10_sample.tar.gz")


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _pair(build, batch, optimizer="sgd", **compile_kw):
    """build(K, config) -> an uncompiled keras model, in both packages;
    both compiled, the port given the reference's weights."""
    jm = build(JK, J.FFConfig(batch_size=batch, num_devices=1))
    jm.compile(optimizer=optimizer, devices=jax.devices("cpu")[:1],
               **compile_kw)
    tm = build(TK, T.FFConfig(batch_size=batch, device="cpu"))
    tm.compile(optimizer=optimizer, **compile_kw)
    assert [op.name for op in tm.ffmodel.layers.topo_order()] == \
        [op.name for op in jm.ffmodel.layers.topo_order()]
    tm.ffmodel.set_weights(jm.ffmodel.get_weights())
    return jm, tm


def _fit_like_reference(jm, tm, x, y, epochs, optimizer="sgd"):
    jh = jm.fit(x, y, epochs=epochs, verbose=False)
    th = tm.fit(x, y, epochs=epochs, verbose=False)
    assert len(th) == len(jh) == epochs
    for a, b in zip(th, jh):
        assert a.train_all == b.train_all
        for f in ("cce_loss", "sparse_cce_loss", "mse_loss", "mae_loss"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=METRIC_RTOL, atol=1e-6,
                                       err_msg=f)
        assert abs(a.train_correct - b.train_correct) == 0
    want, got = jm.ffmodel.get_weights(), tm.ffmodel.get_weights()
    for op, entries in want.items():
        for k, v in entries.items():
            np.testing.assert_allclose(got[op][k], np.asarray(v), rtol=0,
                                       atol=WEIGHT_TOL[optimizer],
                                       err_msg=f"{op}.{k}")
    return th


def _mlp(K, cfg, dropout=None):
    layers = [K.Dense(32, activation="relu", name="d0")]
    if dropout is not None:
        layers.append(K.Dropout(dropout, name="drop"))
    layers.append(K.Dense(4, name="d1"))
    return K.Sequential(layers, input_shape=(16,), config=cfg)


@pytest.mark.parametrize("dropout", [None, 0.0])
def test_sequential_mlp_trains_like_reference(dropout):
    jm, tm = _pair(lambda K, c: _mlp(K, c, dropout), 16,
                   loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
    rng = np.random.RandomState(0)
    x = rng.randn(128, 16).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    assert _scaled(tm.predict(x[:16]), jm.predict(x[:16])) <= OUT_TOL
    hist = _fit_like_reference(jm, tm, x, y, epochs=5)
    assert hist[-1].accuracy > hist[0].accuracy
    assert tm.predict(x[:16]).shape == (16, 4)


def _cnn(K, cfg):
    return K.Sequential([
        K.Conv2D(8, 3, activation="relu", name="c0"),
        K.Conv2D(8, (3, 3), padding="same", activation="relu", name="c1"),
        K.MaxPooling2D(2, name="p0"),
        K.Flatten(name="f"),
        K.Dense(10, activation="softmax", name="head"),
    ], input_shape=(3, 16, 16), config=cfg)


def test_sequential_cnn_with_adam_like_reference():
    jm, tm = _pair(_cnn, 8, optimizer="adam",
                   loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
    rng = np.random.RandomState(0)
    x = rng.randn(32, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 10, 32).astype(np.int32)
    assert tm.predict(x[:8]).shape == (8, 10)
    assert _scaled(tm.predict(x[:8]), jm.predict(x[:8])) <= OUT_TOL
    _fit_like_reference(jm, tm, x, y, epochs=2, optimizer="adam")


def _branches(K, cfg):
    a = K.Input((8,), name="a")
    b = K.Input((8,), name="b")
    ha = K.Dense(16, activation="relu", name="ha")(a)
    hb = K.Dense(16, activation="relu", name="hb")(b)
    merged = K.Concatenate(name="cat0")([ha, hb])
    res = K.Add(name="add")([ha, hb])
    out = K.Dense(4, name="out")(K.Concatenate(name="cat1")([merged, res]))
    return K.Model(inputs=[a, b], outputs=out, config=cfg)


def test_functional_multi_branch_like_reference():
    jm, tm = _pair(_branches, 16)
    rng = np.random.RandomState(1)
    xa = rng.randn(64, 8).astype(np.float32)
    xb = rng.randn(64, 8).astype(np.float32)
    y = ((xa.sum(1) + xb.sum(1)) > 0).astype(np.int32)
    feed = {"a": xa, "b": xb}
    assert _scaled(tm.predict({k: v[:16] for k, v in feed.items()}),
                   jm.predict({k: v[:16] for k, v in feed.items()})) \
        <= OUT_TOL
    _fit_like_reference(jm, tm, feed, y, epochs=3)
    assert "Dense" in tm.summary() and tm.summary() == jm.summary()


def _elementwise(K, cfg):
    inp = K.Input(shape=(32,), name="x")
    a = K.Dense(64, activation="relu", name="a")(inp)
    b = K.Dense(64, activation="tanh", name="b")(inp)
    merged = K.Concatenate(axis=1, name="cat")([
        K.Add(name="add")([a, b]), K.Subtract(name="sub")([a, b]),
        K.Multiply(name="mul")([a, b])])
    t = K.Dense(32, activation="relu", name="t")(merged)
    return K.Model(inp, K.Dense(1, name="out")(t), config=cfg)


def test_elementwise_regression_like_reference():
    """examples/python/keras/elementwise.py's model: MSE under Adam."""
    jm, tm = _pair(_elementwise, 32, optimizer="adam",
                   loss="mean_squared_error", metrics=["mean_squared_error"])
    rng = np.random.RandomState(0)
    x = rng.randn(128, 32).astype(np.float32)
    y = (np.sin(x[:, :1]) + x[:, 1:2] * x[:, 2:3]).astype(np.float32)
    _fit_like_reference(jm, tm, x, y, epochs=2, optimizer="adam")


def _norms(K, cfg):
    inp = K.Input((4, 8, 8), name="img")
    t = K.Conv2D(6, 3, padding="same", use_bias=False, name="c")(inp)
    t = K.BatchNormalization(relu=True, name="bn")(t)
    t = K.AveragePooling2D((2, 2), name="ap")(t)
    t = K.Permute((2, 3, 1), name="perm")(t)           # (4, 4, 6)
    t = K.Reshape((16, 6), name="resh")(t)
    t = K.LayerNormalization(name="ln")(t)
    t = K.Activation("gelu", name="act")(t)
    t = K.Flatten(name="flat")(t)
    t = K.Dense(5, name="dense")(t)
    return K.Model(inp, K.Activation("softmax", name="sm")(t), config=cfg)


def test_norm_pool_and_shape_layers_like_reference():
    jm, tm = _pair(_norms, 8, loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
    rng = np.random.RandomState(2)
    x = rng.randn(32, 4, 8, 8).astype(np.float32)
    y = rng.randint(0, 5, 32).astype(np.int32)
    _fit_like_reference(jm, tm, x, y, epochs=2)
    # BatchNorm's running statistics follow the reference's
    want = jm.ffmodel._state["bn"]
    got = tm.ffmodel.get_state()["bn"]
    for k in ("running_mean", "running_var"):
        assert _scaled(got[k], want[k]) <= 1e-5


def _lstm_classifier(K, cfg, words, maxlen, embed, hidden, classes):
    return K.Sequential([
        K.Embedding(words, embed, input_length=maxlen, name="emb"),
        K.LSTM(hidden, return_sequences=False, name="lstm"),
        K.Dense(classes, activation="softmax", name="head"),
    ], config=cfg)


def test_keras_lstm_reuters_style_like_reference():
    """Embedding -> LSTM -> Dense over the reuters loader (its synthetic
    path at num_words 200, maxlen 16)."""
    (x, y), _ = TK.datasets.reuters.load_data(num_words=200, maxlen=16,
                                              num_samples=64)
    assert TK.datasets.reuters.synthetic is True

    def build(K, cfg):
        return _lstm_classifier(K, cfg, 200, 16, 16, 16, 46)

    jm, tm = _pair(build, 16, loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
    assert tm.ffmodel.layers.source_ops()[0].outputs[0].dtype.value == \
        "int32"
    x, y = x.astype("int32"), y.astype("int32")
    assert _scaled(tm.predict(x[:16]), jm.predict(x[:16])) <= OUT_TOL
    _fit_like_reference(jm, tm, x, y, epochs=2)


def test_keras_lstm_return_sequences_shape():
    m = TK.Sequential([TK.Embedding(50, 8, input_length=6, name="e"),
                       TK.LSTM(5, return_sequences=True, name="l"),
                       TK.Flatten(name="f"), TK.Dense(3, name="d")],
                      config=T.FFConfig(batch_size=4, device="cpu"))
    m.compile()
    ids = np.random.RandomState(0).randint(0, 50, (4, 6)).astype(np.int32)
    assert m.predict(ids).shape == (4, 3)
    with pytest.raises(ValueError, match="seq, features"):
        TK.LSTM(4)(TK.Input((6,)))


def test_lr_scheduler_and_early_stopping():
    m = TK.Sequential([TK.Dense(8, activation="relu"), TK.Dense(2)],
                      input_shape=(4,),
                      config=T.FFConfig(batch_size=8, device="cpu"))
    m.compile()
    lrs = []

    def sched(epoch, lr):
        lrs.append(lr)
        return lr * 0.5

    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    m.fit(x, y, epochs=3, verbose=False,
          callbacks=[TK.LearningRateScheduler(sched)])
    assert lrs == [0.01, 0.005, 0.0025]
    assert m.ffmodel.optimizer.get_lr() == 0.00125
    es = TK.EarlyStopping(monitor="accuracy", patience=1)
    hist = m.fit(x, y, epochs=50, verbose=False, callbacks=[es])
    assert len(hist) < 50 and es.stopped_epoch == len(hist) - 1
    assert es.model is m


def test_verify_metrics_and_progbar():
    import io

    rng = np.random.RandomState(0)
    x = rng.randn(256, 16).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    model = TK.Sequential([TK.Dense(8, activation="relu"),
                           TK.Dense(2, activation="softmax")],
                          input_shape=(16,),
                          config=T.FFConfig(device="cpu"))
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], batch_size=32)
    with pytest.raises(AssertionError, match="accuracy"):
        model.fit(x, y, epochs=1, verbose=False,
                  callbacks=[TK.VerifyMetrics(floor=1.01)])
    log = io.StringIO()
    model.fit(x, y, epochs=3, verbose=False,
              callbacks=[TK.VerifyMetrics(floor=0.4, each_epoch=True),
                         TK.ProgbarLogger(stream=log)])
    assert log.getvalue().startswith("epoch 0: accuracy=")


def test_evaluate_and_the_refusals():
    m = _mlp(TK, T.FFConfig(batch_size=8, device="cpu"))
    with pytest.raises(RuntimeError, match="compile"):
        m.predict(np.zeros((8, 16), np.float32))
    # devices are ranks of a torch.distributed group: none here
    with pytest.raises(ValueError, match="no torch.distributed group"):
        m.compile(devices=[0, 1])
    with pytest.raises(ValueError, match="ranks of the torch.distributed"):
        m.compile(devices=["cuda:0"])
    m.compile(metrics=["accuracy", "sparse_categorical_crossentropy"])
    rng = np.random.RandomState(3)
    x = rng.randn(20, 16).astype(np.float32)
    y = rng.randint(0, 4, 20).astype(np.int32)
    out = m.evaluate(x, y)
    assert len(out) == 2 and all("loss" in r for r in out)
    with pytest.raises(ValueError, match="input_shape"):
        TK.Sequential([TK.Dense(2)]).compile()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = TK.Sequential([TK.Dense(2)], input_shape=(3,))
    with pytest.raises(RuntimeError, match="cuda"):
        m.compile()


@pytest.mark.parametrize("name,kw", [
    ("cifar10", dict(num_samples=64)),
    ("mnist", dict(num_samples=32)),
    ("reuters", dict(num_words=1000, maxlen=50, num_samples=16)),
])
def test_synthetic_datasets_are_the_references(tmp_path, monkeypatch, name,
                                               kw):
    import flexflow_tpu.keras.datasets as jds
    import flexflow_tpu_torch.keras.datasets as tds

    for ds in (jds, tds):
        monkeypatch.setattr(ds, "_CACHE", str(tmp_path))
    (xt, yt), (xe, ye) = getattr(tds, name).load_data(**kw)
    (wxt, wyt), (wxe, wye) = getattr(jds, name).load_data(**kw)
    for got, want in ((xt, wxt), (yt, wyt), (xe, wxe), (ye, wye)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert getattr(tds, name).synthetic is True


def test_cifar10_canonical_tar_parse(tmp_path, monkeypatch):
    import flexflow_tpu_torch.keras.datasets as ds

    cache = tmp_path / "keras_cache"
    cache.mkdir()
    shutil.copy(SHARD, cache / "cifar-10-python.tar.gz")
    monkeypatch.setattr(ds, "_CACHE", str(cache))
    (xtr, ytr), (xte, yte) = ds.cifar10.load_data()
    assert ds.cifar10.synthetic is False
    assert xtr.shape == (64, 3, 32, 32) and xtr.dtype == np.uint8
    assert ytr.shape == (64, 1) and set(np.unique(ytr)) <= set(range(10))
    assert xte.shape == (16, 3, 32, 32) and yte.shape == (16, 1)
    assert xtr.any() and not np.array_equal(xtr[:16], xte)
    import flexflow_tpu.keras.datasets as jds

    monkeypatch.setattr(jds, "_CACHE", str(cache))
    (wxtr, wytr), _ = jds.cifar10.load_data()
    np.testing.assert_array_equal(xtr, wxtr)
    np.testing.assert_array_equal(ytr, wytr)


def test_preprocessing_gives_the_references_results():
    from flexflow_tpu.keras import preprocessing as JP
    from flexflow_tpu_torch.keras import preprocessing as TP

    seqs = [[1, 2, 3], [4], []]
    for kw in ({"maxlen": 2}, {"maxlen": 2, "padding": "post",
                               "truncating": "post"}, {"value": 9}):
        np.testing.assert_array_equal(TP.pad_sequences(seqs, **kw),
                                      JP.pad_sequences(seqs, **kw))
    with pytest.raises(ValueError):
        TP.pad_sequences(seqs, padding="sideways")
    texts = ["the cat sat on the mat", "the dog sat", "cat and dog!"]
    toks = []
    for P in (TP, JP):
        tok = P.Tokenizer(num_words=5, oov_token="<oov>")
        tok.fit_on_texts(texts)
        toks.append(tok)
    assert toks[0].word_index == toks[1].word_index
    assert toks[0].texts_to_sequences(texts + ["zz cat"]) == \
        toks[1].texts_to_sequences(texts + ["zz cat"])
    for mode in ("binary", "count", "freq", "tfidf"):
        np.testing.assert_allclose(toks[0].texts_to_matrix(texts, mode=mode),
                                   toks[1].texts_to_matrix(texts, mode=mode))
    assert TP.text_to_word_sequence("A b, c!") == \
        JP.text_to_word_sequence("A b, c!")
    assert TP.one_hot("a b a", 7) == JP.one_hot("a b a", 7)
    # negatives draw from the global `random` state, as in the reference
    results = []
    for P in (TP, JP):
        random.seed(0)
        results.append(P.skipgrams([1, 2, 3], 10, window_size=1,
                                   negative_samples=1.0, seed=0))
    assert results[0] == results[1]
    np.testing.assert_array_equal(TP.make_sampling_table(20),
                                  JP.make_sampling_table(20))
