"""The port's prefetching SingleDataLoader against flexflow_tpu's on the
CPU.

The same compiled two-input model (float features and int ids through
an embedding) in both packages; both loaders over the same numpy data
give the same batches, value for value and in the same dtypes, over two
epochs, unshuffled and shuffled, at prefetch 1, 2 and 3, with dict
inputs and the host-side narrowing (float64 -> float32, int64 ->
int32).  reset() mid-epoch cancels the worker and starts the next
epoch's order, as the reference's does; a worker's exception surfaces
at next_batch; two epochs of fit(shuffle=True) give the reference's
metrics and weights.  A stress test runs many tiny batches through
prefetch 1 with the interpreter switching threads every microsecond.

Tolerances: the batches only move and narrow values, so they agree
exactly.  fit's metrics and weights, float32 on the CPU, agree to 1e-5
(the same formulas in other summation orders)."""
import sys
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.dataloader import \
    SingleDataLoader as JaxLoader  # noqa: E402
from flexflow_tpu_torch.dataloader import SingleDataLoader  # noqa: E402

ATOL = 1e-5
B = 4


def _build(P, ff):
    x = ff.create_tensor([B, 3], name="x")
    ids = ff.create_tensor([B, 2], dtype="int32", name="ids")
    e = ff.embedding(ids, 10, 5, aggr=P.AggrMode.SUM, name="emb")
    t = ff.concat([ff.dense(x, 5, name="proj"), e], axis=-1, name="cat")
    return ff.softmax(ff.dense(t, 3, name="head"), name="softmax")


def _pair():
    jf = J.FFModel(J.FFConfig(batch_size=B, num_devices=1))
    _build(J, jf)
    jf.compile(optimizer=J.SGDOptimizer(lr=0.1), metrics=["accuracy"],
               devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=B, device="cpu"))
    _build(T, tf)
    tf.compile(optimizer=T.SGDOptimizer(lr=0.1), metrics=["accuracy"])
    tf.set_weights(jf.get_weights())
    return jf, tf


def _data(n, seed=0, wide=True):
    """float64 features and int64 ids and labels when `wide` (the
    loaders narrow them), else float32 and int32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3)
    ids = rng.randint(0, 10, (n, 2))
    y = rng.randint(0, 3, n)
    if not wide:
        x, ids, y = (x.astype(np.float32), ids.astype(np.int32),
                     y.astype(np.int32))
    return {"x": x, "ids": ids}, y


def _same_batch(got, want):
    (gx, gy), (wx, wy) = got, want
    assert sorted(gx) == sorted(wx)
    for k in wx:
        w = np.asarray(wx[k])
        assert str(gx[k].dtype).removeprefix("torch.") == w.dtype.name, k
        np.testing.assert_array_equal(gx[k].numpy(), w, err_msg=k)
    w = np.asarray(wy)
    assert str(gy.dtype).removeprefix("torch.") == w.dtype.name
    np.testing.assert_array_equal(gy.numpy(), w)


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_batches_match_reference_over_two_epochs(prefetch, shuffle, wide):
    jf, tf = _pair()
    x, y = _data(4 * B + 2, seed=prefetch, wide=wide)
    mine = SingleDataLoader(tf, x, y, batch_size=B, shuffle=shuffle,
                            seed=3, prefetch=prefetch)
    ref = JaxLoader(jf, x, y, batch_size=B, shuffle=shuffle, seed=3,
                    prefetch=prefetch)
    assert (mine.num_samples, mine.num_batches, len(mine)) == \
        (ref.num_samples, ref.num_batches, len(ref)) == (4 * B + 2, 4, 4)
    assert mine._dtype == {"x": torch.float32, "ids": torch.int32,
                           None: torch.int32}
    for _ in range(2):
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _same_batch(g, w)
    # each batch is a tensor of its own, not a view of a reused buffer
    assert len({id(b[0]["x"]) for b in got}) == 4
    mine._thread.join(timeout=10)  # it ends after its last batch
    assert not mine._thread.is_alive()


def test_single_input_array_and_next_batch():
    jf, tf = _pair()
    x, y = _data(3 * B)
    feed = {"x": x["x"], "ids": x["ids"]}
    mine = SingleDataLoader(tf, feed, y, batch_size=B, prefetch=2)
    ref = JaxLoader(jf, feed, y, batch_size=B, prefetch=2)
    for _ in range(3):
        _same_batch(mine.next_batch(), ref.next_batch())
    with pytest.raises(StopIteration):
        mine.next_batch()


@pytest.mark.parametrize("wide", [True, False])
def test_index_cuts_each_batch_to_a_shard(wide):
    """With an index per tensor (what fit passes on a torch.distributed
    group: each rank's shard of a global batch in its feed layout), each
    batch is the reference's batch cut by that index: rows only, or rows
    and a later dim, with the same dtypes."""
    jf, tf = _pair()
    x, y = _data(3 * B, seed=5, wide=wide)
    index = {"x": (slice(2, 4), slice(1, 3)), "ids": (slice(0, 2),),
             None: (slice(2, 4),)}
    mine = SingleDataLoader(tf, x, y, batch_size=B, shuffle=True, seed=2,
                            index=index)
    ref = JaxLoader(jf, x, y, batch_size=B, shuffle=True, seed=2)
    for (gx, gy), (wx, wy) in zip(list(mine), list(ref)):
        _same_batch((gx, gy), ({k: np.asarray(v)[index[k]]
                                for k, v in wx.items()},
                               np.asarray(wy)[index[None]]))


def test_reset_mid_epoch_cancels_the_worker():
    """One batch into a shuffled epoch, reset() joins the worker and
    starts the next epoch's order; nothing stale is handed out."""
    jf, tf = _pair()
    x, y = _data(6 * B, seed=4)
    mine = SingleDataLoader(tf, x, y, batch_size=B, shuffle=True, seed=1,
                            prefetch=1)
    ref = JaxLoader(jf, x, y, batch_size=B, shuffle=True, seed=1,
                    prefetch=1)
    _same_batch(mine.next_batch(), ref.next_batch())
    old = mine._thread
    mine.reset()
    ref.reset()
    assert not old.is_alive()
    assert mine._thread is not old and mine._thread.is_alive()
    for g, w in zip(list(mine), list(ref)):
        _same_batch(g, w)
    mine.reset()
    mine._stop_worker()
    assert mine._thread is None
    assert not any(t is old for t in threading.enumerate())


def test_worker_exception_surfaces_at_next_batch(monkeypatch):
    real = SingleDataLoader._gather
    calls = []

    def failing(self, idx, out):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("gather failed on batch 1")
        return real(self, idx, out)

    monkeypatch.setattr(SingleDataLoader, "_gather", failing)
    _, tf = _pair()
    x, y = _data(3 * B)
    loader = SingleDataLoader(tf, x, y, batch_size=B)
    loader.next_batch()
    with pytest.raises(RuntimeError, match="gather failed on batch 1"):
        loader.next_batch()
    loader._thread.join(timeout=10)
    assert not loader._thread.is_alive()


def test_fit_shuffled_matches_reference():
    """Two shuffled epochs through fit: each epoch's metrics and the
    weights after."""
    jf, tf = _pair()
    x, y = _data(5 * B, seed=2)
    got = tf.fit(x, y, epochs=2, shuffle=True, verbose=False)
    want = jf.fit(x, y, epochs=2, shuffle=True, verbose=False)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.train_all, g.train_correct) == (w.train_all,
                                                  w.train_correct)
        np.testing.assert_allclose(g.sparse_cce_loss, w.sparse_cce_loss,
                                   rtol=0, atol=ATOL)
    want_w, got_w = jf.get_weights(), tf.get_weights()
    for op, entries in want_w.items():
        for k, v in entries.items():
            np.testing.assert_allclose(got_w[op][k], np.asarray(v), rtol=0,
                                       atol=ATOL, err_msg=f"{op}.{k}")


def test_fit_stops_its_worker_when_a_step_raises(monkeypatch):
    _, tf = _pair()
    x, y = _data(8 * B)
    made = []
    real_init = SingleDataLoader.__init__

    def recording(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(SingleDataLoader, "__init__", recording)
    monkeypatch.setattr(tf, "train_step", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        tf.fit(x, y, epochs=1, verbose=False)
    assert made and made[0]._thread is None


def test_stress_many_small_batches_keep_their_order():
    """400 one-row batches through prefetch 1 with a thread switch
    every microsecond: every row arrives once, in the shuffled order."""
    _, tf = _pair()
    n = 400
    x = {"x": np.arange(3 * n, dtype=np.float32).reshape(n, 3),
         "ids": np.zeros((n, 2), np.int32)}
    y = np.arange(n, dtype=np.int32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = SingleDataLoader(tf, x, y, batch_size=1, shuffle=True,
                                  seed=7, prefetch=1)
        labels = [int(lab[0]) for _, lab in loader]
        rows = [loader._order[i] for i in range(n)]
    finally:
        sys.setswitchinterval(old)
    assert labels == rows
    assert sorted(labels) == list(range(n))
    loader._thread.join(timeout=10)
    assert not loader._thread.is_alive()
