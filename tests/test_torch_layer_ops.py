"""The layer-op slice of the port against flexflow_tpu on the CPU:
BatchMatmul, Cast, Dropout, the shape ops (Reshape, Expand, Transpose,
Reverse, Pad, Concat, Split, Gather), WeightOp and NoOp.

Each op is built through both packages' layer calls (same output
shapes, types and weight specs), then run on the same seeded numpy
inputs: every output against the reference op's forward, and the
autograd grads over the float inputs and weights against jax.vjp with
the same random cotangents.  Dropout cannot be compared draw for draw
(the port's generator is not jax's threefry), so it is held by its
rules: the identity at rate 0 and in eval, one mask per generator
seed, a keep fraction within 5 sigma of 1 - rate, and a grad of exactly
mask / (1 - rate).

Tolerances, over the output's scale max(1, max|ref|): float32 1e-5 for
forwards and grads.  The shape ops, Cast and WeightOp only move or
round values, so they agree exactly; BatchMatmul sums at most 16
products per output in another order than XLA (~1e-7).  bfloat16
LayerNorm, Softmax and Cast are held against the float64 result: no
farther from it than twice the reference's bfloat16 op, plus one
bfloat16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu_torch.ops.sources import NoOp, SourceParams  # noqa: E402

TOL = 1e-5
BF16_ULP = 2.0 ** -8


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _models(batch=2):
    return (J.FFModel(J.FFConfig(batch_size=batch, num_devices=1)),
            T.FFModel(T.FFConfig(batch_size=batch, device="cpu")))


def _pair(build, shapes, dtypes=None):
    """build(P, ff, input tensors) in both packages -> (jax op, port op),
    after checking that their types, output shapes and dtypes and weight
    specs agree."""
    dtypes = dtypes or ["float32"] * len(shapes)
    ops = []
    for P, ff in zip((J, T), _models(shapes[0][0])):
        ts = [ff.create_tensor(list(s), dtype=d, name=f"x{i}")
              for i, (s, d) in enumerate(zip(shapes, dtypes))]
        out = build(P, ff, ts)
        ops.append((out[0] if isinstance(out, tuple) else out).owner_op)
    jop, top = ops
    assert jop.op_type.value == top.op_type.value
    assert [(o.shape.logical_shape, o.shape.dtype.value)
            for o in jop.outputs] == \
        [(o.shape.logical_shape, o.shape.dtype.value) for o in top.outputs]
    assert [(s.name, s.shape.logical_shape) for s in jop.weight_specs] == \
        [(s.name, s.shape.logical_shape) for s in top.weight_specs]
    return jop, top


def _check(jop, top, inputs, weights=(), tol=TOL):
    """Every output, and the grads over the float inputs and the weights
    (jax.vjp against autograd, one random cotangent per output)."""
    floats = [i for i, x in enumerate(inputs)
              if np.issubdtype(x.dtype, np.floating)]

    def jfwd(fx, ws):
        xs = [jnp.asarray(x) for x in inputs]
        for i, v in zip(floats, fx):
            xs[i] = v
        return jop.forward(xs, list(ws), training=False)

    jouts, vjp = jax.vjp(jfwd, [jnp.asarray(inputs[i]) for i in floats],
                         [jnp.asarray(w) for w in weights])
    rng = np.random.RandomState(7)
    gs = [rng.randn(*o.shape).astype(np.float32) for o in jouts]
    jdx, jdw = vjp([jnp.asarray(g) for g in gs])
    txs = [torch.tensor(x).requires_grad_(i in floats)
           for i, x in enumerate(inputs)]
    tws = [torch.tensor(w).requires_grad_() for w in weights]
    touts = top.forward(txs, tws, training=False)
    assert len(touts) == len(jouts)
    for got, want in zip(touts, jouts):
        assert tuple(got.shape) == tuple(want.shape)
        assert _scaled(got.detach().numpy(), want) <= tol
    wrt = [txs[i] for i in floats] + tws
    grads = torch.autograd.grad(touts, wrt, [torch.from_numpy(g) for g in gs],
                                allow_unused=True)
    for got, want in zip(grads, list(jdx) + list(jdw)):
        got = np.zeros(want.shape) if got is None else got.numpy()
        assert _scaled(got, want) <= tol


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape,target,want", [
    ((2, 3, 4), (2, -1), (2, 12)),
    ((2, 3, 4), (-1, 4), (6, 4)),
    ((2, 12), (2, 3, -1), (2, 3, 4)),
    ((2, 3, 4, 5), (2, 3, 2, -1), (2, 3, 2, 10)),
])
def test_reshape_matches_reference(shape, target, want):
    jop, top = _pair(lambda P, ff, ts: ff.reshape(ts[0], target, name="r"),
                     [shape])
    assert top.outputs[0].shape.logical_shape == want
    _check(jop, top, [_randn(len(target), *shape)])


def test_reshape_copies_after_a_transpose():
    """permute then view: the permuted tensor's strides forbid a view,
    and Reshape copies (torch.reshape)."""
    x = torch.arange(24.0).reshape(2, 3, 4).permute(0, 2, 1)
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    t = ff.create_tensor([2, 4, 3], name="x")
    op = ff.reshape(t, [2, 12]).owner_op
    (y,) = op.forward([x], [])
    assert torch.equal(y, x.contiguous().view(2, 12))


@pytest.mark.parametrize("shape,perm", [
    ((2, 3, 4), (0, 2, 1)), ((2, 3, 4), (2, 0, 1)),
    ((2, 3, 4, 5), (0, 2, 1, 3)), ((2, 3, 4, 5), (3, 1, 0, 2)),
])
def test_transpose_matches_reference(shape, perm):
    jop, top = _pair(lambda P, ff, ts: ff.transpose(ts[0], perm, name="t"),
                     [shape])
    _check(jop, top, [_randn(sum(perm), *shape)])


@pytest.mark.parametrize("shape,sizes", [
    ((2, 1, 4), (2, 3, 4)), ((2, 1, 4, 1), (-1, 5, -1, 3)),
])
def test_expand_matches_reference(shape, sizes):
    """The grad sums over the broadcast dims."""
    jop, top = _pair(lambda P, ff, ts: ff.expand(ts[0], sizes, name="e"),
                     [shape])
    _check(jop, top, [_randn(3, *shape)])


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_concat_matches_reference(axis):
    shapes = [[2, 3, 4], [2, 3, 4], [2, 3, 4]]
    for s, n in zip(shapes, (1, 2, 3)):
        s[axis] = n if axis % 3 else 2
    jop, top = _pair(lambda P, ff, ts: ff.concat(ts, axis, name="c"), shapes)
    _check(jop, top, [_randn(i, *s) for i, s in enumerate(shapes)])


@pytest.mark.parametrize("axis,sizes", [(0, [1, 3]), (1, [2, 1, 3]),
                                        (1, 3), (-1, [4, 1])])
def test_split_matches_reference(axis, sizes):
    """Every part forward and, through a cotangent each, the grad."""
    jop, top = _pair(lambda P, ff, ts: ff.split(ts[0], sizes, axis,
                                                name="s"), [(4, 6, 5)])
    assert len(top.outputs) == (sizes if isinstance(sizes, int)
                                else len(sizes))
    _check(jop, top, [_randn(axis + 5, 4, 6, 5)])


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_reverse_matches_reference(axis):
    jop, top = _pair(lambda P, ff, ts: ff.reverse(ts[0], axis, name="rv"),
                     [(2, 3, 4)])
    _check(jop, top, [_randn(axis + 9, 2, 3, 4)])


@pytest.mark.parametrize("pads,value", [
    (((0, 0), (1, 2), (3, 0)), 0.0), (((1, 1), (0, 0), (2, 2)), -1.5)])
def test_pad_matches_reference(pads, value):
    jop, top = _pair(lambda P, ff, ts: ff.pad(ts[0], pads, value, name="p"),
                     [(2, 3, 4)])
    _check(jop, top, [_randn(4, 2, 3, 4)])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_gather_matches_reference(axis):
    """take_along_axis semantics: the output has the index's shape; the
    data's grad scatters back, summing repeated indices."""
    shape, idx_shape = [3, 4, 5], [3, 4, 5]
    idx_shape[axis] = 6
    jop, top = _pair(lambda P, ff, ts: ff.gather(ts[0], ts[1], axis,
                                                 name="g"),
                     [shape, idx_shape], ["float32", "int32"])
    rng = np.random.RandomState(axis)
    index = rng.randint(0, shape[axis], idx_shape).astype(np.int32)
    _check(jop, top, [_randn(axis, *shape), index])


@pytest.mark.parametrize("src,dst", [("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("float32", "float16")])
def test_cast_matches_reference(src, dst):
    jop, top = _pair(lambda P, ff, ts: ff.cast(ts[0], dst, name="c"),
                     [(3, 7)], [src])
    x = 3.0 * _randn(11, 3, 7)
    jx = jnp.asarray(x, jnp.dtype(src))
    (jy,), vjp = jax.vjp(lambda a: jop.forward([a], []), jx)
    tx = torch.tensor(x).to(getattr(torch, src)).requires_grad_()
    (ty,) = top.forward([tx], [])
    assert ty.dtype == getattr(torch, dst)
    assert np.array_equal(ty.detach().float().numpy(),
                          np.asarray(jy, np.float32))
    g = _randn(12, 3, 7)
    (jdx,) = vjp([jnp.asarray(g, jnp.dtype(dst))])
    (tdx,) = torch.autograd.grad(ty, tx, torch.tensor(g).to(ty.dtype))
    assert np.array_equal(tdx.float().numpy(), np.asarray(jdx, np.float32))


def test_cast_to_int_truncates_as_the_reference():
    jop, top = _pair(lambda P, ff, ts: ff.cast(ts[0], "int32", name="c"),
                     [(4, 5)])
    x = 4.0 * _randn(13, 4, 5)
    (ty,) = top.forward([torch.tensor(x)], [])
    (jy,) = jop.forward([jnp.asarray(x)], [])
    assert ty.dtype == torch.int32
    assert np.array_equal(ty.numpy(), np.asarray(jy))


def _truth(op, x, ws):
    """The op in float64 on the bfloat16-rounded inputs."""
    x = np.asarray(x, np.float64)
    if op == "softmax":
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    if op == "cast":
        return x
    mean = x.mean(-1, keepdims=True)
    var = np.square(x - mean).mean(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + 1e-6) * ws[0] + ws[1]


@pytest.mark.parametrize("op", ["layer_norm", "softmax", "cast"])
def test_bfloat16_ops_round_as_the_reference(op):
    """LayerNorm, Softmax and Cast on bfloat16 tensors (as under
    compute_dtype bfloat16): bfloat16 out, and no farther from the
    float64 result than twice the reference's bfloat16 op, plus one
    bfloat16 ulp (2^-8 of the scale).  The two round their intermediate
    values at other places: jax's softmax rounds the exp to bfloat16
    where torch keeps its exp and sum in float32, and the bfloat16
    rsqrt of LayerNorm differs by an ulp between the two."""
    def build(P, ff, ts):
        if op == "layer_norm":
            return ff.layer_norm(ts[0], [-1], eps=1e-6, name="ln")
        if op == "softmax":
            return ff.softmax(ts[0], axis=-1, name="sm")
        return ff.cast(ts[0], "bfloat16", name="c")

    src = "float32" if op == "cast" else "bfloat16"
    jop, top = _pair(build, [(4, 6, 40)], [src])
    jx = jnp.asarray(2.0 * _randn(14, 4, 6, 40), jnp.dtype(src))
    jws = [jnp.asarray(w, jnp.bfloat16) for w in (
        1.0 + 0.1 * _randn(15, 40), 0.1 * _randn(16, 40))] \
        if op == "layer_norm" else []
    (jy,) = jop.forward([jx], jws)
    (ty,) = top.forward([torch.tensor(np.asarray(jx, np.float32)).to(
        getattr(torch, src))], [torch.tensor(np.asarray(w, np.float32))
                                .bfloat16() for w in jws])
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    truth = _truth(op, np.asarray(jx, np.float64),
                   [np.asarray(w, np.float64) for w in jws])
    err_ref = _scaled(np.asarray(jy, np.float32), truth)
    err_port = _scaled(ty.float().numpy(), truth)
    assert err_port <= 2 * err_ref + BF16_ULP


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("a_shape,b_shape", [((2, 5, 8), (2, 8, 6)),
                                             ((2, 3, 7, 4), (2, 3, 4, 7))])
def test_batch_matmul_matches_reference(a_shape, b_shape, masked):
    """With set_iteration_config(seq_length), positions at or past it
    on the declared seq dims (a's rows, b's columns) are zeroed before
    the product, in both packages."""
    rank = len(a_shape)

    def build(P, ff, ts):
        out = ff.batch_matmul(ts[0], ts[1], a_seq_length_dim=rank - 2,
                              b_seq_length_dim=rank - 1, name="bmm")
        if masked and P is T:
            ff.set_iteration_config(3)
        return out

    jop, top = _pair(build, [a_shape, b_shape])
    if masked:
        # the reference's set_iteration_config needs a compiled model
        jop._iter_seq_length = 3
        assert top._iter_seq_length == 3
    a, b = _randn(1, *a_shape), _randn(2, *b_shape)
    _check(jop, top, [a, b])
    (y,) = top.forward([torch.tensor(a), torch.tensor(b)], [])
    assert (not y[..., 3:, :].any() and not y[..., 3:].any()) == masked


def test_noop_passes_its_input_through():
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    t = ff.create_tensor([2, 3], name="x")
    op = NoOp(SourceParams(t.shape, "noop"), [t], name="n")
    assert op.op_type.value == J.OperatorType.NOOP.value
    x = torch.randn(2, 3)
    assert op.forward([x], [])[0] is x


# -- WeightOp ---------------------------------------------------------------

def _weight_model(P, trainable):
    """x [4, 8] -> dense(8) -> * a bare [8] parameter -> MSE."""
    kw = {"num_devices": 1} if P is J else {"device": "cpu"}
    ff = P.FFModel(P.FFConfig(batch_size=4, **kw))
    x = ff.create_tensor([4, 8], name="x")
    h = ff.dense(x, 8, name="fc")
    w = ff.weight_tensor(np.linspace(0.5, 2.0, 8, dtype=np.float32),
                         trainable=trainable, name="scale")
    ff.multiply(h, w, name="mul")
    ck = {"devices": jax.devices("cpu")[:1]} if P is J else {}
    ff.compile(optimizer=P.SGDOptimizer(lr=0.5, weight_decay=0.1),
               loss_type=P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, **ck)
    return ff


@pytest.mark.parametrize("trainable", [True, False])
def test_weight_op_trains_or_stays_frozen_as_the_reference(trainable):
    """A trainable WeightOp's value is a weight and takes the SGD update
    (weight decay included); a frozen one lives in the op state and
    keeps its value.  Weights and state cross from the reference through
    set_weights/set_state and back out unchanged."""
    jf, tf = _weight_model(J, trainable), _weight_model(T, trainable)
    wop = next(op for op in tf.layers.ops if op.op_type.value == "weight")
    assert wop.num_trainable_weights() == int(trainable)
    assert wop.outputs[0].create_gradients == trainable
    tf.set_weights(jf.get_weights())
    jstate = {op: {k: np.asarray(v) for k, v in e.items()}
              for op, e in jf._state.items()}
    tf.set_state(jstate)
    init = np.linspace(0.5, 2.0, 8, dtype=np.float32)
    where = tf.get_weights() if trainable else tf.get_state()
    assert np.array_equal(where["scale"]["value"], init)
    assert ("scale" in tf.get_weights()) == trainable
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8).astype(np.float32)
    y = rng.randn(4, 8).astype(np.float32)
    for _ in range(2):
        lj = float(jf.train_step({"x": x}, y)["loss"])
        lt = float(tf.train_step({"x": x}, y)["loss"])
        assert abs(lj - lt) <= TOL
    for got, want in ((tf.get_weights(), jf.get_weights()),
                      (tf.get_state(), jstate)):
        assert sorted(got) == sorted(want)
        for op, entries in want.items():
            for k, v in entries.items():
                assert _scaled(got[op][k], v) <= TOL, f"{op}.{k}"
    value = (tf.get_weights() if trainable else tf.get_state())["scale"]
    assert np.array_equal(value["value"], init) != trainable


def test_weight_op_under_bfloat16_compute_keeps_a_float32_master():
    """The value is a float32 master cast to bfloat16 for the forward, as
    other weights are; its gradient reaches the master."""
    ff = T.FFModel(T.FFConfig(batch_size=4, device="cpu",
                              compute_dtype="bfloat16"))
    x = ff.create_tensor([4, 8], name="x")
    w = ff.weight_tensor(np.ones(8, np.float32), name="scale")
    ff.multiply(ff.dense(x, 8, name="fc"), w, name="mul")
    ff.compile(optimizer=T.SGDOptimizer(lr=0.5),
               loss_type=T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    master = ff._weights["scale"]["value"]
    assert master.dtype == torch.float32
    rng = np.random.RandomState(4)
    ff.train_step({"x": rng.randn(4, 8).astype(np.float32)},
                  rng.randn(4, 8).astype(np.float32))
    assert ff._weights["scale"]["value"] is master
    assert master.dtype == torch.float32
    assert not torch.equal(master, torch.ones(8))


# -- Dropout ----------------------------------------------------------------

def _dropout(rate, seed=0):
    ff = T.FFModel(T.FFConfig(batch_size=4, device="cpu"))
    t = ff.create_tensor([4, 64, 128], name="x")
    return ff.dropout(t, rate, seed=seed, name="d").owner_op


def test_dropout_layer_matches_the_reference_op():
    jop, top = _pair(lambda P, ff, ts: ff.dropout(ts[0], 0.25, seed=3,
                                                  name="d"), [(4, 5)])
    assert jop.params.rate == top.params.rate == 0.25
    assert jop.params.seed == top.params.seed == 3


@pytest.mark.parametrize("rate,training", [(0.0, True), (-0.5, True),
                                           (0.3, False)])
def test_dropout_is_the_identity_at_rate_0_and_in_eval(rate, training):
    """The same tensor back, as the reference returns its input."""
    jop, top = _pair(lambda P, ff, ts: ff.dropout(ts[0], rate, name="d"),
                     [(4, 64, 128)])
    x = _randn(0, 4, 64, 128)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    assert jop.forward([jx], [], training=training)[0] is jx
    assert top.forward([tx], [], training=training,
                       generator=torch.Generator().manual_seed(1))[0] is tx


def test_dropout_gives_one_mask_per_generator_seed():
    op = _dropout(0.3)
    x = torch.randn(4, 64, 128) + 5.0  # no zeros in the input

    def mask(seed):
        g = torch.Generator().manual_seed(seed)
        return op.forward([x], [], training=True, generator=g)[0] == 0

    assert torch.equal(mask(11), mask(11))
    assert not torch.equal(mask(11), mask(12))
    # the draws follow the logical order, whatever the memory format
    x4 = torch.randn(2, 8, 4, 4) + 5.0
    outs = [op.forward([t], [], training=True,
                       generator=torch.Generator().manual_seed(11))[0]
            for t in (x4, x4.contiguous(memory_format=torch.channels_last))]
    assert torch.equal(outs[0], outs[1])
    # without a generator the op seeds one from params.seed
    a = op.forward([x], [], training=True)[0]
    b = _dropout(0.3, seed=0).forward([x], [], training=True)[0]
    c = _dropout(0.3, seed=1).forward([x], [], training=True)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_keep_fraction_and_grad():
    """Rate 0.3: the kept share within 5 sigma of 0.7 over 32768
    elements, kept values scaled by 1/0.7, and the grad exactly
    mask / 0.7 times the cotangent."""
    rate, keep = 0.3, 0.7
    op = _dropout(rate)
    x = (torch.rand(4, 64, 128) + 0.5).requires_grad_()
    (y,) = op.forward([x], [], training=True,
                      generator=torch.Generator().manual_seed(5))
    kept = y != 0
    n = x.numel()
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(float(kept.float().mean()) - keep) <= 5 * sigma
    assert torch.equal(y[kept], (x / keep)[kept])
    g = torch.randn(4, 64, 128)
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(dx, torch.where(kept, g / keep, 0.0))
