"""The port's MoE ops against flexflow_tpu's on the CPU: the cumsum
dispatch helpers (dispatch_indices, sort_group_by, sort_combine), TopK,
GroupBy, Aggregate (with the load-balance loss), AggregateSpec and
ExpertsDense.

Each op is built through both packages' layer calls (same op type,
output shapes and dtypes, weight specs), then run on the same seeded
numpy inputs: the float outputs and the auxiliary loss against the
reference op's forward, the integer outputs exactly, and the autograd
grads over the float inputs and weights against jax.vjp with the same
random cotangents.  Cases cover capacity drops and the sample-major
priority that decides them, TopK ties (the lower index first, as
jax.lax.top_k), the balance loss and its gradient, AggregateSpec's
label replication through a train step, and build_moe_mlp and
build_moe_encoder over 2 SGD steps at a capacity factor that drops
tokens.

Tolerances, over the output's scale max(1, max|ref|): float32 1e-5 for
forwards and grads (the ops move rows exactly and sum at most k or d
products per output, in another order than XLA).  Integer outputs
(expert ids, slots, keep flags) agree exactly.  The train steps hold
losses to 1e-5 and weights to 2e-5 after 2 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.models import build_moe_encoder as jax_moe_encoder  # noqa
from flexflow_tpu.models import build_moe_mlp as jax_moe_mlp  # noqa: E402
from flexflow_tpu.ops import moe_dispatch as JD  # noqa: E402
from flexflow_tpu_torch.models import (build_moe_encoder,  # noqa: E402
                                       build_moe_mlp)
from flexflow_tpu_torch.ops import moe_dispatch as TD  # noqa: E402

TOL = 1e-5
LOSS_TOL, WEIGHT_TOL = 1e-5, 2e-5


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _is_float(x) -> bool:
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def _pair(build, shapes, dtypes=None):
    """build(P, ff, input tensors) in both packages -> (jax op, port op),
    after checking their types, output shapes and dtypes and weight
    specs."""
    dtypes = dtypes or ["float32"] * len(shapes)
    ops = []
    for P, ff in ((J, J.FFModel(J.FFConfig(batch_size=shapes[0][0],
                                           num_devices=1))),
                  (T, T.FFModel(T.FFConfig(batch_size=shapes[0][0],
                                           device="cpu")))):
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


def _check(jop, top, inputs, weights=(), aux=False, tol=TOL):
    """Float outputs (and the op's auxiliary loss when `aux`) with their
    grads over the float inputs and the weights; integer outputs
    exactly."""
    floats = [i for i, x in enumerate(inputs) if _is_float(x)]

    def jfwd(fx, ws):
        xs = [jnp.asarray(x) for x in inputs]
        for i, v in zip(floats, fx):
            xs[i] = v
        outs = [o for o in jop.forward(xs, list(ws), training=True)
                if jnp.issubdtype(o.dtype, jnp.floating)]
        return outs + ([jop._last_aux] if aux else [])

    jouts, vjp = jax.vjp(jfwd, [jnp.asarray(inputs[i]) for i in floats],
                         [jnp.asarray(w) for w in weights])
    rng = np.random.RandomState(7)
    gs = [np.asarray(rng.randn(*o.shape), np.float32) for o in jouts]
    jdx, jdw = vjp([jnp.asarray(g) for g in gs])
    txs = [torch.tensor(x).requires_grad_(i in floats)
           for i, x in enumerate(inputs)]
    tws = [torch.tensor(w).requires_grad_() for w in weights]
    touts = top.forward(txs, tws, training=True)
    ints = [o for o in touts if not o.is_floating_point()]
    jints = [o for o in jop.forward([jnp.asarray(x) for x in inputs],
                                    [jnp.asarray(w) for w in weights])
             if not jnp.issubdtype(o.dtype, jnp.floating)]
    assert len(ints) == len(jints)
    for got, want in zip(ints, jints):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    touts = [o for o in touts if o.is_floating_point()]
    if aux:
        touts.append(top._last_aux)
    assert len(touts) == len(jouts)
    for got, want in zip(touts, jouts):
        assert tuple(got.shape) == tuple(want.shape)
        assert _scaled(got.detach().numpy(), want) <= tol
    wrt = [txs[i] for i in floats] + tws
    grads = torch.autograd.grad(touts, wrt,
                                [torch.from_numpy(g) for g in gs],
                                allow_unused=True)
    for got, want in zip(grads, list(jdx) + list(jdw)):
        got = np.zeros(want.shape) if got is None else got.numpy()
        assert _scaled(got, want) <= tol


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assign(seed, b, k, n):
    """[b, k] distinct expert ids per sample, int32."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(
        np.int32)


# -- dispatch helpers --------------------------------------------------

@pytest.mark.parametrize("b,k,n,cap", [(8, 2, 4, 4), (8, 2, 4, 2),
                                       (16, 1, 3, 3), (5, 3, 3, 1)])
def test_dispatch_indices_match_reference(b, k, n, cap):
    assign = _assign(b + k, b, k, n)
    want_slot, want_keep = JD.dispatch_indices(jnp.asarray(assign), cap, n)
    slot, keep = TD.dispatch_indices(torch.from_numpy(assign), cap, n)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    assert slot.dtype == torch.int64


def test_dispatch_serves_tokens_sample_major():
    """Every pair on expert 0 at capacity 3: the first three pairs in
    (sample, slot) order are kept, the rest dropped into the last row."""
    assign = np.zeros((4, 2), np.int32)
    assign[:, 1] = 1
    slot, keep = TD.dispatch_indices(torch.from_numpy(assign), 3, 2)
    assert keep.tolist() == [True, True, True, True, True, True,
                             False, False]
    assert slot.tolist() == [0, 3, 1, 4, 2, 5, 2, 5]


@pytest.mark.parametrize("cap", [8, 2])
def test_sort_group_by_and_combine_match_reference(cap):
    """Capacity 8 keeps every pair (an expert serves at most one pair
    per sample), 2 drops some."""
    b, k, n, d = 8, 2, 4, 5
    assign = _assign(3, b, k, n)
    data = _randn(1, b, d)
    expert_out = _randn(2, n, cap, 6)

    def check(jfn, tfn, x):
        want, vjp = jax.vjp(jfn, jnp.asarray(x))
        g = _randn(9, *want.shape)
        (want_dx,) = vjp(jnp.asarray(g))
        tx = torch.tensor(x).requires_grad_()
        got = tfn(tx)
        assert _scaled(got.detach().numpy(), want) <= TOL
        (dx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
        assert _scaled(dx.numpy(), want_dx) <= TOL

    ja, ta = jnp.asarray(assign), torch.from_numpy(assign)
    check(lambda x: JD.sort_group_by(x, ja, n, cap),
          lambda x: TD.sort_group_by(x, ta, n, cap), data)
    check(lambda x: JD.sort_combine(x, ja, cap)[0],
          lambda x: TD.sort_combine(x, ta, cap)[0], expert_out)
    dropped = (~TD.sort_combine(torch.from_numpy(expert_out), ta,
                                cap)[1]).sum().item()
    assert (dropped > 0) == (cap < 8)


# -- the ops -----------------------------------------------------------

def test_topk_matches_reference_and_breaks_ties_by_index():
    """Values rounded to a quarter tie often: the lower index comes
    first, as in jax.lax.top_k."""
    x = np.round(_randn(4, 6, 8) * 2) / 4
    assert any(len(set(row)) < len(row) for row in x.tolist())
    jop, top = _pair(lambda P, ff, ts: ff.top_k(ts[0], 3, name="topk"),
                     [(6, 8)])
    _check(jop, top, [x])
    x = np.zeros((2, 5), np.float32)
    x[1, 3] = 1.0
    values, idx = top.forward([torch.from_numpy(x)], [])
    assert idx.tolist() == [[0, 1, 2], [3, 0, 1]]


@pytest.mark.parametrize("alpha", [2.0, 1.0, 0.5])
def test_group_by_matches_reference(alpha):
    """alpha 0.5 caps each expert at 2 rows of 8·2 pairs: drops."""
    b, k, n, d = 8, 2, 4, 5
    jop, top = _pair(
        lambda P, ff, ts: ff.group_by(ts[0], ts[1], n, alpha, name="g"),
        [(b, d), (b, k)], ["float32", "int32"])
    cap = top.outputs[0].shape.logical_shape[1]
    assert cap == max(1, int(np.ceil(alpha * k * b / n)))
    _check(jop, top, [_randn(1, b, d), _assign(2, b, k, n)])


def _aggregate_inputs(b, k, n, cap, e, seed=0):
    rng = np.random.RandomState(seed)
    gate_full = rng.rand(b, n).astype(np.float32)
    gate_full /= gate_full.sum(-1, keepdims=True)
    assign = _assign(seed + 1, b, k, n)
    scores = np.take_along_axis(gate_full, assign, axis=1)
    return [scores, assign, gate_full, _randn(seed + 2, n, cap, e)]


@pytest.mark.parametrize("lambda_bal", [0.0, 0.04])
@pytest.mark.parametrize("cap", [4, 2])
def test_aggregate_matches_reference(lambda_bal, cap):
    """The combine, and with lambda_bal > 0 the balance loss and its
    gradient over the gate's softmax."""
    b, k, n, e = 8, 2, 4, 6
    jop, top = _pair(
        lambda P, ff, ts: ff.aggregate(*ts, n, lambda_bal, name="agg"),
        [(b, k), (b, k), (b, n), (n, cap, e)],
        ["float32", "int32", "float32", "float32"])
    _check(jop, top, _aggregate_inputs(b, k, n, cap, e),
           aux=lambda_bal > 0)
    if lambda_bal == 0:
        assert top._last_aux is None


@pytest.mark.parametrize("lambda_bal", [0.0, 0.04])
def test_aggregate_spec_matches_reference(lambda_bal):
    b, k, n, cap, e = 8, 2, 4, 3, 6
    jop, top = _pair(
        lambda P, ff, ts: ff.aggregate_spec(*ts, n, lambda_bal, name="spec"),
        [(b, k), (b, k), (b, n), (n, cap, e)],
        ["float32", "int32", "float32", "float32"])
    assert top.outputs[0].shape.logical_shape == (b * k, e)
    _check(jop, top, _aggregate_inputs(b, k, n, cap, e, seed=3),
           aux=lambda_bal > 0)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_experts_dense_matches_reference(use_bias, act):
    n, cap, d, o = 4, 3, 5, 7
    jop, top = _pair(
        lambda P, ff, ts: ff.experts_dense(
            ts[0], o, activation=P.ActiMode(act), use_bias=use_bias,
            name="ed"),
        [(n, cap, d)])
    assert top.op_type == T.OperatorType.LINEAR
    weights = [_randn(11, n, d, o)] + ([_randn(12, n, o)] if use_bias
                                       else [])
    _check(jop, top, [_randn(10, n, cap, d)], weights)


# -- through the step --------------------------------------------------

def _spec_model(P, ff, b, d, n, k, classes):
    x = ff.create_tensor([b, d], name="input")
    gate = ff.softmax(ff.dense(x, n, name="gate"), name="gate_sm")
    values, assign = ff.top_k(gate, k, name="topk")
    grouped = ff.group_by(x, assign, n, 1.0, name="group_by")
    hidden = ff.experts_dense(grouped, classes, name="experts")
    out = ff.aggregate_spec(values, assign, gate, hidden, n, 0.04,
                            name="spec")
    return ff.softmax(out, name="softmax")


def _compiled_pair(build, batch, lr=0.05, loss="sparse_categorical_"
                   "crossentropy", metrics=("accuracy",)):
    jf = J.FFModel(J.FFConfig(batch_size=batch, num_devices=1))
    build(J, jf)
    jf.compile(optimizer=J.SGDOptimizer(lr=lr), loss_type=loss,
               metrics=list(metrics), devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=batch, device="cpu"))
    build(T, tf)
    tf.compile(optimizer=T.SGDOptimizer(lr=lr), loss_type=loss,
               metrics=list(metrics))
    tf.set_weights(jf.get_weights())
    return jf, tf


def _steps_match(jf, tf, batches):
    for feed, y in batches:
        got, want = tf.train_step(feed, y), jf.train_step(feed, y)
        assert sorted(got) == sorted(k for k in want if not
                                     k.startswith("__"))
        for key in got:
            np.testing.assert_allclose(float(got[key]),
                                       float(np.asarray(want[key])),
                                       rtol=0, atol=LOSS_TOL, err_msg=key)
    want_w, got_w = jf.get_weights(), tf.get_weights()
    for op, entries in want_w.items():
        for k, v in entries.items():
            np.testing.assert_allclose(got_w[op][k], np.asarray(v),
                                       rtol=0, atol=WEIGHT_TOL,
                                       err_msg=f"{op}.{k}")


def test_aggregate_spec_replicates_labels_in_train_and_eval_steps():
    """k predictions per sample: each label repeats k times,
    sample-major, and the balance loss joins the training loss."""
    b, d, n, k, classes = 8, 6, 4, 2, 3
    jf, tf = _compiled_pair(
        lambda P, ff: _spec_model(P, ff, b, d, n, k, classes), b)
    assert tf._label_replication == jf._label_replication == k
    assert tf.executor.label_replication == k
    rng = np.random.RandomState(5)
    batches = [({"input": rng.randn(b, d).astype(np.float32)},
                rng.randint(0, classes, b).astype(np.int32))
               for _ in range(2)]
    _steps_match(jf, tf, batches)
    feed, y = batches[0]
    got, want = tf.eval_step(feed, y), jf.eval_step(feed, y)
    for key in got:
        np.testing.assert_allclose(float(got[key]),
                                   float(np.asarray(want[key])), rtol=0,
                                   atol=LOSS_TOL, err_msg=key)


@pytest.mark.parametrize("model", ["moe_mlp", "moe_encoder"])
def test_moe_builders_train_like_reference(model):
    """2 SGD steps at alpha 0.5 (capacity drops), lambda_bal 0.04."""
    b = 8
    if model == "moe_mlp":
        kw = dict(batch_size=b, input_dim=16, num_classes=4, num_exp=4,
                  num_select=2, hidden_size=16, alpha=0.5)
        builders = {J: jax_moe_mlp, T: build_moe_mlp}
        shape, yshape = (b, 16), (b,)
    else:
        kw = dict(batch_size=b, seq_length=8, hidden_size=16,
                  num_layers=1, num_heads=4, num_exp=4, num_select=2,
                  num_classes=4, alpha=0.5)
        builders = {J: jax_moe_encoder, T: build_moe_encoder}
        shape, yshape = (b, 8, 16), (b, 8)
    jf, tf = _compiled_pair(lambda P, ff: builders[P](ff, **kw), b)
    assert [op.name for op in tf.layers.topo_order()] == \
        [op.name for op in jf.layers.topo_order()]
    rng = np.random.RandomState(1)
    batches = [({"input": rng.randn(*shape).astype(np.float32)},
                rng.randint(0, 4, size=yshape).astype(np.int32))
               for _ in range(2)]
    _steps_match(jf, tf, batches)


# -- the local-expert forms and the exchange of expert parallelism ----------

@pytest.mark.parametrize("shards,chunks,cap", [(4, 1, 6), (1, 4, 6),
                                               (2, 2, 3), (4, 2, 2)])
def test_local_dispatch_forms_equal_the_global_ones(shards, chunks, cap):
    """The tokens split into `shards` (each shard's pairs ranked from the
    counts of the shards before it) and the experts into `chunks`: each
    shard's sort_group_by rows, summed over shards and joined over
    chunks, and each shard's sort_combine rows, summed over chunks and
    joined over shards, equal the one-device forms bit for bit, under a
    capacity that drops pairs; with the defaults the local forms are the
    one-device functions."""
    b, k, n, d = 24, 2, 8, 5
    rng = np.random.RandomState(7)
    assign = torch.tensor(rng.randint(0, n, (b, k)), dtype=torch.int32)
    data = torch.tensor(rng.randn(b, d).astype(np.float32))
    out = torch.tensor(rng.randn(n, cap, d).astype(np.float32))
    want_g = TD.sort_group_by(data, assign, n, cap)
    want_c, keep = TD.sort_combine(out, assign, cap)
    assert not bool(keep.all())  # the capacity drops pairs
    m, rows = n // chunks, b // shards
    counts = torch.stack([torch.bincount(assign[s * rows:(s + 1) * rows]
                                         .reshape(-1).long(), minlength=n)
                          for s in range(shards)])
    offsets = torch.cumsum(counts, 0) - counts
    got_g = torch.cat([sum(TD.sort_group_by(
        data[s * rows:(s + 1) * rows], assign[s * rows:(s + 1) * rows], n,
        cap, c * m, m, offsets[s]) for s in range(shards))
        for c in range(chunks)])
    got_c = torch.cat([sum(TD.sort_combine(
        out[c * m:(c + 1) * m], assign[s * rows:(s + 1) * rows], cap, n,
        c * m, offsets[s])[0] for c in range(chunks))
        for s in range(shards)])
    assert torch.equal(got_g, want_g)
    assert torch.equal(got_c, want_c)
    slot, keep1 = TD.dispatch_indices(assign, cap, n)
    slot0, keep0 = TD.dispatch_indices(assign, cap, n,
                                       torch.zeros(n, dtype=torch.long))
    assert torch.equal(slot, slot0) and torch.equal(keep1, keep0)
    assert torch.equal(TD.sort_group_by(data, assign, n, cap, 0, n), want_g)
    assert torch.equal(TD.sort_combine(out, assign, cap, n, 0)[0], want_c)


def test_exchange_forward_and_backward_against_a_gather():
    """collectives.exchange (the variable all-to-all of expert
    parallelism) on 4 gloo ranks: what each rank receives is the rows
    the others addressed to it, in rank order; each row's grad comes back
    to its sender (the reverse exchange)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_dist_ranks as R

    world = 4
    rng = np.random.RandomState(3)
    # send[r][j]: rows rank r sends rank j (zero included)
    send = rng.randint(0, 4, (world, world))
    send[1, 2] = 0
    rows = [rng.randn(int(send[r].sum()), 3).astype(np.float32)
            for r in range(world)]
    cases = [(R.exchange_case, (rows[r], list(send[r]), list(send[:, r])))
             for r in range(world)]
    got = R.run_group(R.exchange_rank, world, cases, timeout=120)
    for r, (recv, grad) in enumerate(got):
        want = np.concatenate([
            rows[s][send[s, :r].sum():send[s, :r + 1].sum()]
            for s in range(world)])
        np.testing.assert_array_equal(recv, want)
        # receiver j's grad of each row is the row times j + 1
        scale = np.concatenate([np.full(send[r, j], 1.0 + j)
                                for j in range(world)])
        np.testing.assert_allclose(grad, rows[r] * scale[:, None],
                                   rtol=1e-6)
