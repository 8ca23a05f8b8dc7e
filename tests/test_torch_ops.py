"""The port's ops (flexflow_tpu_torch/ops/) against flexflow_tpu's: the
same numpy inputs and weights through each op's forward, float32 on
the CPU, plus the shape rules and weight specs the graph is built on."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402

ATOL = 1e-5
B, S, E, HEADS = 3, 6, 32, 4


def _models():
    return (J.FFModel(J.FFConfig(batch_size=B, num_devices=1)),
            T.FFModel(T.FFConfig(batch_size=B, device="cpu")))


def _shape(ps):
    return (tuple((d.size, d.degree, d.is_replica_dim) for d in ps.dims),
            ps.dtype.value)


def _op(t):
    return t.owner_op


def _weights(op, rng):
    """numpy weights for op's trainable specs at GPT-like scale
    (LayerNorm gamma/beta random too, so they are exercised)."""
    nt = getattr(op, "num_trainable_weights", lambda: len(op.weight_specs))()
    return [(0.2 * rng.randn(*s.shape.logical_shape)).astype(np.float32)
            for s in op.weight_specs[:nt]]


def _run_both(jt, tt, inputs, rng, state=()):
    jop, top = _op(jt), _op(tt)
    assert [_shape(o.shape) for o in jop.outputs] == \
        [_shape(o.shape) for o in top.outputs]
    assert [(s.name, _shape(s.shape)) for s in jop.weight_specs] == \
        [(s.name, _shape(s.shape)) for s in top.weight_specs]
    ws = _weights(jop, rng) + [np.array(a) for a in state]
    jout = jop.forward([jnp.asarray(x) for x in inputs],
                       [jnp.asarray(w) for w in ws])
    tws = [torch.from_numpy(np.array(w)) for w in ws]
    tout = top.forward([torch.from_numpy(np.array(x)) for x in inputs],
                       tws)
    return ([np.asarray(o) for o in jout],
            [o.numpy() for o in tout], tws)


def test_linear_gelu_embedding_add_layernorm():
    rng = np.random.RandomState(0)
    jf, tf = _models()
    outs = []
    for ff in (jf, tf):
        ids = ff.create_tensor([B, S], dtype="int32", name="input")
        x = ff.create_tensor([B, S, E], name="x")
        emb = ff.embedding(ids, 50, E, name="emb")
        lin = ff.dense(x, 48, activation=J.ActiMode.GELU if ff is jf
                       else T.ActiMode.GELU, name="lin")
        ln = ff.layer_norm(x, axes=[-1], name="ln")
        add = ff.add(x, emb, name="sum")
        outs.append((emb, lin, ln, add))
    ids = rng.randint(0, 50, (B, S)).astype(np.int32)
    x = rng.randn(B, S, E).astype(np.float32)
    for k, inputs in enumerate(([ids], [x], [x], [x, x[::-1].copy()])):
        j, t, _ = _run_both(outs[0][k], outs[1][k], inputs, rng)
        np.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)


def test_attention_dense_causal_forward():
    rng = np.random.RandomState(1)
    jf, tf = _models()
    ts = []
    for ff in (jf, tf):
        x = ff.create_tensor([B, S, E], name="x")
        ts.append(ff.multihead_attention(x, x, x, E, HEADS, causal=True,
                                         name="attn"))
    x = rng.randn(B, S, E).astype(np.float32)
    j, t, _ = _run_both(ts[0], ts[1], [x, x, x], rng)
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)


def test_attention_paged_decode_step():
    """One seq-1 paged decode step: the scatter of k/v into the pool
    (in place in the port) and the read, against the reference's
    gather formulation, with a scratch row and rows at mixed
    positions."""
    rng = np.random.RandomState(2)
    page, width, nb = 4, 8, 1 + B * 8
    jf, tf = _models()
    ts = []
    for ff in (jf, tf):
        x = ff.create_tensor([B, 1, E], name="x")
        ts.append(ff.multihead_attention(
            x, x, x, E, HEADS, causal=True, name="attn",
            decode_max_seq=page * width, kv_page_size=page,
            kv_num_blocks=nb))
    d = E // HEADS
    k_pool = rng.randn(nb, page, HEADS, d).astype(np.float32)
    v_pool = rng.randn(nb, page, HEADS, d).astype(np.float32)
    btab = rng.permutation(np.arange(1, nb)).reshape(B, width).astype(
        np.int32)
    btab[0] = 0  # idle slot: scratch table, seq_len 0
    slen = np.array([0, 5, 22], np.int32)
    x = rng.randn(B, 1, E).astype(np.float32)
    j, t, tws = _run_both(ts[0], ts[1], [x, x, x], rng,
                          state=(k_pool, v_pool, btab, slen))
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)
    for i in (1, 2):  # the pools, written in place
        assert t[i] is not None
        np.testing.assert_allclose(tws[-4 + i - 1].numpy(), j[i], rtol=0,
                                   atol=ATOL)
    np.testing.assert_array_equal(t[3], btab)
    np.testing.assert_array_equal(t[4], slen)


def test_flash_branch_raises_instead_of_falling_back(monkeypatch):
    """A KV length of flash_min_seq (2048) takes the flash branch: on CPU
    tensors its plain version, which matches the reference op's flash
    branch; on any other device the kernel wrapper, which raises there
    rather than falling back to the plain version."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.RandomState(3)
    jf, tf = _models()
    ts = []
    for ff in (jf, tf):
        x = ff.create_tensor([1, 2048, 8], name="x")
        ts.append(ff.multihead_attention(x, x, x, 8, 2, causal=True,
                                         name="attn"))
    x = rng.randn(1, 2048, 8).astype(np.float32)
    calls = []
    real = fa.flash_fwd_plain
    monkeypatch.setattr(fa, "flash_fwd_plain",
                        lambda *a: calls.append(1) or real(*a))
    j, t, tws = _run_both(ts[0], ts[1], [x, x, x], rng)
    assert calls == [1]
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)
    meta = torch.zeros(1, 2048, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        _op(ts[1]).forward([meta] * 3, [w.to("meta") for w in tws])
    assert calls == [1]
