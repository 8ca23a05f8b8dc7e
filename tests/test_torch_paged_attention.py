"""The port's paged attention (flexflow_tpu_torch/ops/kernels/
paged_attention.py) on the CPU, where the wrapper runs its plain gather
version: held against the JAX package's Pallas kernel in interpret mode
and against the reference's gather oracle on the same numpy inputs,
across page sizes, chunk lengths, partial tail pages, scratch rows and
CoW-shared blocks (the cases of tests/test_paged_kernel.py); and the
card kernel's split-and-merge, emulated here, against the same.  The
CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py and tests/test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexflow_tpu.ops.pallas import paged_attention as jpk  # noqa: E402
from flexflow_tpu_torch.ops.kernels import \
    paged_attention as tpk  # noqa: E402

ATOL = 1e-5  # float32 on both sides; only the summation order differs


def _gather_oracle(qh, k_pool, v_pool, btab, slen, scale):
    """The read math of flexflow_tpu's _attend_decode_paged: a dense
    per-row gather and a per-position masked softmax."""
    b, s, h, _ = qh.shape
    page = k_pool.shape[1]
    n = btab.shape[1] * page
    key_pos = jnp.arange(n, dtype=jnp.int32)
    pos = slen.reshape(b).astype(jnp.int32)
    ctxs = []
    for j in range(s):
        kv_k = jnp.take(k_pool, btab, axis=0).reshape(b, n, h, -1)
        kv_v = jnp.take(v_pool, btab, axis=0).reshape(b, n, h, -1)
        scores = jnp.einsum("bqhd,bkhd->bhqk", qh[:, j:j + 1], kv_k) * scale
        mask = key_pos[None, :] <= (pos + j)[:, None]
        scores = jnp.where(mask[:, None, None, :], scores,
                           jnp.finfo(scores.dtype).min)
        probs = jax.nn.softmax(scores, axis=-1)
        ctxs.append(jnp.einsum("bhqk,bkhd->bqhd", probs, kv_v))
    return jnp.concatenate(ctxs, axis=1)


def _case(rng, b, s, h, d, page, width, share=False):
    """Pools + tables with partial tail positions and one scratch row
    (slot 0: seq_len 0, table all zeros); `share` maps rows 2 and 3
    onto row 1's first blocks (the prefix cache's CoW shape)."""
    nb = 1 + b * width
    k_pool = rng.randn(nb, page, h, d).astype(np.float32)
    v_pool = rng.randn(nb, page, h, d).astype(np.float32)
    qh = rng.randn(b, s, h, d).astype(np.float32)
    btab = rng.permutation(np.arange(1, nb))[:b * width].reshape(
        b, width).astype(np.int32)
    btab[0] = 0
    top = width * page - s
    slen = np.array([0] + [1 + rng.randint(top - 1) for _ in range(b - 1)],
                    np.int32)
    if share:
        btab[2, :2] = btab[1, :2]
        btab[3, 0] = btab[1, 0]
        slen[1:4] = [2 * page + 1, 2 * page + 2, page + 1]
    return qh, k_pool, v_pool, btab, slen


def _port(arrs, scale):
    return tpk.paged_attention(*(torch.from_numpy(a) for a in arrs),
                               scale).numpy()


@pytest.mark.parametrize("share", [False, True], ids=["private", "cow"])
@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("page", [4, 8])
def test_plain_matches_pallas_interpret_and_gather_oracle(page, chunk,
                                                          share):
    rng = np.random.RandomState(100 * page + 10 * chunk + share)
    arrs = _case(rng, b=5, s=chunk, h=3, d=16, page=page, width=4,
                 share=share)
    scale = 1.0 / np.sqrt(16)
    got = _port(arrs, scale)
    assert tpk.paged_attention.launches == 0  # CPU: the plain version
    jarrs = [jnp.asarray(a) for a in arrs]
    pallas = np.asarray(jpk.paged_attention(*jarrs, scale, interpret=True))
    oracle = np.asarray(_gather_oracle(*jarrs, scale))
    assert got.shape == (5, chunk, 3, 16)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)


def test_chunk_equals_successive_decode_calls():
    """The seq-C read over a scattered chunk equals C seq-1 reads at
    successive positions."""
    rng = np.random.RandomState(3)
    qh, kp, vp, bt, sl = _case(rng, b=3, s=4, h=2, d=8, page=4, width=4)
    chunk = _port((qh, kp, vp, bt, sl), 0.3)
    for j in range(4):
        one = _port((np.ascontiguousarray(qh[:, j:j + 1]), kp, vp, bt,
                     sl + j), 0.3)
        np.testing.assert_allclose(chunk[:, j:j + 1], one, rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("chunk,width", [(1, 8), (1, 64), (4, 8)])
def test_blocks_read_matches_the_reference(chunk, width):
    rng = np.random.RandomState(chunk * width)
    seq_lens = rng.randint(0, width * 4, 9)
    live = rng.rand(9) > 0.3
    assert tpk.blocks_read(seq_lens, live, chunk, 4, width) == \
        jpk.blocks_read(seq_lens, live, chunk, 4, width)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The argument checks the CUDA path runs before any launch."""
    q = torch.zeros(2, 1, 4, 64)
    pool = torch.zeros(5, 4, 4, 64)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    sl = torch.zeros(2, dtype=torch.int32)
    tpk._check(q, pool, pool, bt, sl)  # the accepted shape
    with pytest.raises(ValueError, match="head dims"):
        small = torch.zeros(2, 1, 4, 32)
        tpk._check(small, pool[..., :32], pool[..., :32], bt, sl)
    with pytest.raises(ValueError, match="queries per row"):
        tpk._check(torch.zeros(2, 17, 4, 64), pool, pool, bt, sl)
    with pytest.raises(TypeError, match="int32"):
        tpk._check(q, pool, pool, bt.long(), sl)
    with pytest.raises(TypeError, match="one dtype"):
        tpk._check(q, pool.bfloat16(), pool, bt, sl)
    with pytest.raises(ValueError, match="contiguous"):
        tpk._check(torch.zeros(2, 4, 2, 64).transpose(1, 2), pool,
                   pool, bt, sl)


def _split_merge(qh, k_pool, v_pool, btab, slen, scale, split_pages):
    """The card kernel's arithmetic in torch: per (row, head), the row's
    live keys cut into splits of `split_pages` pages; per split and chunk
    token one max m (-1e30 when no key of the split is live for the
    token), p = exp(s - m), l = sum p, acc = p V; the partials merged by
    their m in split order, out = acc / (l or 1).  Returns the context
    and the number of (split, chunk token) partials with no live key."""
    b, s, h, d = qh.shape
    page, width = k_pool.shape[1], btab.shape[1]
    span = split_pages * page
    out = torch.zeros(b, s, h, d)
    empty = 0
    for i in range(b):
        pos = int(slen[i])
        n_tok = min(pos + s - 1, width * page - 1) + 1
        keys = k_pool[btab[i].long()].reshape(width * page, h, d)
        vals = v_pool[btab[i].long()].reshape(width * page, h, d)
        parts = []
        for t0 in range(0, n_tok, span):
            t = torch.arange(t0, min(t0 + span, n_tok))
            sc = torch.einsum("jhd,thd->hjt", qh[i], keys[t]) * scale
            live = t[None, :] <= pos + torch.arange(s)[:, None]  # [j, t]
            sc = sc.masked_fill(~live, float("-inf"))
            m = sc.amax(dim=-1)
            m = torch.where(torch.isinf(m), torch.full_like(m, -1e30), m)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(dim=-1),
                          torch.einsum("hjt,thd->hjd", p, vals[t])))
            empty += int((~live.any(dim=1)).sum()) * h
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l_sum, acc = torch.zeros_like(mx), torch.zeros(h, s, d)
        for m, l, a in parts:
            f = torch.exp(m - mx)
            l_sum = l_sum + l * f
            acc = acc + a * f[..., None]
        l_sum = torch.where(l_sum > 0, l_sum, torch.ones_like(l_sum))
        out[i] = (acc / l_sum[..., None]).permute(1, 0, 2)
    return out, empty


@pytest.mark.parametrize("share", [False, True], ids=["private", "cow"])
@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("split_pages", [1, 2, tpk.SPLIT_PAGES])
def test_split_and_merge_matches_pallas_interpret_and_gather_oracle(
        split_pages, chunk, share):
    """The card kernel's split over pages and its merge in split order,
    emulated, against the Pallas kernel in interpret mode and the gather
    oracle (float32 on all sides, summation order only: ATOL).  Rows cut
    mid-split, a row whose last split has no live key for chunk token 0
    (its keys start at pos + 1), the scratch row (seq_len 0) and
    CoW-shared blocks."""
    page, width = 4, 8
    rng = np.random.RandomState(10 * split_pages + chunk + share)
    arrs = list(_case(rng, b=6, s=chunk, h=3, d=16, page=page, width=width,
                      share=share))
    span = split_pages * page
    slen = arrs[4]
    slen[4] = 2 * span + span // 2 + 1          # ends mid-split
    slen[5] = span - 1 if chunk > 1 else span   # token 0 ends a split
    scale = 1.0 / np.sqrt(16)
    got, empty = _split_merge(*(torch.from_numpy(a) for a in arrs), scale,
                              split_pages)
    assert (tpk.live_splits(slen, chunk, page, width, split_pages)
            > 1).sum() >= 2
    if chunk > 1:
        assert empty > 0  # a split with no live key for some token
    jarrs = [jnp.asarray(a) for a in arrs]
    pallas = np.asarray(jpk.paged_attention(*jarrs, scale, interpret=True))
    oracle = np.asarray(_gather_oracle(*jarrs, scale))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=ATOL)
