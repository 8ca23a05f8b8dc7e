"""The port's flash attention (flexflow_tpu_torch/ops/kernels/
flash_attention.py) against flexflow_tpu's: the plain forward and
backward against the Pallas kernels K1-K3 run in interpret mode and
against their off-TPU branches, on the same numpy inputs, as
tests/test_flash_kernels.py runs them (seq 256, d 64); a float64
gradcheck of the autograd Function; `mha_flash`'s layout; the three-pass
TF32 products of the card's K1, K2 and K3, emulated, against the float32
tolerance; and a CUDA tensor never reaching the plain versions.  The
CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import flexflow_tpu.ops.pallas.flash_attention as jfa  # noqa: E402
from flexflow_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

SCALE = 0.125
# float32 throughout: the plain versions and the reference's off-TPU
# branches are the same formulas, so they differ only in summation order
# (1e-5); the Pallas kernels run the online softmax over 128-wide tiles,
# which moves the results by up to a few ulp of the running sums more
# (5e-5 on values of order 1)
TOL_SAME = 1e-5
TOL_PALLAS = 5e-5

if not jfa._HAVE_PALLAS:  # pragma: no cover
    pytest.skip("pallas unavailable", allow_module_level=True)


def _inputs(seed, bh=2, s=256, d=64):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bh, s, d).astype(np.float32) * 0.4
               for _ in range(3))
    dout = rng.randn(bh, s, d).astype(np.float32) * 0.3
    return q, k, v, dout


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("causal", [False, True])
def test_forward_plain_matches_pallas_and_reference(causal):
    q, k, v, _ = _inputs(0)
    out, lse = fa.flash_fwd(*_t(q, k, v), SCALE, causal)  # CPU: plain
    p_out, p_lse = jfa._flash_fwd_pallas(*_j(q, k, v), SCALE, causal, 128,
                                         128, interpret=True)
    r_out, r_lse = jfa._flash_fwd(*_j(q, k, v), SCALE, causal)
    for got, pallas, ref in ((out, p_out, r_out), (lse, p_lse, r_lse)):
        got = got.numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=TOL_SAME)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=0,
                                   atol=TOL_PALLAS)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_matches_pallas_and_reference(causal):
    q, k, v, dout = _inputs(1)
    r_out, r_lse = jfa._flash_fwd(*_j(q, k, v), SCALE, causal)
    out, lse = np.asarray(r_out), np.asarray(r_lse)
    got = fa.flash_bwd(*_t(q, k, v, out, lse, dout), SCALE, causal)
    pallas = jfa._flash_bwd_pallas(*_j(q, k, v, out, lse, dout), SCALE,
                                   causal, 128, 128, interpret=True)
    ref = jfa._flash_vjp_bwd(SCALE, causal, tuple(_j(q, k, v, out, lse)),
                             jnp.asarray(dout))
    # the per-kernel wrappers' CPU path gives the same grads
    delta = fa.flash_delta(*_t(out, dout))
    tq, tk, tv, tdo, tlse = _t(q, k, v, dout, lse)
    split = (fa.flash_bwd_dq(tq, tk, tv, tdo, tlse, delta, SCALE, causal),
             *fa.flash_bwd_dkv(tq, tk, tv, tdo, tlse, delta, SCALE, causal))
    for name, g, s, p, r in zip(("dq", "dk", "dv"), got, split, pallas,
                                ref):
        np.testing.assert_array_equal(g.numpy(), s.numpy(), err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL_SAME, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=0,
                                   atol=TOL_PALLAS, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(5, 5), (4, 7), (7, 4)])
def test_autograd_function_gradcheck(causal, sq, sk):
    gen = torch.Generator().manual_seed(sq * 10 + sk)
    q, k, v = (torch.randn(2, n, 4, dtype=torch.float64, generator=gen,
                           requires_grad=True) for n in (sq, sk, sk))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, 0.5, causal), (q, k, v))


@pytest.mark.parametrize("causal", [False, True])
def test_mha_flash_layout_matches_reference(causal):
    """[b, s, h, d] in and out, heads folded next to the batch the
    reference's way: out[:, :, h] is attention over head h alone."""
    rng = np.random.RandomState(3)
    qh, kh, vh = (rng.randn(2, 40, 3, 8).astype(np.float32)
                  for _ in range(3))
    got = fa.mha_flash(*_t(qh, kh, vh), SCALE, causal)
    ref = jfa.mha_flash(*_j(qh, kh, vh), SCALE, causal)
    assert tuple(got.shape) == (2, 40, 3, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL_SAME)
    one, _ = fa.flash_fwd_plain(*_t(qh[:, :, 1], kh[:, :, 1], vh[:, :, 1]),
                                SCALE, causal)
    np.testing.assert_allclose(got[:, :, 1].numpy(), one.numpy(), rtol=0,
                               atol=TOL_SAME)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest even, on the
    float32 bits."""
    b = x.contiguous().view(torch.int32)
    b = b + 0xFFF + ((b >> 13) & 1)
    return (b & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the card's K2 and K3 form a float32 product on the tensor
    cores: x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and
    lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), each product exact in
    float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _bwd_from_products(mm, q, k, v, dout, lse, delta, scale, causal):
    """dq, dk, dv from the five products of K2 and K3 (S, dP, P^T dO,
    dS K, dS^T Q), each formed by `mm`."""
    p = torch.exp(mm(q, k.transpose(1, 2)) * scale - lse[..., None])
    if causal:
        p = p * torch.ones(p.shape[-2:], dtype=torch.bool).tril()
    dp = mm(dout, v.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return (mm(ds, k), mm(ds.transpose(1, 2), q),
            mm(p.transpose(1, 2), dout))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_three_pass_tf32_products_keep_float32_tolerance(d, causal):
    """The precision argument of K2 and K3's float32 path, emulated here:
    forming each of the five products in three TF32 passes keeps dq, dk
    and dv within the card tests' float32 tolerance, 1e-4 of the
    output's scale max(1, max|plain|), of the plain backward at seq
    2048; one TF32 pass does not."""
    rng = np.random.RandomState(d + causal)
    q, k, v, dout = _t(*(rng.standard_normal((2, 2048, d)).astype(
        np.float32) for _ in range(4)))
    scale = d ** -0.5
    out, lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    ref = fa.flash_bwd_plain(q, k, v, out, lse, dout, scale, causal)
    delta = fa.flash_delta(out, dout)

    def err(mm):
        got = _bwd_from_products(mm, q, k, v, dout, lse, delta, scale,
                                 causal)
        return max(float((g - r).abs().max()) / max(1.0, float(
            r.abs().max())) for g, r in zip(got, ref))

    assert err(_mm_3xtf32) <= 1e-4
    assert err(_mm_1xtf32) > 1e-4


def _fwd_from_products(mm, q, k, v, scale, causal):
    """out and LSE as K1 forms them: S = Q K^T and P V each formed by
    `mm`, P = exp(S - m) left unnormalised (float32, so not rounded
    before P V), out = P V / l and LSE = m + log l."""
    s = mm(q, k.transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(),
                          float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    return mm(p, v) / l[..., None], m[..., 0] + torch.log(l)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_three_pass_tf32_forward_keeps_float32_tolerance(d, causal):
    """The precision argument of K1's float32 path, emulated here:
    forming S and P V in three TF32 passes keeps out and LSE within the
    card tests' float32 tolerance, 1e-4 of the output's scale max(1,
    max|plain|), of the plain forward at seq 2048 (about 5e-7 here); one
    TF32 pass does not (1.2e-4 to 3.6e-4 here)."""
    rng = np.random.RandomState(d + causal)
    q, k, v = _t(*(rng.standard_normal((2, 2048, d)).astype(np.float32)
                   for _ in range(3)))
    scale = d ** -0.5
    ref = fa.flash_fwd_plain(q, k, v, scale, causal)

    def err(mm):
        got = _fwd_from_products(mm, q, k, v, scale, causal)
        return max(float((g - r).abs().max()) / max(1.0, float(
            r.abs().max())) for g, r in zip(got, ref))

    assert err(_mm_3xtf32) <= 1e-4
    assert err(_mm_1xtf32) > 1e-4


def test_cuda_tensor_never_takes_the_plain_versions(monkeypatch):
    """Only a CPU tensor runs the plain versions: any other goes to the
    kernels' checks and launch (here the device check raises)."""
    calls = []
    for name in ("flash_fwd_plain", "flash_bwd_plain", "_bwd_plain"):
        monkeypatch.setattr(fa, name, lambda *a, _n=name: calls.append(_n))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    x = torch.zeros(2, 128, 64, device="meta")
    lse = torch.zeros(2, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_fwd(x, x, x, SCALE, False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_bwd(x, x, x, x, lse, x, SCALE, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_bwd_dq(x, x, x, x, lse, lse, SCALE, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_bwd_dkv(x, x, x, x, lse, lse, SCALE, True)
    assert calls == []
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before
