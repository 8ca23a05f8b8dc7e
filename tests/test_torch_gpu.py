"""The port's CUDA kernels on the card: each held against its plain
PyTorch version, the flash kernels through their autograd Function, and
the paged decode step run through the paged-attention kernel.
These need a CUDA device and skip without one; on the GPU machine run
`python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest`
(that machine has no jax, which tests/conftest.py imports).  This file
imports no jax, so it runs where only torch is installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a")
    return torch.device("cuda")


def _case(rng, b, s, h, d, page, width, dtype, dev):
    nb = 1 + b * width
    kp = torch.randn(nb, page, h, d, device=dev).to(dtype)
    vp = torch.randn(nb, page, h, d, device=dev).to(dtype)
    qh = torch.randn(b, s, h, d, device=dev).to(dtype)
    btab = rng.permutation(np.arange(1, nb)).reshape(b, width).astype(
        np.int32)
    btab[0] = 0                      # scratch row
    btab[2, :2] = btab[1, :2]        # CoW-shared blocks
    slen = np.array([0] + [1 + rng.randint(width * page - s - 1)
                           for _ in range(b - 1)], np.int32)
    return qh, kp, vp, torch.tensor(btab, device=dev), \
        torch.tensor(slen, device=dev)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("s", [1, 5, 16])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_attention_kernel_matches_plain(cuda, dtype, tol, s, d):
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk

    torch.manual_seed(0)
    rng = np.random.RandomState(s * d)
    dt = getattr(torch, dtype)
    qh, kp, vp, bt, sl = _case(rng, 5, s, 4, d, 8, 6, dt, cuda)
    before = pk.paged_attention.launches
    got = pk.paged_attention(qh, kp, vp, bt, sl, d ** -0.5)
    assert pk.paged_attention.launches == before + 1
    # the plain version in float32 on the same values: the kernel
    # accumulates in float32, so only its output rounding differs
    ref = pk.paged_attention_plain(qh.float(), kp.float(), vp.float(), bt,
                                   sl, d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == qh.shape
    assert float((got.float() - ref).abs().max()) <= tol


FLASH_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _flash_err(got, ref):
    """max |got - ref| over the output's scale, max(1, max |ref|)."""
    return float((got.float() - ref.float()).abs().max()
                 / max(1.0, float(ref.float().abs().max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk", [(3, 200, 200), (2, 130, 300),
                                      (2, 300, 130), (1, 1, 1)])
def test_flash_kernels_match_plain(cuda, dtype, d, causal, bh, sq, sk):
    """K1, K2 and K3 against their plain versions, run in float32 on the
    same values: both accumulate in float32 in other orders (float32:
    1e-4 of the output's scale); in bfloat16 the kernels round P and dS
    to bfloat16 before their products and their outputs to bfloat16,
    2^-9 each (3e-2)."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(bh * sq + sk + d)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(bh, n, d, generator=gen, device=cuda).to(dt)
               for n in (sq, sk, sk))
    dout = torch.randn(bh, sq, d, generator=gen, device=cuda).to(dt)
    scale = d ** -0.5
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, scale, causal)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, dout, scale, causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(b + 1 for b in before)
    f = [t.float() for t in (q, k, v, dout)]
    r_out, r_lse = fa.flash_fwd_plain(f[0], f[1], f[2], scale, causal)
    r_dq, r_dk, r_dv = fa.flash_bwd_plain(f[0], f[1], f[2], r_out, r_lse,
                                          f[3], scale, causal)
    tol = FLASH_TOL[dtype]
    for name, got, ref in (("out", out, r_out), ("lse", lse, r_lse),
                           ("dq", dq, r_dq), ("dk", dk, r_dk),
                           ("dv", dv, r_dv)):
        assert got.shape == ref.shape, name
        assert torch.isfinite(got).all(), name
        assert _flash_err(got, ref) <= tol, (name, _flash_err(got, ref))


def _backward_inputs(cuda, dtype, d, causal, seed, bh=4, s=2048):
    """q, k, v, dout in `dtype` and their float32 copies, with LSE and
    delta from the plain forward in float32 on the same values."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = [torch.randn(bh, s, d, generator=gen, device=cuda).to(dt)
         for _ in range(4)]
    f = [t.float() for t in x]
    out, lse = fa.flash_fwd_plain(f[0], f[1], f[2], d ** -0.5, causal)
    return x, f, out, lse, fa.flash_delta(out, f[3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_at_seq_2048(cuda, dtype, d, causal):
    """K2 and K3 alone at the training sequence length, given the plain
    forward's LSE and delta: against the plain backward run in float32 on
    the same values, at FLASH_TOL (float32: the three TF32 passes and the
    tensor cores' float32 sums in another order; bfloat16: P and dS
    rounded to bfloat16 before their products, and the outputs)."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    (q, k, v, dout), f, out, lse, delta = _backward_inputs(
        cuda, dtype, d, causal, seed=d + causal)
    scale = d ** -0.5
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
    ref = fa.flash_bwd_plain(f[0], f[1], f[2], out, lse, f[3], scale,
                             causal)
    torch.cuda.synchronize()
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == q.dtype and got.shape == r.shape, name
        assert torch.isfinite(got).all(), name
        assert _flash_err(got, r) <= FLASH_TOL[dtype], (name,
                                                        _flash_err(got, r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """Every output tile of K2 and K3 has one owner and sums in one
    order: two launches on the same inputs give the same bits."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    (q, k, v, dout), _, _, lse, delta = _backward_inputs(
        cuda, dtype, 64, False, seed=11)
    runs = [(fa.flash_bwd_dq(q, k, v, dout, lse, delta, 0.125, False),
             *fa.flash_bwd_dkv(q, k, v, dout, lse, delta, 0.125, False))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_attention_grads_through_autograd(cuda):
    """The autograd Function on the card: one K1 forward, one K2 and one
    K3 launch for the backward, and the grads of the plain version."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(7)
    qh, kh, vh = (torch.randn(2, 192, 3, 64, generator=gen, device=cuda,
                              requires_grad=True) for _ in range(3))
    before = fa.flash_bwd_dkv.launches
    fa.mha_flash(qh, kh, vh, 0.125, True).square().sum().backward()
    assert fa.flash_bwd_dkv.launches == before + 1
    got = [t.grad.clone() for t in (qh, kh, vh)]
    cpu = [t.detach().cpu().requires_grad_() for t in (qh, kh, vh)]
    fa.mha_flash(*cpu, 0.125, True).square().sum().backward()
    for g, c in zip(got, cpu):
        assert _flash_err(g.cpu(), c.grad) <= FLASH_TOL["float32"]


def test_bert_train_steps_in_bfloat16_run_the_flash_kernels(cuda):
    """compute_dtype bfloat16 sends bfloat16 q, k, v through K1-K3
    (flash_min_seq=0) while the float32 master weights take the update.
    Two steps track the float32 run from the same weights to 5e-2 in the
    loss: every op of the 2-layer model rounds to bfloat16 (2^-9)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_bert
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    bert = dict(batch_size=2, seq_length=256, hidden_size=128,
                num_layers=2, num_heads=2, intermediate_size=256)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 256, 128).astype(np.float32)
    y = rng.randint(0, 2, (2, 1)).astype(np.int32)
    losses, weights = {}, None
    for cd in ("float32", "bfloat16"):
        ff = FFModel(FFConfig(batch_size=2, device="cuda", compute_dtype=cd,
                              flash_min_seq=0))
        build_bert(ff, **bert)
        ff.compile(seed=0)
        if weights is None:
            weights = ff.get_weights()
        ff.set_weights(weights)
        before = fa.flash_bwd_dkv.launches
        losses[cd] = [float(ff.train_step({"input": x}, y)["loss"])
                      for _ in range(2)]
        assert fa.flash_bwd_dkv.launches == before + 2 * 2
        assert all(w.dtype == torch.float32 and torch.isfinite(w).all()
                   for e in ff._weights.values() for w in e.values())
    assert np.isfinite(losses["bfloat16"]).all()
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"],
                               rtol=0, atol=5e-2)


def test_paged_decode_step_runs_the_kernel(cuda):
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_gpt
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk
    from flexflow_tpu_torch.serving import ContinuousScheduler

    gpt = dict(batch_size=4, seq_length=64, hidden_size=128, num_layers=2,
               num_heads=2, intermediate_size=256, vocab_size=96)
    outs = {}
    for dev in ("cuda", "cpu"):
        ff = FFModel(FFConfig(batch_size=4, device=dev))
        build_gpt(ff, **gpt)
        ff.compile(seed=3)
        if dev == "cpu":
            ff.set_weights(outs["w"])
        else:
            outs["w"] = ff.get_weights()
        sched = ContinuousScheduler.from_trained(
            ff, batch_slots=4, page_size=8, prefill_chunk=4)
        before = pk.paged_attention.launches
        try:
            outs[dev] = [sched.generate(list(range(1, 1 + n)), 6)
                         for n in (3, 11)]
            stats = sched.stats()
        finally:
            sched.close()
        launched = pk.paged_attention.launches - before
        forwards = stats["steps"] + 4 * stats["prefill_steps"]
        assert launched == (2 * forwards if dev == "cuda" else 0)
    assert outs["cuda"] == outs["cpu"]


BN_TOL = {"float32": 1e-6, "bfloat16": 8e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["res_relu", "relu", "res", "none"])
@pytest.mark.parametrize("m,c,offset", [(4096, 256, 0), (1001, 37, 0),
                                        (333, 64, 1), (7, 4100, 0),
                                        (5, 2053, 0), (1, 8, 0)])
def test_bn_apply_kernel_matches_plain(cuda, dtype, variant, m, c, offset):
    """P1 against its plain version on the same inputs: the same float32
    multiply and adds in the same order, rounded once, so the bits agree
    (held to one ulp of the output's scale, BN_TOL).  Odd C and M, a
    misaligned x (offset 1: the scalar path) and a prime C of 2053 (no
    grid of whole rows: the general loop)."""
    from flexflow_tpu_torch.ops.kernels import bn_apply as bk

    gen = torch.Generator(device=cuda).manual_seed(m * c + offset)
    dt = getattr(torch, dtype)
    base = torch.randn(m * c + offset, generator=gen, device=cuda).to(dt)
    x = base[offset:].view(m, c)
    res = (torch.randn(m, c, generator=gen, device=cuda).to(dt)
           if variant.startswith("res") else None)
    scale = torch.randn(c, generator=gen, device=cuda).to(dt)
    shift = torch.randn(c, generator=gen, device=cuda).to(dt)
    relu = variant.endswith("relu")
    before = bk.bn_apply.launches
    got = bk.bn_apply(x, scale, shift, res, relu)
    assert bk.bn_apply.launches == before + 1
    ref = bk.bn_apply_plain(x, scale, shift, res, relu)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (m, c)
    assert bk.vectorized(x, res) == (offset == 0 and c % (16 // dt.itemsize)
                                     == 0)
    assert _flash_err(got, ref) <= BN_TOL[dtype]


def test_bn_apply_reads_channels_last_and_refuses_nchw(cuda):
    from flexflow_tpu_torch.ops.kernels import bn_apply as bk

    x = torch.randn(4, 32, 7, 5, device=cuda)
    s, b = torch.rand(32, device=cuda) + 0.5, torch.randn(32, device=cuda)
    before = bk.bn_apply.launches
    with pytest.raises(ValueError, match="channels_last"):
        bk.bn_apply(x, s, b, None, True)
    assert bk.bn_apply.launches == before
    xc = x.contiguous(memory_format=torch.channels_last)
    y = bk.bn_apply(xc, s, b, xc, True)
    assert y.is_contiguous(memory_format=torch.channels_last)
    want = torch.relu(x * s.view(1, -1, 1, 1) + b.view(1, -1, 1, 1) + x)
    assert float((y - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_bn_apply_grads_on_card_match_cpu(cuda):
    """The autograd Function (P1 forward, plain backward) on the card
    against the same on the CPU: float32 sums in other orders, 1e-5."""
    from flexflow_tpu_torch.ops.kernels import bn_apply as bk

    gen = torch.Generator().manual_seed(5)
    x, r, g = (torch.randn(6, 16, 9, 7, generator=gen).contiguous(
        memory_format=torch.channels_last) for _ in range(3))
    s, b = torch.rand(16, generator=gen) + 0.5, torch.randn(16, generator=gen)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        ins = [t.to(dev).requires_grad_() for t in (x, s, b, r)]
        y = bk.BNApply.apply(ins[0], ins[1], ins[2], ins[3], True)
        grads.append(torch.autograd.grad(y, ins, g.to(dev)))
    for a, c in zip(*grads):
        assert float((a.cpu() - c).abs().max()) <= 1e-5


def test_small_resnet_train_steps_on_card_match_cpu(cuda):
    """The fx-imported small ResNet (stem 3->8, a downsampling and an
    identity Bottleneck) through compile, copy_weights and two SGD
    steps, float32 with TF32 off, on the card against the port's CPU
    run: every BatchNorm through P1 (8 launches per forward), losses,
    weights and running statistics within 1e-4 (cuDNN's and oneDNN's
    convolutions sum in other orders)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from flexflow_tpu_torch.ops.kernels import bn_apply as bk

    _, _, SmallResNet = chip_smoke.resnet_modules()
    torch.manual_seed(2)
    module = SmallResNet()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ffs = {dev: chip_smoke.build_resnet(torch, module, 4, 32, dev,
                                            "float32")
               for dev in ("cuda", "cpu")}
        rng = np.random.RandomState(2)
        x = rng.randn(8, 3, 32, 32).astype(np.float32)
        y = rng.randint(0, 10, 8).astype(np.int32)
        before = bk.bn_apply.launches
        losses = {dev: [float(ff.train_step({"input": x[4 * i:4 * i + 4]},
                                            y[4 * i:4 * i + 4])["loss"])
                        for i in range(2)] for dev, ff in ffs.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert bk.bn_apply.launches == before + 2 * 8
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                               atol=1e-4)
    for get in ("get_weights", "get_state"):
        g, c = getattr(ffs["cuda"], get)(), getattr(ffs["cpu"], get)()
        for op, entries in c.items():
            for k, v in entries.items():
                np.testing.assert_allclose(g[op][k], v, rtol=0, atol=1e-4,
                                           err_msg=f"{op}.{k}")
