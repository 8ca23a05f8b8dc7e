"""The port's CUDA kernels on the card: each held against its plain
PyTorch version, the flash kernels through their autograd Function, and
the paged decode step run through the paged-attention kernel; the
layer-op slice's Dropout on a CUDA generator, BatchMatmul and the small
ViT against the CPU; the zoo slice's prefetching loader (the card's
batches against the CPU's, a long shuffled epoch with no staging buffer
reused early), the MoE ops and a channels_last Concat against the CPU;
the sequence-model slice's LSTM, the dense decode twin and an ONNX
import on the card against the CPU; the speculative verify step on the
card against seq-1 stepping (bit for bit, row by row) and greedy tokens
under off, ngram and a self-drafter; the search slice's profiler (an
attention timed through K1, a failing launch that propagates) and a
small search costed on the card; the captured train step against the
eager one (losses and weights bit for bit, a learning rate changed
after the capture, a capture again after set_iteration_config, a
capture after a captured model was dropped in a reference cycle); a
strategy restored from the store, whose first step builds and captures
K1-K3; a checkpoint restored into a captured step's own tensors (with
its generator, under dropout), replays after it training the restored
state; an async save's pinned snapshot; a hung_step fault timing out the
watchdog; a profile window whose kernels sit in their ops' ranges; Keras
compile(devices=[0, 1]) on 4 ranks (chip_smoke's keras_devices leg, over
gloo and, with 4 cards, NCCL).  These
need a CUDA device and skip without one; on the GPU machine run
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


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("s", [1, 8, 16])
def test_paged_attention_kernel_on_long_rows(cuda, dtype, tol, s):
    """K4 split over pages at the serving table width (64 pages of 16,
    positions up to 1023): a scratch row (seq_len 0), a row ending
    mid-split, a row at the table's end and CoW-shared blocks, against
    the plain version in float32; two launches give the same bits."""
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk

    torch.manual_seed(s)
    rng = np.random.RandomState(s)
    dt = getattr(torch, dtype)
    page, width = 16, 64
    qh, kp, vp, bt, sl = _case(rng, 6, s, 12, 64, page, width, dt, cuda)
    span = pk.SPLIT_PAGES * page
    slen = sl.cpu().numpy()
    slen[1] = 3 * span + span // 2 + 5      # ends mid-split
    slen[2] = width * page - s              # its chunk ends at the table
    slen[3] = 1023 - s + 1
    sl = torch.tensor(slen, device=cuda)
    assert (pk.live_splits(slen, s, page, width) > 1).sum() >= 3
    runs = [pk.paged_attention(qh, kp, vp, bt, sl, 0.125) for _ in range(2)]
    ref = pk.paged_attention_plain(qh.float(), kp.float(), vp.float(), bt,
                                   sl, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert float((runs[0].float() - ref).abs().max()) <= tol


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_kernel_resources_and_bits(cuda, dtype, d):
    """K1 on the tensor cores: no local memory (spills), a block fits on
    an SM, and two launches at seq 2048 give the same bits and agree
    with the plain forward at FLASH_TOL."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    dt = getattr(torch, dtype)
    res = fa.bwd_resources("fwd", d, dt)
    assert res["local_bytes"] == 0 and res["blocks_per_sm"] >= 1, res
    (q, k, v, _), f, r_out, r_lse, _ = _backward_inputs(
        cuda, dtype, d, False, seed=20 + d)
    runs = [fa.flash_fwd(q, k, v, d ** -0.5, False) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert _flash_err(runs[0][0], r_out) <= FLASH_TOL[dtype]
    assert _flash_err(runs[0][1], r_lse) <= FLASH_TOL[dtype]


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


def test_verify_step_on_card_equals_seq1_stepping(cuda):
    """The speculative verify step through K4: each live position's
    logits equal the decode step's on the same pools bit for bit, a
    row's logits do not depend on the other rows (the same row alone
    gives the same bits), and one verify call launches K4 once per layer
    per fed position, spec_k + 1 in all; then off, ngram and the target
    as its own drafter give the same greedy tokens through the
    scheduler, with no degrade and no draft fault."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_gpt
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk
    from flexflow_tpu_torch.serving import (ContinuousScheduler,
                                            PagedKVDecodeModel)

    gpt = dict(batch_size=4, seq_length=64, hidden_size=128, num_layers=2,
               num_heads=2, intermediate_size=256, vocab_size=96)
    ff = FFModel(FFConfig(batch_size=4, device="cuda"))
    build_gpt(ff, **gpt)
    ff.compile(seed=5)
    k = 4
    model = PagedKVDecodeModel(ff, batch_slots=4, page_size=8,
                               num_blocks=33, spec_decode="ngram",
                               spec_k=k)
    rng = np.random.RandomState(0)
    btab = rng.permutation(np.arange(1, model.num_blocks))[:32].reshape(
        4, 8).astype(np.int32)
    lens = np.array([5, 17, 60, 30], np.int32)
    for t in range(int(lens.max())):
        live = t < lens
        model.step(rng.randint(0, 96, 4).astype(np.int32),
                   np.where(live, t, 0).astype(np.int32),
                   np.where(live[:, None], btab, 0).astype(np.int32))
    saved = {op: {n: v.clone() for n, v in e.items()}
             for op, e in model._state.items()}

    def restore():
        with torch.no_grad():
            for op, e in model._state.items():
                for n, v in e.items():
                    v.copy_(saved[op][n])

    tokens = rng.randint(0, 96, (4, k + 1)).astype(np.int32)
    counts = np.array([k + 1, 2, k + 1, k + 1], np.int32)
    before = pk.paged_attention.launches
    got = model.verify_step(tokens, lens, counts, btab)
    assert pk.paged_attention.launches - before == 2 * (k + 1)
    alone_counts = np.array([0, 0, 0, k + 1], np.int32)
    restore()
    alone = model.verify_step(tokens, lens, alone_counts,
                              np.where(alone_counts[:, None] > 0, btab, 0))
    assert np.array_equal(alone[3], got[3])
    restore()
    for j in range(k + 1):
        live = (j < counts) & (lens + j < 64)
        step = model.step(tokens[:, j], np.where(live, lens + j, 0),
                          np.where(live[:, None], btab, 0))
        for i in np.flatnonzero(live):
            assert np.array_equal(step[i], got[i, j]), (i, j)
    prompts = [[3, 9, 3, 9, 3, 9, 3], list(range(10, 40)), [7] * 5]
    outs = {}
    for mode, spec, draft in (("off", "off", None), ("ngram", "ngram", None),
                              ("draft_self", "draft", ff)):
        sched = ContinuousScheduler.from_trained(
            ff, batch_slots=4, page_size=8, prefill_chunk=4,
            spec_decode=spec, spec_k=k, draft_ff=draft,
            check_invariants=True)
        try:
            hs = [sched.generate_async(p, 16) for p in prompts]
            outs[mode] = [h.wait(300) for h in hs]
            st = sched.stats()["speculative"]
        finally:
            sched.close()
        assert st["verify_faults"] == 0 and not st["degraded"]
        assert not st["proposer"].get("dead", False)
        assert not st["proposer"].get("draft_faults", 0)
    assert outs["ngram"] == outs["off"] == outs["draft_self"]


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


def test_dropout_on_a_cuda_generator(cuda):
    """One seed of a CUDA generator gives one mask; the kept share lies
    within 5 sigma of 1 - rate over 2^20 elements; kept values are
    scaled by 1 / (1 - rate)."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=256, device="cpu"))  # builds the op
    op = ff.dropout(ff.create_tensor([256, 4096], name="x"), 0.1).owner_op
    x = torch.rand(256, 4096, device=cuda) + 0.5

    def run(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return op.forward([x], [], training=True, generator=g)[0]

    a, b, c = run(3), run(3), run(4)
    assert a.device == x.device
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    sigma = (0.9 * 0.1 / x.numel()) ** 0.5
    assert abs(float(kept.float().mean()) - 0.9) <= 5 * sigma
    assert torch.equal(a[kept], (x / 0.9)[kept])


def test_batch_matmul_on_card_matches_cpu(cuda):
    """torch.matmul through the op, float32 with TF32 off: cuBLAS against
    the CPU's GEMM within 1e-5 (other summation orders over k = 64)."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=8, device="cpu"))  # builds the op
    op = ff.batch_matmul(ff.create_tensor([8, 12, 196, 64], name="a"),
                         ff.create_tensor([8, 12, 64, 196], name="b")
                         ).owner_op
    gen = torch.Generator().manual_seed(6)
    a = torch.randn(8, 12, 196, 64, generator=gen)
    b = torch.randn(8, 12, 64, 196, generator=gen)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (got,) = op.forward([a.to(cuda), b.to(cuda)], [])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (want,) = op.forward([a, b], [])
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))


def test_small_vit_forward_on_card_matches_cpu(cuda):
    """chip_smoke.py's SmallViT through the fx importer, float32 with
    TF32 off: logits on the card against the port's CPU run within 1e-4
    (cuBLAS's and cuDNN's sums against the CPU's)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    _, SmallViT = chip_smoke.vit_modules()
    torch.manual_seed(3)
    module = SmallViT()
    x = np.random.RandomState(3).randn(4, 3, 32, 32).astype(np.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = {dev: chip_smoke.build_vit(module, 4, 32, dev, "float32")
               .forward({"input": x}).cpu().numpy()
               for dev in ("cuda", "cpu")}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=0, atol=1e-4)


def _loader_model(device, batch):
    from flexflow_tpu_torch import AggrMode, FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=batch, device=device))
    x = ff.create_tensor([batch, 3, 8, 8], name="x")
    ids = ff.create_tensor([batch, 2], dtype="int32", name="ids")
    e = ff.embedding(ids, 10, 4, aggr=AggrMode.SUM, name="emb")
    t = ff.concat([ff.flat(ff.conv2d(x, 2, 3, 3, 1, 1, 1, 1)), e], axis=-1)
    ff.softmax(ff.dense(t, 3))
    ff.compile()
    return ff


def test_loader_batches_on_card_equal_cpu_batches(cuda):
    """Two shuffled epochs at prefetch 2, float64 and int64 narrowed on
    the host: every card batch equals the CPU loader's, in dtype too."""
    from flexflow_tpu_torch import SingleDataLoader

    rng = np.random.RandomState(0)
    x = {"x": rng.randn(40, 3, 8, 8), "ids": rng.randint(0, 10, (40, 2))}
    y = rng.randint(0, 3, 40)
    loaders = {dev: SingleDataLoader(_loader_model(dev, 8), x, y,
                                     batch_size=8, shuffle=True, seed=2)
               for dev in ("cuda", "cpu")}
    for _ in range(2):
        for (gx, gy), (cx, cy) in zip(*(list(ld) for ld in
                                        loaders.values())):
            assert gy.is_cuda and gy.dtype == cy.dtype == torch.int32
            assert torch.equal(gy.cpu(), cy)
            for k in cx:
                assert gx[k].is_cuda and gx[k].dtype == cx[k].dtype
                assert torch.equal(gx[k].cpu(), cx[k])


def test_loader_reuses_no_staging_buffer_early(cuda):
    """A long shuffled epoch at prefetch 3 (a ring of 5 pinned buffers)
    while the card is kept busy between batches: each batch holds the
    rows its indices name, so no buffer was gathered into before its
    copy had landed."""
    from flexflow_tpu_torch import SingleDataLoader

    n, b = 4096, 16
    x = {"x": np.arange(n * 192, dtype=np.float32).reshape(n, 3, 8, 8),
         "ids": np.zeros((n, 2), np.int32)}
    y = np.arange(n, dtype=np.int32)
    ff = _loader_model("cuda", b)
    loader = SingleDataLoader(ff, x, y, batch_size=b, shuffle=True, seed=5,
                              prefetch=3)
    busy = torch.randn(2048, 2048, device=cuda)
    for i, (bx, by) in enumerate(loader):
        busy = busy @ busy * 1e-3  # keep the compute stream behind
        rows = loader._order[i * b:(i + 1) * b]
        assert torch.equal(by.cpu(), torch.from_numpy(y[rows]))
        assert torch.equal(bx["x"].cpu(), torch.from_numpy(x["x"][rows]))
    assert i + 1 == n // b and len(loader._ring) == 5


def test_moe_ops_on_card_match_cpu(cuda):
    """TopK, GroupBy (with drops), ExpertsDense and Aggregate with the
    balance loss, forward and grads: the card against the CPU within
    1e-5 (the dispatch moves rows exactly; index_add's order on the card
    adds only zero rows to a shared slot)."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=64, device="cpu"))
    x = ff.create_tensor([64, 32], name="x")
    gate = ff.softmax(ff.dense(x, 5))
    values, assign = ff.top_k(gate, 2)
    grouped = ff.group_by(x, assign, 5, 0.5)
    hidden = ff.experts_dense(grouped, 16)
    ff.aggregate(values, assign, gate, hidden, 5, 0.04)
    ops = [t.owner_op for t in (values, grouped, hidden)]
    agg = ff.layers.sink_op()
    gen = torch.Generator().manual_seed(0)
    xin = torch.randn(64, 32, generator=gen)
    logits = torch.randn(64, 5, generator=gen)
    w = torch.randn(5, 32, 16, generator=gen)
    bias = torch.randn(5, 16, generator=gen)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        xs = xin.to(dev).requires_grad_()
        g = torch.softmax(logits.to(dev).requires_grad_(), -1)
        ws = [w.to(dev).requires_grad_(), bias.to(dev).requires_grad_()]
        v, a = ops[0].forward([g], [])
        grp = ops[1].forward([xs, a], [])[0]
        hid = ops[2].forward([grp], ws)[0]
        (y,) = agg.forward([v, a, g, hid], [])
        total = (y * y).sum() + agg._last_aux
        grads = torch.autograd.grad(total, [xs] + ws)
        out[dev.type] = [a, y, agg._last_aux] + list(grads)
    for got, want in zip(out["cuda"], out["cpu"]):
        got = got.detach().cpu()
        if not want.is_floating_point():
            assert torch.equal(got, want)
            continue
        want = want.detach()
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_channels_last_concat_on_card(cuda):
    """A Concat between channels_last edges runs NHWC on the card: its
    output is channels_last and equals the CPU's."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=2, device="cpu"))
    a = ff.create_tensor([2, 3, 5, 5], name="a")
    b = ff.create_tensor([2, 4, 5, 5], name="b")
    op = ff.concat([a, b], axis=1).owner_op
    gen = torch.Generator().manual_seed(1)
    ins = [torch.randn(2, 3, 5, 5, generator=gen),
           torch.randn(2, 4, 5, 5, generator=gen)]
    cl = [t.to(cuda).contiguous(memory_format=torch.channels_last)
          for t in ins]
    (got,) = op.forward(cl, [])
    assert got.is_contiguous(memory_format=torch.channels_last)
    (want,) = op.forward(ins, [])
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("pool,k,stride,pad", [("avg", 3, 1, 1),
                                               ("avg", 3, 2, 1),
                                               ("max", 3, 2, 1)])
def test_padded_pool_grads_on_card_match_cpu(cuda, pool, k, stride, pad):
    """Pool2D on a channels_last input with padding (Inception's 3x3 avg
    pools): output and input grads on the card against the CPU within
    1e-6.  torch's own padded avg_pool2d back-propagates wrongly over a
    channels_last input on the card; Pool2D pads explicitly instead."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=8, device="cpu"))
    op = ff.pool2d(ff.create_tensor([8, 64, 17, 17], name="x"), k, k,
                   stride, stride, pad, pad, pool_type=pool).owner_op
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(8, 64, 17, 17, generator=gen)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        xi = x.to(dev)
        if dev.type == "cuda":
            xi = xi.contiguous(memory_format=torch.channels_last)
        xi.requires_grad_()
        (y,) = op.forward([xi], [])
        gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
        (dx,) = torch.autograd.grad(y, xi, gy.to(dev))
        out[dev.type] = (y.detach().cpu(), dx.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        assert float((got - want).abs().max()) <= 1e-6 * max(
            1.0, float(want.abs().max()))


def test_lstm_on_card_matches_cpu(cuda):
    """The LSTM op's forward and its grads over input, kernel and bias on
    the card against the CPU, float32 with TF32 off, within 1e-5 of the
    scale (cuBLAS's and MKL's GEMMs sum in other orders over 50 steps)."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=8, device="cpu"))
    op = ff.lstm(ff.create_tensor([8, 50, 32], name="x"), 64).owner_op
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(8, 50, 32, generator=gen)
    k = 0.2 * torch.randn(96, 256, generator=gen)
    b = 0.1 * torch.randn(256, generator=gen)
    gy = torch.randn(8, 50, 64, generator=gen)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            ins = [t.to(dev).requires_grad_() for t in (x, k, b)]
            (y,) = op.forward(ins[:1], ins[1:])
            grads = torch.autograd.grad(y, ins, gy.to(dev))
            out[dev] = [y.detach().cpu()] + [g.cpu() for g in grads]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for got, want in zip(out["cuda"], out["cpu"]):
        assert float((got - want).abs().max()) <= 1e-5 * max(
            1.0, float(want.abs().max()))


def test_dense_decode_step_on_card_matches_cpu(cuda):
    """A small GPT's dense decode twin: 6 decode steps on the card
    against the CPU with the same weights (logits and caches within
    1e-5 of the scale, TF32 off); the caches stay on the card and are
    written in place; greedy tokens of gpt_generate_cached and
    gpt_generate_scan equal on both devices."""
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel
    from flexflow_tpu_torch import decoding as D
    from flexflow_tpu_torch.models.transformer import build_gpt

    kw = dict(batch_size=4, seq_length=16, hidden_size=64, num_layers=2,
              num_heads=4, intermediate_size=128, vocab_size=97)
    ffs = {}
    for dev in ("cuda", "cpu"):
        ff = FFModel(FFConfig(batch_size=4, device=dev))
        build_gpt(ff, **kw)
        ff.compile(comp_mode=CompMode.INFERENCE)
        ffs[dev] = ff
    ffs["cuda"].set_weights(ffs["cpu"].get_weights())
    decs = {dev: D.make_gpt_decoder(ff) for dev, ff in ffs.items()}
    ids = np.random.RandomState(5).randint(0, 97, (4, 6)).astype(np.int32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cache = decs["cuda"]._state["attn_0"]["k_cache"]
        logits = {dev: [] for dev in decs}
        for dev, ffd in decs.items():
            ffd.reset_decode_state()
            for t in range(6):
                logits[dev].append(ffd.decode_step({
                    "input": ids[:, t:t + 1],
                    "positions": np.full((4, 1), t, np.int32)}).cpu())
        assert decs["cuda"]._state["attn_0"]["k_cache"] is cache
        assert cache.is_cuda
        for a, c in zip(logits["cuda"], logits["cpu"]):
            assert float((a - c).abs().max()) <= 1e-5 * max(
                1.0, float(c.abs().max()))
        g, c = decs["cuda"].get_state(), decs["cpu"].get_state()
        for op, entries in c.items():
            for k, v in entries.items():
                np.testing.assert_allclose(g[op][k], v, rtol=0, atol=1e-5)
        toks = {dev: (D.gpt_generate_cached(ffd, ids[:, :3], 8),
                      D.gpt_generate_scan(ffd, ids[:, :3], 8))
                for dev, ffd in decs.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, c in zip(toks["cuda"], toks["cpu"]):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(*toks["cuda"])


def test_onnx_import_on_card_runs_p1(cuda):
    """chip_smoke's small ResNet as ONNX wire bytes (the port's
    protowire), imported with ONNXModel and copy_weights on the card:
    eval-mode forward against the torch module (1e-4 of the scale, TF32
    off), every BatchNorm through P1 (8 launches per forward), and two
    SGD steps against the port's CPU run within 1e-4."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.onnx_frontend import ONNXModel, module_to_onnx
    from flexflow_tpu_torch.ops.kernels import bn_apply as bk

    _, _, SmallResNet = chip_smoke.resnet_modules()
    torch.manual_seed(3)
    module = SmallResNet()
    with torch.no_grad():
        module.train()
        module(torch.randn(8, 3, 32, 32))
    module.eval()
    wire = module_to_onnx(module, (4, 3, 32, 32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ffs = {}
        for dev in ("cuda", "cpu"):
            ff = FFModel(FFConfig(batch_size=4, device=dev))
            m = ONNXModel(wire)
            m.apply(ff, [ff.create_tensor([4, 3, 32, 32], name="input")])
            ff.compile(optimizer=SGDOptimizer(lr=0.01))
            m.copy_weights(ff)
            ffs[dev] = ff
        rng = np.random.RandomState(3)
        x = rng.randn(4, 3, 32, 32).astype(np.float32)
        before = bk.bn_apply.launches
        got = ffs["cuda"].forward({"input": x}).cpu()
        assert bk.bn_apply.launches == before + 8
        with torch.no_grad():
            want = module(torch.from_numpy(x))
        assert float((got - want).abs().max()) <= 1e-4 * max(
            1.0, float(want.abs().max()))
        y = rng.randint(0, 10, 4).astype(np.int32)
        losses = {dev: [float(ff.train_step({"input": x}, y)["loss"])
                        for _ in range(2)] for dev, ff in ffs.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                               atol=1e-4)


def _attention_op(seq: int, heads: int = 4, embed: int = 256):
    from flexflow_tpu_torch.ops.attention import (MultiHeadAttention,
                                                  MultiHeadAttentionParams)
    from flexflow_tpu_torch.tensor import ParallelTensor, ParallelTensorShape

    q = ParallelTensor(ParallelTensorShape.make([2, seq, embed]))
    return MultiHeadAttention(MultiHeadAttentionParams(embed, heads),
                              [q, q, q], name="attn")


def test_profiler_times_attention_through_k1(cuda):
    from flexflow_tpu_torch import profiler
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    op = _attention_op(2048)
    before = fa.flash_fwd.launches
    t = profiler.measure_op_forward(op, device=cuda, repeats=2, chain=4,
                                    flash_min_seq=2048)
    assert t is not None and t > 0
    assert fa.flash_fwd.launches - before == 1 + 2 * 4  # warm-up, windows
    assert op._flash_min_seq == 2048


def test_profiler_propagates_a_failing_launch(cuda, monkeypatch):
    """A kernel whose launch fails on the card raises through the
    profiler: only an op that cannot run on its own may return None."""
    from flexflow_tpu_torch import profiler
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    real = fa.load_library()

    class FailingLaunch:
        def __getattr__(self, name):
            return getattr(real, name)

        def ff_flash_fwd(self, *args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(fa, "load_library", lambda: FailingLaunch())
    measurer = profiler.make_measure_fn(device=cuda, flash_min_seq=0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        measurer(_attention_op(256))
    assert measurer.measured == 0 and measurer.unmeasurable == []


def test_small_search_is_costed_on_the_card(cuda, tmp_path):
    """unity_search over the HGX node file with search_calibrate on: the
    ops are timed on the card (attention through K1 at flash_min_seq
    0), keyed by the card's name."""
    import json

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_bert
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.pcg.search import unity_search
    from flexflow_tpu_torch.sim.machine_model import machine_file

    cache = tmp_path / "costs.json"
    ff = FFModel(FFConfig(batch_size=8, device="cuda", search_budget=10,
                          search_calibrate=True, flash_min_seq=0,
                          op_cost_cache_file=str(cache),
                          machine_model_file=machine_file("hgx_h100_8")))
    build_bert(ff, batch_size=8, seq_length=256, hidden_size=256,
               num_layers=2, num_heads=4, intermediate_size=1024)
    before = fa.flash_fwd.launches
    best = unity_search(ff, 8)
    assert best.total_devices == 8
    assert best.search_stats["measured_ops"] > 0
    assert fa.flash_fwd.launches > before
    keys = list(json.loads(cache.read_text()))
    assert keys and all(k.split("|")[1] == torch.cuda.get_device_name(0)
                        for k in keys)


def _small_bert_pair(capture_modes, **cfg):
    """The same 2-layer BERT (seq 256, the flash branch) once per entry
    of `capture_modes`, all from the first one's weights."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_bert

    out, weights = [], None
    for capture in capture_modes:
        ff = FFModel(FFConfig(batch_size=2, device="cuda", flash_min_seq=0,
                              **cfg))
        build_bert(ff, batch_size=2, seq_length=256, hidden_size=128,
                   num_layers=2, num_heads=2, intermediate_size=256)
        ff.compile(seed=0)
        if not capture:
            ff._step_fn = ff.executor.build_step(capture=False)
        if weights is None:
            weights = ff.get_weights()
        ff.set_weights(weights)
        out.append(ff)
    return out


def test_captured_step_matches_the_eager_step(cuda):
    """Five train_steps eager and captured (one warm-up, the capture and
    its replay, three replays) from the same weights and batches make
    five updates each: the same losses and weights bit for bit (the same
    kernels in the same order); the capture counted K1-K3 once per layer,
    which every replay launches again."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    eager, graph = _small_bert_pair((False, True))
    rng = np.random.RandomState(1)
    batches = [(rng.randn(2, 256, 128).astype(np.float32),
                rng.randint(0, 2, (2, 1)).astype(np.int32))
               for _ in range(5)]
    before = fa.flash_fwd.launches
    want = [float(eager.train_step({"input": x}, y)["loss"])
            for x, y in batches]
    assert fa.flash_fwd.launches == before + 5 * 2
    before = fa.flash_fwd.launches
    got = [float(graph.train_step({"input": x}, y)["loss"])
           for x, y in batches]
    assert fa.flash_fwd.launches == before + 2 * 2
    assert got == want
    st = graph.executor.capture_status
    assert st["mode"] == "graph" and st["warmup_steps"] == 1
    assert st["captures"] == 1 and st["replays"] == 4
    assert st["launches_at_capture"]["K1"] == 2
    we, wg = eager.get_weights(), graph.get_weights()
    for op, entries in we.items():
        for k, v in entries.items():
            np.testing.assert_array_equal(wg[op][k], v)


def test_captured_step_takes_a_new_learning_rate(cuda):
    """set_learning_rate after the capture reaches the replays (the
    update reads the rate from its device tensor): the captured run's
    losses equal the eager run's with the same change."""
    eager, graph = _small_bert_pair((False, True))
    rng = np.random.RandomState(2)
    x = rng.randn(2, 256, 128).astype(np.float32)
    y = rng.randint(0, 2, (2, 1)).astype(np.int32)
    losses = []
    for ff in (eager, graph):
        run = []
        for i in range(5):
            if i == 3:
                ff.set_learning_rate(0.5)
            run.append(float(ff.train_step({"input": x}, y)["loss"]))
        losses.append(run)
    assert losses[0] == losses[1]
    assert graph.executor.capture_status["replays"] == 4


def test_captured_step_is_captured_again_after_set_iteration_config(cuda):
    """A new iteration length changes what the step bakes in on the host,
    so the next calls warm up and capture again."""
    (ff,) = _small_bert_pair((True,))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 256, 128).astype(np.float32)
    y = rng.randint(0, 2, (2, 1)).astype(np.int32)
    for _ in range(3):
        ff.train_step({"input": x}, y)
    ff.set_iteration_config(128)
    for _ in range(3):
        ff.train_step({"input": x}, y)
    st = ff.executor.capture_status
    assert (st["warmup_steps"], st["captures"], st["replays"]) == (2, 2, 4)


def test_capture_survives_a_dead_graph_in_a_cycle(cuda):
    """A captured model dropped while a reference cycle keeps it alive is
    destroyed by the cyclic collector; run at every allocation, the
    collector would destroy its graph (freeing the graph's pool) in the
    middle of the next model's capture, which invalidates that capture.
    The capture collects before and keeps the collector off during it."""
    import gc

    for _ in range(2):
        (ff,) = _small_bert_pair((True,))
        ff._self_cycle = ff  # kept alive until the cyclic collector runs
        rng = np.random.RandomState(4)
        x = rng.randn(2, 256, 128).astype(np.float32)
        y = rng.randint(0, 2, (2, 1)).astype(np.int32)
        threshold = gc.get_threshold()
        gc.set_threshold(1, 1, 1)
        try:
            losses = [float(ff.train_step({"input": x}, y)["loss"])
                      for _ in range(3)]
        finally:
            gc.set_threshold(*threshold)
        assert np.isfinite(losses).all()
        assert ff.executor.capture_status["replays"] == 2
        del ff


def test_a_restored_strategy_captures_and_runs_the_flash_kernels(cuda,
                                                                 tmp_path):
    """A strategy restored from the store skips the search, so no kernel
    runs before the first step: the captured step's warm-up still builds
    and launches K1-K3, the capture counts them once per layer, and the
    restored model trains the searched one's losses bit for bit."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    kw = dict(search_budget=4, strategy_store=str(tmp_path / "store"),
              op_cost_cache_file=str(tmp_path / "costs.json"))
    (searched,) = _small_bert_pair((True,), **kw)
    weights = searched.get_weights()
    before = fa.flash_fwd.launches
    (restored,) = _small_bert_pair((True,), **kw)
    assert fa.flash_fwd.launches == before  # no op timed
    assert restored.strategy.search_stats["store_hit"] is True
    assert searched.strategy.search_stats["store_hit"] is False
    restored.set_weights(weights)
    rng = np.random.RandomState(2)
    batches = [(rng.randn(2, 256, 128).astype(np.float32),
                rng.randint(0, 2, (2, 1)).astype(np.int32))
               for _ in range(3)]
    got = [float(restored.train_step({"input": x}, y)["loss"])
           for x, y in batches]
    st = restored.executor.capture_status
    assert st["mode"] == "graph" and st["captures"] == 1
    assert all(st["launches_at_capture"][k] == 2 for k in ("K1", "K2", "K3"))
    want = [float(searched.train_step({"input": x}, y)["loss"])
            for x, y in batches]
    assert got == want


# -- checkpoints and telemetry on the card ------------------------------------

def _res_bert(seed, dropout=0.0, **cfg):
    """A 2-layer BERT under Adam, seq 256: the flash branch, or with
    attention dropout the dense one (its draws from the generator)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_bert

    ff = FFModel(FFConfig(batch_size=2, device="cuda", flash_min_seq=0,
                          seed=seed, **cfg))
    build_bert(ff, batch_size=2, seq_length=256, hidden_size=128,
               num_layers=2, num_heads=2, intermediate_size=256,
               dropout=dropout)
    ff.compile(optimizer=AdamOptimizer(alpha=1e-3), seed=seed)
    return ff


def _res_batches(n, seed=5):
    rng = np.random.RandomState(seed)
    return [({"input": rng.randn(2, 256, 128).astype(np.float32)},
             rng.randint(0, 2, (2, 1)).astype(np.int32)) for _ in range(n)]


def _state(ff):
    from flexflow_tpu_torch.checkpoint import _Snapshot

    return _Snapshot(ff, own=True).arrays()


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind,dropout", [("local", 0.0), ("dcp", 0.0),
                                          ("local", 0.1)])
def test_a_replay_after_a_restore_trains_the_restored_state(cuda, tmp_path,
                                                            kind, dropout):
    """A model captured on its own weights restores a checkpoint: the
    weights, Adam's slots and step and the generator are written into
    the tensors the graph replays on, so the replays after it train the
    restored state (and, under dropout, draw what the uninterrupted run
    draws): losses and state bit for bit."""
    from flexflow_tpu_torch.checkpoint import (CheckpointManager,
                                               LocalCheckpointManager)

    cls = LocalCheckpointManager if kind == "local" else CheckpointManager
    batches = _res_batches(6)
    a = _res_bert(0, dropout)
    for inputs, labels in batches[:3]:
        a.train_step(inputs, labels)
    cls(str(tmp_path)).save(a, 3)
    want = [float(a.train_step(*b)["loss"]) for b in batches[3:]]
    b = _res_bert(1, dropout)
    for inputs, labels in batches[:2]:
        b.train_step(inputs, labels)  # the warm-up, the capture
    st = b.executor.capture_status
    assert st["mode"] == "graph" and st["captures"] == 1
    assert cls(str(tmp_path)).restore(b) == 3
    got = [float(b.train_step(*x)["loss"]) for x in batches[3:]]
    assert st["captures"] == 1 and st["replays"] >= 3
    assert got == want
    _assert_state_equal(_state(b), _state(a))


def test_an_async_save_on_the_card_owns_its_snapshot(cuda, tmp_path):
    """save(wait=False) copies to pinned memory behind an event and
    returns; the steps after it update the weights in place while the
    writer runs: what lands is the state at the save."""
    from flexflow_tpu_torch.checkpoint import LocalCheckpointManager

    batches = _res_batches(4)
    a = _res_bert(0)
    for x in batches[:2]:
        a.train_step(*x)
    want = _state(a)
    mgr = LocalCheckpointManager(str(tmp_path))
    mgr.save(a, 2, wait=False)
    for x in batches[2:]:
        a.train_step(*x)
    assert mgr.drain() == []
    b = _res_bert(1)
    mgr.restore(b)
    _assert_state_equal(_state(b), want)


def test_a_hung_step_fault_times_out_the_watchdog(cuda):
    """A HUNG_STEP fault holds the stream past the step: the read of the
    step's loss outlives the watchdog's deadline, HungStepTimeout comes
    at the deadline, and the stream finishes after it."""
    import time

    from flexflow_tpu_torch.executor import check_step_health
    from flexflow_tpu_torch.resilience import (FaultKind, FaultPlan,
                                               HungStepTimeout, StepWatchdog)

    ff = _res_bert(0)
    (x,) = _res_batches(1)
    plan = FaultPlan.single(0, FaultKind.HUNG_STEP)
    m = ff.train_step(*x)
    assert plan.hang_device(0, ff.device, 3.0)
    t0 = time.perf_counter()
    with pytest.raises(HungStepTimeout):
        check_step_health(m, step=0, watchdog=StepWatchdog(1.0))
    assert 1.0 <= time.perf_counter() - t0 < 1.5
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"]))


def test_the_profile_window_attributes_the_flash_kernels(cuda, tmp_path):
    """profile_steps "2:2" over a captured fit: the window's steps are
    replays like the others, the exported trace parses and holds K1-K3
    once per layer per step, each launched by a cudaGraphLaunch, and
    the map the warm-up recorded marks each with its attn_* op."""
    import json

    ff = _res_bert(0, trace_dir=str(tmp_path), profile_steps="2:2")
    rng = np.random.RandomState(5)
    x = rng.randn(10, 256, 128).astype(np.float32)
    y = rng.randint(0, 2, (10, 1)).astype(np.int32)
    ff.fit(x, y, batch_size=2, epochs=1, verbose=False)
    st = ff.executor.capture_status
    assert st["captures"] == 1 and st["replays"] == 4  # steps 1 to 4
    assert st["kernel_ops"]
    tel = ff.telemetry
    assert tel.attribution["replays"] == 2
    with open(tel.profile_path) as f:
        events = json.load(f)["traceEvents"]
    graphs = {e["args"]["correlation"] for e in events
              if e.get("name") == "cudaGraphLaunch"}
    for tag in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel"):
        ks = [e for e in events
              if e.get("cat") == "kernel" and tag in e.get("name", "")]
        assert len(ks) == 2 * 2, tag
        for e in ks:
            assert e["args"]["correlation"] in graphs, tag
            assert e["args"]["op"].startswith("attn_"), (tag, e["args"])


# -- the supervised path ---------------------------------------------------

def _captured_pair():
    """Two 2-layer BERTs from the same seed, each captured (a warm-up, the
    capture, a replay) on the same three batches."""
    pair = [_res_bert(0), _res_bert(0)]
    for ff in pair:
        for inputs, labels in _res_batches(3):
            ff.train_step(inputs, labels)
        assert ff.executor.capture_status["replays"] == 2
    return pair


def test_skip_step_rollback_keeps_the_captured_tensors(cuda, tmp_path):
    """nan_policy skip_step on a captured step: the rollback copies the
    snapshot into the tensors the graph replays on (their data_ptrs do
    not move), and the next replay trains the rolled-back state, equal to
    a twin that never saw the poisoned batch."""
    from flexflow_tpu_torch.checkpoint import _state_leaves
    from flexflow_tpu_torch.resilience import TrainingSupervisor

    ff, twin = _captured_pair()
    sup = TrainingSupervisor(ff, str(tmp_path), nan_policy="skip_step")
    ptrs = [t.data_ptr() for _, t, _, _ in _state_leaves(ff)]
    before = _state(ff)
    snap = sup._snapshot()
    (inputs, labels), = _res_batches(1, seed=6)
    poisoned = {k: np.full_like(v, np.nan) for k, v in inputs.items()}
    assert not np.isfinite(float(ff.train_step(poisoned, labels)["loss"]))
    sup._rollback(snap)
    assert [t.data_ptr() for _, t, _, _ in _state_leaves(ff)] == ptrs
    _assert_state_equal(_state(ff), before)
    got = float(ff.train_step(inputs, labels)["loss"])
    want = float(twin.train_step(inputs, labels)["loss"])
    assert got == want
    _assert_state_equal(_state(ff), _state(twin))
    assert ff.executor.capture_status["replays"] == 4


def test_recompile_captures_again(cuda):
    """FFModel.recompile drops the captured step before it builds the new
    one, carries the state 0 apart, and the new step is captured again
    and trains as a twin that was never recompiled; twice, with the
    cyclic collector run at every allocation (a dead graph destroyed
    during the new capture would invalidate it)."""
    import gc

    ff, twin = _captured_pair()
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for round_ in range(2):
            before = _state(ff)
            ff.recompile()
            st = ff.executor.capture_status
            assert st["mode"] == "graph" and st["captures"] == 0
            _assert_state_equal(_state(ff), before)
            for inputs, labels in _res_batches(3, seed=7 + round_):
                got = float(ff.train_step(inputs, labels)["loss"])
                want = float(twin.train_step(inputs, labels)["loss"])
                assert got == want
            assert st["captures"] == 1 and st["replays"] == 2
            _assert_state_equal(_state(ff), _state(twin))
    finally:
        gc.set_threshold(*threshold)


def test_a_reformed_group_runs_its_nccl_collectives(cuda, tmp_path):
    """Four NCCL ranks, one card each: an all-reduce, then
    distributed.reform_group onto ranks 0-1 (the supervisor's elastic
    path); the two survivors all-reduce over the new group of 2, the
    others leave."""
    import multiprocessing as mp
    import os
    import pickle
    import sys

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices: one NCCL rank per card")
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_dist_ranks as G

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=G.nccl_reform_rank,
                         args=(r, 4, str(tmp_path / "s1"),
                               str(tmp_path / "s2"), str(tmp_path)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(180)
    for p in procs:
        if p.is_alive():
            p.kill()
    results = []
    for r in range(4):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", value
        results.append(value)
    assert [first for first, _, _ in results] == [10.0] * 4
    assert [new for _, new, _ in results] == [0, 1, None, None]
    assert [second for _, _, second in results[:2]] == [(2, "nccl", 3.0)] * 2


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_keras_compile_on_devices_leaves_and_trains(cuda, tmp_path, backend):
    """chip_smoke's keras_devices leg on 4 ranks: Keras compile(devices=
    [0, 1]) over gloo (the ranks share the cards) or NCCL (a card each):
    ranks 2-3 leave the group and their fit raises; ranks 0-1 train the
    MLP example as the 2-card run on the re-formed group
    (chip_smoke._keras_devices_record: losses and weights within
    MULTIGPU_TOL, no kernel launch)."""
    import multiprocessing as mp
    import os
    import pickle
    import sys

    if backend == "nccl" and torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices: one NCCL rank per card")
    here = os.path.dirname(__file__)
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))
    import chip_smoke
    import torch_dist_ranks as G

    job = chip_smoke._keras_devices_job(torch, str(tmp_path))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=G.keras_devices_rank,
                         args=(r, 4, str(tmp_path / "store"), backend, job,
                               str(tmp_path)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    ranks = []
    for r in range(4):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", value
        ranks.append(value)
    rec = chip_smoke._keras_devices_record(ranks, str(tmp_path))
    assert rec["faults"] == []
    assert rec["left"] == [2, 3]
    assert all(s >= 0 for s in rec["reform_s"])


def _serving_gpt(cuda):
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_gpt

    ff = FFModel(FFConfig(batch_size=4, device="cuda"))
    build_gpt(ff, batch_size=4, seq_length=64, hidden_size=128,
              num_layers=2, num_heads=2, intermediate_size=256,
              vocab_size=96)
    ff.compile(seed=5)
    cfg = ff.config
    cfg.serving_slots, cfg.kv_page_size, cfg.prefill_chunk = 4, 8, 4
    return ff


def test_a_handoff_between_engines_on_the_card_equals_seq1(cuda):
    """Two replicas of one front on the card, each engine on a stream of
    its own: import_block writes in place (every pool keeps its
    data_ptr), and a generation paused after 21 written tokens (two
    pages of 8 and a 5-token tail), its blocks migrated and its tail
    imported, completes as seq-1 stepping does on one engine alone."""
    from flexflow_tpu_torch.serving import (ContinuousScheduler,
                                            PagedKVDecodeModel,
                                            ServingFront)

    ff = _serving_gpt(cuda)
    prompt = [3, 9, 4, 1, 7, 7, 2, 30, 11, 5, 61, 8, 40]
    alone = ContinuousScheduler(PagedKVDecodeModel(
        ff, batch_slots=4, page_size=8, prefill_chunk=0))
    try:
        want = alone.generate(prompt, 24, timeout=60)
    finally:
        alone.close()
    front = ServingFront.from_trained(ff, num_replicas=2, handoff=True,
                                      check_invariants=True)
    try:
        models = [r.scheduler.model._model for r in front.replicas]
        assert models[0].stream is not models[1].stream
        ptrs = [{(op, k): v.data_ptr() for op, e in m._state.items()
                 for k, v in e.items()} for m in models]
        armed = [True]
        for r, m in zip(front.replicas, models):
            real = m.step

            def step(tokens, slens, btab, _real=real, _r=r):
                out = _real(tokens, slens, btab)
                if armed[0] and 20 in [int(x) for x in slens]:
                    armed[0] = False
                    _r.request_handoff(remaining_over=0, export_kv=True)
                return out

            m.step = step
        got = front.generate(prompt, 24, timeout=60)
        ho = front.stats()["handoff"]
        for m, before in zip(models, ptrs):
            assert {(op, k): v.data_ptr() for op, e in m._state.items()
                    for k, v in e.items()} == before
    finally:
        front.close()
    assert got == want
    assert ho["requested"] == ho["ok"] == 1 and ho["replays"] == 0


def test_a_stalled_replica_dies_alone(cuda):
    """A HUNG_STEP stalls replica 0's stream past the watchdog: replica
    0 dies and restarts once, replica 1 (its own stream) never waits on
    the stall, and every completion equals the uninterrupted run's."""
    import time

    from flexflow_tpu_torch.resilience.faults import FaultKind, FaultPlan
    from flexflow_tpu_torch.serving import ServingFront

    ff = _serving_gpt(cuda)
    prompts = [[5 + i, 9, 2, 7 * i % 96] for i in range(6)]
    oracle = ServingFront.from_trained(ff, num_replicas=2)
    try:
        want = [h.wait(60) for h in [oracle.generate_async(p, 20)
                                     for p in prompts]]
    finally:
        oracle.close()
    front = ServingFront.from_trained(
        ff, num_replicas=2, step_timeout=1.0, retry_backoff=0.0,
        fault_plans={0: FaultPlan.single(8, FaultKind.HUNG_STEP)})
    try:
        got = [h.wait(60) for h in [front.generate_async(p, 20)
                                    for p in prompts]]
        r0, r1 = front.replicas
        for _ in range(300):
            if r0.restarts:
                break
            time.sleep(0.05)
        assert r0.deaths == r0.restarts == 1
        assert r0.stats()["hung_dispatches"] in ({"step": 1},
                                                 {"prefill": 1})
        assert r1.deaths == 0
    finally:
        front.close()
        torch.cuda.synchronize()
    assert got == want
