"""The port's CUDA kernels on the card: each held against its plain
PyTorch version, and the paged decode step run through the kernel.
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
