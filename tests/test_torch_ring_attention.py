"""Ring attention (flexflow_tpu_torch/parallel/ring_attention.py) against
flexflow_tpu.parallel.ring_attention on the CPU: forward and grads,
causal and not, the flash ring (the kernels' plain versions per block)
and the dense ring, over a 4-rank `seq` axis; and a DP x SP BERT over 2
SGD steps through the executor (the second through fit, whose loader
cuts each rank's batch and sequence shard).

The port runs in one spawned gloo group of 4 ranks
(tests/torch_dist_ranks.py), the reference on 4 devices of the 8-device
CPU mesh, its flash blocks in interpret mode as
tests/test_ring_attention.py runs them, on the same numpy inputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from flexflow_tpu import FFConfig, FFModel, LossType, SGDOptimizer
from flexflow_tpu.models.transformer import bert_sp_strategy as ref_sp
from flexflow_tpu.models.transformer import build_bert
from flexflow_tpu.parallel.ring_attention import ring_attention as ref_ring
from flexflow_tpu_torch.models.transformer import bert_sp_strategy
from flexflow_tpu_torch.models.transformer import build_bert as t_build_bert
from flexflow_tpu_torch.optimizer import SGDOptimizer as TSGD
from flexflow_tpu_torch.parallel.ring_attention import use_flash_blocks

SP = 4
B, S, H, D = 2, 128 * SP, 2, 64  # the reference's flash shards: 128 keys
SCALE = 1.0 / np.sqrt(D)
# float32 on both sides: blockwise LSE merges in other orders, and the
# flash blocks' plain versions against Pallas's interpret mode
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
CASES = [(impl, causal) for impl in ("flash", "dense")
         for causal in (False, True)]
TINY = dict(batch_size=4, seq_length=32, hidden_size=32, num_layers=1,
            num_heads=4, intermediate_size=64)


def _inputs():
    rng = np.random.RandomState(11)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def group(devices8):
    """The reference's outputs and grads per case, the tiny BERT's
    reference losses and weights, and the port's 4-rank results."""
    from jax.sharding import Mesh

    q, k, v = _inputs()
    mesh = Mesh(np.array(devices8[:SP]), ("seq",))
    ref = {}
    for impl, causal in CASES:
        def f(q, k, v, impl=impl, causal=causal):
            o = ref_ring(q, k, v, mesh, "seq", scale=SCALE, causal=causal,
                         block_impl=impl)
            return jnp.sum(o.astype(jnp.float32) ** 2), o

        (_, o), g = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        ref[impl, causal] = [np.asarray(o)] + [np.asarray(x) for x in g]
    cases = [(R.ring_case, (q, k, v, impl, causal, SCALE))
             for impl, causal in CASES]
    # the DP x SP BERT (tests/test_ring_attention.py's tiny model)
    ff = FFModel(FFConfig(batch_size=TINY["batch_size"]))
    build_bert(ff, **TINY)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=ref_sp(4, sp=2), devices=devices8[:4], seed=0)
    w = ff.get_weights()
    rng = np.random.RandomState(4)
    batches = [({"input": rng.randn(4, 32, 32).astype(np.float32)},
                rng.randint(0, 2, 4).astype(np.int32)) for _ in range(2)]
    ref["bert"] = [float(ff.train_step(*b)["loss"]) for b in batches]
    ref["bert_weights"] = ff.get_weights()
    cases.append((R.train_steps, (functools.partial(t_build_bert, **TINY),
                                  bert_sp_strategy(4, sp=2), w, batches,
                                  functools.partial(TSGD, lr=0.01)),
                  {"fit_last": True}))
    out = R.run_group(R.run_cases, SP, cases, timeout=180)
    return ref, out


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{i}-{'causal' if c else 'full'}"
                              for i, c in CASES])
def test_ring_matches_reference(group, case):
    """Each rank's output and q/k/v grads from the port's flash ring and
    its dense ring are its sequence shard of the reference ring's with
    the same blocks (block_impl "flash" and "dense")."""
    ref, out = group
    impl, causal = CASES[case]
    want = ref[impl, causal]
    n = S // SP
    for rank, got in enumerate(out):
        sl = slice(rank * n, (rank + 1) * n)
        mine = got[case]
        np.testing.assert_allclose(mine[0], want[0][:, sl], **TOL)
        for g, w in zip(mine[1:], want[1:]):
            np.testing.assert_allclose(g, w[:, sl], **GRAD_TOL)


def test_flash_and_dense_rings_agree(group):
    """The port's two rings give the same results on every rank."""
    _, out = group
    for got in out:
        for causal in (0, 1):
            for a, b in zip(got[causal], got[2 + causal]):
                np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_dp_sp_bert_two_steps_match_reference(group):
    ref, out = group
    for rank in out:
        np.testing.assert_allclose(rank[-1]["losses"], ref["bert"],
                                   rtol=2e-5, atol=2e-5)
    for op, entries in ref["bert_weights"].items():
        for k, v in entries.items():
            np.testing.assert_allclose(out[0][-1]["weights"][op][k], v,
                                       rtol=2e-5, atol=2e-5)


def test_flash_blocks_only_where_the_kernels_take_the_shapes():
    """ring_attention takes the flash ring where K1-K3 take the shard
    shapes and the global KV length reaches the flash crossover, and the
    dense ring elsewhere (head dim 8, a causal ring with unequal q and k
    shards, a short sequence), as the reference's `_use_flash_blocks`."""
    q = torch.zeros(2, 16, 2, 8)
    assert not use_flash_blocks(q, q, 4, False, 0)
    q64, k64 = torch.zeros(2, 16, 2, 64), torch.zeros(2, 32, 2, 64)
    assert not use_flash_blocks(q64, k64, 4, True, 0)
    assert use_flash_blocks(q64, k64, 4, False, 0)
    assert use_flash_blocks(q64, q64, 4, True, 0)
    assert not use_flash_blocks(q64, k64, 4, False, 2048)
    assert use_flash_blocks(q64, k64, 64, False, 2048)
