"""The port's pipeline schedules (flexflow_tpu_torch/parallel/pipeline.py)
against the reference's (tests/test_pipeline.py): GPipe against
sequential execution for each (dp, pp, microbatches), its grads, the
shape checks, the transformer demo's GPipe and 1F1B steps, 1F1B equal to
GPipe, both schedules training, and 1F1B's saved activations flat in
the microbatch count where GPipe's grow.

The port runs in spawned gloo groups (tests/torch_dist_ranks.py), one of
8 ranks and one of 4, each spawned once for the module; the reference
runs in this process on the 8-device CPU mesh, on the same numpy inputs,
with its initial weights copied into the port.
"""
import numpy as np
import pytest
from jax.sharding import Mesh

import jax
import jax.numpy as jnp
import torch_dist_ranks as R
from flexflow_tpu.parallel.pipeline import (make_pipelined_transformer_step,
                                            pipelined_apply)
from flexflow_tpu_torch.parallel.machine import DeviceMesh
from flexflow_tpu_torch.parallel.pipeline import (_split_microbatches,
                                                  local_blocks)

# float32 on both sides: XLA's and torch's sums run in other orders
TOL = dict(rtol=2e-5, atol=2e-5)

APPLY = [(1, 4, 8), (2, 4, 4), (1, 8, 8)]
KW = dict(layers=4, hidden=16, ffn=32, num_heads=4, num_classes=4, lr=0.1)
SCHEDULES = [(1, 4, 8), (2, 4, 4)]
MEM_KW = dict(layers=4, hidden=32, ffn=64, num_heads=4, num_classes=4,
              lr=0.1)
MEM_M = (8, 32)


def _mesh(devices, dp, pp):
    return Mesh(np.array(devices[: dp * pp]).reshape(dp, pp), ("data", "pp"))


def _ref_block(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stacked_params(layers, dim, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(layers, dim, dim) / np.sqrt(dim)).astype(
                np.float32),
            "b": (rng.randn(layers, dim) * 0.1).astype(np.float32)}


def _sequential(params, x):
    for i in range(params["w"].shape[0]):
        x = _ref_block(jax.tree.map(lambda a: a[i], params), x)
    return x


def _data(seed, batch=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 8, 16).astype(np.float32),
            rng.randint(0, 4, batch).astype(np.int32))


def _ref_steps(devices, dp, pp, mb, x, y, steps, schedule="gpipe", kw=KW):
    init_fn, step_fn = make_pipelined_transformer_step(
        _mesh(devices, dp, pp), num_microbatches=mb, schedule=schedule,
        **kw)
    params = init_fn(seed=0)
    p0 = jax.tree.map(np.asarray, params)
    losses = []
    for _ in range(steps):
        params, loss = step_fn(params, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return p0, losses, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def groups(devices8):
    """The reference's results and the port's, for every case: 8-rank
    cases in one group, 4-rank cases in another."""
    ref, by_world = {}, {4: [], 8: []}
    x = np.random.RandomState(1).randn(16, 16).astype(np.float32)
    for dp, pp, mb in APPLY:
        params = _stacked_params(layers=pp * 2, dim=16)
        ref[("apply", dp, pp, mb)] = (
            np.asarray(pipelined_apply(_ref_block,
                                       jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(x),
                                       mesh=_mesh(devices8, dp, pp),
                                       num_microbatches=mb)),
            np.asarray(_sequential(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x))))
        by_world[dp * pp].append((("apply", dp, pp, mb), R.pipelined_case,
                                  (dp, pp, mb, params, x)))
    # grads of the output's sum (test_pipeline_gradients_match_sequential)
    gp = _stacked_params(layers=4, dim=8)
    gx = np.random.RandomState(2).randn(8, 8).astype(np.float32)
    gmesh = _mesh(devices8, 2, 4)
    ref["grads"] = (
        jax.grad(lambda p: pipelined_apply(
            _ref_block, p, jnp.asarray(gx), mesh=gmesh,
            num_microbatches=4).sum())(jax.tree.map(jnp.asarray, gp)),
        jax.grad(lambda p: _sequential(p, jnp.asarray(gx)).sum())(
            jax.tree.map(jnp.asarray, gp)))
    by_world[8].append(("grads", R.pipelined_case, (2, 4, 4, gp, gx, True)))
    # the demo's two schedules over 2 steps, and 10 to train
    x0, y0 = _data(0)
    for dp, pp, mb in SCHEDULES:
        for schedule in ("gpipe", "1f1b"):
            p0, losses, after = _ref_steps(devices8, dp, pp, mb, x0, y0, 2,
                                           schedule)
            key = ("steps", schedule, dp, pp, mb)
            ref[key] = (losses, after)
            kw = dict(KW, num_microbatches=mb)
            by_world[dp * pp].append((key, R.transformer_case,
                                      (dp, pp, kw, p0, x0, y0, 2, schedule)))
    for schedule, seed in (("gpipe", 0), ("1f1b", 1)):
        x, y = _data(seed)
        p0, losses, _ = _ref_steps(devices8, 2, 4, 4, x, y, 10, schedule)
        ref[("trains", schedule)] = losses
        by_world[8].append((("trains", schedule), R.transformer_case,
                            (2, 4, dict(KW, num_microbatches=4), p0, x, y,
                             10, schedule)))
    # saved activations at 4-row microbatches, pp 4
    for schedule in ("gpipe", "1f1b"):
        for mb in MEM_M:
            init_fn, _ = make_pipelined_transformer_step(
                _mesh(devices8, 1, 4), num_microbatches=mb, **MEM_KW)
            p0 = jax.tree.map(np.asarray, init_fn(seed=0))
            xm = np.zeros((4 * mb, 8, 32), np.float32)
            ym = np.zeros((4 * mb,), np.int32)
            by_world[4].append((("saved", schedule, mb),
                                R.transformer_case,
                                (1, 4, dict(MEM_KW, num_microbatches=mb),
                                 p0, xm, ym, 1, schedule, False, True)))
    out = {}
    for world, cases in by_world.items():
        got = R.run_group(R.run_cases, world,
                          [(fn, args) for _, fn, args in cases],
                          timeout=240)
        for i, (key, _, _) in enumerate(cases):
            out[key] = [rank[i] for rank in got]
    return ref, out


@pytest.mark.parametrize("dp,pp,mb", APPLY)
def test_pipeline_matches_sequential(groups, dp, pp, mb):
    ref, out = groups
    pipe, seq = ref[("apply", dp, pp, mb)]
    # every stage of a pipe group holds its data shard's rows
    n = 16 // dp
    for d, _, y in out[("apply", dp, pp, mb)]:
        np.testing.assert_allclose(y, pipe[d * n:(d + 1) * n], **TOL)
        np.testing.assert_allclose(y, seq[d * n:(d + 1) * n], **TOL)


def test_pipeline_gradients_match_sequential(groups):
    ref, out = groups
    g_pipe, g_seq = ref["grads"]
    ranks = out["grads"]
    for k in ("w", "b"):
        # each pp coordinate holds its chunk of blocks, the same on
        # every data rank once summed over them
        chunks = {r[1]: r[3][k] for r in ranks}
        for r in ranks:
            np.testing.assert_array_equal(r[3][k], chunks[r[1]])
        got = np.concatenate([chunks[c] for c in range(4)])
        np.testing.assert_allclose(got, np.asarray(g_pipe[k]), **TOL)
        np.testing.assert_allclose(got, np.asarray(g_seq[k]), rtol=1e-4,
                                   atol=1e-4)


def test_pipeline_rejects_bad_shapes():
    """The port's shape checks, on one rank of a pp 4 mesh: a block
    count pp does not divide, a batch the microbatch count does not
    divide."""
    mesh = DeviceMesh({"data": 1, "pp": 4}, 0, "cpu", {}, {})
    import torch

    six = {k: torch.tensor(v) for k, v in
           _stacked_params(layers=6, dim=8).items()}
    with pytest.raises(ValueError, match="not divisible by pp"):
        local_blocks(six, mesh)
    with pytest.raises(ValueError, match="num_microbatches"):
        _split_microbatches(torch.zeros(8, 8), 3)
    from flexflow_tpu_torch.parallel.pipeline import \
        make_pipelined_transformer_step as port_step
    with pytest.raises(ValueError, match="not divisible by pp"):
        port_step(mesh, layers=6, hidden=8, ffn=8, num_heads=2,
                  num_classes=2, num_microbatches=4)
    with pytest.raises(ValueError, match="schedule"):
        port_step(mesh, layers=4, hidden=8, ffn=8, num_heads=2,
                  num_classes=2, num_microbatches=4, schedule="zb")


def _check_steps(ranks, losses, after):
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
    got = ranks[0]
    for k, v in after["blocks"].items():
        np.testing.assert_allclose(got["blocks"][k], v, **TOL)
    np.testing.assert_allclose(got["head"], after["head"], **TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("dp,pp,mb", SCHEDULES)
def test_transformer_steps_match_reference(groups, dp, pp, mb, schedule):
    """Two SGD steps of the demo, losses and weights after them."""
    ref, out = groups
    key = ("steps", schedule, dp, pp, mb)
    _check_steps(out[key], *ref[key])


@pytest.mark.parametrize("dp,pp,mb", SCHEDULES)
def test_1f1b_matches_gpipe(groups, dp, pp, mb):
    """The port's 1F1B computes GPipe's loss and update: the same math,
    another residency of activations."""
    _, out = groups
    g = out[("steps", "gpipe", dp, pp, mb)][0]
    o = out[("steps", "1f1b", dp, pp, mb)][0]
    np.testing.assert_allclose(o["losses"], g["losses"], **TOL)
    for k in g["blocks"]:
        np.testing.assert_allclose(o["blocks"][k], g["blocks"][k], **TOL)
    np.testing.assert_allclose(o["head"], g["head"], **TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipelined_transformer_trains(groups, schedule):
    ref, out = groups
    losses = out[("trains", schedule)][0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref[("trains", schedule)], **TOL)


def test_1f1b_saved_activations_scale_with_stages_not_microbatches(groups):
    """At 4-row microbatches (the batch grows with M), the bytes autograd
    holds at once grow with M under GPipe (every tick's graph lives until
    the backward) and stay flat under 1F1B (one tick's stage at a
    time)."""
    _, out = groups
    peak = {(s, m): max(r["saved_peak"] for r in out[("saved", s, m)])
            for s in ("gpipe", "1f1b") for m in MEM_M}
    g8, g32 = peak[("gpipe", 8)], peak[("gpipe", 32)]
    o8, o32 = peak[("1f1b", 8)], peak[("1f1b", 32)]
    assert g32 > g8 * 2.0
    assert o32 < o8 * 1.05
    assert o8 < g8 / 3
