"""P1, the BatchNorm apply (flexflow_tpu_torch/ops/kernels/bn_apply.py),
against the reference on the CPU: its plain version against the probe's
own Pallas kernel `pallas_apply` (scripts/resnet_bn_probe.py, compiled
from the file's AST because the probe runs its benchmark when imported)
in interpret mode, in bfloat16; against jax.nn.relu(x * s + b + r) in
float32; the autograd Function's grads against jax.vjp of the same
expression; and the wrapper's layout rules.

Tolerances.  float32: the two sides do the same multiply and adds, but
XLA may contract x * s + b into one FMA, so 1e-6 of the output's scale.
bfloat16 against the probe: the probe rounds x * s, then + b, then + r
to bfloat16 (three roundings, each within 2^-8 of its partial result:
bfloat16 keeps 8 significant bits), the plain version rounds once, so
each element may differ by 2^-8 (|x s| + |x s + b| + 2 |x s + b + r|).  Grads: sums over M of
float32 products in other orders, 1e-5 absolute on values of order 10.
"""
import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental import pallas as pl  # noqa: E402

from flexflow_tpu_torch.ops.kernels import bn_apply as bk  # noqa: E402

PROBE = Path(__file__).resolve().parents[1] / "scripts" / "resnet_bn_probe.py"
VARIANTS = {"res_relu": (True, True), "relu": (False, True),
            "res": (True, False), "none": (False, False)}


def _probe_pallas_apply():
    """`pallas_apply` of the probe, its def alone compiled from the AST,
    with pl.pallas_call in interpret mode."""
    tree = ast.parse(PROBE.read_text(), filename=str(PROBE))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "pallas_apply")
    ns = {"jax": jax, "jnp": jnp,
          "pl": types.SimpleNamespace(
              pallas_call=functools.partial(pl.pallas_call, interpret=True),
              BlockSpec=pl.BlockSpec)}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(PROBE),
                 "exec"), ns)
    return ns["pallas_apply"]


def _case(rng, m, c):
    x = rng.randn(m, c).astype(np.float32)
    r = rng.randn(m, c).astype(np.float32)
    s = (rng.rand(1, c) + 0.5).astype(np.float32)
    b = (rng.randn(1, c) * 0.1).astype(np.float32)
    return x, s, b, r


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("m,c", [(512, 64), (768, 40), (256, 2048)])
def test_plain_matches_the_probe_kernel_in_bfloat16(m, c):
    x, s, b, r = (_bf16(a) for a in _case(np.random.RandomState(c), m, c))
    probe = _probe_pallas_apply()
    want = np.asarray(probe(*(jnp.asarray(a, jnp.bfloat16)
                              for a in (x, s, b, r)))).astype(np.float32)
    got = bk.bn_apply_plain(*(torch.tensor(a).to(torch.bfloat16)
                              for a in (x, s, b, r)), True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, c)
    xs = x.astype(np.float64) * s
    bound = 2.0 ** -8 * (np.abs(xs) + np.abs(xs + b)
                         + 2 * np.abs(xs + b + r))
    assert (np.abs(got.float().numpy() - want) <= bound + 1e-30).all()
    # the plain version against the exact result: one bfloat16 rounding
    # of a float32 sum
    exact = np.maximum(xs + b + r, 0)
    assert (np.abs(got.float().numpy() - exact)
            <= 2.0 ** -8 * np.abs(exact)
            + 2.0 ** -22 * (np.abs(xs) + np.abs(b) + np.abs(r))).all()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_matches_jax_in_float32(variant):
    has_res, relu = VARIANTS[variant]
    x, s, b, r = _case(np.random.RandomState(1), 300, 24)
    want = x * s + b + (r if has_res else 0)
    want = np.asarray(jax.nn.relu(jnp.asarray(want)) if relu else want)
    got = bk.bn_apply_plain(torch.tensor(x), torch.tensor(s[0]),
                            torch.tensor(b[0]),
                            torch.tensor(r) if has_res else None, relu)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)


def _jax_expr(has_res, relu):
    def f(x, s, b, r):
        y = x * s[None, :] + b[None, :]
        if has_res:
            y = y + r
        return jax.nn.relu(y) if relu else y
    return f


@pytest.mark.parametrize("layout", ["rows", "channels_last"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_autograd_function_grads_match_jax_vjp(variant, layout):
    has_res, relu = VARIANTS[variant]
    rng = np.random.RandomState(2)
    n, c, h, w = 3, 8, 5, 4
    x, s, b, r = _case(rng, n * h * w, c)
    g = rng.randn(n * h * w, c).astype(np.float32)
    jy, vjp = jax.vjp(_jax_expr(has_res, relu), jnp.asarray(x),
                      jnp.asarray(s[0]), jnp.asarray(b[0]), jnp.asarray(r))
    want = vjp(jnp.asarray(g))

    def to4(a):  # [M, C] rows -> NCHW in channels_last memory (a view)
        t = torch.tensor(a)
        if layout == "rows":
            return t
        return t.view(n, h, w, c).permute(0, 3, 1, 2)

    tx, tr = to4(x).requires_grad_(), to4(r).requires_grad_()
    ts = torch.tensor(s[0], requires_grad=True)
    tb = torch.tensor(b[0], requires_grad=True)
    y = bk.BNApply.apply(tx, ts, tb, tr if has_res else None, relu)
    assert y.shape == tx.shape and y.stride() == tx.stride()
    grads = torch.autograd.grad(y, [tx, ts, tb] + ([tr] if has_res else []),
                                to4(g))
    np.testing.assert_allclose(bk.rows(y.detach()).numpy(), np.asarray(jy),
                               rtol=0, atol=1e-6)
    for got, ref in zip(grads, want):
        got = bk.rows(got) if got.dim() == 4 else got
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


def test_reads_channels_last_as_rows_without_a_copy():
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(2, 6, 3, 5).astype(np.float32))
    res = torch.tensor(rng.randn(2, 6, 3, 5).astype(np.float32))
    s, b = torch.rand(6) + 0.5, torch.randn(6)
    xc = x.contiguous(memory_format=torch.channels_last)
    rc = res.contiguous(memory_format=torch.channels_last)
    view = bk.rows(xc)
    assert view.shape == (30, 6) and view.data_ptr() == xc.data_ptr()
    y = bk.bn_apply(xc, s, b, rc, True)
    assert y.shape == x.shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    want = torch.relu(x * s.view(1, 6, 1, 1) + b.view(1, 6, 1, 1) + res)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
    assert bk.bn_apply.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("bad", ["nchw", "strided_rows", "res_nchw",
                                 "scale_len", "scale_dtype", "int_x"])
def test_layouts_and_arguments_it_cannot_read_raise(bad):
    x = torch.randn(2, 6, 3, 5).contiguous(memory_format=torch.channels_last)
    res, s, b = x.clone(), torch.ones(6), torch.zeros(6)
    args = {"nchw": (x.contiguous(), s, b, None),
            "strided_rows": (torch.randn(10, 12)[:, ::2], s, b, None),
            "res_nchw": (x, s, b, res.contiguous()),
            "scale_len": (x, torch.ones(5), b, None),
            "scale_dtype": (x, s.double(), b, None),
            "int_x": (torch.ones(30, 6, dtype=torch.int32), s, b, None)}[bad]
    with pytest.raises((ValueError, TypeError)):
        bk.bn_apply(*args, True)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor off the CPU goes to the kernel's checks and launch (here
    the device check raises), never to the plain version."""
    calls = []
    monkeypatch.setattr(bk, "bn_apply_plain", lambda *a: calls.append(a))
    x = torch.zeros(8, 16, device="meta")
    s = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bk.bn_apply(x, s, s, None, True)
    assert calls == [] and bk.bn_apply.launches == 0


def test_source_names_what_it_replaces_and_its_bound():
    src = bk.SOURCE.read_text()
    assert "pallas_apply" in src and "resnet_bn_probe.py" in src
    assert "Bound: bytes" in src
    assert "__fmul_rn" in src and "__fadd_rn" in src
