"""Flash attention, forward and backward: attention's flash branch in
training and inference (MultiHeadAttention._attend).

Replaces the TPU kernels of flexflow_tpu/ops/pallas/flash_attention.py:
K1 `_fwd_kernel` (launched by `_flash_fwd_pallas`), K2 `_bwd_dq_kernel`
and K3 `_bwd_dkv_kernel` (both launched by `_flash_bwd_pallas`).  On the
card they are CUDA C++ kernels written by hand for sm_90a,
`csrc/flash_attention.cu`, built with nvcc at first use into
`flexflow_tpu_torch/_build/` and loaded through ctypes (`_build.py`).
Each kernel computes its products itself, tile by tile, so the [s, s]
scores never reach device memory; at the training shape they are bound
by operations on the tensor cores (float32 as three TF32 passes,
bfloat16 in one; see the source's note).  `bwd_resources` reports what
the card gives K1, K2 and K3 (registers, spills, shared memory, blocks
per SM).

Layout [batch*heads, seq, head_dim], contiguous.  `flash_fwd` returns
(out, lse) and `flash_bwd` (dq, dk, dv), the entry points ring attention
calls; `FlashAttention` binds them as one autograd Function that saves
q, k, v, out and lse (never the probabilities); `mha_flash` is the
[b, s, h, d] wrapper.  CPU tensors run the plain versions, the off-TPU
branches of the reference's `_flash_fwd` and `_flash_vjp_bwd`; CUDA
tensors launch the kernels or raise, with no fallback.  The counters
`flash_fwd.launches`, `flash_bwd_dq.launches` and
`flash_bwd_dkv.launches` count the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

SOURCE = _build.CSRC / "flash_attention.cu"

HEAD_DIMS = (64, 128)
MAX_BH = 65535  # the kernels put batch*heads on gridDim.y
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30  # the reference's mask value


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ff_flash_fwd.argtypes = [P] * 5 + [I] * 4 + [F, I, I, P]
    lib.ff_flash_bwd_dq.argtypes = [P] * 7 + [I] * 4 + [F, I, I, P]
    lib.ff_flash_bwd_dkv.argtypes = [P] * 8 + [I] * 4 + [F, I, I, P]
    lib.ff_flash_bwd_resources.argtypes = [I, I, I, P]
    for fn in (lib.ff_flash_fwd, lib.ff_flash_bwd_dq, lib.ff_flash_bwd_dkv,
               lib.ff_flash_bwd_resources):
        fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def bwd_resources(kernel: str, head_dim: int, dtype: torch.dtype) -> dict:
    """What the card gives one block of K1 ("fwd"), K2 ("dq") or K3
    ("dkv") at (head_dim, dtype): registers per thread, local memory per
    thread (spills; 0 means none), dynamic shared memory and resident
    blocks per SM."""
    lib = load_library()
    out = (ctypes.c_int * 4)()
    rc = lib.ff_flash_bwd_resources({"fwd": 1, "dq": 2, "dkv": 3}[kernel],
                                    head_dim, _DTYPE_CODES[dtype], out)
    _build.check_launch(lib, rc, f"flash {kernel} resources")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), out))


# -- plain versions ------------------------------------------------------

def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or wider when it already is (float64 for gradcheck);
    the reference's .astype(float32)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _masked_scores(q, k, scale: float, causal: bool) -> torch.Tensor:
    s = _wide(torch.einsum("bqd,bkd->bqk", q, k)) * scale
    if causal:
        # absolute positions: q_i sees k_0..k_i, also when sq != sk
        mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_fwd_plain(q, k, v, scale: float,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The off-TPU branch of the reference's `_flash_fwd`: (out in q's
    dtype, lse in float32)."""
    s = _masked_scores(q, k, scale, causal)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    out = torch.einsum("bqk,bkd->bqd", (e / l[..., None]).to(v.dtype), v)
    return out, m + torch.log(l)


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, shared by the two backward
    kernels (one torch reduction, as the reference's jnp pass)."""
    return (_wide(dout) * _wide(out)).sum(dim=-1)


def _bwd_plain(q, k, v, dout, lse, delta, scale: float, causal: bool):
    qf, kf, vf, dof = _wide(q), _wide(k), _wide(v), _wide(dout)
    p = torch.exp(_masked_scores(qf, kf, scale, causal) - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, out, lse, dout, scale: float, causal: bool):
    """The off-TPU branch of the reference's `_flash_vjp_bwd`: (dq, dk,
    dv) from the recomputed probabilities exp(s - lse)."""
    return _bwd_plain(q, k, v, dout, lse, flash_delta(out, dout), scale,
                      causal)


# -- kernel wrappers -----------------------------------------------------

def _check(what: str, q, k, v, *rest) -> None:
    if q.device.type != "cuda":
        raise ValueError(
            f"{what} runs on cuda or cpu tensors, got {q.device}")
    tensors = (("q", q), ("k", k), ("v", v)) + tuple(
        (f"arg{i}", t) for i, t in enumerate(rest))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel needs one dtype for q, k and v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} are not [bh, sq, d], [bh, sk, d], [bh, sk, d]")
    bh, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dims {HEAD_DIMS}, got {d}")
    if not (1 <= bh <= MAX_BH and sq >= 1 and k.shape[1] >= 1):
        raise ValueError(f"{what} kernel takes 1 <= bh <= {MAX_BH} and "
                         f"non-empty sequences, got {tuple(q.shape)} / "
                         f"{tuple(k.shape)}")


def _check_rows(what: str, q, dout, lse, delta) -> None:
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} {dout.dtype} "
                         f"does not match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(f"{what}: {name} must be float32 "
                             f"{tuple(q.shape[:2])}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, scale: float,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: q [bh, sq, d], k and v [bh, sk, d] -> (out [bh, sq, d] in q's
    dtype, lse [bh, sq] float32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal)
    _check("flash_fwd", q, k, v)
    bh, sq, d = q.shape
    lib = load_library()
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    rc = lib.ff_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1],
                          d, float(scale), int(causal), _DTYPE_CODES[q.dtype],
                          _stream(q))
    _build.check_launch(lib, rc, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, scale: float,
                 causal: bool) -> torch.Tensor:
    """K2: dq [bh, sq, d] in q's dtype."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, scale, causal)[0]
    _check("flash_bwd_dq", q, k, v, dout, lse, delta)
    _check_rows("flash_bwd_dq", q, dout, lse, delta)
    bh, sq, d = q.shape
    lib = load_library()
    dq = torch.empty_like(q)
    rc = lib.ff_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq, k.shape[1],
        d, float(scale), int(causal), _DTYPE_CODES[q.dtype], _stream(q))
    _build.check_launch(lib, rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale: float,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) [bh, sk, d] in k's dtype."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, scale, causal)[1:]
    _check("flash_bwd_dkv", q, k, v, dout, lse, delta)
    _check_rows("flash_bwd_dkv", q, dout, lse, delta)
    bh, sq, d = q.shape
    lib = load_library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = lib.ff_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        sq, k.shape[1], d, float(scale), int(causal), _DTYPE_CODES[q.dtype],
        _stream(q))
    _build.check_launch(lib, rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, out, lse, dout, scale: float, causal: bool):
    """K2 + K3: (dq, dk, dv) from the forward's out and lse."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, dout, scale, causal)
    delta = flash_delta(out, dout)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention on [bh, s, d] through K1, with K2 + K3 as its backward.
    Saves q, k, v, out and lse: O(s) per row, not the [s, s]
    probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    """q, k, v [bh, s, d] -> [bh, sq, d], differentiable."""
    return FlashAttention.apply(q, k, v, scale, causal)


def mha_flash(qh, kh, vh, scale: float, causal: bool) -> torch.Tensor:
    """[b, s, h, d] wrapper -> [b, sq, h, d] (the reference's
    `mha_flash`).  The heads move next to the batch in one contiguous
    copy of q, k and v each; the output comes back as a view."""
    b, sq, h, d = qh.shape
    sk = kh.shape[1]
    q2 = qh.permute(0, 2, 1, 3).contiguous().view(b * h, sq, d)
    k2 = kh.permute(0, 2, 1, 3).contiguous().view(b * h, sk, d)
    v2 = vh.permute(0, 2, 1, 3).contiguous().view(b * h, sk, vh.shape[-1])
    o = flash_attention(q2, k2, v2, scale, causal)
    return o.view(b, h, sq, -1).permute(0, 2, 1, 3)
