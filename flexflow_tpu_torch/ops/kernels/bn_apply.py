"""P1: BatchNorm apply with the residual add and the ReLU after it,
y = max(x * scale + shift + res, 0), on [M, C] rows (channels last):
every BatchNorm of a ResNet's forward.

Replaces the TPU kernel `pallas_apply` of scripts/resnet_bn_probe.py, a
Pallas kernel over 256-row blocks of a bfloat16 [M, C] tensor.  On the
card it is a CUDA C++ kernel written by hand for sm_90a,
`csrc/bn_apply.cu`, built with nvcc at first use into
`flexflow_tpu_torch/_build/` and loaded through ctypes (`_build.py`).
It is bound by bytes: it reads x (and res) and writes y once each (see
the source's note for the design).  Compile-time variants drop the
residual and the ReLU; float32 and bfloat16; any M and C.

`bn_apply(x, scale, shift, res=None, relu=True)` takes x (and res) as
a row-major [M, C] tensor or as an NCHW-shaped tensor in channels_last
memory, which it reads as [M, C] with no copy; any other layout raises,
since the kernel never copies behind the caller's back.  scale and
shift hold C values in x's dtype.  A CPU tensor runs `bn_apply_plain`;
a CUDA tensor launches the kernel or raises, with no fallback.
`bn_apply.launches` counts the kernel launches.  `BNApply` is the
autograd Function: P1 forward, plain-torch backward (the reference has
no backward kernel for it).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SOURCE = _build.CSRC / "bn_apply.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ff_bn_apply.argtypes = [P] * 5 + [ctypes.c_longlong, I, I, I, P]
    lib.ff_bn_apply.restype = ctypes.c_int
    lib.ff_bn_apply_vectorized.argtypes = [P, P, P, I, I]
    lib.ff_bn_apply_vectorized.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def rows(t: torch.Tensor) -> torch.Tensor:
    """The [M, C] view of t: a row-major 2-D tensor as it is, an NCHW
    tensor in channels_last memory as [N*H*W, C].  Raises for any other
    layout instead of copying."""
    if t.dim() == 2 and t.is_contiguous():
        return t
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        n, c, h, w = t.shape
        return t.permute(0, 2, 3, 1).view(n * h * w, c)
    raise ValueError(
        f"bn_apply reads [M, C] rows: a contiguous 2-D tensor or a 4-D "
        f"tensor in channels_last memory, got shape {tuple(t.shape)} with "
        f"strides {t.stride()} (the executor's layout pass puts BatchNorm "
        "inputs in channels_last; bn_apply does not copy)")


def _like(y_rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y's [M, C] rows in x's shape and memory format (a view)."""
    if x.dim() == 2:
        return y_rows
    n, c, h, w = x.shape
    return y_rows.view(n, h, w, c).permute(0, 3, 1, 2)


def bn_apply_plain(x, scale, shift, res=None, relu: bool = True):
    """max(x * scale + shift (+ res), 0) on [M, C] rows, in float32,
    rounded once to x's dtype: the product and each sum rounded in
    float32 in this order, as the kernel does them."""
    y = x.float() * scale.reshape(-1).float() + shift.reshape(-1).float()
    if res is not None:
        y = y + res.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, xr, scale, shift, res, rr) -> None:
    c = xr.shape[1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bn_apply takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != x.dtype or t.numel() != c or not t.is_contiguous():
            raise ValueError(
                f"bn_apply: {name} must be {c} contiguous {x.dtype} "
                f"values, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"bn_apply: {name} is on {t.device}, x on "
                             f"{x.device}")
    if res is not None:
        if rr.shape != xr.shape or res.dtype != x.dtype \
                or res.device != x.device:
            raise ValueError(
                f"bn_apply: res {tuple(res.shape)} {res.dtype} on "
                f"{res.device} does not match x {tuple(x.shape)} {x.dtype} "
                f"on {x.device}")


def bn_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             res: Optional[torch.Tensor] = None,
             relu: bool = True) -> torch.Tensor:
    """y = max(x * scale + shift + res, 0) in x's shape, dtype and memory
    format; res and the ReLU are optional.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream or
    raise."""
    xr = rows(x)
    rr = rows(res) if res is not None else None
    _check(x, xr, scale, shift, res, rr)
    if x.device.type == "cpu":
        return _like(bn_apply_plain(xr, scale, shift, rr, relu), x)
    if x.device.type != "cuda":
        raise ValueError(f"bn_apply runs on cuda or cpu tensors, got "
                         f"{x.device}")
    lib = load_library()
    out = torch.empty_like(xr)
    m, c = xr.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ff_bn_apply(
            xr.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            rr.data_ptr() if rr is not None else None, out.data_ptr(),
            m, c, int(relu), _DTYPE_CODES[x.dtype], stream)
    _build.check_launch(lib, rc, "bn_apply")
    bn_apply.launches += 1
    return _like(out, x)


bn_apply.launches = 0


def vectorized(x, res=None) -> bool:
    """Whether the kernel takes its 16-byte vector path for x (and res):
    C a multiple of 16 bytes and every pointer 16-byte aligned."""
    xr = rows(x)
    lib = load_library()
    return bool(lib.ff_bn_apply_vectorized(
        xr.data_ptr(), rows(res).data_ptr() if res is not None else None,
        xr.data_ptr(), xr.shape[1], _DTYPE_CODES[x.dtype]))


class BNApply(torch.autograd.Function):
    """P1 forward; plain-torch backward.  With g' = g * [y > 0] (g where
    the ReLU is off): dx = g' * scale, dscale = sum_M g' * x and
    dshift = sum_M g' in float32, dres = g'.  Saves x, scale and y, all
    of which the graph holds anyway (y is the next conv's input)."""

    @staticmethod
    def forward(ctx, x, scale, shift, res, relu):
        y = bn_apply(x, scale, shift, res, relu)
        ctx.save_for_backward(x, scale, y)
        ctx.relu = relu
        ctx.has_res = res is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, y = ctx.saved_tensors
        if ctx.relu:
            # torch.where keeps g's memory format (masked_fill does not)
            g = torch.where(y > 0, g, 0.0)
        bshape = (1, -1) + (1,) * (x.dim() - 2)
        dims = (0,) + tuple(range(2, x.dim()))
        dx = g * scale.view(bshape)
        dscale = (g.float() * x).sum(dim=dims).to(scale.dtype)
        dshift = g.sum(dim=dims, dtype=torch.float32).to(scale.dtype)
        return (dx, dscale.view(scale.shape), dshift.view(scale.shape),
                g if ctx.has_res else None, None)
