"""torch.fx -> FFModel importer of the port
(flexflow_tpu/torch_frontend/model.py).

`PyTorchModel` traces an nn.Module with torch.fx and lowers every node
through the same serializable descriptions as the reference: a
module-config dict for call_module nodes (`module_config`,
`lower_module`) and a canonical function name for call_function and
call_method nodes (`lower_function`, `lower_method`).  `copy_weights`
carries the module's parameters into the compiled FFModel (torch Linear
[out, in] -> kernel [in, out]; conv kernels OIHW as they are) and
BatchNorm's running statistics into its op state.

Functional F.linear and F.conv2d weights arrive as arrays and are
pinned through ArrayInitializer; a bare parameter or buffer operand of
add, sub, mul or div becomes a WeightOp holding its array, frozen when
the source did not require grad.  Both keep the values they had at
trace time: copy_weights leaves them as imported.  The reference's own
refusals stay (masked_fill; expand of a bare parameter).

The file route is the reference's: `torch_to_file` writes the trace as
JSON lines (one record per fx node: its op, name, encoded args and
kwargs, and the module config or canonical function name) with the
get_attr tensors in an npz sidecar (`path + ".npz"`), and `file_to_ff`
replays such a file onto an FFModel through the same lowering calls.
A file written by either package loads in the other.
"""
from __future__ import annotations

import json
import math
import operator
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.fx
import torch.nn as nn
import torch.nn.functional as F

from ..fftype import DataType
from ..initializer import ArrayInitializer
from ..model import FFModel
from ..tensor import ParallelTensor


# ---------------------------------------------------------------------------
# module -> serializable config
# ---------------------------------------------------------------------------

def module_config(m) -> Dict:
    """A JSON-serializable lowering config of an nn.Module (the
    reference's call_module payload)."""
    if isinstance(m, nn.Linear):
        return {"kind": "linear", "out": m.out_features,
                "bias": m.bias is not None}
    if isinstance(m, nn.Conv2d):
        if m.padding_mode != "zeros":
            raise ValueError(f"unsupported conv padding_mode "
                             f"{m.padding_mode!r}")
        pad = m.padding if isinstance(m.padding, tuple) else (m.padding,) * 2
        return {"kind": "conv2d", "out": m.out_channels,
                "kernel": list(m.kernel_size), "stride": list(m.stride),
                "padding": [pad[0], pad[1]], "groups": m.groups,
                "bias": m.bias is not None}
    if isinstance(m, (nn.MaxPool2d, nn.AvgPool2d)):
        k = m.kernel_size if isinstance(m.kernel_size, tuple) else (
            m.kernel_size,) * 2
        s = m.stride if isinstance(m.stride, tuple) else (
            m.stride or m.kernel_size,) * 2
        p = m.padding if isinstance(m.padding, tuple) else (m.padding,) * 2
        return {"kind": "pool2d", "k": list(k), "s": list(s), "p": list(p),
                "type": "max" if isinstance(m, nn.MaxPool2d) else "avg"}
    if isinstance(m, nn.AdaptiveAvgPool2d):
        o = m.output_size if isinstance(m.output_size, tuple) else (
            m.output_size, m.output_size)
        return {"kind": "adaptive_avg_pool2d", "out": [o[0], o[1]]}
    if isinstance(m, nn.BatchNorm2d):
        return {"kind": "batch_norm"}
    if isinstance(m, nn.LayerNorm):
        return {"kind": "layer_norm", "ndims": len(m.normalized_shape),
                "affine": m.elementwise_affine, "eps": m.eps}
    if isinstance(m, nn.Embedding):
        return {"kind": "embedding", "num": m.num_embeddings,
                "dim": m.embedding_dim}
    for cls, fn in ((nn.ReLU, "relu"), (nn.GELU, "gelu"),
                    (nn.Sigmoid, "sigmoid"), (nn.Tanh, "tanh"),
                    (nn.ELU, "elu")):
        if isinstance(m, cls):
            return {"kind": "unary", "fn": fn}
    if isinstance(m, nn.Softmax):
        return {"kind": "softmax", "dim": m.dim if m.dim is not None else -1}
    if isinstance(m, nn.Dropout):
        return {"kind": "dropout", "p": m.p}
    if isinstance(m, nn.Flatten):
        return {"kind": "flatten", "start": m.start_dim, "end": m.end_dim}
    if isinstance(m, nn.Identity):
        return {"kind": "identity"}
    if isinstance(m, nn.MultiheadAttention):
        if not m.batch_first:
            raise ValueError("set batch_first=True for MHA import")
        return {"kind": "mha", "embed": m.embed_dim, "heads": m.num_heads,
                "dropout": m.dropout, "bias": m.in_proj_bias is not None,
                "add_bias_kv": m.bias_k is not None}
    raise ValueError(f"unsupported torch module in trace: {m}")


_UNARY_FNS = {"relu": "relu", "gelu": "gelu", "sigmoid": "sigmoid",
              "tanh": "tanh", "elu": "elu", "exp": "exp", "log": "log",
              "sin": "sin", "cos": "cos", "sqrt": "sqrt", "rsqrt": "rsqrt",
              "erf": "erf", "floor": "floor"}

# module-config kinds that own trainable weights (copy_weights targets)
_WEIGHTED_KINDS = {"linear", "conv2d", "batch_norm", "layer_norm",
                   "embedding", "mha"}


def lower_module(ff: FFModel, cfg: Dict, a: List, name: str):
    """Lower one call_module node from its serializable config."""
    kind = cfg["kind"]
    if kind == "linear":
        return ff.dense(a[0], cfg["out"], use_bias=cfg["bias"], name=name)
    if kind == "conv2d":
        return ff.conv2d(
            a[0], cfg["out"], cfg["kernel"][0], cfg["kernel"][1],
            cfg["stride"][0], cfg["stride"][1], cfg["padding"][0],
            cfg["padding"][1], groups=cfg["groups"], use_bias=cfg["bias"],
            name=name)
    if kind == "pool2d":
        k, s, p = cfg["k"], cfg["s"], cfg["p"]
        return ff.pool2d(a[0], k[0], k[1], s[0], s[1], p[0], p[1],
                         pool_type=cfg["type"], name=name)
    if kind == "adaptive_avg_pool2d":
        h, w = a[0].shape.logical_shape[2:4]
        kh, kw = h // cfg["out"][0], w // cfg["out"][1]
        return ff.pool2d(a[0], kh, kw, kh, kw, 0, 0, pool_type="avg",
                         name=name)
    if kind == "batch_norm":
        return ff.batch_norm(a[0], relu=False, name=name)
    if kind == "layer_norm":
        rank = a[0].shape.logical_rank
        axes = tuple(range(rank - cfg["ndims"], rank))
        return ff.layer_norm(a[0], axes, cfg["affine"], cfg["eps"],
                             name=name)
    if kind == "embedding":
        return ff.embedding(a[0], cfg["num"], cfg["dim"], name=name)
    if kind == "unary":
        return getattr(ff, _UNARY_FNS[cfg["fn"]])(a[0], name=name)
    if kind == "softmax":
        return ff.softmax(a[0], axis=cfg["dim"], name=name)
    if kind == "dropout":
        return ff.dropout(a[0], cfg["p"], name=name)
    if kind == "flatten":
        return _flatten(ff, a[0], cfg["start"], cfg["end"], name)
    if kind == "identity":
        return a[0]
    if kind == "mha":
        out = ff.multihead_attention(
            a[0], a[1], a[2], cfg["embed"], cfg["heads"],
            dropout=cfg["dropout"], bias=cfg["bias"],
            add_bias_kv=cfg["add_bias_kv"], name=name)
        # torch MHA returns (output, attn_weights): the traced
        # 'out, _ = attn(...)' unpack resolves through getitem(0)
        return (out, None)
    raise ValueError(f"unsupported module config kind: {kind}")


# ---------------------------------------------------------------------------
# function / method lowering by canonical name
# ---------------------------------------------------------------------------

_FN_NAMES: Dict = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.truediv: "div", operator.floordiv: "floordiv",
    operator.neg: "neg", operator.pow: "pow",
    operator.getitem: "getitem",
    # fx records `x.shape` as call_function(builtins.getattr): shapes are
    # static, so it folds to a tuple of ints
    getattr: "getattr_",
    torch.add: "add", torch.sub: "sub", torch.mul: "mul",
    torch.div: "div", torch.pow: "pow", torch.neg: "neg",
    torch.relu: "relu", F.relu: "relu", F.gelu: "gelu",
    torch.sigmoid: "sigmoid", F.sigmoid: "sigmoid",
    torch.tanh: "tanh", F.tanh: "tanh", F.elu: "elu",
    torch.exp: "exp", torch.log: "log", torch.sin: "sin",
    torch.cos: "cos", torch.sqrt: "sqrt", torch.rsqrt: "rsqrt",
    torch.erf: "erf", torch.floor: "floor",
    torch.maximum: "maximum", torch.minimum: "minimum",
    torch.max: "maximum", torch.min: "minimum",
    F.softmax: "softmax", torch.flatten: "flatten",
    torch.cat: "cat", torch.split: "split", torch.chunk: "chunk",
    torch.matmul: "matmul", torch.bmm: "matmul",
    torch.reshape: "reshape", torch.transpose: "transpose",
    torch.permute: "permute", torch.mean: "mean",
    torch.sum: "sum", torch.unsqueeze: "unsqueeze",
    torch.squeeze: "squeeze", F.dropout: "dropout",
    F.linear: "f_linear", F.conv2d: "f_conv2d",
    F.adaptive_avg_pool2d: "adaptive_avg_pool2d",
    F.avg_pool2d: "avg_pool2d", F.max_pool2d: "max_pool2d",
}

_METHOD_ALIASES = {
    "view": "reshape", "reshape": "reshape", "permute": "permute",
    "transpose": "transpose", "flatten": "flatten",
    "contiguous": "identity_m", "mean": "mean", "sum": "sum",
    "size": "size", "pow": "pow", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "expand": "expand", "expand_as": "expand_as",
    "unsqueeze": "unsqueeze", "squeeze": "squeeze", "chunk": "chunk",
    "split": "split", "to": "to", "float": "to_float",
    "type_as": "type_as", "relu": "relu", "sigmoid": "sigmoid",
    "tanh": "tanh", "matmul": "matmul", "bmm": "matmul",
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "masked_fill": None, "detach": "identity_m",
}


class TracedArray(np.ndarray):
    """A numpy view of a get_attr tensor that remembers whether the
    tensor required grad (a buffer imports as a frozen WeightOp)."""

    trainable: bool = True


def _traced_array(arr, trainable: bool) -> TracedArray:
    t = np.asarray(arr).view(TracedArray)
    t.trainable = bool(trainable)
    return t


def _is_tensor(x) -> bool:
    return isinstance(x, ParallelTensor)


def _axis_arg(a, kw, pos, key="dim", default=None):
    if key in kw:
        return kw[key]
    return a[pos] if len(a) > pos else default


def _getitem(ff: FFModel, x, idx, name: str):
    """getitem on a tensor: ints, slices of step 1 and tuples of them,
    lowered through Split (and a Reshape that drops the int-indexed
    dims)."""
    if isinstance(x, (tuple, list)):
        return x[idx]
    if not _is_tensor(x):
        raise ValueError(f"getitem on unsupported value {type(x)}")
    items = idx if isinstance(idx, tuple) else (idx,)
    out = x
    squeeze_axes = []
    for axis, it in enumerate(items):
        size = out.shape.logical_shape[axis]
        if isinstance(it, slice):
            if it == slice(None):
                continue
            start = it.start or 0
            if start < 0:
                start += size
            stop = size if it.stop is None else it.stop
            if stop < 0:
                stop += size
            # torch clamps out-of-range bounds
            start = max(0, start)
            stop = max(start, min(stop, size))
            if stop == start:
                raise ValueError(f"empty slice on axis {axis} is "
                                 "unsupported")
            if (it.step or 1) != 1:
                raise ValueError("strided tensor slicing is unsupported")
            out = _slice_axis(ff, out, axis, start, stop, name)
        elif isinstance(it, int):
            it = it % size
            out = _slice_axis(ff, out, axis, it, it + 1, name)
            squeeze_axes.append(axis)
        else:
            raise ValueError(f"unsupported tensor index {it!r}")
    if squeeze_axes:
        shape = [s for ax, s in enumerate(out.shape.logical_shape)
                 if ax not in squeeze_axes]
        out = ff.reshape(out, shape, name=f"{name}_sq")
    return out


def _slice_axis(ff, x, axis, start, stop, name):
    size = x.shape.logical_shape[axis]
    sizes = [s for s in (start, stop - start, size - stop) if s > 0]
    if sizes == [size]:
        return x
    parts = ff.split(x, sizes, axis, name=f"{name}_ax{axis}")
    return parts[1 if start > 0 else 0]


def _unsqueeze(ff, x, dim, name):
    shape = list(x.shape.logical_shape)
    shape.insert(dim % (len(shape) + 1), 1)
    return ff.reshape(x, shape, name=name)


def _squeeze(ff, x, dim, name):
    shape = list(x.shape.logical_shape)
    if dim is None:
        shape = [s for s in shape if s != 1]
    else:
        dim = dim % len(shape)
        if shape[dim] != 1:
            return x
        shape.pop(dim)
    return ff.reshape(x, shape, name=name)


def _flatten(ff, x, start, end, name):
    """flatten(start, end): Flat for (1, -1), as the reference lowers
    it; a Reshape otherwise."""
    shape = list(x.shape.logical_shape)
    start, end = start % len(shape), end % len(shape)
    if start == 1 and end == len(shape) - 1:
        return ff.flat(x, name=name)
    merged = math.prod(shape[start:end + 1])
    return ff.reshape(x, shape[:start] + [merged] + shape[end + 1:],
                      name=name)


def lower_function(ff: FFModel, fname: str, a: List, kw: Dict, name: str):
    """Lower one call_function node by canonical name (the reference's
    FunctionNode kinds)."""
    if fname in ("add", "sub", "mul", "div"):
        # a bare parameter or buffer operand becomes a WeightOp, frozen
        # when the source did not require grad
        a = [ff.weight_tensor(v, trainable=getattr(v, "trainable", True),
                              name=f"{name}_w{i}")
             if isinstance(v, np.ndarray) and v.ndim > 0 else v
             for i, v in enumerate(a)]
        if _is_tensor(a[0]) and _is_tensor(a[1]):
            fn = {"add": ff.add, "sub": ff.subtract, "mul": ff.multiply,
                  "div": ff.divide}[fname]
            return fn(a[0], a[1], name=name)
        if not _is_tensor(a[0]) and not _is_tensor(a[1]):
            # static-shape arithmetic in the trace folds in Python
            return {"add": operator.add, "sub": operator.sub,
                    "mul": operator.mul,
                    "div": operator.truediv}[fname](a[0], a[1])
        tensor, scalar = (a[0], a[1]) if _is_tensor(a[0]) else (a[1], a[0])
        if fname == "sub" and not _is_tensor(a[0]):
            # scalar - x = -(x - scalar)
            t = ff.scalar_sub(tensor, float(scalar), name=f"{name}_s")
            return ff.scalar_multiply(t, -1.0, name=name)
        if fname == "div" and not _is_tensor(a[0]):
            # scalar / x = scalar * x^-1
            t = ff.pow(tensor, -1.0, name=f"{name}_r")
            return ff.scalar_multiply(t, float(scalar), name=name)
        fn = {"add": ff.scalar_add, "sub": ff.scalar_sub,
              "mul": ff.scalar_multiply,
              "div": ff.scalar_true_divide}[fname]
        return fn(tensor, float(scalar), name=name)
    if fname == "floordiv":
        if not _is_tensor(a[0]):  # folded shape arithmetic (shape // 2)
            return operator.floordiv(a[0], a[1])
        t = ff.scalar_true_divide(a[0], float(a[1]), name=f"{name}_d")
        return ff.floor(t, name=name)
    if fname == "neg":
        if not _is_tensor(a[0]):
            return -a[0]
        return ff.scalar_multiply(a[0], -1.0, name=name)
    if fname == "pow":
        if not _is_tensor(a[0]):
            return operator.pow(a[0], a[1])
        return ff.pow(a[0], float(a[1]), name=name)
    if fname in _UNARY_FNS:
        return getattr(ff, _UNARY_FNS[fname])(a[0], name=name)
    if fname in ("maximum", "minimum"):
        if len(a) < 2 or not _is_tensor(a[1]):
            raise ValueError(f"{fname} reduction form is unsupported")
        return (ff.max if fname == "maximum" else ff.min)(a[0], a[1],
                                                          name=name)
    if fname == "softmax":
        return ff.softmax(a[0], axis=_axis_arg(a, kw, 1, default=-1),
                          name=name)
    if fname == "flatten":
        start = kw.get("start_dim", a[1] if len(a) > 1 else 0)
        end = kw.get("end_dim", a[2] if len(a) > 2 else -1)
        return _flatten(ff, a[0], start, end, name)
    if fname == "cat":
        return ff.concat(list(a[0]), _axis_arg(a, kw, 1, default=0),
                         name=name)
    if fname == "split":
        axis = _axis_arg(a, kw, 2, default=0)
        spec = a[1]
        if isinstance(spec, int):  # torch: the size of each chunk
            size = a[0].shape.logical_shape[axis]
            sizes = [spec] * (size // spec)
            if size % spec:
                sizes.append(size % spec)
        else:
            sizes = list(spec)
        return ff.split(a[0], sizes, axis, name=name)
    if fname == "chunk":
        axis = _axis_arg(a, kw, 2, default=0)
        n = int(a[1])
        size = a[0].shape.logical_shape[axis]
        sizes = [size // n + (1 if i < size % n else 0) for i in range(n)]
        return ff.split(a[0], sizes, axis, name=name)
    if fname == "matmul":
        if _is_tensor(a[1]):
            return ff.batch_matmul(a[0], a[1], name=name)
        # a constant operand: x @ W is a dense layer with pinned weights
        return _dense_from_array(ff, a[0], np.asarray(a[1]), None, name,
                                 transpose=False)
    if fname in ("reshape", "permute"):
        # the shape or perm as one sequence, or spread as a method's args
        dims = a[1] if isinstance(a[1], (tuple, list)) else a[1:]
        if fname == "reshape":
            return _reshape(ff, a[0], dims, name)
        return ff.transpose(a[0], list(dims), name=name)
    if fname == "transpose":
        return _transpose2(ff, a[0], a[1], a[2], name)
    if fname == "unsqueeze":
        return _unsqueeze(ff, a[0], _axis_arg(a, kw, 1, default=0), name)
    if fname == "squeeze":
        return _squeeze(ff, a[0], _axis_arg(a, kw, 1), name)
    if fname == "dropout":
        return ff.dropout(a[0], kw.get("p", a[1] if len(a) > 1 else 0.5),
                          name=name)
    if fname == "f_linear":
        w = np.asarray(a[1])
        b = a[2] if len(a) > 2 else kw.get("bias")
        return _dense_from_array(ff, a[0], w,
                                 None if b is None else np.asarray(b), name,
                                 transpose=True)
    if fname == "f_conv2d":
        w = np.asarray(a[1])
        b = a[2] if len(a) > 2 else kw.get("bias")
        b = None if b is None else np.asarray(b)
        stride = kw.get("stride", a[3] if len(a) > 3 else 1)
        padding = kw.get("padding", a[4] if len(a) > 4 else 0)
        groups = kw.get("groups", a[6] if len(a) > 6 else 1)
        stride = stride if isinstance(stride, (tuple, list)) else (stride,) * 2
        padding = (padding if isinstance(padding, (tuple, list))
                   else (padding,) * 2)
        out = ff.conv2d(a[0], w.shape[0], w.shape[2], w.shape[3], stride[0],
                        stride[1], padding[0], padding[1], groups=int(groups),
                        use_bias=b is not None, name=name)
        _pin_weights(out.owner_op, kernel=w, bias=b)
        return out
    if fname == "to":
        return _cast_like(ff, a, kw, name)
    if fname in ("mean", "sum"):
        axes = _axis_arg(a, kw, 1)
        if axes is None:
            axes = list(range(a[0].shape.logical_rank))
        if isinstance(axes, int):
            axes = [axes]
        fn = ff.mean if fname == "mean" else ff.reduce_sum
        return fn(a[0], list(axes), keepdims=kw.get("keepdim", False),
                  name=name)
    if fname == "getitem":
        return _getitem(ff, a[0], a[1], name)
    if fname == "getattr_":
        x, attr = a[0], a[1]
        if _is_tensor(x) and attr == "shape":
            return tuple(x.shape.logical_shape)
        if not _is_tensor(x):
            return getattr(x, attr)
        raise ValueError(f"unsupported tensor attribute in trace: {attr}")
    if fname == "adaptive_avg_pool2d":
        o = a[1] if isinstance(a[1], (tuple, list)) else (a[1], a[1])
        h, w = a[0].shape.logical_shape[2:4]
        return ff.pool2d(a[0], h // o[0], w // o[1], h // o[0], w // o[1],
                         0, 0, pool_type="avg", name=name)
    if fname in ("avg_pool2d", "max_pool2d"):
        k = a[1] if isinstance(a[1], (tuple, list)) else (a[1],) * 2
        s = kw.get("stride", a[2] if len(a) > 2 else None) or k
        s = s if isinstance(s, (tuple, list)) else (s,) * 2
        p = kw.get("padding", a[3] if len(a) > 3 else 0)
        p = p if isinstance(p, (tuple, list)) else (p,) * 2
        return ff.pool2d(a[0], k[0], k[1], s[0], s[1], p[0], p[1],
                         pool_type="avg" if fname == "avg_pool2d" else "max",
                         name=name)
    raise ValueError(f"unsupported torch function in trace: {fname}")


def lower_method(ff: FFModel, mname: str, a: List, kw: Dict, name: str):
    """Lower one call_method node (the reference's tensor-method
    nodes)."""
    canon = _METHOD_ALIASES.get(mname)
    if canon is None:
        raise ValueError(f"unsupported tensor method in trace: {mname}")
    x = a[0]
    if canon == "identity_m":
        return x
    if canon == "size":
        return (x.shape.logical_shape[a[1]] if len(a) > 1
                else x.shape.logical_shape)
    if canon == "expand":
        # a bare parameter (an array, not a tensor) fails here, as in the
        # reference
        sizes = a[1] if isinstance(a[1], (tuple, list)) else a[1:]
        return ff.expand(x, [int(s) for s in sizes], name=name)
    if canon == "expand_as":
        return ff.expand(x, a[1].shape.logical_shape, name=name)
    if canon == "to_float":
        return ff.cast(x, DataType.FLOAT, name=name)
    if canon == "type_as":
        return ff.cast(x, a[1].shape.dtype, name=name)
    return lower_function(ff, canon, a, kw, name)


def _reshape(ff, x, shape, name):
    # Reshape's shape rule resolves a -1 (ops/shape.py)
    return ff.reshape(x, [int(s) for s in shape], name=name)


def _transpose2(ff, x, d0, d1, name):
    perm = list(range(x.shape.logical_rank))
    perm[d0], perm[d1] = perm[d1], perm[d0]
    return ff.transpose(x, perm, name=name)


def _cast_like(ff, a, kw, name):
    """.to(dtype): a Cast (a torch dtype or its name); without a dtype,
    the tensor as it is."""
    target = kw.get("dtype", a[1] if len(a) > 1 else None)
    if target is None:
        return a[0]
    return ff.cast(a[0], DataType.from_any(target), name=name)


def _dense_from_array(ff, x, w, b, name, transpose: bool):
    """F.linear or a product with a constant: a dense layer with pinned
    weights.  F.linear's weight is [out, in]; a constant right operand
    of matmul is [in, out]."""
    kernel = w.T.copy() if transpose else np.asarray(w)
    out = ff.dense(x, kernel.shape[1], use_bias=b is not None, name=name)
    _pin_weights(out.owner_op, kernel=kernel, bias=b)
    return out


def _pin_weights(op, kernel=None, bias=None):
    by_name = {"kernel": kernel, "bias": bias}
    op.weight_specs = [
        s.__class__(s.name, s.shape, ArrayInitializer(by_name[s.name]))
        if by_name.get(s.name) is not None else s
        for s in op.weight_specs]


# ---------------------------------------------------------------------------
# the importer
# ---------------------------------------------------------------------------

class PyTorchModel:
    """Wraps an nn.Module for lowering into an FFModel:

        pt = PyTorchModel(torch_module)
        (out,) = pt.torch_to_ff(ffmodel, [input_tensor])
        ffmodel.compile(...)
        pt.copy_weights(ffmodel)   # the module's weights and BN stats
    """

    def __init__(self, module, seq_length: Optional[int] = None):
        self.module = module
        self.seq_length = seq_length
        self.traced = torch.fx.symbolic_trace(module)
        # fx node name -> ff op name (for copy_weights)
        self._op_of_node: Dict[str, str] = {}

    def torch_to_ff(self, ff: FFModel,
                    inputs: Sequence[ParallelTensor]) -> List[ParallelTensor]:
        env: Dict[str, object] = {}
        input_iter = iter(inputs)
        outputs: List[ParallelTensor] = []
        modules = dict(self.traced.named_modules())

        def resolve(x):
            return env[x.name] if isinstance(x, torch.fx.Node) else x

        for node in self.traced.graph.nodes:
            if node.op == "placeholder":
                env[node.name] = next(input_iter)
            elif node.op == "get_attr":
                v = _fetch_attr(self.module, node.target)
                if isinstance(v, torch.Tensor):
                    v = _traced_array(v.detach().cpu().numpy(),
                                      v.requires_grad)
                env[node.name] = v
            elif node.op == "call_module":
                if node.kwargs:
                    raise ValueError(
                        f"unsupported module kwargs {list(node.kwargs)} on "
                        f"{node.target} (e.g. MHA masks are not lowered)")
                cfg = module_config(modules[node.target])
                a = torch.fx.node.map_arg(list(node.args), resolve)
                env[node.name] = lower_module(ff, cfg, a, node.name)
                if cfg["kind"] in _WEIGHTED_KINDS:
                    self._op_of_node[node.name] = node.name
            elif node.op == "call_function":
                fname = _FN_NAMES.get(node.target)
                if fname is None:
                    raise ValueError(
                        f"unsupported torch function in trace: {node.target}")
                a = torch.fx.node.map_arg(list(node.args), resolve)
                kw = torch.fx.node.map_arg(dict(node.kwargs), resolve)
                env[node.name] = lower_function(ff, fname, a, kw, node.name)
            elif node.op == "call_method":
                a = torch.fx.node.map_arg(list(node.args), resolve)
                kw = torch.fx.node.map_arg(dict(node.kwargs), resolve)
                env[node.name] = lower_method(ff, node.target, a, kw,
                                              node.name)
            elif node.op == "output":
                args = node.args[0]
                if isinstance(args, (tuple, list)):
                    outputs.extend(env[x.name] for x in args)
                else:
                    outputs.append(env[args.name])
        return outputs

    def torch_to_file(self, path: str):
        """Write the trace to `path` as JSON lines, and its get_attr
        tensors to `path + ".npz"` (when there are any)."""
        modules = dict(self.traced.named_modules())
        consts: Dict[str, np.ndarray] = {}
        lines: List[str] = []

        def enc(x):
            if isinstance(x, torch.fx.Node):
                return {"__ref__": x.name}
            if isinstance(x, slice):
                return {"__slice__": [x.start, x.stop, x.step]}
            if isinstance(x, (list, tuple)):
                return {"__list__": [enc(v) for v in x]}
            if isinstance(x, torch.dtype):
                return {"__dtype__": str(x).replace("torch.", "")}
            if x is None or isinstance(x, (bool, int, float, str)):
                return x
            raise ValueError(f"unserializable arg {x!r} in fx trace")

        for node in self.traced.graph.nodes:
            if node.op == "placeholder":
                lines.append(json.dumps({"op": "input", "name": node.name}))
            elif node.op == "get_attr":
                v = _fetch_attr(self.module, node.target)
                if isinstance(v, torch.Tensor):
                    consts[node.name] = v.detach().cpu().numpy()
                    lines.append(json.dumps(
                        {"op": "const", "name": node.name,
                         "trainable": bool(v.requires_grad)}))
                else:
                    lines.append(json.dumps(
                        {"op": "literal", "name": node.name, "value": v}))
            elif node.op in ("call_module", "call_function", "call_method"):
                if node.op == "call_module" and node.kwargs:
                    raise ValueError(
                        f"unsupported module kwargs {list(node.kwargs)} on "
                        f"{node.target}")
                rec = {"op": node.op, "name": node.name,
                       "args": [enc(x) for x in node.args],
                       "kwargs": {k: enc(v) for k, v in node.kwargs.items()}}
                if node.op == "call_module":
                    rec["config"] = module_config(modules[node.target])
                elif node.op == "call_function":
                    fname = _FN_NAMES.get(node.target)
                    if fname is None:
                        raise ValueError(
                            f"unsupported function {node.target} in trace")
                    rec["target"] = fname
                else:
                    rec["target"] = node.target
                lines.append(json.dumps(rec))
            elif node.op == "output":
                args = node.args[0]
                refs = ([x.name for x in args]
                        if isinstance(args, (tuple, list)) else [args.name])
                lines.append(json.dumps({"op": "output", "refs": refs}))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        if consts:
            np.savez(path + ".npz", **consts)

    def copy_weights(self, ff: FFModel):
        """Copy the module's parameters into the compiled FFModel (torch
        Linear [out, in] -> kernel [in, out]; conv kernels OIHW as they
        are) and BatchNorm's running statistics into its op state.  The
        arrays pinned at trace time (WeightOps, functional weights) stay
        as imported."""
        weights = ff.get_weights()
        state = ff.get_state()
        modules = dict(self.traced.named_modules())
        nodes = {n.name: n for n in self.traced.graph.nodes}

        def arr(t):
            return t.detach().cpu().numpy().copy()

        for fx_name, op_name in self._op_of_node.items():
            m = modules[nodes[fx_name].target]
            if op_name not in weights:
                continue
            entry = weights[op_name]
            if isinstance(m, nn.Linear):
                entry["kernel"] = arr(m.weight).T.copy()
                if m.bias is not None:
                    entry["bias"] = arr(m.bias)
            elif isinstance(m, nn.Conv2d):
                entry["kernel"] = arr(m.weight)
                if m.bias is not None:
                    entry["bias"] = arr(m.bias)
            elif isinstance(m, nn.Embedding):
                entry["weight"] = arr(m.weight)
            elif isinstance(m, nn.LayerNorm) and m.elementwise_affine:
                entry["gamma"] = arr(m.weight)
                entry["beta"] = arr(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                entry["gamma"] = arr(m.weight)
                entry["beta"] = arr(m.bias)
                st = state.get(op_name, {})
                if m.running_mean is not None:
                    st["running_mean"] = arr(m.running_mean)
                    st["running_var"] = arr(m.running_var)
            elif isinstance(m, nn.MultiheadAttention):
                _copy_mha(m, entry)
        ff.set_weights(weights)
        ff.set_state(state)


def _copy_mha(m, entry):
    """Packed in_proj [3E, E] (or separate q/k/v_proj_weight when kdim or
    vdim differ) and out_proj [E, E] -> per-head wq/wk/wv [E_in, H, C]
    and wo [H, C, E] (ops/attention.py)."""
    E, H = m.embed_dim, m.num_heads
    C = E // H

    def per_head(w):  # [E_out = H*C, E_in] -> [E_in, H, C]
        return w.reshape(H, C, w.shape[1]).transpose(2, 0, 1).copy()

    if m.in_proj_weight is not None:
        ipw = m.in_proj_weight.detach().numpy()
        wq, wk, wv = ipw[:E], ipw[E:2 * E], ipw[2 * E:]
    else:
        wq = m.q_proj_weight.detach().numpy()
        wk = m.k_proj_weight.detach().numpy()
        wv = m.v_proj_weight.detach().numpy()
    entry["wq"], entry["wk"], entry["wv"] = (per_head(wq), per_head(wk),
                                             per_head(wv))
    entry["wo"] = (m.out_proj.weight.detach().numpy()
                   .reshape(E, H, C).transpose(1, 2, 0).copy())
    if m.in_proj_bias is not None:
        ipb = m.in_proj_bias.detach().numpy()
        entry["bq"] = ipb[:E].reshape(H, C).copy()
        entry["bk"] = ipb[E:2 * E].reshape(H, C).copy()
        entry["bv"] = ipb[2 * E:].reshape(H, C).copy()
        entry["bo"] = m.out_proj.bias.detach().numpy().copy()
    if m.bias_k is not None and "bias_k" in entry:
        # appended bias token, torch [1, 1, E] -> [1, H, C]
        entry["bias_k"] = m.bias_k.detach().numpy().reshape(1, H, C).copy()
        entry["bias_v"] = m.bias_v.detach().numpy().reshape(1, H, C).copy()


def file_to_ff(path: str, ff: FFModel,
               inputs: Sequence[ParallelTensor]) -> List[ParallelTensor]:
    """Replay a trace written by torch_to_file (of either package) onto
    `ff`, through the same lowering calls as torch_to_ff; returns the
    output tensors."""
    consts = {}
    if os.path.exists(path + ".npz"):
        with np.load(path + ".npz") as data:
            consts = dict(data)
    env: Dict[str, object] = {}
    input_iter = iter(inputs)
    outputs: List[ParallelTensor] = []

    def dec(x):
        if isinstance(x, dict):
            if "__ref__" in x:
                return env[x["__ref__"]]
            if "__slice__" in x:
                return slice(*x["__slice__"])
            if "__list__" in x:
                return [dec(v) for v in x["__list__"]]
            if "__dtype__" in x:
                return x["__dtype__"]
        return x

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            op = rec["op"]
            if op == "input":
                env[rec["name"]] = next(input_iter)
            elif op == "const":
                env[rec["name"]] = _traced_array(consts[rec["name"]],
                                                 rec.get("trainable", True))
            elif op == "literal":
                env[rec["name"]] = rec["value"]
            elif op == "output":
                outputs.extend(env[r] for r in rec["refs"])
            else:
                a = [dec(x) for x in rec["args"]]
                kw = {k: dec(v) for k, v in rec["kwargs"].items()}
                name = rec["name"]
                if op == "call_module":
                    env[name] = lower_module(ff, rec["config"], a, name)
                elif op == "call_function":
                    # tuples serialize as __list__: getitem indices, and
                    # the shape tuples of `x.size()[:-1] + (h, d)`
                    if rec["target"] == "getitem" and isinstance(a[1], list):
                        a[1] = tuple(a[1])
                    if rec["target"] == "add" and any(
                            isinstance(v, tuple) for v in a):
                        a = [tuple(v) if isinstance(v, list) else v
                             for v in a]
                    env[name] = lower_function(ff, rec["target"], a, kw, name)
                else:
                    env[name] = lower_method(ff, rec["target"], a, kw, name)
    return outputs


def _fetch_attr(module, target: str):
    obj = module
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj
