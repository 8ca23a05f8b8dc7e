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

A node whose op the port does not have yet (Dropout, Cast, Reshape,
Transpose, Concat, Split, BatchMatmul, weights pinned from functional
calls or bare parameters) raises NotImplementedError naming the
ROADMAP.md item it waits for.  The string-IR file route of the
reference (`torch_to_file`, `file_to_ff`) comes with a later slice.
"""
from __future__ import annotations

import operator
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.fx
import torch.nn as nn
import torch.nn.functional as F

from ..model import FFModel
from ..tensor import ParallelTensor

# where the ops these nodes lower to are queued
_ROADMAP_OPS = "ROADMAP.md §1.B.2 (op forwards and grads)"


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what}: the port has no op for it yet; it waits for "
        f"{_ROADMAP_OPS}")


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
        _not_ported("nn.Dropout (Dropout op)")
    if kind == "flatten":
        if cfg["start"] != 1 or cfg["end"] != -1:
            _not_ported("nn.Flatten other than (1, -1) (Reshape op)")
        return ff.flat(a[0], name=name)
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

# canonical names whose op the port lacks, with the op named
_NOT_PORTED = {
    "cat": "Concat", "split": "Split", "chunk": "Split",
    "matmul": "BatchMatmul", "reshape": "Reshape",
    "transpose": "Transpose", "permute": "Transpose",
    "unsqueeze": "Reshape", "squeeze": "Reshape", "dropout": "Dropout",
    "f_linear": "Linear with pinned array weights",
    "f_conv2d": "Conv2D with pinned array weights", "to": "Cast",
    "to_float": "Cast", "type_as": "Cast", "expand": "Expand",
    "expand_as": "Expand",
}


def _is_tensor(x) -> bool:
    return isinstance(x, ParallelTensor)


def _axis_arg(a, kw, pos, key="dim", default=None):
    if key in kw:
        return kw[key]
    return a[pos] if len(a) > pos else default


def lower_function(ff: FFModel, fname: str, a: List, kw: Dict, name: str):
    """Lower one call_function node by canonical name (the reference's
    FunctionNode kinds)."""
    if fname in _NOT_PORTED:
        _not_ported(f"torch function {fname!r} ({_NOT_PORTED[fname]} op)")
    if fname in ("add", "sub", "mul", "div"):
        if any(isinstance(v, np.ndarray) and v.ndim > 0 for v in a):
            _not_ported(f"{fname} with a bare parameter or buffer operand "
                        "(WeightOp)")
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
        if start == 1 and kw.get("end_dim", -1) == -1:
            return ff.flat(a[0], name=name)
        _not_ported("flatten other than (1, -1) (Reshape op)")
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
        if isinstance(a[0], (tuple, list)):
            return a[0][a[1]]
        _not_ported("indexing a tensor (Split and Reshape ops)")
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
    if canon == "flatten":
        return lower_function(ff, "flatten", [x, a[1] if len(a) > 1 else 0],
                              {}, name)
    return lower_function(ff, canon, a, kw, name)


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
                    v = v.detach().numpy()
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

    def copy_weights(self, ff: FFModel):
        """Copy the module's parameters into the compiled FFModel (torch
        Linear [out, in] -> kernel [in, out]; conv kernels OIHW as they
        are) and BatchNorm's running statistics into its op state."""
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


def _fetch_attr(module, target: str):
    obj = module
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj
