"""ONNX graph -> FFModel importer of the port
(flexflow_tpu/onnx_frontend/model.py).

`ONNXModel.apply` walks the graph and lowers each node through one
handler per op_type onto the port's FFModel layer calls, with the
reference's handlers and names; initializer tensors become the weights
that `copy_weights` writes after compile, and BatchNormalization's
running statistics go into the op state (FFModel.set_state).  Parsing
prefers the `onnx` package when it is installed and otherwise reads the
wire bytes through protowire.py, so bytes and paths import without it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..model import FFModel
from ..tensor import ParallelTensor
from . import protowire


def _attrs(node) -> Dict[str, object]:
    out = {}
    for a in node.attribute:
        if isinstance(a, protowire.Attribute):
            out[a.name] = a.value
        else:
            import onnx

            out[a.name] = onnx.helper.get_attribute_value(a)
    return out


class ONNXModel:
    def __init__(self, path_or_model):
        try:
            import onnx
            import onnx.numpy_helper
        except ImportError:
            onnx = None
        if isinstance(path_or_model, str):
            self.model = (onnx.load(path_or_model) if onnx is not None
                          else protowire.load_model(path_or_model))
        elif isinstance(path_or_model, bytes):
            self.model = (onnx.ModelProto.FromString(path_or_model)
                          if onnx is not None
                          else protowire.load_model(path_or_model))
        else:
            self.model = path_or_model
        self.graph = self.model.graph
        self.initializers: Dict[str, np.ndarray] = {}
        for init in self.graph.initializer:
            if isinstance(init, protowire.Tensor):
                self.initializers[init.name] = init.array
            else:
                self.initializers[init.name] = onnx.numpy_helper.to_array(
                    init
                )
        self._weight_of_op: Dict[str, Dict[str, np.ndarray]] = {}
        # op state captured at import (BatchNorm's running statistics),
        # written into the op state by copy_weights
        self._state_of_op: Dict[str, Dict[str, np.ndarray]] = {}

    # ------------------------------------------------------------------
    def apply(self, ff: FFModel,
              inputs: Sequence[ParallelTensor]) -> List[ParallelTensor]:
        env: Dict[str, object] = {}
        graph_inputs = [
            i for i in self.graph.input if i.name not in self.initializers
        ]
        for gi, t in zip(graph_inputs, inputs):
            env[gi.name] = t
        for name, arr in self.initializers.items():
            env[name] = arr

        for node in self.graph.node:
            handler = getattr(self, f"_handle_{node.op_type.lower()}", None)
            if handler is None:
                raise ValueError(f"unsupported ONNX op: {node.op_type}")
            outs = handler(ff, node, env)
            if not isinstance(outs, (tuple, list)):
                outs = [outs]
            for oname, val in zip(node.output, outs):
                env[oname] = val
        return [env[o.name] for o in self.graph.output]

    def copy_weights(self, ff: FFModel):
        """The imported initializers into the compiled model's weights,
        and BatchNorm's running statistics into its op state, by op
        name (ops the graph did not import keep their values)."""
        weights = ff.get_weights()
        for op_name, entry in self._weight_of_op.items():
            if op_name in weights:
                weights[op_name].update(entry)
        ff.set_weights(weights)
        state = ff.get_state()
        for op_name, entry in self._state_of_op.items():
            st = state.get(op_name)
            if st is None:
                continue
            for k, v in entry.items():
                if k in st:
                    st[k] = np.asarray(v, st[k].dtype)
        ff.set_state(state)

    # -- handlers (one per ONNX op_type) ----------------------------------
    def _handle_gemm(self, ff, node, env):
        x = env[node.input[0]]
        w = env[node.input[1]]  # [out, in] (transB=1 convention)
        at = _attrs(node)
        if at.get("transA", 0):
            raise ValueError(
                f"Gemm {node.name}: transA=1 unsupported (no graph op "
                "transposes the activation operand)"
            )
        if not at.get("transB", 0):
            w = w.T
        # alpha/beta fold into the (constant) weight and bias
        alpha = float(at.get("alpha", 1.0))
        beta = float(at.get("beta", 1.0))
        w = w * alpha if alpha != 1.0 else w
        out_dim = w.shape[0]
        use_bias = len(node.input) > 2
        name = node.name or f"gemm_{node.output[0]}"
        out = ff.dense(x, out_dim, use_bias=use_bias, name=name)
        entry = {"kernel": np.ascontiguousarray(w.T)}
        if use_bias:
            b = np.asarray(env[node.input[2]], np.float32)
            entry["bias"] = b * beta if beta != 1.0 else b
        self._weight_of_op[name] = entry
        return out

    def _handle_matmul(self, ff, node, env):
        x = env[node.input[0]]
        w = env[node.input[1]]
        if isinstance(w, np.ndarray):  # weight matmul == dense, [in, out]
            name = node.name or f"matmul_{node.output[0]}"
            out = ff.dense(x, w.shape[1], use_bias=False, name=name)
            self._weight_of_op[name] = {"kernel": np.ascontiguousarray(w)}
            return out
        return ff.batch_matmul(x, w, name=node.name or None)

    def _handle_conv(self, ff, node, env):
        x = env[node.input[0]]
        w = env[node.input[1]]  # OIHW
        at = _attrs(node)
        kh, kw = at.get("kernel_shape", w.shape[2:4])
        sh, sw = at.get("strides", [1, 1])
        pads = at.get("pads", [0, 0, 0, 0])
        groups = at.get("group", 1)
        use_bias = len(node.input) > 2
        name = node.name or f"conv_{node.output[0]}"
        out = ff.conv2d(x, w.shape[0], kh, kw, sh, sw, pads[0], pads[1],
                        groups=groups, use_bias=use_bias, name=name)
        entry = {"kernel": np.asarray(w)}
        if use_bias:
            entry["bias"] = np.asarray(env[node.input[2]])
        self._weight_of_op[name] = entry
        return out

    def _handle_maxpool(self, ff, node, env):
        at = _attrs(node)
        kh, kw = at["kernel_shape"]
        sh, sw = at.get("strides", [1, 1])
        pads = at.get("pads", [0, 0, 0, 0])
        return ff.pool2d(env[node.input[0]], kh, kw, sh, sw, pads[0], pads[1],
                         pool_type="max", name=node.name or None)

    def _handle_averagepool(self, ff, node, env):
        at = _attrs(node)
        kh, kw = at["kernel_shape"]
        sh, sw = at.get("strides", [1, 1])
        pads = at.get("pads", [0, 0, 0, 0])
        return ff.pool2d(env[node.input[0]], kh, kw, sh, sw, pads[0], pads[1],
                         pool_type="avg", name=node.name or None)

    def _handle_relu(self, ff, node, env):
        return ff.relu(env[node.input[0]], name=node.name or None)

    def _handle_sigmoid(self, ff, node, env):
        return ff.sigmoid(env[node.input[0]], name=node.name or None)

    def _handle_tanh(self, ff, node, env):
        return ff.tanh(env[node.input[0]], name=node.name or None)

    def _handle_softmax(self, ff, node, env):
        at = _attrs(node)
        return ff.softmax(env[node.input[0]], axis=at.get("axis", -1),
                          name=node.name or None)

    def _handle_add(self, ff, node, env):
        return ff.add(env[node.input[0]], env[node.input[1]],
                      name=node.name or None)

    def _handle_sub(self, ff, node, env):
        return ff.subtract(env[node.input[0]], env[node.input[1]],
                           name=node.name or None)

    def _handle_mul(self, ff, node, env):
        return ff.multiply(env[node.input[0]], env[node.input[1]],
                           name=node.name or None)

    def _handle_concat(self, ff, node, env):
        at = _attrs(node)
        return ff.concat([env[i] for i in node.input], at.get("axis", 0),
                         name=node.name or None)

    def _handle_split(self, ff, node, env):
        at = _attrs(node)
        sizes = at.get("split")
        if sizes is None:
            sizes = len(node.output)
        return ff.split(env[node.input[0]], list(sizes)
                        if not isinstance(sizes, int) else sizes,
                        at.get("axis", 0), name=node.name or None)

    def _handle_flatten(self, ff, node, env):
        return ff.flat(env[node.input[0]], name=node.name or None)

    def _handle_reshape(self, ff, node, env):
        shape = env[node.input[1]]
        return ff.reshape(env[node.input[0]], [int(s) for s in shape],
                          name=node.name or None)

    def _handle_transpose(self, ff, node, env):
        at = _attrs(node)
        return ff.transpose(env[node.input[0]], list(at["perm"]),
                            name=node.name or None)

    def _handle_dropout(self, ff, node, env):
        at = _attrs(node)
        return ff.dropout(env[node.input[0]], at.get("ratio", 0.5),
                          name=node.name or None)

    def _handle_identity(self, ff, node, env):
        return env[node.input[0]]

    def _handle_batchnormalization(self, ff, node, env):
        """X, scale, B, mean, var -> batch_norm, the affine and the
        running statistics carried by copy_weights."""
        x = env[node.input[0]]
        at = _attrs(node)
        name = node.name or f"bn_{node.output[0]}"
        out = ff.batch_norm(
            x, relu=False,
            eps=float(at.get("epsilon", 1e-5)),
            momentum=float(at.get("momentum", 0.9)),
            name=name,
        )
        self._weight_of_op[name] = {
            "gamma": np.asarray(env[node.input[1]], np.float32),
            "beta": np.asarray(env[node.input[2]], np.float32),
        }
        self._state_of_op[name] = {
            "running_mean": np.asarray(env[node.input[3]], np.float32),
            "running_var": np.asarray(env[node.input[4]], np.float32),
        }
        return out

    def _handle_globalaveragepool(self, ff, node, env):
        x = env[node.input[0]]
        h, w = x.shape.logical_shape[2:4]
        return ff.pool2d(x, h, w, 1, 1, 0, 0, pool_type="avg",
                         name=node.name or None)

    def _handle_pad(self, ff, node, env):
        at = _attrs(node)
        mode = at.get("mode", b"constant")
        mode = mode.decode() if isinstance(mode, bytes) else mode
        if mode != "constant":
            raise ValueError(f"Pad {node.name}: mode {mode!r} unsupported")
        if "pads" in at:  # opset < 11
            flat = [int(p) for p in at["pads"]]
            value = float(at.get("value", 0.0))
        else:  # opset >= 11: pads (and optional value) are inputs
            flat = [int(p) for p in np.asarray(env[node.input[1]]).ravel()]
            value = (float(np.asarray(env[node.input[2]]).ravel()[0])
                     if len(node.input) > 2 and node.input[2] else 0.0)
        x = env[node.input[0]]
        rank = len(flat) // 2
        pads = list(zip(flat[:rank], flat[rank:]))
        if isinstance(x, np.ndarray):
            return np.pad(x, pads, constant_values=value)
        if not any(b or a for b, a in pads):
            return x
        return ff.pad(x, pads, value=value, name=node.name or None)

    def _handle_cast(self, ff, node, env):
        to = int(_attrs(node)["to"])
        np_dtype = protowire._DTYPES.get(to)
        if np_dtype is None:
            raise ValueError(f"Cast {node.name}: unsupported dtype {to}")
        x = env[node.input[0]]
        if isinstance(x, np.ndarray):
            return x.astype(np_dtype)
        return ff.cast(x, np.dtype(np_dtype).name, name=node.name or None)

    def _axes_arg(self, node, env, at):
        if "axes" in at:  # opset < 13
            return [int(a) for a in at["axes"]]
        return [int(a) for a in np.asarray(env[node.input[1]]).ravel()]

    def _handle_unsqueeze(self, ff, node, env):
        at = _attrs(node)
        axes = self._axes_arg(node, env, at)
        x = env[node.input[0]]
        if isinstance(x, np.ndarray):
            out_rank = x.ndim + len(axes)
            for ax in sorted(a % out_rank for a in axes):
                x = np.expand_dims(x, ax)
            return x
        shape = list(x.shape.logical_shape)
        out_rank = len(shape) + len(axes)
        for ax in sorted(a % out_rank for a in axes):
            shape.insert(ax, 1)
        return ff.reshape(x, shape, name=node.name or None)

    def _handle_squeeze(self, ff, node, env):
        at = _attrs(node)
        x = env[node.input[0]]
        if isinstance(x, np.ndarray):
            axes = (self._axes_arg(node, env, at)
                    if ("axes" in at or len(node.input) > 1) else None)
            return np.squeeze(x, tuple(axes) if axes else None)
        shape = list(x.shape.logical_shape)
        if "axes" in at or len(node.input) > 1:
            axes = {a % len(shape) for a in self._axes_arg(node, env, at)}
        else:
            axes = {i for i, s in enumerate(shape) if s == 1}
        shape = [s for i, s in enumerate(shape) if i not in axes]
        return ff.reshape(x, shape, name=node.name or None)

    def _handle_constant(self, ff, node, env):
        at = _attrs(node)
        if "value" in at:
            v = at["value"]
            if not isinstance(v, np.ndarray):
                # with the onnx package installed get_attribute_value
                # returns a raw TensorProto
                import onnx.numpy_helper

                v = onnx.numpy_helper.to_array(v)
            return np.asarray(v)
        for k in ("value_float", "value_int"):
            if k in at:
                return np.asarray(at[k])
        if "value_floats" in at:
            return np.asarray(at["value_floats"], np.float32)
        if "value_ints" in at:
            return np.asarray(at["value_ints"], np.int64)
        raise ValueError(f"Constant {node.name}: no value attribute")

    def _handle_range(self, ff, node, env):
        vals = [env[i] for i in node.input[:3]]
        if not all(isinstance(v, np.ndarray) for v in vals):
            raise ValueError(
                f"Range {node.name}: only constant start/limit/delta "
                "are supported (a range over a graph tensor has a "
                "data-dependent shape)"
            )
        start, limit, delta = (v.ravel()[0] for v in vals)
        return np.arange(start, limit, delta)

    def _handle_shape(self, ff, node, env):
        x = env[node.input[0]]
        shape = (x.shape if isinstance(x, np.ndarray)
                 else x.shape.logical_shape)
        at = _attrs(node)  # opset-15 slice attributes
        start = int(at.get("start", 0))
        end = at.get("end")
        return np.asarray(shape, np.int64)[
            start:(int(end) if end is not None else None)]


def onnx_to_flexflow(path_or_model, ff: FFModel,
                     inputs: Sequence[ParallelTensor]):
    m = ONNXModel(path_or_model)
    return m, m.apply(ff, inputs)
