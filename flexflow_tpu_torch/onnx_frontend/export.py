"""A torch CNN module as ONNX wire bytes, without the `onnx` package
(torch.onnx.export needs it): `module_to_onnx` walks the module's
torch.fx trace and writes the nodes torch.onnx.export would, through
protowire's encoder.  The ONNX importer's tests and chip_smoke.py feed
its bytes to ONNXModel."""
from __future__ import annotations

import operator

import torch
import torch.fx
import torch.nn as nn

from . import protowire


def module_to_onnx(module, in_shape, pw=None) -> bytes:
    """A CNN module (Conv2d, BatchNorm2d, ReLU, MaxPool2d, adds,
    AdaptiveAvgPool2d(1), flatten, Linear) as ONNX wire bytes, in the
    node sequence torch.onnx.export writes for it (Conv,
    BatchNormalization, Relu, MaxPool, Add, GlobalAveragePool, Flatten,
    Gemm), from its torch.fx trace and written by `pw`, a protowire
    module (the port's by default)."""
    if pw is None:
        pw = protowire
    traced = torch.fx.symbolic_trace(module)
    mods = dict(traced.named_modules())
    nodes, inits, outputs = [], {}, []

    def arr(t):
        return t.detach().cpu().numpy()

    names = {}  # fx node -> its tensor's name (the placeholder: "input")

    def emit(op, node, inputs, **attrs):
        names[node] = node.name
        nodes.append(pw.encode_node(op, inputs, [node.name], **attrs))

    for node in traced.graph.nodes:
        args = [names[a] if isinstance(a, torch.fx.Node) else a
                for a in node.args]
        if node.op == "placeholder":
            names[node] = "input"
            continue
        if node.op == "output":
            outputs.append(names[node.args[0]])
            continue
        if node.op == "call_module":
            m, t = mods[node.target], node.target
            if isinstance(m, nn.Conv2d):
                ins = [args[0], f"{t}.weight"]
                inits[f"{t}.weight"] = arr(m.weight)
                if m.bias is not None:
                    ins.append(f"{t}.bias")
                    inits[f"{t}.bias"] = arr(m.bias)
                emit("Conv", node, ins, kernel_shape=list(m.kernel_size),
                     strides=list(m.stride), pads=list(m.padding) * 2,
                     group=m.groups)
            elif isinstance(m, nn.BatchNorm2d):
                keys = [f"{t}.{k}" for k in ("weight", "bias",
                                             "running_mean", "running_var")]
                for k, v in zip(keys, (m.weight, m.bias, m.running_mean,
                                       m.running_var)):
                    inits[k] = arr(v)
                emit("BatchNormalization", node, [args[0]] + keys,
                     epsilon=float(m.eps), momentum=1.0 - m.momentum)
            elif isinstance(m, nn.ReLU):
                emit("Relu", node, args[:1])
            elif isinstance(m, nn.MaxPool2d):
                k, st, pd = (m.kernel_size, m.stride, m.padding)
                emit("MaxPool", node, args[:1], kernel_shape=[k, k],
                     strides=[st, st], pads=[pd] * 4)
            elif isinstance(m, nn.AdaptiveAvgPool2d) and m.output_size in (
                    1, (1, 1)):
                emit("GlobalAveragePool", node, args[:1])
            elif isinstance(m, nn.Linear):
                inits[f"{t}.weight"] = arr(m.weight)
                inits[f"{t}.bias"] = arr(m.bias)
                emit("Gemm", node, [args[0], f"{t}.weight", f"{t}.bias"],
                     alpha=1.0, beta=1.0, transB=1)
            else:
                raise ValueError(f"module_to_onnx: module {m!r}")
        elif node.target in (operator.add, torch.add):
            emit("Add", node, args[:2])
        elif node.target in (torch.relu, torch.nn.functional.relu):
            emit("Relu", node, args[:1])
        elif node.target is torch.flatten and args[1:] == [1]:
            emit("Flatten", node, args[:1], axis=1)
        else:
            raise ValueError(f"module_to_onnx: {node.op} {node.target}")
    return pw.encode_model(nodes, [("input", list(in_shape))], outputs,
                           inits)
