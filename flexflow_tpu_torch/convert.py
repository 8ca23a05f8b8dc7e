"""Weights from the JAX package into the port.

`from_jax_weights(np_weights, ff)` takes flexflow_tpu's
`FFModel.get_weights()` output, {op name: {weight name: numpy array}},
and returns the port's tensors on `ff`'s device.  The layouts are the
reference's own and the same in both packages: attention wq/wk/wv
[embed, heads, head_dim] and wo [heads, head_dim, embed], Linear.kernel
[in, out] (+ bias [out]), Embedding.weight [num_entries, out_dim],
LayerNorm gamma and beta, Conv2D.kernel OIHW (+ bias), BatchNorm gamma
and beta, a trainable WeightOp's value.  Under a pipeline the block ops'
weights come as the reference's stacked group, {"__pipeline__":
{"<j>.<name>": [L, ...]}}, template op j's weight over the L blocks.
`from_jax_state` does the same
for the op state (FFModel._state: BatchNorm's running_mean and
running_var, a frozen WeightOp's value).  Every op
name, entry name and shape is checked against `ff`'s graph; the first
missing, extra or misshapen entry raises, naming it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .executor import PIPELINE


def _expected(ff, trainable: bool) -> Dict[str, Dict[str, tuple]]:
    """{op: {entry: (shape, torch dtype)}} of ff's trainable weights, or
    of its op state."""
    out: Dict[str, Dict[str, tuple]] = {}
    graph = ff.operators if ff.operators is not None else ff.layers
    plan = getattr(ff.executor, "pipeline_plan", None)
    blocks = set() if plan is None else {
        op.guid for blk in plan.blocks for op in blk}
    for op in graph.topo_order():
        if op.guid in blocks:
            continue
        nt = op.num_trainable_weights()
        specs = op.weight_specs[:nt] if trainable else op.weight_specs[nt:]
        for spec in specs:
            out.setdefault(op.name, {})[spec.name] = (
                tuple(spec.shape.logical_shape),
                spec.shape.dtype.torch_dtype)
    if plan is not None and trainable:
        # plan_pipeline admits no op state inside the blocks
        out[PIPELINE] = {
            f"{j}.{spec.name}": ((plan.num_blocks,)
                                 + tuple(spec.shape.logical_shape),
                                 spec.shape.dtype.torch_dtype)
            for j, op in enumerate(plan.blocks[0])
            for spec in op.weight_specs}
    return out


def _convert(tree, want, what: str, group: str, device):
    for op_name in tree:
        if op_name not in want:
            raise ValueError(f"unexpected {what} group {op_name!r}: the "
                             f"model has no op of that name with {group}")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for op_name, specs in want.items():
        if op_name not in tree:
            raise ValueError(f"missing {group} for op {op_name!r}")
        got = tree[op_name]
        for wname in got:
            if wname not in specs:
                raise ValueError(
                    f"unexpected {what} {op_name}.{wname}: the op has "
                    f"{sorted(specs)}")
        entries = {}
        for wname, (shape, dtype) in specs.items():
            if wname not in got:
                raise ValueError(f"missing {what} {op_name}.{wname}")
            arr = np.asarray(got[wname])
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"{what} {op_name}.{wname} has shape "
                    f"{tuple(arr.shape)}, the model expects {shape}")
            entries[wname] = torch.tensor(arr, dtype=dtype, device=device)
        out[op_name] = entries
    return out


def from_jax_weights(np_weights, ff) -> Dict[str, Dict[str, torch.Tensor]]:
    return _convert(np_weights, _expected(ff, trainable=True), "weight",
                    "weights", ff.device)


def from_jax_state(np_state, ff) -> Dict[str, Dict[str, torch.Tensor]]:
    """The op-state half: the reference's FFModel._state ({op: {entry:
    array}}, e.g. BatchNorm's running_mean and running_var), checked
    like the weights."""
    return _convert(np_state, _expected(ff, trainable=False), "state",
                    "state", ff.device)
