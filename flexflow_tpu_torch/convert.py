"""Weights from the JAX package into the port.

`from_jax_weights(np_weights, ff)` takes flexflow_tpu's
`FFModel.get_weights()` output, {op name: {weight name: numpy array}},
and returns the port's tensors on `ff`'s device.  The layouts are the
reference's own and the same in both packages: attention wq/wk/wv
[embed, heads, head_dim] and wo [heads, head_dim, embed], Linear.kernel
[in, out] (+ bias [out]), Embedding.weight [num_entries, out_dim],
LayerNorm gamma and beta.  Every op name, weight name and shape is
checked against `ff`'s graph; the first missing, extra or misshapen
entry raises, naming it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _expected(ff) -> Dict[str, Dict[str, tuple]]:
    """{op: {weight: (shape, torch dtype)}} of ff's trainable weights."""
    out: Dict[str, Dict[str, tuple]] = {}
    for op in ff.layers.topo_order():
        nt = op.num_trainable_weights()
        for spec in op.weight_specs[:nt]:
            out.setdefault(op.name, {})[spec.name] = (
                tuple(spec.shape.logical_shape),
                spec.shape.dtype.torch_dtype)
    return out


def from_jax_weights(np_weights, ff) -> Dict[str, Dict[str, torch.Tensor]]:
    want = _expected(ff)
    for op_name in np_weights:
        if op_name not in want:
            raise ValueError(f"unexpected weight group {op_name!r}: the "
                             "model has no op of that name")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for op_name, specs in want.items():
        if op_name not in np_weights:
            raise ValueError(f"missing weights for op {op_name!r}")
        got = np_weights[op_name]
        for wname in got:
            if wname not in specs:
                raise ValueError(
                    f"unexpected weight {op_name}.{wname}: the op has "
                    f"{sorted(specs)}")
        entries = {}
        for wname, (shape, dtype) in specs.items():
            if wname not in got:
                raise ValueError(f"missing weight {op_name}.{wname}")
            arr = np.asarray(got[wname])
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"weight {op_name}.{wname} has shape "
                    f"{tuple(arr.shape)}, the model expects {shape}")
            entries[wname] = torch.tensor(arr, dtype=dtype,
                                          device=ff.device)
        out[op_name] = entries
    return out
