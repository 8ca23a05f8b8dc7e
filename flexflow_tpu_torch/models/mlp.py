"""MLP_Unify, Unity's two-tower MLP benchmark
(flexflow_tpu/models/mlp.py): two inputs through parallel towers of
8 x 8192-wide denses, summed, softmaxed."""
from __future__ import annotations

from typing import Optional, Sequence

from ..fftype import ActiMode


def build_mlp_unify(ff, batch_size: int = 64, input_dim: int = 1024,
                    hidden_dims: Optional[Sequence[int]] = None):
    hidden_dims = list(hidden_dims or [8192] * 8)
    t1 = ff.create_tensor([batch_size, input_dim], name="input1")
    t2 = ff.create_tensor([batch_size, input_dim], name="input2")
    for i, d in enumerate(hidden_dims):
        act = ActiMode.NONE if i + 1 == len(hidden_dims) else ActiMode.RELU
        t1 = ff.dense(t1, d, activation=act, use_bias=False,
                      name=f"t1_dense_{i}")
        t2 = ff.dense(t2, d, activation=act, use_bias=False,
                      name=f"t2_dense_{i}")
    t = ff.add(t1, t2, name="add")
    return ff.softmax(t, name="softmax")
