"""CANDLE-Uno, the drug-response MLP ensemble
(flexflow_tpu/models/candle_uno.py): one bias-free ReLU tower per input
feature set, their concat, a deep joint MLP and a scalar regression
head (MSE loss)."""
from __future__ import annotations

from typing import Optional, Sequence

from ..fftype import ActiMode


def _feature_tower(ff, t, dims: Sequence[int], prefix: str):
    for i, d in enumerate(dims):
        t = ff.dense(t, d, activation=ActiMode.RELU, use_bias=False,
                     name=f"{prefix}_{i}")
    return t


def build_candle_uno(ff, batch_size: int = 64,
                     input_dims: Optional[Sequence[int]] = None,
                     dense_layers: Optional[Sequence[int]] = None,
                     dense_feature_layers: Optional[Sequence[int]] = None):
    """Defaults are the reference's: inputs (942, 5270, 2048), 4192-wide
    joint (4 layers) and feature (8 layers) stacks."""
    input_dims = list(input_dims or [942, 5270, 2048])
    dense_layers = list(dense_layers or [4192] * 4)
    dense_feature_layers = list(dense_feature_layers or [4192] * 8)
    encoded = []
    for i, in_dim in enumerate(input_dims):
        inp = ff.create_tensor([batch_size, in_dim], name=f"input_{i}")
        encoded.append(_feature_tower(ff, inp, dense_feature_layers,
                                      prefix=f"tower_{i}"))
    out = ff.concat(encoded, axis=-1, name="concat")
    for i, d in enumerate(dense_layers):
        out = ff.dense(out, d, activation=ActiMode.RELU, use_bias=False,
                       name=f"joint_{i}")
    return ff.dense(out, 1, use_bias=False, name="head")
