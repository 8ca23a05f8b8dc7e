"""Mixture-of-Experts example builders (flexflow_tpu/models/moe.py):
`build_moe_mlp`, the flat MoE classifier, and `build_moe_encoder`,
attention and MoE-FFN blocks with post-LN residuals."""
from __future__ import annotations

from ..fftype import ActiMode


def build_moe_mlp(ff, batch_size: int = 64, input_dim: int = 784,
                  num_classes: int = 10, num_exp: int = 5,
                  num_select: int = 2, hidden_size: int = 64,
                  alpha: float = 2.0, lambda_bal: float = 0.04):
    t = ff.create_tensor([batch_size, input_dim], name="input")
    t = ff.moe(t, num_exp, num_select, hidden_size, alpha, lambda_bal)
    t = ff.dense(t, num_classes, activation=ActiMode.RELU, name="head")
    return ff.softmax(t, name="softmax")


def build_moe_encoder(ff, batch_size: int = 8, seq_length: int = 128,
                      hidden_size: int = 64, num_layers: int = 6,
                      num_heads: int = 16, num_exp: int = 5,
                      num_select: int = 2, alpha: float = 2.0,
                      lambda_bal: float = 0.04, num_classes: int = 10):
    x = ff.create_tensor([batch_size, seq_length, hidden_size],
                         name="input")
    for i in range(num_layers):
        attn = ff.multihead_attention(x, x, x, hidden_size, num_heads,
                                      name=f"attn_{i}")
        x = ff.layer_norm(ff.add(attn, x), axes=[-1], name=f"ln_attn_{i}")
        m = ff.moe(x, num_exp, num_select, hidden_size, alpha, lambda_bal,
                   name=f"moe_{i}")
        x = ff.layer_norm(ff.add(m, x), axes=[-1], name=f"ln_moe_{i}")
    x = ff.dense(x, num_classes, name="head")
    return ff.softmax(x, name="softmax")
