"""DLRM and XDL recommenders (flexflow_tpu/models/dlrm.py).

The tables are Embedding ops with SUM aggregation over the bag,
initialized uniform in ±sqrt(1/vocab) as the reference's create_emb
does.  Their gradients are dense, as the reference's are.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

from ..fftype import ActiMode, AggrMode
from ..initializer import UniformInitializer


def _mlp(ff, t, dims: Sequence[int], sigmoid_layer: int, prefix: str):
    """A bias-free ReLU stack whose layer `sigmoid_layer` is a sigmoid;
    `dims` lists the output widths."""
    for i, d in enumerate(dims):
        act = ActiMode.SIGMOID if i == sigmoid_layer else ActiMode.RELU
        t = ff.dense(t, d, activation=act, use_bias=False,
                     name=f"{prefix}_{i}")
    return t


def _embedding(ff, input, vocab: int, dim: int, name: str):
    rng = math.sqrt(1.0 / vocab)
    return ff.embedding(input, vocab, dim, aggr=AggrMode.SUM,
                        kernel_initializer=UniformInitializer(-rng, rng),
                        name=name)


def build_dlrm(ff, batch_size: int = 64,
               embedding_size: Sequence[int] = (1000000, 1000000, 1000000,
                                                1000000),
               embedding_bag_size: int = 1, sparse_feature_size: int = 64,
               dense_feature_dim: int = 64,
               mlp_bot: Optional[Sequence[int]] = None,
               mlp_top: Optional[Sequence[int]] = None):
    """The dense bottom MLP and one embedding per table -> concat
    interaction -> the top MLP, its last layer a sigmoid."""
    mlp_bot = list(mlp_bot or [sparse_feature_size, sparse_feature_size])
    mlp_top = list(mlp_top or [64, 2])
    sparse_inputs = [
        ff.create_tensor([batch_size, embedding_bag_size], dtype="int32",
                         name=f"sparse_input_{i}")
        for i in range(len(embedding_size))]
    dense_input = ff.create_tensor([batch_size, dense_feature_dim],
                                   name="dense_input")
    x = _mlp(ff, dense_input, mlp_bot, sigmoid_layer=-1, prefix="bot")
    ly: List = [_embedding(ff, si, embedding_size[i], sparse_feature_size,
                           name=f"embedding_{i}")
                for i, si in enumerate(sparse_inputs)]
    z = ff.concat([x] + ly, axis=-1, name="interact_cat")
    return _mlp(ff, z, mlp_top, sigmoid_layer=len(mlp_top) - 1,
                prefix="top")


def build_xdl(ff, batch_size: int = 64,
              embedding_size: Sequence[int] = (1000000, 1000000, 1000000,
                                               1000000),
              embedding_bag_size: int = 1, sparse_feature_size: int = 64,
              mlp_dims: Optional[Sequence[int]] = None):
    """XDL: concat of the embeddings -> an MLP whose last layer is a
    sigmoid."""
    mlp_dims = list(mlp_dims or [256, 256, 2])
    sparse_inputs = [
        ff.create_tensor([batch_size, embedding_bag_size], dtype="int32",
                         name=f"sparse_input_{i}")
        for i in range(len(embedding_size))]
    ly = [_embedding(ff, si, embedding_size[i], sparse_feature_size,
                     name=f"embedding_{i}")
          for i, si in enumerate(sparse_inputs)]
    t = ff.concat(ly, axis=-1, name="concat")
    return _mlp(ff, t, mlp_dims, sigmoid_layer=len(mlp_dims) - 1,
                prefix="mlp")
