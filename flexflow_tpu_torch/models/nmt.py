"""Seq2seq NMT builder (flexflow_tpu/models/nmt.py).

Teacher-forced training: source tokens -> embedding -> encoder LSTM
stack; target tokens -> embedding -> decoder LSTM stack, plus the mean
of the encoder states as a summary context; Luong-style dot-product
attention over the encoder states in PCG ops (scores = dec @ enc^T ->
softmax -> context; concat + tanh projection) -> vocabulary projection
-> softmax.  The layer names are the reference's, so weights cross
between the packages by name.  `greedy_decode` is the reference's
inference loop: it re-runs the compiled forward once per target
position and feeds back the argmaxes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fftype import ActiMode, AggrMode


def build_nmt(ff, batch_size: int = 64, src_len: int = 16,
              tgt_len: int = 16, src_vocab: int = 8000,
              tgt_vocab: int = 8000, embed_dim: int = 64,
              hidden_size: int = 128, num_layers: int = 2,
              attention: bool = True):
    src = ff.create_tensor([batch_size, src_len], dtype="int32", name="src")
    tgt = ff.create_tensor([batch_size, tgt_len], dtype="int32", name="tgt")

    enc = ff.embedding(src, src_vocab, embed_dim, aggr=AggrMode.NONE,
                       name="src_embed")
    for i in range(num_layers):
        enc = ff.lstm(enc, hidden_size, return_sequences=True,
                      name=f"enc_lstm_{i}")
    # the encoder -> decoder hand-off: the mean over source positions,
    # broadcast onto the decoder states
    ctx = ff.mean(enc, axes=[1], keepdims=True, name="enc_context")

    dec = ff.embedding(tgt, tgt_vocab, embed_dim, aggr=AggrMode.NONE,
                       name="tgt_embed")
    for i in range(num_layers):
        dec = ff.lstm(dec, hidden_size, return_sequences=True,
                      name=f"dec_lstm_{i}")
    dec = ff.add(dec, ctx, name="condition")

    if attention:
        # [B,T,H] @ [B,H,S] -> [B,T,S] -> softmax over S -> @ [B,S,H]
        enc_t = ff.transpose(enc, [0, 2, 1], name="enc_T")
        scores = ff.batch_matmul(dec, enc_t, name="attn_scores")
        attn = ff.softmax(scores, axis=-1, name="attn_weights")
        context = ff.batch_matmul(attn, enc, name="attn_context")
        comb = ff.concat([dec, context], axis=2, name="attn_concat")
        dec = ff.dense(comb, hidden_size, activation=ActiMode.TANH,
                       name="attn_comb")

    logits = ff.dense(dec, tgt_vocab, name="vocab_proj")
    return ff.softmax(logits, name="softmax")


def greedy_decode(ff, src_tokens, bos_id: int = 1,
                  tgt_len: int = None) -> np.ndarray:
    """Greedy autoregressive decoding with the compiled training graph:
    the fixed-shape forward re-runs per target position and its argmax
    feeds back (an O(T^2) utility loop, not a serving path)."""
    src_tokens = np.asarray(src_tokens, np.int32)
    batch = src_tokens.shape[0]
    if tgt_len is None:
        tgt_len = next(op for op in ff.layers.source_ops()
                       if op.name == "tgt").outputs[0].shape.logical_shape[1]
    buf = np.zeros((batch, tgt_len), np.int32)
    buf[:, 0] = bos_id
    for t in range(1, tgt_len):
        probs = ff.forward({"src": src_tokens, "tgt": buf})
        buf[:, t] = probs[:, t - 1].argmax(-1).to(torch.int32).cpu().numpy()
    return buf
