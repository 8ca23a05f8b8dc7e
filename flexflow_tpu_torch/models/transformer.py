"""The GPT and BERT model definitions and host sampling
(flexflow_tpu/models/transformer.py).

`build_gpt` is the reference's pre-LN GPT-2 graph with the same layer
names (tok_embed, pos_embed, ln1_i, attn_i, ln2_i, ffn1_i, ffn2_i,
final_ln, lm_head), so weights cross between the packages by name.
Its defaults are GPT-2-small: hidden 768, 12 layers, 12 heads, FFN
3072, vocab 50257, 1024 positions.

`build_transformer` is the reference's Transformer example (Unity's
evaluation model): N x (attention -> dense (ReLU) -> dense), no norm
and no residual, and a per-token scalar head; its defaults are 12
layers, hidden 1024, 16 heads, seq 512, batch 8.

`build_bert` is the reference's post-LN BERT encoder with a
mean-pooled classifier (attn_i, attn_res_i, attn_ln_i, ffn1_i, ffn2_i,
ffn_res_i, ffn_ln_i, pool, classifier).  Its defaults are BERT-base:
hidden 768, 12 layers, 12 heads, FFN 3072.
"""
from __future__ import annotations

import numpy as np

from ..fftype import ActiMode


def build_gpt(ff, batch_size: int = 8, seq_length: int = 1024,
              hidden_size: int = 768, num_layers: int = 12,
              num_heads: int = 12, intermediate_size: int = 3072,
              vocab_size: int = 50257, dropout: float = 0.0,
              max_positions: int = 0, decode_max_seq: int = 0,
              kv_page_size: int = 0, kv_num_blocks: int = 0):
    """Decoder-only causal LM: token ids + position ids -> embeddings ->
    N x [LN -> causal attention -> residual; LN -> GELU MLP ->
    residual] -> final LN -> untied LM head.  max_positions decouples
    the position table from the graph's seq length, so the seq-1 decode
    twin shares the trained table."""
    ids = ff.create_tensor([batch_size, seq_length], dtype="int32",
                           name="input")
    pos = ff.create_tensor([batch_size, seq_length], dtype="int32",
                           name="positions")
    t = ff.embedding(ids, vocab_size, hidden_size, name="tok_embed")
    pe = ff.embedding(pos, max_positions or seq_length, hidden_size,
                      name="pos_embed")
    t = ff.add(t, pe, name="embed_sum")
    for i in range(num_layers):
        a = ff.layer_norm(t, axes=[-1], name=f"ln1_{i}")
        a = ff.multihead_attention(
            a, a, a, hidden_size, num_heads, dropout=dropout,
            causal=True, name=f"attn_{i}",
            decode_max_seq=decode_max_seq,
            kv_page_size=kv_page_size, kv_num_blocks=kv_num_blocks,
        )
        t = ff.add(t, a, name=f"attn_res_{i}")
        h = ff.layer_norm(t, axes=[-1], name=f"ln2_{i}")
        h = ff.dense(h, intermediate_size, activation=ActiMode.GELU,
                     name=f"ffn1_{i}")
        h = ff.dense(h, hidden_size, name=f"ffn2_{i}")
        t = ff.add(t, h, name=f"ffn_res_{i}")
    t = ff.layer_norm(t, axes=[-1], name="final_ln")
    return ff.dense(t, vocab_size, use_bias=False, name="lm_head")


def build_transformer(ff, batch_size: int = 8, seq_length: int = 512,
                      hidden_size: int = 1024, num_layers: int = 12,
                      num_heads: int = 16):
    t = ff.create_tensor([batch_size, seq_length, hidden_size],
                         name="input")
    for i in range(num_layers):
        a = ff.multihead_attention(t, t, t, hidden_size, num_heads,
                                   name=f"attn_{i}")
        h = ff.dense(a, hidden_size, activation=ActiMode.RELU,
                     name=f"ffn1_{i}")
        t = ff.dense(h, hidden_size, name=f"ffn2_{i}")
    return ff.dense(t, 1, name="lm_head")


def build_bert(ff, batch_size: int = 32, seq_length: int = 128,
               hidden_size: int = 768, num_layers: int = 12,
               num_heads: int = 12, intermediate_size: int = 3072,
               vocab_size: int = 30522, num_classes: int = 2,
               dropout: float = 0.0, from_token_ids: bool = False):
    """BERT-base encoder stack with a classification head: features
    [b, s, hidden] (or token ids through tok_embed) -> N x [attention ->
    residual -> LN; GELU FFN -> residual -> LN] -> mean over the
    sequence -> classifier logits."""
    if from_token_ids:
        ids = ff.create_tensor([batch_size, seq_length], dtype="int32",
                               name="input")
        t = ff.embedding(ids, vocab_size, hidden_size, name="tok_embed")
    else:
        t = ff.create_tensor([batch_size, seq_length, hidden_size],
                             name="input")
    for i in range(num_layers):
        a = ff.multihead_attention(t, t, t, hidden_size, num_heads,
                                   dropout=dropout, name=f"attn_{i}")
        t = ff.add(t, a, name=f"attn_res_{i}")
        t = ff.layer_norm(t, axes=[-1], name=f"attn_ln_{i}")
        h = ff.dense(t, intermediate_size, activation=ActiMode.GELU,
                     name=f"ffn1_{i}")
        h = ff.dense(h, hidden_size, name=f"ffn2_{i}")
        t = ff.add(t, h, name=f"ffn_res_{i}")
        t = ff.layer_norm(t, axes=[-1], name=f"ffn_ln_{i}")
    pooled = ff.mean(t, axes=[1], name="pool")
    return ff.dense(pooled, num_classes, name="classifier")


def validate_sampling(top_k: int, top_p: float):
    if top_k < 0 or not 0.0 <= top_p <= 1.0:
        raise ValueError(f"invalid sampling filter: top_k={top_k} "
                         f"top_p={top_p}")


def sample_next(step_logits, temperature: float, rng, top_k: int = 0,
                top_p: float = 0.0):
    """Sample next-token ids from [batch, vocab] host logits with a numpy
    RandomState: temperature, then top_k, then top_p nucleus;
    temperature 0 = greedy.  The draws match the reference's."""
    if temperature <= 0.0:
        return step_logits.argmax(-1).astype(np.int32)
    z = np.asarray(step_logits, np.float32) / temperature
    if top_k and top_k < z.shape[-1]:
        kth = np.partition(z, -top_k, axis=-1)[:, -top_k, None]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max(-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(-1, keepdims=True)
    if top_p and 0.0 < top_p < 1.0:
        order = np.argsort(-p, axis=-1)
        sp = np.take_along_axis(p, order, -1)
        drop_sorted = np.cumsum(sp, axis=-1) - sp >= top_p
        drop = np.zeros_like(drop_sorted)
        np.put_along_axis(drop, order, drop_sorted, -1)
        p = np.where(drop, 0.0, p)
        p /= p.sum(-1, keepdims=True)
    return np.array([rng.choice(p.shape[-1], p=p[b])
                     for b in range(p.shape[0])], np.int32)
