"""The GPT and BERT model definitions, host sampling and the
re-forward generation loops (flexflow_tpu/models/transformer.py).

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

`bert_tp_strategy` and `bert_sp_strategy` are the reference's hybrid
strategies for `build_bert`: data x tensor parallel (heads and the
first FFN's out channels on "model") and data x sequence parallel (the
sequence on "seq", attention as ring attention).

`gpt_generate` and `gpt_beam_search` are the reference's O(T^2)
utility loops: each emitted token re-runs the compiled fixed-shape
forward over the whole right-padded buffer.  decoding.py holds their
O(T) KV-cache forms.
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


def bert_tp_strategy(num_devices: int, tp: int = 2, num_layers: int = 12):
    """Hybrid DP x TP strategy for build_bert: attention heads and the
    first FFN's out channels column parallel on the "model" axis (the
    second FFN runs row parallel on them), the batch on "data"."""
    from ..ops.op import ShardConfig
    from ..strategy import Strategy

    dp = num_devices // tp
    s = Strategy(mesh_axes={"data": dp, "model": tp})
    s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": dp})]
    for i in range(num_layers):
        s.shard_configs[f"attn_{i}"] = ShardConfig(channel=tp)
        s.shard_configs[f"ffn1_{i}"] = ShardConfig(channel=tp)
    return s


def bert_sp_strategy(num_devices: int, sp: int = 4):
    """Hybrid DP x SP (context parallel) strategy: the sequence dim of
    every activation sharded over the "seq" axis, attention as ring
    attention over it (parallel/ring_attention.py), the batch on
    "data"."""
    from ..strategy import Strategy

    if sp < 1 or num_devices % sp != 0:
        raise ValueError(
            f"num_devices {num_devices} not divisible by sp degree {sp}")
    dp = num_devices // sp
    s = Strategy(mesh_axes={"data": dp, "seq": sp})
    chain = []
    if dp > 1:
        chain.append(("repartition", {"dim": 0, "degree": dp}))
    chain.append(("repartition", {"dim": 1, "degree": sp}))
    s.edge_ops["__inputs__"] = chain
    return s


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


def _seq_source(ff):
    src = next(op for op in ff.layers.source_ops() if op.name == "input")
    return src.outputs[0].shape.logical_shape  # (batch, seq)


def _step_logits(ff, buf, pos, rows, t) -> np.ndarray:
    """Logits at position t of the first `rows` rows of one full
    forward, brought to the host alone (not the [b, s, vocab] whole)."""
    logits = ff.forward({"input": buf, "positions": pos})
    return logits[:rows, t].float().cpu().numpy()


def gpt_generate(ff, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 0.0):
    """Autoregressive generation with the compiled fixed-shape GPT:
    right-pad the prompt to the model's seq length, re-run the forward
    per emitted token and feed back the sampled id (temperature 0 =
    greedy; then top_k, then top_p, as in sample_next).  The causal mask
    keeps the padding out of the next-token logits.

    prompt_ids: [batch, prompt_len] ints.  Returns [batch, prompt_len +
    max_new_tokens], cut at the model's seq length."""
    prompt_ids = np.asarray(prompt_ids, np.int32)
    validate_sampling(top_k, top_p)
    seq_len = _seq_source(ff)[1]
    prompt_ids = prompt_ids[:, :seq_len]
    batch, plen = prompt_ids.shape
    if plen < 1:
        raise ValueError("gpt_generate needs a non-empty prompt")
    total = min(seq_len, plen + max_new_tokens)
    buf = np.zeros((batch, seq_len), np.int32)
    buf[:, :plen] = prompt_ids
    pos = np.tile(np.arange(seq_len, dtype=np.int32), (batch, 1))
    rng = np.random.RandomState(seed)
    for t in range(plen, total):
        step = _step_logits(ff, buf, pos, batch, t - 1)
        buf[:, t] = sample_next(step, temperature, rng, top_k, top_p)
    return buf[:, :total]


def gpt_beam_search(ff, prompt_ids, max_new_tokens: int,
                    beam_size: int = 4, length_penalty: float = 0.0,
                    eos_id: int = -1):
    """Beam search on the compiled fixed-shape GPT, one prompt: the
    beams ride the model's batch (which must be >= beam_size; the other
    rows are padding) and every step re-runs the full forward.  Scores
    are summed token log-probs; `length_penalty` applies GNMT's
    ((5+len)/6)^lp to the final scores; `eos_id` >= 0 freezes finished
    beams, which compete at their final score.

    prompt_ids: [prompt_len] or [1, prompt_len] ints.
    Returns (tokens [total_len], score float)."""
    prompt_ids = np.asarray(prompt_ids, np.int32).reshape(1, -1)
    model_batch, seq_len = _seq_source(ff)
    if beam_size > model_batch:
        raise ValueError(
            f"beam_size {beam_size} exceeds compiled batch {model_batch}")
    prompt_ids = prompt_ids[:, :seq_len]
    plen = prompt_ids.shape[1]
    if plen < 1:
        raise ValueError("gpt_beam_search needs a non-empty prompt")
    total = min(seq_len, plen + max_new_tokens)

    buf = np.zeros((model_batch, seq_len), np.int32)
    buf[:beam_size, :plen] = prompt_ids  # every beam starts from the prompt
    pos = np.tile(np.arange(seq_len, dtype=np.int32), (model_batch, 1))
    scores = np.full(beam_size, -np.inf, np.float64)
    scores[0] = 0.0  # step 1: only one distinct hypothesis exists
    alive = np.ones(beam_size, bool)
    gen_len = np.zeros(beam_size, np.int64)  # emitted tokens per beam

    for t in range(plen, total):
        step = _step_logits(ff, buf, pos, beam_size, t - 1)
        z = step - step.max(-1, keepdims=True)
        lp = z - np.log(np.exp(z).sum(-1, keepdims=True))  # [beam, vocab]
        vocab = lp.shape[-1]
        cand = scores[:, None] + np.where(alive[:, None], lp, -np.inf)
        if eos_id >= 0 and not alive.all():
            # a finished beam competes as one stay-put candidate
            cand[~alive, :] = -np.inf
            cand[~alive, 0] = scores[~alive]
        flat = cand.reshape(-1)
        top = np.argsort(-flat)[:beam_size]
        src_beam, tok = top // vocab, (top % vocab).astype(np.int32)
        new_buf = buf[:beam_size][src_beam].copy()
        new_alive = alive[src_beam].copy()
        new_buf[new_alive, t] = tok[new_alive]  # frozen beams keep padding
        gen_len = gen_len[src_beam] + new_alive
        if eos_id >= 0:
            new_alive &= tok != eos_id
        buf[:beam_size] = new_buf
        scores = flat[top]
        alive = new_alive
        if eos_id >= 0 and not alive.any():
            break
    if length_penalty > 0.0:
        norm = ((5.0 + np.maximum(gen_len, 1).astype(np.float64)) / 6.0) \
            ** length_penalty
        best = int(np.argmax(scores / norm))
    else:
        best = int(np.argmax(scores))
    return buf[best, :total].copy(), float(scores[best])
