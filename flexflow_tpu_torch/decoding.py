"""KV-cache decoding (flexflow_tpu/decoding.py).

`make_gpt_decoder` builds the seq-1 decode twin of a
`models.transformer.build_gpt` model.  The twin SHARES the weight
tensors of the model it was built from; it does not copy them.

The dense twin (kv_page_size 0) keeps a [b, max_seq, h, d] k/v cache
and a cache_pos counter per attention layer, updated in place by every
step (ops/attention.py `_attend_decode`).  Three drivers run on it:

  * gpt_generate_cached: a host loop over FFModel.decode_step, which
    samples each token on the host (models.transformer.sample_next, the
    reference's numpy draws);
  * gpt_beam_search_cached: batched beam search, the beams riding the
    decoder's batch; each selection gathers the caches' rows by source
    beam (`_reorder_cache_rows`, index_select on the state tensors);
  * gpt_generate_scan / run_generate_scan: the whole generation as one
    device-side loop, where the reference traced one lax.scan: the
    tokens, positions and sampling stay on the card (argmax, or
    torch.multinomial with a torch.Generator seeded from `seed`), and
    the host waits once, for the final token buffer.

The paged twin (kv_page_size > 0) is the continuous engine's: every
attention layer's k/v cache is a [kv_num_blocks, kv_page_size, h, d]
block pool with a host-owned block table and per-slot seq_lens.  The
build_paged_* functions return plain functions over the twin's weight
and state dictionaries.  Where the reference jit-compiled them with the
state donated, here they update the KV pools IN PLACE and return the
same state dictionary.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .fftype import CompMode, OperatorType
from .model import FFModel


def _gpt_dims(ff: FFModel) -> Dict[str, int]:
    """Read the build_gpt hyperparameters back off a built graph."""
    by_name = {op.name: op for op in ff.layers.topo_order()}
    attn = [op for op in ff.layers.topo_order()
            if op.op_type == OperatorType.MULTIHEAD_ATTENTION]
    if (not attn or "tok_embed" not in by_name or "pos_embed" not in by_name
            or "ffn1_0" not in by_name):
        raise ValueError(
            "make_gpt_decoder expects a models.transformer.build_gpt "
            "graph (tok_embed/pos_embed/attn_i/ffn1_i naming)")
    p = attn[0].params
    return {
        "num_layers": len(attn),
        "hidden_size": p.embed_dim,
        "num_heads": p.num_heads,
        "dropout": p.dropout,
        "vocab_size": by_name["tok_embed"].params.num_entries,
        "max_seq": by_name["pos_embed"].params.num_entries,
        "intermediate_size": by_name["ffn1_0"].params.out_channels,
    }


def make_gpt_decoder(ff_train: FFModel, batch_size: Optional[int] = None,
                     kv_page_size: int = 0, kv_num_blocks: int = 0,
                     tp: int = 1) -> FFModel:
    """Build + compile the seq-1 decode twin of a GPT on the train
    model's device, with decode_max_seq = its position-table size, and
    point its weights at the train model's tensors.  kv_page_size 0
    builds the dense-cache twin, > 0 the paged one.  Head tensor
    parallelism (tp > 1) comes with the multi-GPU slice."""
    from .config import FFConfig
    from .models.transformer import build_gpt

    if tp != 1:
        raise NotImplementedError(
            f"make_gpt_decoder(tp={tp}): tensor-parallel decode replicas "
            "come with the multi-GPU slice of the port")
    dims = _gpt_dims(ff_train)
    b = batch_size or ff_train.config.batch_size
    cfg = FFConfig(batch_size=b, compute_dtype=ff_train.config.compute_dtype,
                   device=str(ff_train.device))
    ffd = FFModel(cfg)
    build_gpt(
        ffd, batch_size=b, seq_length=1,
        hidden_size=dims["hidden_size"], num_layers=dims["num_layers"],
        num_heads=dims["num_heads"],
        intermediate_size=dims["intermediate_size"],
        vocab_size=dims["vocab_size"], dropout=0.0,
        max_positions=dims["max_seq"], decode_max_seq=dims["max_seq"],
        kv_page_size=kv_page_size, kv_num_blocks=kv_num_blocks,
    )
    ffd.compile(comp_mode=CompMode.INFERENCE)
    # every weight is seq-independent, so the trained tensors drop
    # straight in, shared, by (op, weight) name
    shared = {}
    for op_name, entries in ffd._weights.items():
        src = ff_train._weights.get(op_name, {})
        new_entries = {}
        for k, v in entries.items():
            if k not in src:
                raise ValueError(f"decode graph weight {op_name}.{k} "
                                 "is missing in the trained model")
            sv = src[k]
            if tuple(sv.shape) != tuple(v.shape):
                raise ValueError(
                    f"decode weight {op_name}.{k}: trained shape "
                    f"{tuple(sv.shape)} != decode shape {tuple(v.shape)}")
            new_entries[k] = sv if sv.dtype == v.dtype else sv.to(v.dtype)
        shared[op_name] = new_entries
    ffd._weights = shared
    return ffd


def _host_logits(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _check_batch(ffd: FFModel, batch: int, what: str):
    if batch != ffd.config.batch_size:
        raise ValueError(f"{what} {batch} != decoder batch "
                         f"{ffd.config.batch_size}")


def gpt_generate_cached(ffd: FFModel, prompt_ids, max_new_tokens: int,
                        temperature: float = 0.0, seed: int = 0,
                        top_k: int = 0, top_p: float = 0.0) -> np.ndarray:
    """Host-loop KV-cache generation on a dense make_gpt_decoder twin:
    the prompt goes in one token per step (the caches fill as a side
    effect), then each sampled token feeds back.  At temperature 0 its
    tokens are gpt_generate's."""
    from .models.transformer import sample_next, validate_sampling

    validate_sampling(top_k, top_p)
    prompt_ids = np.asarray(prompt_ids, np.int32)
    max_seq = _gpt_dims(ffd)["max_seq"]
    batch, plen = prompt_ids.shape
    if plen < 1:
        raise ValueError("gpt_generate_cached needs a non-empty prompt")
    _check_batch(ffd, batch, "prompt batch")
    total = min(max_seq, plen + max_new_tokens)
    ffd.reset_decode_state()
    buf = np.zeros((batch, total), np.int32)
    buf[:, :plen] = prompt_ids[:, :total]
    rng = np.random.RandomState(seed)
    # the token at total-1 is the last one written, so its decode step
    # (whose logits nothing reads) is not run
    for t in range(total - 1):
        logits = ffd.decode_step({
            "input": buf[:, t:t + 1],
            "positions": np.full((batch, 1), t, np.int32)})
        if t + 1 < plen:
            continue  # prefill: the next token is given
        buf[:, t + 1] = sample_next(_host_logits(logits[:, 0]),
                                    temperature, rng, top_k, top_p)
    return buf


def _reorder_cache_rows(ffd: FFModel, perm: np.ndarray):
    """Gather the dense caches' batch rows by `perm`, in place (beam
    bookkeeping: row i's history becomes row perm[i]'s).  cache_pos is
    the same for every row and stays."""
    perm = np.asarray(perm)
    if np.array_equal(perm, np.arange(len(perm))):
        return
    idx = None
    with torch.no_grad():
        for entries in ffd._state.values():
            for k in ("k_cache", "v_cache"):
                v = entries.get(k)
                if v is None:
                    continue
                if idx is None:
                    idx = torch.as_tensor(perm, dtype=torch.long,
                                          device=v.device)
                v.copy_(v.index_select(0, idx))


def gpt_beam_search_cached(ffd: FFModel, prompt_ids, max_new_tokens: int,
                           beam_size: int = 4, length_penalty: float = 0.0,
                           eos_id: int = -1):
    """KV-cached, batched beam search on a dense make_gpt_decoder twin:
    the O(T) form of models.transformer.gpt_beam_search, over several
    prompts.  `num_prompts * beam_size` must equal the decoder's batch.
    Scores are summed token log-probs; `length_penalty` applies GNMT's
    ((5+len)/6)^lp to the final scores; `eos_id` >= 0 freezes finished
    beams, which compete at their final score.

    prompt_ids: [num_prompts, prompt_len] ints.
    Returns (tokens [num_prompts, total_len], scores [num_prompts]).
    """
    prompt_ids = np.asarray(prompt_ids, np.int32)
    if prompt_ids.ndim == 1:
        prompt_ids = prompt_ids[None]
    max_seq = _gpt_dims(ffd)["max_seq"]
    P, plen = prompt_ids.shape
    K = beam_size
    if plen < 1:
        raise ValueError("gpt_beam_search_cached needs a non-empty prompt")
    if P * K != ffd.config.batch_size:
        raise ValueError(
            f"num_prompts*beam_size = {P}*{K} != decoder batch "
            f"{ffd.config.batch_size}")
    total = min(max_seq, plen + max_new_tokens)
    B = P * K

    ffd.reset_decode_state()
    buf = np.zeros((B, total), np.int32)
    buf[:, :plen] = np.repeat(prompt_ids[:, :total], K, axis=0)
    scores = np.full((P, K), -np.inf, np.float64)
    scores[:, 0] = 0.0  # one distinct hypothesis per prompt at step 1
    alive = np.ones((P, K), bool)
    gen_len = np.zeros((P, K), np.int64)

    for t in range(total - 1):
        logits = ffd.decode_step({
            "input": buf[:, t:t + 1],
            "positions": np.full((B, 1), t, np.int32)})
        if t + 1 < plen:
            continue  # prefill: every row follows its prompt
        step = _host_logits(logits[:, 0]).reshape(P, K, -1)
        z = step - step.max(-1, keepdims=True)
        lp = z - np.log(np.exp(z).sum(-1, keepdims=True))  # [P, K, vocab]
        vocab = lp.shape[-1]
        cand = scores[..., None] + np.where(alive[..., None], lp, -np.inf)
        for p in range(P):
            if eos_id >= 0 and not alive[p].all():
                cand[p, ~alive[p], :] = -np.inf
                cand[p, ~alive[p], 0] = scores[p, ~alive[p]]
        flat = cand.reshape(P, -1)
        top = np.argsort(-flat, axis=-1)[:, :K]  # [P, K]
        src_beam, tok = top // vocab, (top % vocab).astype(np.int32)
        perm = (np.arange(P)[:, None] * K + src_beam).reshape(-1)
        _reorder_cache_rows(ffd, perm)
        new_buf = buf[perm].copy()
        new_alive = np.take_along_axis(alive, src_beam, -1)
        write = new_alive.reshape(-1)
        new_buf[write, t + 1] = tok.reshape(-1)[write]
        gen_len = np.take_along_axis(gen_len, src_beam, -1) + new_alive
        if eos_id >= 0:
            new_alive &= tok != eos_id
        buf = new_buf
        scores = np.take_along_axis(flat, top, -1)
        alive = new_alive
        if eos_id >= 0 and not alive.any():
            break
    if length_penalty > 0.0:
        norm = ((5.0 + np.maximum(gen_len, 1).astype(np.float64)) / 6.0) \
            ** length_penalty
        best = np.argmax(scores / norm, axis=-1)
    else:
        best = np.argmax(scores, axis=-1)
    rows = np.arange(P) * K + best
    return buf[rows].copy(), scores[np.arange(P), best].astype(float)


def gpt_generate_scan(ffd: FFModel, prompt_ids, max_new_tokens: int,
                      temperature: float = 0.0, seed: int = 0) -> np.ndarray:
    """The whole generation as one device-side loop on a dense twin
    (run_generate_scan): no host sync between tokens."""
    prompt_ids = np.asarray(prompt_ids, np.int32)
    max_seq = _gpt_dims(ffd)["max_seq"]
    batch, plen = prompt_ids.shape
    if plen < 1:
        raise ValueError("gpt_generate_scan needs a non-empty prompt")
    _check_batch(ffd, batch, "prompt batch")
    total = int(min(max_seq, plen + max_new_tokens))
    prompt_pad = np.zeros((batch, total), np.int32)
    prompt_pad[:, :plen] = prompt_ids[:, :total]
    out = run_generate_scan(ffd, prompt_pad,
                            np.full(batch, plen, np.int32), temperature,
                            seed)
    out[:, :plen] = prompt_ids[:, :total]  # the prompt verbatim
    return out


def run_generate_scan(ffd: FFModel, prompt_pad: np.ndarray,
                      plens: np.ndarray, temperature: float = 0.0,
                      seed: int = 0) -> np.ndarray:
    """The device-side generator over a row-padded prompt buffer.

    prompt_pad: [batch, total] int32, row i's prompt in [:plens[i]].
    Each row takes its own prompt token while t + 1 < plens[i], then its
    sampled one, up to `total`; prompt, lengths, tokens and positions
    live on the twin's device, so the loop enqueues work and the host
    waits once, for the token buffer.  Sampling at temperature > 0 draws
    with torch.multinomial from a torch.Generator seeded with `seed`
    (not the reference's jax.random draws).  The caches are left as the
    last step wrote them; the next generation resets them."""
    batch, total = prompt_pad.shape
    _check_batch(ffd, batch, "prompt batch")
    limit = _gpt_dims(ffd)["max_seq"]
    if total - 1 > limit:  # an index_copy_ past the caches faults
        raise ValueError(f"run_generate_scan: {total - 1} steps past "
                         f"decode_max_seq={limit}")
    ffd.reset_decode_state()
    ex, dev = ffd.executor, ffd.device
    prompt = torch.as_tensor(np.asarray(prompt_pad, np.int32), device=dev)
    plen_t = torch.as_tensor(np.asarray(plens, np.int32), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    toks = torch.empty(batch, total, dtype=torch.int32, device=dev)
    toks[:, 0] = prompt[:, 0]
    tok = prompt[:, 0]
    with torch.no_grad():
        for t in range(total - 1):
            logits, _ = ex.run_forward(
                ffd._weights, ffd._state,
                {"input": tok[:, None],
                 "positions": torch.full((batch, 1), t, dtype=torch.int32,
                                         device=dev)})
            step = logits[:, 0]
            if temperature > 0.0:
                probs = torch.softmax(step / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = torch.argmax(step, dim=-1)
            # during its prefill a row's next token is its prompt's
            tok = torch.where(t + 1 < plen_t, prompt[:, t + 1],
                              nxt.to(torch.int32))
            toks[:, t + 1] = tok
    ffd._sync_decode_pos()
    return toks.cpu().numpy()


def _with_tables(state, block_table, seq_lens):
    """A shallow view of the state with every attention layer's block
    table and seq_lens replaced (the pools stay the same tensors)."""
    return {
        op: {k: (block_table if k == "block_table"
                 else seq_lens if k == "seq_lens" else v)
             for k, v in entries.items()}
        for op, entries in state.items()
    }


def build_paged_decode_step(ffd: FFModel):
    """The continuous engine's decode step on a paged twin:

        step(weights, state, tokens[b], positions[b], block_table)
            -> (logits [b, vocab], state)

    Every row steps one token at its own position; tensors live on the
    twin's device.  The pools in `state` are written in place."""
    ex = ffd.executor

    def step(weights, state, tokens, positions, block_table):
        positions = positions.to(torch.int32)
        with torch.no_grad():
            logits, _ = ex.run_forward(
                weights, _with_tables(state, block_table, positions),
                {"input": tokens[:, None], "positions": positions[:, None]})
        return logits[:, 0], state

    return step


def build_paged_prefill_step(ffd: FFModel, chunk: int):
    """The [slots, C] chunked-prefill step:

        prefill(weights, state, tokens[b, C], positions[b], block_table)
            -> state

    Row i's token j lands at positions[i] + j.  Like the reference's
    lax.scan, this is a loop of C seq-1 forwards, so every op keeps the
    decode step's shapes and the pool bytes match one-token prefill.
    A row's trailing pad positions past the position table are routed
    to the scratch block (zeroed table row) and clamped in range."""
    if chunk < 2:
        raise ValueError(f"chunk must be >= 2, got {chunk}")
    ex = ffd.executor
    max_seq = _gpt_dims(ffd)["max_seq"]

    def prefill(weights, state, tokens, positions, block_table):
        positions = positions.to(torch.int32)
        with torch.no_grad():
            for j in range(chunk):
                pos_j = positions + j
                live = (pos_j < max_seq)[:, None]
                bt_j = torch.where(live, block_table,
                                   torch.zeros_like(block_table))
                pos_j = pos_j.clamp(max=max_seq - 1)
                ex.run_forward(
                    weights, _with_tables(state, bt_j, pos_j),
                    {"input": tokens[:, j:j + 1],
                     "positions": pos_j[:, None]})
        return state

    return prefill


def build_paged_copy_block(ffd: FFModel):
    """Copy-on-write for the paged pools:

        copy(state, src, dst) -> state

    copies physical block `src` to block `dst` in EVERY layer's k/v
    pool, in place (the prefix cache's COW before a full-hit request's
    first write).  It runs on the same stream as the steps, so a
    following step reads the copied bytes."""

    def copy(state, src: int, dst: int):
        with torch.no_grad():
            for entries in state.values():
                for k in ("k_cache", "v_cache"):
                    if k in entries:
                        entries[k][dst].copy_(entries[k][src])
        return state

    return copy
