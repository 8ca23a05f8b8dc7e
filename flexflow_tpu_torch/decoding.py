"""Paged KV-cache decoding (flexflow_tpu/decoding.py).

`make_gpt_decoder` builds the seq-1 PAGED decode twin of a
`models.transformer.build_gpt` model: every attention layer's k/v
cache is a [kv_num_blocks, kv_page_size, h, d] block pool with a
host-owned block table and per-slot seq_lens.  The twin SHARES the
weight tensors of the model it was built from; it does not copy them.

The build_paged_* functions return plain functions over the twin's
weight and state dictionaries.  Where the reference jit-compiled them
with the state donated, here they update the KV pools IN PLACE and
return the same state dictionary.
"""
from __future__ import annotations

from typing import Dict, Optional

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
                     kv_page_size: int = 0,
                     kv_num_blocks: int = 0) -> FFModel:
    """Build + compile the paged seq-1 decode twin of a GPT on the train
    model's device, with decode_max_seq = its position-table size, and
    point its weights at the train model's tensors."""
    from .config import FFConfig
    from .models.transformer import build_gpt

    if kv_page_size < 1:
        raise ValueError(
            "make_gpt_decoder builds the paged twin (kv_page_size > 0); "
            "the dense-cache twin is not in the serving slice of the port")
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
