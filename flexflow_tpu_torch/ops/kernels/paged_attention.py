"""Paged attention over the serving tier's paged KV pool: the read side
of every paged decode step, in every layer.

Replaces the TPU kernel `_paged_kernel` (launched by `paged_attention`,
flexflow_tpu/ops/pallas/paged_attention.py).  On the card it is a CUDA
C++ kernel written by hand for sm_90a, `csrc/paged_attention.cu`,
built with nvcc at first use into `flexflow_tpu_torch/_build/` and
loaded through ctypes (`_build.py`).  The kernel is bound by bytes: it
reads each row's live KV pages once, in place through the block table,
with two flops per element read.  Its grid is (head, row, split), a
split being a run of `SPLIT_PAGES` whole pages of one row: a block stages
its split's K and V rows with cp.async, scores them all at once and
writes a float32 partial (m, l, acc) to a workspace, and the last block
of a (row, head) merges the partials in split order (see the source's
note).  Blocks past a row's live pages exit at once, so per-step reads
follow live tokens instead of `decode_max_seq`.  The workspace comes from
the caching allocator at each call; the merge's counters are one int32
per (row, head), kept per device and left at 0 by every launch, so calls
that share a device run on one stream at a time.

`paged_attention` keeps the reference's signature and layout.  A CPU
tensor runs `paged_attention_plain`, the gather formulation of
`MultiHeadAttention._attend_decode_paged` (the reference oracle):
gather the row's pages into a dense view, mask `key_pos <= pos + j`,
softmax, then the context product.  A CUDA tensor launches the kernel
or raises; nothing falls back.  `paged_attention.launches` counts the
kernel launches (one per call).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

SOURCE = _build.CSRC / "paged_attention.cu"

MAX_CHUNK = 16  # the kernel's kMaxChunk
HEAD_DIMS = (64, 128)
# pages of one split: of the lengths chip_smoke.py's kernels phase sweeps
# on the card (1-16 pages of 16 at the 8-slot decode shapes), 4 and 8 are
# within a few percent of each other and 4 gives short rows more blocks
SPLIT_PAGES = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_counters: dict = {}  # device -> int32 merge counters, all 0 between calls


def split_grid(batch: int, heads: int, table_width: int,
               split_pages: int = SPLIT_PAGES) -> tuple:
    """The kernel's grid (heads, batch, splits): splits of `split_pages`
    pages cover the table's width, whatever the rows' live counts."""
    return heads, batch, -(-table_width // split_pages)


def live_splits(seq_lens: np.ndarray, chunk: int, page: int,
                table_width: int,
                split_pages: int = SPLIT_PAGES) -> np.ndarray:
    """Splits per row that hold a live key (the others exit at once):
    ceil(live count / span), the live count min(pos + chunk - 1,
    table_width * page - 1) + 1 as in the kernel."""
    pos = np.asarray(seq_lens, np.int64)
    n_tok = np.minimum(pos + chunk - 1, table_width * page - 1) + 1
    return -(-n_tok // (split_pages * page))


def _merge_counters(device: torch.device, n: int) -> torch.Tensor:
    c = _counters.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


def blocks_read(seq_lens: np.ndarray, live_mask: np.ndarray, chunk: int,
                page: int, table_width: int) -> int:
    """Host-side twin of the kernel's traffic: physical KV blocks one
    launch reads for the rows `live_mask` marks live (idle rows count
    0).  The dense-gather equivalent is ``len(seq_lens) *
    table_width``."""
    pos = np.asarray(seq_lens, np.int64)
    last = np.minimum(pos + chunk - 1, table_width * page - 1)
    per_row = np.where(np.asarray(live_mask, bool), last // page + 1, 0)
    return int(per_row.sum())


def _bind(lib: ctypes.CDLL) -> None:
    lib.ff_paged_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.ff_paged_attention.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def paged_attention_plain(qh, k_pool, v_pool, block_table, seq_lens,
                          scale: float) -> torch.Tensor:
    """The gather formulation of the read side, on any device: per chunk
    position j, a dense [b, table_width * page] view of the row's
    pages, the mask key_pos <= pos + j (filled with the dtype's finfo
    min, as the reference oracle does), softmax and the context
    product, all in qh's dtype."""
    b, s, h, _ = qh.shape
    page = k_pool.shape[1]
    n = block_table.shape[1] * page
    btab = block_table.long()
    pos = seq_lens.reshape(b).long()
    kv_k = k_pool[btab].reshape(b, n, h, -1).to(qh.dtype)
    kv_v = v_pool[btab].reshape(b, n, h, -1).to(qh.dtype)
    key_pos = torch.arange(n, device=qh.device)
    ctxs = []
    for j in range(s):
        scores = torch.einsum("bqhd,bkhd->bhqk", qh[:, j:j + 1],
                              kv_k) * scale
        mask = key_pos[None, :] <= (pos + j)[:, None]  # [b, n]
        scores = scores.masked_fill(~mask[:, None, None, :],
                                    torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        ctxs.append(torch.einsum("bhqk,bkhd->bqhd", probs, kv_v))
    return ctxs[0] if s == 1 else torch.cat(ctxs, dim=1)


def _check(qh, k_pool, v_pool, block_table, seq_lens):
    b, s, h, dk = qh.shape
    dev = qh.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if t.device != dev:
            raise ValueError(
                f"paged_attention: {name} is on {t.device}, qh on {dev}")
    if qh.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16, got "
            f"{qh.dtype}")
    if k_pool.dtype != qh.dtype or v_pool.dtype != qh.dtype:
        raise TypeError(
            f"paged_attention kernel needs one dtype for q and the pools, "
            f"got {qh.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_table and seq_lens must "
                        "be int32")
    if not 1 <= s <= MAX_CHUNK:
        raise ValueError(
            f"paged_attention kernel takes 1..{MAX_CHUNK} queries per "
            f"row, got {s}")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or k_pool.shape[2] != h or k_pool.shape[3] != dk:
        raise ValueError(
            f"paged_attention: pools {tuple(k_pool.shape)} / "
            f"{tuple(v_pool.shape)} do not match qh {tuple(qh.shape)}")
    if dk not in HEAD_DIMS:
        raise ValueError(
            f"paged_attention kernel takes head dims {HEAD_DIMS}, got {dk}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(
            f"paged_attention: block_table {tuple(block_table.shape)} / "
            f"seq_lens {tuple(seq_lens.shape)} do not match {b} rows")
    for name, t in (("qh", qh), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")


def paged_attention(qh, k_pool, v_pool, block_table, seq_lens,
                    scale: float, split_pages: int = SPLIT_PAGES
                    ) -> torch.Tensor:
    """Paged attention over the pool.

    qh:          [b, s, h, dk]  this step's queries (s = 1 or chunk C)
    k_pool:      [num_blocks, page, h, dk]  the physical K pool
    v_pool:      [num_blocks, page, h, dv]
    block_table: [b, table_width] int32 (host-owned, scratch-padded)
    seq_lens:    [b] int32, row i's incoming position (its chunk
                 occupies positions seq_lens[i] .. seq_lens[i]+s-1,
                 already scattered into the pool by the caller)
    split_pages: pages of one split of the kernel's grid
    ->           [b, s, h, dv] context, qh's dtype

    CPU tensors run the plain version; CUDA tensors launch the kernel
    on the current stream or raise."""
    if qh.device.type == "cpu":
        return paged_attention_plain(qh, k_pool, v_pool, block_table,
                                     seq_lens, scale)
    if qh.device.type != "cuda":
        raise ValueError(
            f"paged_attention runs on cuda or cpu tensors, got {qh.device}")
    _check(qh, k_pool, v_pool, block_table, seq_lens)
    if split_pages < 1:
        raise ValueError(f"paged_attention: split_pages {split_pages} < 1")
    b, s, h, dk = qh.shape
    width = block_table.shape[1]
    lib = load_library()
    out = torch.empty((b, s, h, v_pool.shape[-1]), dtype=qh.dtype,
                      device=qh.device)
    n_splits = split_grid(b, h, width, split_pages)[2]
    part = torch.empty(b * h * n_splits * s * (dk + 2), dtype=torch.float32,
                       device=qh.device)
    counters = _merge_counters(qh.device, b * h)
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ff_paged_attention(
            qh.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), b, s, h, dk,
            k_pool.shape[1], width, split_pages, float(scale),
            _DTYPE_CODES[qh.dtype], stream)
    _build.check_launch(lib, rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
