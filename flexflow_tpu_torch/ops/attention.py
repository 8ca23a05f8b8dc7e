"""Multi-head attention (flexflow_tpu/ops/attention.py).

Per-projection weights in the reference's layout: wq/wk/wv are
[embed, heads, head_dim] and wo is [heads, head_dim, embed].  Three
modes run in the port:

  * the train-graph forward `_attend`, in training and inference.  At
    a KV length >= flash_min_seq (FFConfig.flash_min_seq, stamped on the
    op by compile), or when the score tensor would pass 2 GiB, it takes
    the flash kernels K1-K3 through `mha_flash` (the CUDA kernels on the
    card, their plain versions on the CPU); below that, with attention
    dropout, or for causal attention with appended keys, the dense
    score matrix, whose dropout draws from the executor's
    torch.Generator.  Under a strategy that shards the sequence, the
    multi-GPU executor passes `seq_ring`, ring attention over its mesh's
    sequence axis (parallel/ring_attention.py), which launches K1-K3 on
    every block; in one process a sharded sequence raises;
  * the DENSE decode mode (decode_max_seq > 0, kv_page_size 0), the
    decode twin of decoding.gpt_generate_cached, _scan and the beam
    search: [b, decode_max_seq, h, d] caches and a cache_pos counter in
    the op state, written in place under torch.no_grad() at device-side
    indices (`_attend_decode`), read by two einsums over the whole
    cache with the unwritten slots masked at finfo(dtype).min;
  * the PAGED decode mode (decode_max_seq > 0 and kv_page_size > 0),
    the serving tier's step: scatter this step's k/v into the block
    pool at each row's own position, in plain torch indexing and IN
    PLACE (the reference returned new pools under donation), then read
    the pool through ops/kernels/paged_attention.paged_attention (the
    CUDA kernel on the card, its plain gather version on the CPU).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..config import DEFAULT_FLASH_MIN_SEQ
from ..fftype import DataType, OperatorType
from ..initializer import GlorotUniform, ZeroInitializer
from ..tensor import ParallelDim, ParallelTensorShape
from .kernels.flash_attention import mha_flash
from .kernels.paged_attention import paged_attention
from .op import Op, ShapeError, ShardConfig, WeightSpec

# the reference forces its flash kernel when the per-device [b, h, q, k]
# score tensor would exceed this
_FLASH_FORCE_SCORE_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class MultiHeadAttentionParams:
    embed_dim: int
    num_heads: int
    kdim: int = 0  # 0 -> embed_dim
    vdim: int = 0
    dropout: float = 0.0
    use_bias: bool = False
    add_bias_kv: bool = False
    add_zero_attn: bool = False
    causal: bool = False

    @property
    def k_channels(self) -> int:
        return (self.kdim or self.embed_dim) // self.num_heads

    @property
    def v_channels(self) -> int:
        return (self.vdim or self.embed_dim) // self.num_heads


class MultiHeadAttention(Op):
    op_type = OperatorType.MULTIHEAD_ATTENTION

    def __init__(self, params, inputs, name="", shard=None,
                 decode_max_seq: int = 0, kv_page_size: int = 0,
                 kv_num_blocks: int = 0):
        # must exist before Op.__init__ runs make_weight_specs
        self._decode_max_seq = int(decode_max_seq)
        self._kv_page_size = int(kv_page_size)
        self._kv_num_blocks = int(kv_num_blocks)
        # FFConfig.flash_min_seq; compile stamps the model's value
        self._flash_min_seq = DEFAULT_FLASH_MIN_SEQ
        super().__init__(params, inputs, name=name,
                         shard=shard or ShardConfig())

    def infer_output_shapes(self, input_shapes):
        q, k, v = input_shapes
        p: MultiHeadAttentionParams = self.params
        qd = [d for d in q.dims if not d.is_replica_dim]
        kd = [d for d in k.dims if not d.is_replica_dim]
        vd = [d for d in v.dims if not d.is_replica_dim]
        if len(qd) != 3:
            raise ShapeError(f"{self.name}: expect [batch, seq, embed] inputs")
        if p.num_heads % self.shard.channel != 0:
            raise ShapeError(f"{self.name}: heads {p.num_heads} not "
                             f"divisible by degree {self.shard.channel}")
        if qd[1].degree != 1 or kd[1].degree != 1 or vd[1].degree != 1:
            if not (qd[1].degree == kd[1].degree == vd[1].degree):
                raise ShapeError(
                    f"{self.name}: ring attention needs equal q/k/v seq "
                    f"degrees, got {qd[1].degree}/{kd[1].degree}/"
                    f"{vd[1].degree}")
            if p.add_bias_kv or p.add_zero_attn:
                raise ShapeError(f"{self.name}: kv-append options "
                                 "unsupported with sequence sharding")
            if p.dropout > 0.0:
                raise ShapeError(
                    f"{self.name}: attention dropout unsupported with "
                    "sequence sharding (ring attention)")
        ri = q.replica_degree
        c = self.shard.channel
        if c > 1 and ri % c == 0:
            ri //= c
        dims = (
            ParallelDim(qd[0].size, qd[0].degree),
            ParallelDim(qd[1].size, qd[1].degree),
            ParallelDim(p.embed_dim, 1),
            ParallelDim(1, ri * c, is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, q.dtype)]

    def _decode_n(self) -> int:
        return self._decode_max_seq

    def _paged(self) -> bool:
        return self._decode_n() > 0 and self._kv_page_size > 0

    def ctor_kwargs(self) -> dict:
        n = self._decode_n()
        if not n:
            return {}
        kw = {"decode_max_seq": n}
        if self._paged():
            kw["kv_page_size"] = self._kv_page_size
            kw["kv_num_blocks"] = self._kv_num_blocks
        return kw

    def num_trainable_weights(self) -> int:
        p: MultiHeadAttentionParams = self.params
        return 4 + (4 if p.use_bias else 0) + (2 if p.add_bias_kv else 0)

    def make_weight_specs(self, input_shapes):
        q, k, v = input_shapes
        p: MultiHeadAttentionParams = self.params
        qd = [d for d in q.dims if not d.is_replica_dim]
        batch_degree = qd[0].degree * qd[1].degree
        c = self.shard.channel
        dt = q.dtype

        def w(shape_sizes, head_axis):
            dims = [ParallelDim(s, c if i == head_axis else 1)
                    for i, s in enumerate(shape_sizes)]
            extra = batch_degree if head_axis is not None \
                else batch_degree * c
            dims.append(ParallelDim(1, extra, is_replica_dim=True))
            return ParallelTensorShape(tuple(dims), dt)

        embed = p.embed_dim
        init = GlorotUniform(fan_in=embed, fan_out=embed)
        specs = [
            WeightSpec("wq", w((embed, p.num_heads, p.k_channels), 1), init),
            WeightSpec("wk", w((k.logical_shape[-1], p.num_heads,
                                p.k_channels), 1), init),
            WeightSpec("wv", w((v.logical_shape[-1], p.num_heads,
                                p.v_channels), 1), init),
            WeightSpec("wo", w((p.num_heads, p.v_channels, embed), 0), init),
        ]
        zero = ZeroInitializer()
        if p.use_bias:
            specs += [
                WeightSpec("bq", w((p.num_heads, p.k_channels), 0), zero),
                WeightSpec("bk", w((p.num_heads, p.k_channels), 0), zero),
                WeightSpec("bv", w((p.num_heads, p.v_channels), 0), zero),
                WeightSpec("bo", w((embed,), None), zero),
            ]
        if p.add_bias_kv:
            specs += [
                WeightSpec("bias_k", w((1, p.num_heads, p.k_channels), 1),
                           init),
                WeightSpec("bias_v", w((1, p.num_heads, p.v_channels), 1),
                           init),
            ]
        n = self._decode_n()
        if n > 0:
            if p.add_bias_kv or p.add_zero_attn:
                raise ShapeError(
                    f"{self.name}: kv-append options unsupported in "
                    "decode mode")
            if qd[1].degree != 1:
                raise ShapeError(
                    f"{self.name}: decode mode needs an unsharded seq dim")
            if self._paged():
                return specs + self._paged_state_specs(qd, dt)

            def cache(d_head):
                dims = (
                    ParallelDim(qd[0].size, qd[0].degree),
                    ParallelDim(n),
                    ParallelDim(p.num_heads, c),
                    ParallelDim(d_head),
                    ParallelDim(1, q.replica_degree, is_replica_dim=True),
                )
                return ParallelTensorShape(dims, dt)

            pos_shape = ParallelTensorShape(
                (ParallelDim(1),
                 ParallelDim(1, q.total_degree, is_replica_dim=True)),
                DataType.INT32,
            )
            specs += [
                WeightSpec("k_cache", cache(p.k_channels), zero),
                WeightSpec("v_cache", cache(p.v_channels), zero),
                WeightSpec("cache_pos", pos_shape, zero),
            ]
        return specs

    def _paged_state_specs(self, qd, dt):
        """State specs for paged decode: block-pool k/v caches plus the
        host-owned per-slot block table and sequence lengths."""
        p: MultiHeadAttentionParams = self.params
        n, page, nb = self._decode_n(), self._kv_page_size, \
            self._kv_num_blocks
        if not 1 <= qd[1].size <= n:
            raise ShapeError(
                f"{self.name}: paged decode chunk must be within [1, "
                f"decode_max_seq={n}], got {qd[1].size}")
        if qd[0].degree != 1:
            raise ShapeError(
                f"{self.name}: paged decode mode needs an unsharded "
                "batch dim (slots are host-owned)")
        if page < 1 or n % page:
            raise ShapeError(
                f"{self.name}: kv_page_size {page} must divide "
                f"decode_max_seq {n}")
        if nb < 2:
            raise ShapeError(
                f"{self.name}: kv_num_blocks {nb} < 2 (block 0 is the "
                "scratch block idle slots write into)")
        zero = ZeroInitializer()

        def pool(d_head):
            dims = (
                ParallelDim(nb), ParallelDim(page),
                ParallelDim(p.num_heads, self.shard.channel),
                ParallelDim(d_head),
                ParallelDim(1, 1, is_replica_dim=True),
            )
            return ParallelTensorShape(dims, dt)

        def ints(*sizes):
            dims = tuple(ParallelDim(s) for s in sizes) + (
                ParallelDim(1, 1, is_replica_dim=True),)
            return ParallelTensorShape(dims, DataType.INT32)

        return [
            WeightSpec("k_cache", pool(p.k_channels), zero),
            WeightSpec("v_cache", pool(p.v_channels), zero),
            WeightSpec("block_table", ints(qd[0].size, n // page), zero),
            WeightSpec("seq_lens", ints(qd[0].size), zero),
        ]

    def forward(self, inputs, weights, *, training=False,
                generator=None, seq_ring=None):
        q, k, v = inputs
        p: MultiHeadAttentionParams = self.params
        wq, wk, wv, wo = weights[:4]
        wi = 4
        # [b, s, e] x [e, h, d] -> [b, s, h, d]
        qh = torch.einsum("bse,ehd->bshd", q, wq)
        kh = torch.einsum("bse,ehd->bshd", k, wk)
        vh = torch.einsum("bse,ehd->bshd", v, wv)
        bo = None
        if p.use_bias:
            bq, bk, bv, bo = weights[wi:wi + 4]
            wi += 4
            qh = qh + bq[None, None]
            kh = kh + bk[None, None]
            vh = vh + bv[None, None]
        if p.add_bias_kv:
            bias_k, bias_v = weights[wi:wi + 2]
            bsz = kh.shape[0]
            kh = torch.cat([kh, bias_k[None].expand(bsz, *bias_k.shape)], 1)
            vh = torch.cat([vh, bias_v[None].expand(bsz, *bias_v.shape)], 1)
        if p.add_zero_attn:
            bsz, _, h, dk = kh.shape
            kh = torch.cat([kh, kh.new_zeros(bsz, 1, h, dk)], 1)
            vh = torch.cat([vh, vh.new_zeros(bsz, 1, h, vh.shape[-1])], 1)
        scale = 1.0 / np.sqrt(p.k_channels)
        if self._paged():
            k_cache, v_cache, btab, slen = weights[-4:]
            ctx = self._attend_decode_paged(qh, kh, vh, k_cache, v_cache,
                                            btab, slen, scale)
            out = torch.einsum("bqhd,hde->bqe", ctx, wo)
            if bo is not None:
                out = out + bo[None, None]
            return [out.to(q.dtype), k_cache, v_cache, btab, slen]
        if self._decode_n() > 0:
            k_cache, v_cache, pos = weights[-3:]
            ctx = self._attend_decode(qh, kh, vh, k_cache, v_cache, pos,
                                      scale)
            out = torch.einsum("bqhd,hde->bqe", ctx, wo)
            if bo is not None:
                out = out + bo[None, None]
            return [out.to(q.dtype), k_cache, v_cache, pos]
        ctx = self._attend(qh, kh, vh, scale, training=training,
                           generator=generator, seq_ring=seq_ring)
        out = torch.einsum("bqhd,hde->bqe", ctx, wo)
        if bo is not None:
            out = out + bo[None, None]
        return [out.to(q.dtype)]

    def _attend_decode(self, qh, kh, vh, k_cache, v_cache, pos, scale):
        """Dense-cache incremental attention: this step's k/v are written
        IN PLACE into the [b, N, h, d] caches at positions pos..pos+s-1
        (`pos` is the [1] int32 cache_pos entry, which then advances by
        s, in place), and the step's queries attend over the whole cache
        with the slots past each query masked.  Every index stays on the
        device, so a decode loop makes no host sync.  Causal: key slot k
        is visible to query j when k <= pos + j; otherwise every written
        slot (k < pos + s) is."""
        p: MultiHeadAttentionParams = self.params
        s = qh.shape[1]
        n = k_cache.shape[1]
        q_pos = pos.long() + torch.arange(s, device=qh.device)
        with torch.no_grad():
            k_cache.index_copy_(1, q_pos, kh.to(k_cache.dtype))
            v_cache.index_copy_(1, q_pos, vh.to(v_cache.dtype))
            pos.add_(s)
        key_pos = torch.arange(n, device=qh.device)
        if p.causal:
            mask = key_pos[None, :] <= q_pos[:, None]  # [s, n]
        else:
            mask = (key_pos < q_pos[-1] + 1)[None, :].expand(s, n)
        scores = torch.einsum("bqhd,bkhd->bhqk", qh,
                              k_cache.to(qh.dtype)) * scale
        scores = scores.masked_fill(~mask[None, None],
                                    torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache.to(qh.dtype))

    def _attend_decode_paged(self, qh, kh, vh, k_cache, v_cache, btab,
                             slen, scale):
        """Paged incremental attention.  Row i's chunk token j is
        written IN PLACE into the pools at position slen[i] + j (block
        btab[i, pos // page], offset pos % page), in the reference's
        order; positions past the position table are routed to the
        scratch block (a zeroed table row) and clamped, since torch
        indexing faults on CUDA and wraps negatives where jax drops
        out-of-range writes.  Then one paged_attention call reads each
        row's pages.  Idle slots point their table at scratch block 0
        with seq_len 0, so their writes land in scratch and their
        logits are ignored by the scheduler."""
        b, s = qh.shape[0], qh.shape[1]
        page = self._kv_page_size
        n = btab.shape[1] * page
        pos = slen.reshape(b)
        rows = torch.arange(b, device=qh.device)
        for j in range(s):
            pj = (pos + j).long()
            if j > 0:
                safe = (pj < n)[:, None]
                bt_j = torch.where(safe, btab, torch.zeros_like(btab))
                pj = pj.clamp(max=n - 1)
            else:
                bt_j = btab  # decode positions are in range by contract
            blk = bt_j[rows, pj // page].long()
            off = pj % page
            k_cache[blk, off] = kh[:, j].to(k_cache.dtype)
            v_cache[blk, off] = vh[:, j].to(v_cache.dtype)
        return paged_attention(qh.contiguous(), k_cache, v_cache, btab,
                               pos.to(torch.int32).contiguous(), scale)

    def _attend(self, qh, kh, vh, scale, *, training, generator=None,
                seq_ring=None):
        p: MultiHeadAttentionParams = self.params
        if seq_ring is not None:
            return seq_ring(qh, kh, vh, scale, p.causal,
                            self._flash_min_seq)
        if self.inputs[0].shape.degrees[1] > 1:
            raise NotImplementedError(
                f"{self.name}: a sharded sequence runs as ring attention "
                "over the ranks of a torch.distributed group (the "
                "multi-GPU executor); one process cannot run it alone")
        kv_appended = kh.shape[1] - self.inputs[1].shape.logical_shape[1]
        use_dropout = training and p.dropout > 0.0 and generator is not None
        # the per-device [b, h, q, k] score tensor (one device: no
        # partition degrees to divide by)
        scores_bytes = (qh.shape[0] * qh.shape[2] * qh.shape[1]
                        * kh.shape[1] * qh.element_size())
        force_flash = scores_bytes > _FLASH_FORCE_SCORE_BYTES
        if force_flash and (use_dropout or (p.causal and kv_appended)):
            warnings.warn(
                f"{self.name}: ~{scores_bytes >> 30} GiB of attention "
                "scores will materialize per device — the flash path "
                "cannot take over because of "
                + ("attention dropout" if use_dropout
                   else "causal attention with appended kv "
                        "(add_bias_kv/add_zero_attn)"))
        if (not use_dropout and not (p.causal and kv_appended)
                and (kh.shape[1] >= self._flash_min_seq or force_flash)):
            return mha_flash(qh, kh, vh, scale, p.causal)
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
        if p.causal:
            qlen, klen = scores.shape[-2], scores.shape[-1]
            # appended bias_kv/zero_attn keys are always attendable;
            # real keys follow absolute-position causality
            mask = torch.ones(qlen, klen, dtype=torch.bool,
                              device=scores.device).tril()
            if kv_appended:
                mask[:, klen - kv_appended:] = True
            scores = scores.masked_fill(~mask,
                                        torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        if use_dropout:
            keep = 1.0 - p.dropout
            kept = torch.rand(probs.shape, generator=generator,
                              device=probs.device) < keep
            probs = probs * kept / keep
        return torch.einsum("bhqk,bkhd->bqhd", probs, vh)

    def flops(self):
        p: MultiHeadAttentionParams = self.params
        b, s, e = self.inputs[0].shape.logical_shape
        ks = self.inputs[1].shape.logical_shape[1]
        proj = 2.0 * b * s * e * p.num_heads * p.k_channels * 3
        proj += 2.0 * b * s * e * p.num_heads * p.v_channels
        attn = 2.0 * b * p.num_heads * s * ks * (p.k_channels + p.v_channels)
        return proj + attn
