"""Ring attention: sequence-parallel attention over the ranks of one mesh
axis (flexflow_tpu/parallel/ring_attention.py).

q, k and v arrive sharded on the sequence dim over the `seq` axis.  The
K/V blocks travel the ring, one `batch_isend_irecv` per step, while
each rank merges its queries' partial results through their
log-sum-exp.  At step s a rank holds the block of the rank s places
back.

The flash ring (`RingFlashAttention`) runs the ported kernels on every
block: K1 (`flash_fwd`) gives each block's normalized output and LSE,
the merge state; the backward runs K2 and K3 (`flash_bwd_dq`,
`flash_bwd_dkv`) per block against the global LSE and delta, and the
dK/dV partial sums travel with their blocks, so that after the last of
`sp` shifts each gradient block is home.  Causal rings with square
shards use the kernels' own causal mask on the diagonal block (step 0)
and skip the blocks a rank cannot see (later steps hold earlier blocks
exactly when step <= coordinate).  The kernels take no position
offsets and are not changed for the ring.  On CPU tensors the wrappers
run their plain versions, as everywhere in the port.

The dense ring (`_ring_dense`) computes each block's scores in torch,
with absolute-position causality, and differentiates through autograd
(the shift's backward is the reverse shift).  It covers what the flash
ring does not take: head dims or dtypes the kernels refuse, causal
rings with unequal q and k shards, and a KV length under the flash
crossover.
"""
from __future__ import annotations

import torch

from ..ops.kernels import flash_attention as fa
from .collectives import ring_shift
from .machine import DeviceMesh

_NEG_INF = -1e30


def _merge(o_acc, lse_acc, o_b, lse_b):
    """The -inf-safe log-sum-exp merge of two normalized partials
    (o [bh, s, d] float32, lse [bh, s])."""
    lse_new = torch.logaddexp(lse_acc, lse_b)
    live = lse_new > _NEG_INF / 2
    c_old = torch.where(live, torch.exp(lse_acc - lse_new), 0.0)
    c_new = torch.where(live, torch.exp(lse_b - lse_new), 0.0)
    return o_acc * c_old[..., None] + o_b * c_new[..., None], lse_new


def _visible(causal: bool, step: int, coord: int) -> bool:
    """Whether the block held at `step` is visible to this rank's
    queries: all are without a mask; with one, the diagonal (step 0)
    and the earlier blocks (step <= coord)."""
    return not causal or step == 0 or step <= coord


class RingFlashAttention(torch.autograd.Function):
    """q, k, v [bh, s_local, d], sharded on s over `axis`."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, scale, causal):
        sp, c = mesh.size(axis), mesh.coord(axis)
        bh, s, d = q.shape
        o_acc = q.new_zeros((bh, s, v.shape[-1]), dtype=torch.float32)
        lse_acc = q.new_full((bh, s), _NEG_INF, dtype=torch.float32)
        k_blk, v_blk = k, v
        for step in range(sp):
            if _visible(causal, step, c):
                o_b, lse_b = fa.flash_fwd(q, k_blk, v_blk, scale,
                                          causal and step == 0)
                o_acc, lse_acc = _merge(o_acc, lse_acc, o_b.float(), lse_b)
            if step + 1 < sp:
                k_blk, v_blk = ring_shift([k_blk, v_blk], mesh, axis)
        out = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_acc)
        ctx.mesh, ctx.axis, ctx.scale, ctx.causal = mesh, axis, scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, scale, causal = ctx.mesh, ctx.axis, ctx.scale, ctx.causal
        sp, c = mesh.size(axis), mesh.coord(axis)
        dout = dout.contiguous()
        delta = fa.flash_delta(out, dout)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_blk, v_blk = k, v
        for step in range(sp):
            if _visible(causal, step, c):
                diag = causal and step == 0
                dq += fa.flash_bwd_dq(q, k_blk, v_blk, dout, lse, delta,
                                      scale, diag).float()
                dk_b, dv_b = fa.flash_bwd_dkv(q, k_blk, v_blk, dout, lse,
                                              delta, scale, diag)
                dk_blk += dk_b.float()
                dv_blk += dv_b.float()
            if step + 1 < sp:
                k_blk, v_blk = ring_shift([k_blk, v_blk], mesh, axis)
            dk_blk, dv_blk = ring_shift([dk_blk, dv_blk], mesh, axis)
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None, None)


class _Shift(torch.autograd.Function):
    """One ring step forward; its backward is one step back."""

    @staticmethod
    def forward(ctx, k, v, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(ring_shift([k, v], mesh, axis))

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = ring_shift([gk.contiguous(), gv.contiguous()], ctx.mesh,
                            ctx.axis, step=-1)
        return gk, gv, None, None


def _block_dense(q, k, v, scale, mask):
    """One (q block, kv block) partial in float32 (the reference's
    `_block_attend`): q [b, sq, h, d], k/v [b, sk, h, d] -> (o normalized
    [b, sq, h, d], lse [b, h, sq]); fully masked rows give lse -inf and
    o 0."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l_safe = torch.where(l > 0.0, l, torch.ones_like(l))
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_b = pv / l_safe.transpose(1, 2)[..., None]
    lse_b = torch.where(l > 0.0, m + torch.log(l_safe),
                        torch.full_like(l, _NEG_INF))
    return o_b, lse_b


def _ring_dense(qh, kh, vh, mesh, axis, scale, causal):
    """The dense ring on [b, s_local, h, d] (the reference's
    `_ring_attention_sharded`)."""
    sp, c = mesh.size(axis), mesh.coord(axis)
    b, s_local, h, d = qh.shape
    k_local = kh.shape[1]
    lse_acc = qh.new_full((b, h, s_local), _NEG_INF, dtype=torch.float32)
    o_acc = qh.new_zeros((b, s_local, h, vh.shape[-1]), dtype=torch.float32)
    k_blk, v_blk = kh, vh
    for step in range(sp):
        mask = None
        if causal:
            src = (c - step) % sp
            q_pos = c * s_local + torch.arange(s_local, device=qh.device)
            k_pos = src * k_local + torch.arange(k_local, device=qh.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        o_b, lse_b = _block_dense(qh, k_blk, v_blk, scale, mask)
        o, lse_acc = _merge(o_acc.transpose(1, 2), lse_acc,
                            o_b.transpose(1, 2), lse_b)
        o_acc = o.transpose(1, 2)
        if step + 1 < sp:
            k_blk, v_blk = _Shift.apply(k_blk, v_blk, mesh, axis)
    return o_acc.to(qh.dtype)


def use_flash_blocks(qh, kh, sp: int, causal: bool,
                     flash_min_seq: int) -> bool:
    """Whether the flash ring takes these per-shard [b, s, h, d] shapes:
    where the kernels can (the reference's `_use_flash_blocks`) and the
    global KV length reaches the flash crossover, as one card's
    attention decides."""
    b, sq, h, d = qh.shape
    return (d in fa.HEAD_DIMS and b * h <= fa.MAX_BH
            and qh.dtype in (torch.float32, torch.bfloat16)
            and kh.dtype == qh.dtype and kh.shape[-1] == d
            and not (causal and sq != kh.shape[1])
            and kh.shape[1] * sp >= flash_min_seq)


def _ring_flash(qh, kh, vh, mesh, axis, scale, causal):
    """The flash ring on [b, s_local, h, d] shards."""
    b, sq, h, d = qh.shape
    sk = kh.shape[1]

    def flat(t, s):
        return t.permute(0, 2, 1, 3).contiguous().view(b * h, s,
                                                       t.shape[-1])

    o = RingFlashAttention.apply(flat(qh, sq), flat(kh, sk), flat(vh, sk),
                                 mesh, axis, float(scale), bool(causal))
    return o.view(b, h, sq, -1).permute(0, 2, 1, 3)


def ring_attention(qh, kh, vh, mesh: DeviceMesh, axis: str, *,
                   scale: float, causal: bool = False,
                   flash_min_seq: int = 0) -> torch.Tensor:
    """Attention on local [b, s_local, h, d] shards of q, k and v whose
    sequence dim is sharded over `axis`; returns the local [b, s_local,
    h, d] output: the flash ring where `use_flash_blocks`, else the
    dense ring."""
    ring = (_ring_flash
            if use_flash_blocks(qh, kh, mesh.size(axis), causal,
                                flash_min_seq) else _ring_dense)
    return ring(qh, kh, vh, mesh, axis, scale, causal)
