"""Pipeline parallelism (flexflow_tpu/parallel/pipeline.py).

The mesh axis `pp` holds the stages.  Each rank owns a contiguous chunk
of L/S identical blocks, their weights stacked on a leading dim of size L
that is sharded over `pp` (`stacked_param_sharding`), and computes on
its data shard; where the reference's `shard_map` hands each device its
blocks and rows, the functions here take this rank's.

`gpipe` runs the lockstep schedule of M + S - 1 ticks: in every tick
every stage runs its chunk, stage 0 on microbatch t and the others on
what `ppermute` shifted in from the stage before.  The backward pipeline
is autograd's: `ppermute`'s backward shifts the other way, and since
every rank builds a graph of the same shape (fill and drain ticks
compute on zeros and are masked with `torch.where`, so a NaN there
cannot leak), the shifts of the backward pair up rank by rank.  The
last stage's outputs reach the whole pipe group through an all-reduce,
whose backward is again a sum over the group: with the executor's loss
convention (every rank seeds 1/world) that sum is the adjoint of the
reference's `psum` broadcast.

`one_f_one_b` interleaves each tick's forward with a backward, so a
stage holds at most 2S - 1 saved boundary activations instead of M.
Autograd cannot order that across microbatches, so the function takes
the grads itself: the reference's per-tick `jax.vjp` is
`torch.autograd.grad` on the stage's forward recomputed at the saved
activation.  It runs the fill and drain ticks' halves only where they
are valid: outside an autograd graph nothing has to pair up.

`make_pipelined_transformer_step` is the reference's demo: an encoder
block stack under either schedule with a mean-pooled linear head and
SGD.  Its attention runs through the flash kernels K1-K3 (`mha_flash`),
which compute the reference block's softmax(q k^T / sqrt(d)) v.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.flash_attention import mha_flash
from .collectives import (Layout, all_reduce, all_reduce_, local_slice,
                          ppermute, ring_shift)
from .machine import DeviceMesh

Params = Dict[str, torch.Tensor]


def _coord(mesh: Optional[DeviceMesh], axis: str) -> int:
    return mesh.coord(axis) if mesh is not None else 0


def _size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return mesh.axis_sizes.get(axis, 1) if mesh is not None else 1


def gpipe(stage_fn: Callable, stage_params: Params, x_mb: torch.Tensor, *,
          mesh: Optional[DeviceMesh], axis: str = "pp", num_stages: int,
          num_microbatches: int) -> torch.Tensor:
    """GPipe forward over this rank's pipe group, differentiable.

    stage_fn(stage_params, act) -> act: this rank's stage (shape
    preserved).  x_mb: [M, mb, ...] microbatches (read on stage 0; the
    other stages may hold anything of the same shape).  Returns the
    [M, mb, ...] outputs on every stage of the group."""
    S, M = num_stages, num_microbatches
    if S == 1:
        return torch.stack([stage_fn(stage_params, x) for x in x_mb])
    stage = _coord(mesh, axis)
    dev = x_mb.device
    # fills, not copies from the host: capturable (capture.py)
    first = torch.full((), stage == 0, device=dev)
    zero = torch.zeros_like(x_mb[0])
    buf, ys = zero, []
    for t in range(M + S - 1):
        x_t = x_mb[t] if t < M else zero
        y = stage_fn(stage_params, torch.where(first, x_t, buf))
        ys.append(y)
        if t < M + S - 2:  # the last tick's shift would feed nothing
            buf = ppermute(y, mesh, axis, 1)
    outs = torch.stack(ys[S - 1:])
    outs = torch.where(torch.full((), stage == S - 1, device=dev), outs,
                       torch.zeros_like(outs))
    return all_reduce(outs, mesh, axis)


def one_f_one_b(stage_fn: Callable, stage_params: Params,
                x_mb: torch.Tensor, last_fn: Callable, last_params: Params,
                targets_mb: torch.Tensor, *, mesh: Optional[DeviceMesh],
                axis: str = "pp", num_stages: int, num_microbatches: int):
    """The 1F1B schedule over this rank's pipe group; returns (mean
    loss, this stage's grads, the head's grads), the loss and the head's
    grads summed over the group (only the last stage computes them).

      stage_fn(stage_params, act) -> act          this rank's stage
      last_fn(last_params, act, target) -> loss   one microbatch's head

    Stage s runs microbatch f's forward at tick s + f and microbatch j's
    backward at tick 2(S-1) - s + j; the last stage's backward of j falls
    in the tick of its forward, where its head's cotangent is made.
    Saved boundary activations live in a ring of 2S - 1 slots.  Each
    tick shifts activations one stage on and cotangents one back, in one
    batch of point-to-point operations."""
    S, M = num_stages, num_microbatches
    R = 2 * S - 1
    stage = _coord(mesh, axis)
    is_last = stage == S - 1
    sp = {k: v.detach().requires_grad_(True)
          for k, v in stage_params.items()}
    heads = {k: v.detach().requires_grad_(True)
             for k, v in last_params.items()}
    g_stage = {k: torch.zeros_like(v) for k, v in sp.items()}
    g_last = {k: torch.zeros_like(v) for k, v in heads.items()}
    loss = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    zero = torch.zeros_like(x_mb[0])
    fwd_buf = bwd_buf = zero
    ring = [None] * R
    for t in range(M + 2 * S - 2):
        # forward half: microbatch f = t - s
        f = t - stage
        y, dy_here = zero, None
        if 0 <= f < M:
            a_in = x_mb[f] if stage == 0 else fwd_buf
            ring[t % R] = a_in
            with torch.no_grad():
                y = stage_fn(sp, a_in)
            if is_last:
                with torch.enable_grad():
                    act = y.detach().requires_grad_(True)
                    loss_f = last_fn(heads, act, targets_mb[f])
                    *d_last, dy_here = torch.autograd.grad(
                        loss_f, list(heads.values()) + [act],
                        torch.full_like(loss_f, 1.0 / M))
                loss = loss + loss_f.detach().float() / M
                for g, d in zip(g_last.values(), d_last):
                    g.add_(d)
        # backward half: microbatch j, its activation from the ring
        j = t - (2 * (S - 1) - stage)
        dx = zero
        if 0 <= j < M:
            with torch.enable_grad():
                a = ring[(stage + j) % R].detach().requires_grad_(True)
                out = stage_fn(sp, a)
                *d_stage, dx = torch.autograd.grad(
                    out, list(sp.values()) + [a],
                    dy_here if is_last else bwd_buf)
            for g, d in zip(g_stage.values(), d_stage):
                g.add_(d)
        if S > 1:
            fwd_buf, bwd_buf = ring_shift([y, dx], mesh, axis, step=[1, -1])
    if S > 1:
        group = mesh.group(axis)
        all_reduce_(loss, group)
        for g in g_last.values():
            all_reduce_(g, group)
    return loss, g_stage, g_last


def _split_microbatches(x: torch.Tensor, num_microbatches: int
                        ) -> torch.Tensor:
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible by num_microbatches {num_microbatches}")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def pipelined_apply(block_fn: Callable, stacked_params: Params,
                    x: torch.Tensor, *, mesh: Optional[DeviceMesh],
                    num_microbatches: int, pp_axis: str = "pp",
                    remat: bool = False) -> torch.Tensor:
    """A stack of identical blocks as this rank's part of a dp x pp
    pipelined computation, differentiable end to end.

    block_fn(params_i, act) -> act: one block.  stacked_params: this
    rank's chunk of the stacked weights, [L/S, ...] per leaf
    (`local_blocks` cuts it from the global stack).  x: this rank's data
    shard [batch, ...].  Returns the stack's output on x, on every stage.
    With no mesh the stack runs as one stage.  remat=True checkpoints
    each block: the backward then recomputes its internals and each
    in-flight microbatch keeps one boundary activation per block."""
    stage_fn = _make_stage_fn(block_fn, remat)
    y_mb = gpipe(stage_fn, stacked_params,
                 _split_microbatches(x, num_microbatches), mesh=mesh,
                 axis=pp_axis, num_stages=_size(mesh, pp_axis),
                 num_microbatches=num_microbatches)
    return y_mb.reshape((-1,) + tuple(y_mb.shape[2:]))


def _make_stage_fn(block_fn: Callable, remat: bool) -> Callable:
    """One stage: this rank's blocks in order (shared by both schedules
    so that their numerics cannot diverge); with remat each block runs
    under torch.utils.checkpoint (non-reentrant).  No block draws from a
    global generator (the executor's seed a generator of their own per
    block, which the recompute seeds again), so the checkpoint keeps no
    RNG state: reading the card's generator is refused inside a CUDA
    graph capture."""

    def stage_fn(local_params: Params, act: torch.Tensor) -> torch.Tensor:
        rows = {k: v.unbind(0) for k, v in local_params.items()}
        for i in range(len(next(iter(rows.values())))):
            p = {k: r[i] for k, r in rows.items()}
            act = (checkpoint(block_fn, p, act, use_reentrant=False,
                              preserve_rng_state=False)
                   if remat else block_fn(p, act))
        return act

    return stage_fn


def stacked_param_sharding(ndim: int, pp_axis: str = "pp") -> Layout:
    """The Layout of a [L, ...] stacked block weight: dim 0 sharded over
    the pipe axis."""
    return Layout(((pp_axis,),) + ((),) * (ndim - 1))


def local_blocks(stacked: Params, mesh: Optional[DeviceMesh],
                 pp_axis: str = "pp") -> Params:
    """This rank's chunk of global [L, ...] stacked weights."""
    pp = _size(mesh, pp_axis)
    layers = next(iter(stacked.values())).shape[0]
    if layers % pp:
        raise ValueError(f"{layers} blocks not divisible by pp={pp}")
    if mesh is None:
        return dict(stacked)
    return {k: local_slice(v, stacked_param_sharding(v.ndim, pp_axis),
                           mesh).contiguous() for k, v in stacked.items()}


# ----------------------------------------------------------------------
# The reference's demo model: a pipelined transformer-encoder train step
# ----------------------------------------------------------------------

def _init_block_params(gen: torch.Generator, layers: int, hidden: int,
                       ffn: int, device) -> Params:
    scale = 1.0 / math.sqrt(hidden)
    shapes = {"w_qkv": (layers, hidden, 3 * hidden),
              "w_o": (layers, hidden, hidden),
              "w_in": (layers, hidden, ffn),
              "w_out": (layers, ffn, hidden)}
    return {k: torch.randn(s, generator=gen, device=device) * scale
            for k, s in shapes.items()}


def _encoder_block(p: Params, x: torch.Tensor, *, num_heads: int
                   ) -> torch.Tensor:
    b, s, h = x.shape
    hd = h // num_heads
    q, k, v = (t.reshape(b, s, num_heads, hd)
               for t in (x @ p["w_qkv"]).split(h, dim=-1))
    o = mha_flash(q, k, v, 1.0 / math.sqrt(hd), False).reshape(b, s, h)
    x = _ln(x + o @ p["w_o"])
    y = torch.relu(x @ p["w_in"]) @ p["w_out"]
    return _ln(x + y)


def _ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps)


def _head_loss(head: Params, act: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    logits = act.mean(dim=1) @ head["head"]
    return F.cross_entropy(logits, target.long())


def make_pipelined_transformer_step(
        mesh: Optional[DeviceMesh], *, layers: int, hidden: int, ffn: int,
        num_heads: int, num_classes: int, num_microbatches: int,
        lr: float = 0.01, pp_axis: str = "pp", dp_axis: str = "data",
        schedule: str = "gpipe", remat: bool = False, device=None):
    """(init_fn, step_fn): an SGD train step (forward, loss, backward,
    update) of a block-stacked encoder pipelined over `pp_axis` and
    batch-sharded over `dp_axis`, on this rank.

    init_fn(seed) -> params {"blocks": {name: [L/S, ...]}, "head": {"head":
    [hidden, classes]}}, this rank's part of weights drawn from `seed`
    (`local_params` cuts given global weights the same way).
    step_fn(params, x, y) -> (params, loss): x [b/dp, seq, hidden] and y
    [b/dp] are this rank's rows; params are updated in place; the loss is
    the global batch's mean.  schedule "gpipe" differentiates through
    `pipelined_apply` (O(M) saved boundaries; remat=True keeps one per
    block) and "1f1b" takes the grads in `one_f_one_b` (O(S)); both
    compute the same update.  With no mesh the step runs on `device`
    ("cuda" unless given) as one stage."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    pp, dp = _size(mesh, pp_axis), _size(mesh, dp_axis)
    if layers % pp:
        raise ValueError(f"{layers} blocks not divisible by pp={pp}")
    dev = torch.device(mesh.device if mesh is not None else device or "cuda")
    world = pp * dp
    M = num_microbatches

    def init_fn(seed: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        blocks = _init_block_params(gen, layers, hidden, ffn, dev)
        head = torch.randn((hidden, num_classes), generator=gen,
                           device=dev) / math.sqrt(hidden)
        return local_params({"blocks": blocks, "head": {"head": head}},
                            mesh, pp_axis)

    def block(p, x):
        return _encoder_block(p, x, num_heads=num_heads)

    def sum_over(t, axis):
        if _size(mesh, axis) > 1:
            all_reduce_(t, mesh.group(axis))
        return t

    def update(params, g_blocks, g_head):
        with torch.no_grad():
            for k, g in g_blocks.items():
                params["blocks"][k].sub_(lr * g)
            for k, g in g_head.items():
                params["head"][k].sub_(lr * g)
        return params

    def gpipe_step(params, x, y):
        blocks = {k: v.detach().requires_grad_(True)
                  for k, v in params["blocks"].items()}
        head = {k: v.detach().requires_grad_(True)
                for k, v in params["head"].items()}
        with torch.enable_grad():
            h = pipelined_apply(block, blocks, x, mesh=mesh,
                                num_microbatches=M, pp_axis=pp_axis,
                                remat=remat)
            loss = _head_loss(head, h, y)
            # the executor's convention: each rank seeds 1/world, the
            # pipe group's all-reduce sums the cotangents of the region
            grads = torch.autograd.grad(
                loss / world, list(blocks.values()) + list(head.values()))
        g_blocks = dict(zip(blocks, grads[:len(blocks)]))
        g_head = dict(zip(head, grads[len(blocks):]))
        for g in g_blocks.values():
            sum_over(g, dp_axis)
        for g in g_head.values():
            sum_over(sum_over(g, dp_axis), pp_axis)
        loss = sum_over(loss.detach().clone(), dp_axis) / dp
        return update(params, g_blocks, g_head), loss

    stage_fn = _make_stage_fn(block, remat)

    def ofob_step(params, x, y):
        loss, g_blocks, g_head = one_f_one_b(
            stage_fn, params["blocks"], _split_microbatches(x, M),
            _head_loss, params["head"], _split_microbatches(y, M),
            mesh=mesh, axis=pp_axis, num_stages=pp, num_microbatches=M)
        # dp: the mean over the data axis
        for t in [loss] + list(g_blocks.values()) + list(g_head.values()):
            sum_over(t, dp_axis).div_(dp)
        return update(params, g_blocks, g_head), loss

    return init_fn, (gpipe_step if schedule == "gpipe" else ofob_step)


def local_params(params, mesh: Optional[DeviceMesh], pp_axis: str = "pp"):
    """This rank's part of the demo's global params: its chunk of every
    stacked block weight, the head whole."""
    return {"blocks": local_blocks(params["blocks"], mesh, pp_axis),
            "head": dict(params["head"])}
