"""How each op computes on its ranks' shards: the per-op half of what
XLA's SPMD partitioner does for the reference.

For every op of a strategy-applied PCG, `plan_op` picks the layouts
(parallel/collectives.py) in which the op's inputs and weights are
handed to its forward on each rank, and the layout of what that forward
returns.  The executor redistributes the inputs and weights into those
layouts, runs the op on the local tensors and redistributes each result
to the layout of its output's MachineView: that last step is the
counterpart of the reference's `with_sharding_constraint`.

The rules:
  * a dim of the output that the op computes element by element from
    dims of its inputs (the batch of a convolution, every dim of an
    element-wise op, all but the normalized axes of a LayerNorm, ...)
    keeps the output view's sharding, and the inputs' matching dims take
    it too; every other dim is computed whole, and weights whole;
  * Linear is column parallel on the axes that shard its kernel's out
    channels in the view, and row parallel (a partial sum, then the
    bias once and the activation after the sum) on the axes that shard
    its input's channels;
  * MultiHeadAttention runs its local heads on the axes that shard the
    heads of wq (wk, wv and wo are brought to them; a partial sum over
    heads, the output bias once), and ring attention
    (parallel/ring_attention.py) on the one axis that shards its
    input's sequence (two raise, as in the reference);
  * a dim may lie on several axes (a factored per-op view): a plan
    keeps them in the view's order, major first;
  * Mean and Reduce over a sharded dim give a partial sum (the local
    mean scaled by 1/n);
  * BatchNorm's statistics are summed over the axes that shard its
    batch and spatial dims before the scale and shift, so every rank
    normalizes with the global batch's statistics;
  * a Reshape keeps the sharding of dim 0 when the axes divide both
    leading dims (each chunk is then the same run of the row-major
    elements on either side);
  * the MoE ops (parallel/expert_parallel.py): TopK shards its batch
    dims; GroupBy fills its view's chunk of the experts with the rows of
    every token shard, at their global slots; ExpertsDense is
    element-wise in the expert dim (its kernel and bias sharded there,
    its channels whole); Aggregate and AggregateSpec combine the rows of
    this rank's tokens, a partial sum over the expert axes that do not
    shard the tokens, and take the balance loss over the global batch;
  * a parallel op's forward is the identity: redistributing its input's
    layout to its output's view is the collective its name says
    (Repartition a slice, Combine an all-gather, Replicate the identity
    with a summed backward, Reduction a sum, AllToAll an all-to-all);
  * any other op runs whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from ..fftype import ActiMode, OperatorType
from ..ops.dense import apply_activation
from ..ops.experts import ExpertsDense
from . import expert_parallel as ep
from .collectives import Layout, all_reduce
from .machine import DeviceMesh, view_to_spec
from .ring_attention import ring_attention

OT = OperatorType

_ELEMENTWISE = {OT.ELEMENT_UNARY, OT.DROPOUT, OT.CAST, OT.NOOP}
_BATCH_ONLY = {OT.CONV2D, OT.POOL2D, OT.FLAT}


@dataclasses.dataclass
class OpPlan:
    ins: List[Layout]
    weights: List[Layout]
    outs: List[Layout]
    # replaces op.forward(ins, ws, training=, generator=) when set
    fn: Optional[Callable] = None
    # extra keyword arguments of op.forward
    kwargs: dict = dataclasses.field(default_factory=dict)
    # applied to output 0 after it reached its view's layout
    post: Optional[Callable] = None


def layout_of(pt) -> Layout:
    """The layout of a tensor's MachineView."""
    return Layout(view_to_spec(pt))


def _free_dims(op) -> Optional[List[List[Optional[int]]]]:
    """Per output dim, per input, the input dim it is computed from
    element by element (None: the input broadcasts there, or the output
    dim is not element-wise: then every input maps None); None for an
    op with no such dims."""
    t = op.op_type
    out = op.outputs[0].shape.logical_shape
    ins = [i.shape.logical_shape for i in op.inputs]
    r = len(out)
    if t in _ELEMENTWISE:
        return [[d] for d in range(r)]
    if t == OT.ELEMENT_BINARY:
        rows = []
        for d in range(r):
            row = []
            for s in ins:
                di = d - (r - len(s))
                row.append(di if di >= 0 and s[di] == out[d] else None)
            rows.append(row)
        return rows
    if t == OT.LAYER_NORM:
        normed = {a % r for a in op.params.axes}
        return [[None if d in normed else d] for d in range(r)]
    if t == OT.SOFTMAX:
        ax = op.params.axis % r
        return [[None if d == ax else d] for d in range(r)]
    if t in _BATCH_ONLY or t == OT.BATCH_NORM:
        return [[0 if d == 0 else None] for d in range(r)]
    if t == OT.LINEAR:
        return [[d if d < r - 1 else None] for d in range(r)]
    if t == OT.EMBEDDING:
        return [[d if d < r - 1 else None] for d in range(r)]
    if t == OT.TRANSPOSE:
        return [[op.params.perm[d]] for d in range(r)]
    if t == OT.CONCAT:
        ax = op.params.axis % r
        return [[None if d == ax else d for _ in ins] for d in range(r)]
    if t == OT.BATCH_MATMUL:
        return [[d if d < r - 2 else None for _ in ins] for d in range(r)]
    if t in (OT.RESHAPE, OT.MEAN, OT.REDUCE_SUM) and ins[0][:1] == out[:1]:
        if t == OT.RESHAPE or 0 not in op.params.axes:
            return [[0 if d == 0 else None] for d in range(r)]
    return None


def _generic(op, out_view: Layout, in_views: List[Layout]) -> OpPlan:
    """Element-wise dims keep the view's sharding; the rest run whole."""
    rows = _free_dims(op)
    r = len(out_view.spec)
    out_spec = [()] * r
    in_specs = [[()] * len(v.spec) for v in in_views]
    if rows is not None and len(op.outputs) == 1:
        for d in range(r):
            axes = out_view.spec[d]
            if not axes or (all(m is None for m in rows[d])
                            and len(op.inputs) > 0):
                continue
            out_spec[d] = axes
            for i, m in enumerate(rows[d]):
                if m is not None:
                    in_specs[i][m] = axes
    return OpPlan(
        ins=[Layout(tuple(s)) for s in in_specs],
        weights=[Layout.replicated(w.shape.logical_rank)
                 for w in op.weights],
        outs=[Layout(tuple(out_spec))] + [
            Layout.replicated(o.shape.logical_rank) for o in op.outputs[1:]])


def _plan_linear(op, mesh, out_view, in_views, w_views) -> OpPlan:
    plan = _generic(op, out_view, in_views)
    kview = w_views[0]
    x_last = in_views[0].spec[-1]
    col = [a for a in kview.spec[1] if a in out_view.spec[-1]]
    row = [a for a in x_last
           if a not in kview.spec[1] and a not in out_view.spec[-1]
           and a not in plan.ins[0].axes()]
    r = len(out_view.spec)
    out_spec = list(plan.outs[0].spec)
    x_spec = list(plan.ins[0].spec)
    k_spec = [(), ()]
    b_spec = [()]
    if col:
        axes = tuple(a for a in out_view.spec[-1] if a in col)
        out_spec[r - 1] = axes
        k_spec[1] = axes
        b_spec[0] = axes
    partial = frozenset()
    if row:
        axes = tuple(row)
        x_spec[-1] = axes
        k_spec[0] = axes
        partial = frozenset(row)
    plan.ins = [Layout(tuple(x_spec))]
    plan.outs = [Layout(tuple(out_spec), partial)]
    ws = [Layout(tuple(k_spec))]
    p = op.params
    if p.use_bias:
        ws.append(Layout(tuple(b_spec), partial))
    plan.weights = ws
    if partial and p.activation != ActiMode.NONE:
        act = p.activation

        def fn(ins, wts, training=False, generator=None):
            y = ins[0] @ wts[0]
            return [y + wts[1] if len(wts) > 1 else y]

        plan.fn = fn
        plan.post = lambda y: apply_activation(y, act)
    return plan


def _plan_attention(op, mesh, out_view, in_views, w_views) -> OpPlan:
    """Local heads on the axes sharding wq's heads; ring attention on the
    axis sharding the query's sequence; batch as the output view."""
    heads = tuple(w_views[0].spec[1])
    q_view = in_views[0]
    seq = tuple(a for a in q_view.spec[1] if a not in heads)
    if len(seq) > 1:
        # the reference's ring asserts one sequence axis too
        # (flexflow_tpu/ops/attention.py:591)
        raise NotImplementedError(
            f"{op.name}: ring attention over more than one mesh axis "
            f"({seq}), a factored view neither package runs: ROADMAP §1 "
            "item 1")
    batch = tuple(a for a in out_view.spec[0]
                  if a not in heads and a not in seq)
    in_l = Layout((batch, seq, ()))
    partial = frozenset(heads)
    ws = []
    for spec, w in zip(op.weight_specs, op.weights):
        rank = w.shape.logical_rank
        s = [()] * rank
        name = spec.name
        if heads and name in ("wq", "wk", "wv", "bias_k", "bias_v"):
            s[1] = heads
        elif heads and name in ("wo", "bq", "bk", "bv"):
            s[0] = heads
        ws.append(Layout(tuple(s), partial if name == "bo" else frozenset()))
    plan = OpPlan(ins=[in_l, in_l, in_l], weights=ws,
                  outs=[Layout((batch, seq, ()), partial)])
    if seq:
        axis = seq[0]

        def seq_ring(qh, kh, vh, scale, causal, flash_min_seq):
            return ring_attention(qh, kh, vh, mesh, axis, scale=scale,
                                  causal=causal,
                                  flash_min_seq=flash_min_seq)

        plan.kwargs["seq_ring"] = seq_ring
    return plan


def _plan_reduce(op, mesh, out_view, in_views) -> OpPlan:
    """Sharded reduced dims give a partial sum (a mean scaled by 1/n)."""
    p = op.params
    x_view = in_views[0]
    rank = len(x_view.spec)
    axes = sorted(a % rank for a in p.axes)
    reduced = [a for d in axes for a in x_view.spec[d]]
    kept = [d for d in range(rank) if d not in axes]
    x_spec = [()] * rank
    out_spec = [()] * len(out_view.spec)
    for j, d in enumerate(range(rank) if p.keepdims else kept):
        if d in axes:
            continue
        take = tuple(a for a in out_view.spec[j] if a not in reduced)
        x_spec[d] = take
        out_spec[j] = take
    for d in axes:
        x_spec[d] = x_view.spec[d]
    n = 1
    for a in reduced:
        n *= mesh.size(a)
    plan = OpPlan(ins=[Layout(tuple(x_spec))], weights=[],
                  outs=[Layout(tuple(out_spec), frozenset(reduced))])
    if reduced and op.params.op == "mean":
        def fn(ins, wts, training=False, generator=None):
            return [x / n for x in op.forward(ins, wts, training=training,
                                              generator=generator)]

        plan.fn = fn
    return plan


def _plan_batch_norm(op, mesh, out_view, in_views) -> OpPlan:
    """Batch and spatial shards; statistics summed over their axes."""
    x_view = in_views[0]
    spec = [tuple(a for a in x_view.spec[d]) if d != 1 else ()
            for d in range(4)]
    spec[0] = tuple(a for a in out_view.spec[0])
    axes = [a for d in (0, 2, 3) for a in spec[d]]
    n = 1
    for a in axes:
        n *= mesh.size(a)
    plan = OpPlan(ins=[Layout(tuple(spec))],
                  weights=[Layout.replicated(1)] * 4,
                  outs=[Layout(tuple(spec))])
    if axes:
        def stats_reduce(mean, meansq):
            both = torch.stack([mean, meansq])
            for a in axes:
                both = all_reduce(both, mesh, a)
            both = both / n
            return both[0], both[1]

        plan.kwargs["stats_reduce"] = stats_reduce
    return plan


def _size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(a)
    return n


def _rows(axes, rank: int, partial=frozenset()) -> Layout:
    """Dim 0 sharded over `axes`, the rest whole."""
    return Layout((tuple(axes),) + ((),) * (rank - 1), frozenset(partial))


def _plan_reshape(op, mesh, out_view, in_views) -> OpPlan:
    src = op.inputs[0].shape.logical_shape
    dst = op.outputs[0].shape.logical_shape
    axes = out_view.spec[0]
    n = _size(mesh, axes)
    if not axes or src[0] % n or dst[0] % n:
        return _generic(op, out_view, in_views)
    shape = (-1,) + tuple(dst[1:])

    def fn(ins, wts, training=False, generator=None):
        return [torch.reshape(ins[0], shape)]

    return OpPlan(ins=[_rows(axes, len(src))], weights=[],
                  outs=[_rows(axes, len(dst))], fn=fn)


def _token_axis(mesh, axes) -> Optional[str]:
    """The one axis along which a MoE op takes its tokens sharded: the
    first of `axes` (the rest are gathered)."""
    return next((a for a in axes[:1] if mesh.size(a) > 1), None)


def _plan_topk(op, mesh, out_view, in_views) -> OpPlan:
    lay = Layout(tuple(out_view.spec[:-1]) + ((),))
    return OpPlan(ins=[lay], weights=[], outs=[lay, lay])


def _plan_group_by(op, mesh, out_view, in_views) -> OpPlan:
    t = _token_axis(mesh, in_views[0].spec[0])
    experts = tuple(out_view.spec[0])
    cap = op.outputs[0].shape.logical_shape[1]
    tok = _rows((t,) if t else (), 2)

    def fn(ins, wts, training=False, generator=None):
        return [ep.group_by(ins[0], ins[1], op.params.n, cap, mesh, t,
                            experts)]

    return OpPlan(ins=[tok, tok], weights=[], outs=[_rows(experts, 3)],
                  fn=fn)


def _plan_experts_dense(op, mesh, out_view) -> OpPlan:
    experts = out_view.spec[0]
    ws = [_rows(experts, 3)] + ([_rows(experts, 2)]
                                if op.params.use_bias else [])
    return OpPlan(ins=[_rows(experts, 3)], weights=ws,
                  outs=[_rows(experts, 3)])


def _plan_aggregate(op, mesh, out_view, in_views) -> OpPlan:
    t = _token_axis(mesh, out_view.spec[0])
    experts = tuple(in_views[3].spec[0])
    tok = _rows((t,) if t else (), 2)
    partial = {a for a in experts if a != t and mesh.size(a) > 1}
    batch = op.inputs[1].shape.logical_shape[0]
    n = op.params.n
    plan = OpPlan(ins=[tok, tok, tok, _rows(experts, 3)], weights=[],
                  outs=[_rows((t,) if t else (), 2, partial)])
    plan.kwargs["combine"] = lambda out, assign: ep.combine(
        out, assign, n, mesh, t, experts)
    plan.kwargs["balance_reduce"] = ep.balance_reduce(mesh, t, batch)
    return plan


def plan_op(op, mesh: DeviceMesh, in_views: List[Layout]) -> OpPlan:
    """The OpPlan of `op`, given the layouts its inputs arrive in."""
    out_view = layout_of(op.outputs[0])
    w_views = [layout_of(w) for w in op.weights]
    t = op.op_type
    if op.is_parallel_op():
        return OpPlan(ins=list(in_views), weights=[],
                      outs=[in_views[0]])
    # its op type is LINEAR, its kernel [n, d, out]
    if isinstance(op, ExpertsDense):
        return _plan_experts_dense(op, mesh, out_view)
    if t == OT.TOPK:
        return _plan_topk(op, mesh, out_view, in_views)
    if t == OT.GROUP_BY:
        return _plan_group_by(op, mesh, out_view, in_views)
    if t in (OT.AGGREGATE, OT.AGGREGATE_SPEC):
        return _plan_aggregate(op, mesh, out_view, in_views)
    if t == OT.RESHAPE:
        return _plan_reshape(op, mesh, out_view, in_views)
    if t == OT.LINEAR:
        return _plan_linear(op, mesh, out_view, in_views, w_views)
    if t == OT.MULTIHEAD_ATTENTION and not getattr(op, "_decode_max_seq", 0):
        return _plan_attention(op, mesh, out_view, in_views, w_views)
    if t in (OT.MEAN, OT.REDUCE_SUM):
        return _plan_reduce(op, mesh, out_view, in_views)
    if t == OT.BATCH_NORM:
        return _plan_batch_norm(op, mesh, out_view, in_views)
    return _generic(op, out_view, in_views)
