"""Graph executor of the PyTorch port (flexflow_tpu/executor.py).

Runs the PCG on one device under the trivial strategy: `init_weights`
builds the weight and state dictionaries ({op name: {weight name:
tensor}}), and `run_forward` interprets the graph op by op, eagerly.
The reference's flat path is kept: floating inputs and weights are cast
to the compute dtype (`to_compute`), decode caches live in the compute
dtype, and the sink output is cast to float32.  State entries (the
paged KV pools, BatchNorm's running statistics) are updated in place
and outside autograd, so the returned state holds the same tensors it
was given and no step's graph stays alive through them.

Two plans are made once, at construction.  The layout pass
(pcg/layout.py) picks the 4-D edges that are channels_last, and the
executor converts each op's inputs to what the op wants.  The
BatchNorm plan (`plan_bn_applies`) is how the port gets the fusion that
XLA gives the reference: a BatchNorm whose only consumer is an add
(as its first operand) whose only consumer is a ReLU runs as one P1
launch with the add's other operand as residual; a BatchNorm whose
only consumer is a ReLU runs as one with the ReLU; every other
BatchNorm applies through P1 with its own `relu`.  No tensor that is
the sink or has a second consumer is fused away.

`build_step` and `build_eval_step` are the training surface.  Autograd
takes the place of `jax.value_and_grad`: the forward runs with
training=True, `torch.autograd.grad` differentiates the loss over the
trainable weights, and the optimizer writes weights and slots in place
under torch.no_grad(), where the reference's jitted step donated them.
Two rules of the reference's step serve MoE: every op's auxiliary loss
(`_last_aux`, Aggregate's load balance) is collected by `run_forward`
and added to the training loss, and under AggregateSpec, whose output
holds k predictions per sample, each label is repeated k times,
sample-major (`label_replication`), in training and in eval.
Remat (`remat`, `remat_segments`: the reference's `_build_remat_plan`)
splits the graph at single-tensor cuts (pcg/segments.py) and runs each
selected pure segment under `torch.utils.checkpoint` (non-reentrant), so
that its activations are recomputed in the backward; a segment with an
input op, op state (BatchNorm's running statistics, which a recompute
would update twice) or a random draw (Dropout: the executor's
torch.Generator is not restored by the checkpoint) runs inline.

Given a DeviceMesh (`mesh`), the executor runs the strategy's sharded
step on this rank (the reference's SPMD step, without a partitioner):
each op runs on its local shards as parallel/spmd.py plans it, and each
output is redistributed to its MachineView's layout, the counterpart of
the reference's `with_sharding_constraint`.  Every rank draws the same
global weights and keeps its shard.  The loss is taken over the global
batch: each rank's mean over its rows is scaled so that the ranks' sum
is the global mean, and the backward starts from 1/world on every rank,
which with the adjoint collectives gives each weight's exact grad once
its partial sums are added over the axes that replicate it.  The ZeRO
ladder (parallel/zero.py) shards the update over `wus_axis`: at stage 2
the backward runs through `Tensor.backward`, and a hook on each leaf
hands its grad to `ScatterBuckets`, which reduce-scatters it by bucket
while the backward goes on; at stage 3, on the flat path (no remat
plan), the gather of the next op's scattered weights is issued before
each op runs (`_z3_prefetch`, the reference's), into a per-step cache
that the use empties: at most this op's and the next one's gathers are
held, as the reference's double buffer holds them.

On the two-level mesh of a multi-slice run (topology/hierarchy.py: a
leading "slice" axis and `hier_axis`, the placement axis's intra-slice
remainder), the grads of the weights replicated over both are reduced
in the hierarchical form, as the reference's `hier_update` has XLA
lower them: a reduce-scatter over `hier_axis` (inside each slice), an
all-reduce of the shard over "slice" (between slices) and an all-gather
over `hier_axis`.  With the ZeRO ladder on, `wus_axis` is that
remainder and `hier_axis` is None: the sharded update reduce-scatters
over it first and all-reduces only its shard between slices.

On a CUDA device `build_step` returns the step captured as one CUDA
graph (capture.py), unless `capture_blockers` names something in the
plan that keeps it eager; `capture_status` says which, and why.

While `op_scopes` is set (FFModel.fit sets it for the steps of a
`profile_steps` window), every op's launches run under
`torch.profiler.record_function(op.name)`, the counterpart of the
reference's `jax.named_scope(op.name)`, so that the profiler's trace
attributes each kernel to its PCG op.  A captured step replays in the
window too: its kernels get their ops from the map that its warm-up
recorded under `map_kernels` (capture.py, obs/attribution.py).  Unset,
no per-op object is made.  `check_step_health` reads a step's loss
under the `nan_policy` it is given and, given a watchdog, under its
deadline.

Under a pipeline (`pipeline_plan`, parallel/pipeline_plan.py) the block
ops leave the per-op schedule: their weights are stacked per template
weight over the L blocks under "__pipeline__", keyed "<j>.<name>" and
sharded over the pipe axis, and the region runs the template block's
ops once per block through `pipelined_apply` (parallel/pipeline.py) on
the region input's data shard.  The stacked leaves' grads are summed
over every axis but the pipe axis; the prefix's and suffix's weights,
replicated over it, over it too.  Under expert parallelism
(parallel/expert_parallel.py) every rank computes Aggregate's balance
loss over the global batch, so the 1/world seed counts it once.  Each
op's collectives are counted under its class's name
(`collectives.traffic`), the update's under "update".  A view may shard
one dim over several mesh axes (a factored per-op view): the layouts
carry a tuple of axes per dim, and each collective runs over one axis
at a time.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .capture import CAPTURE_OFF, CapturedStep, capture_blockers
from .fftype import OpBinary, OperatorType, OpUnary
from .parallel.collectives import (Layout, all_gather, all_reduce_,
                                   gather_global, local_slice,
                                   prefetch_gather, redistribute,
                                   reduce_scatter, traffic_scope)
from .parallel.pipeline import pipelined_apply, stacked_param_sharding
from .parallel.spmd import layout_of, plan_op
from .parallel.zero import ScatterBuckets, shard_update_spec
from .pcg.graph import Graph
from .pcg.layout import NHWC, PASS, assign_layouts
from .topology.hierarchy import SLICE_AXIS

Weights = Dict[str, Dict[str, torch.Tensor]]

#: the weight group of the pipeline's stacked block weights
PIPELINE = "__pipeline__"


class NonFiniteLossError(RuntimeError):
    """A step's loss is NaN or infinite (check_step_health); the
    reference's supervisor maps it to its nan_policy (the port's waits
    for ROADMAP §1 item 7.7)."""

    def __init__(self, loss: float, step: Optional[int] = None):
        self.loss = loss
        self.step = step
        where = f" at step {step}" if step is not None else ""
        super().__init__(f"non-finite loss {loss!r}{where}")


def check_step_health(metrics: Dict[str, Any], step: Optional[int] = None,
                      nan_policy: str = "raise", watchdog=None) -> None:
    """NonFiniteLossError when the step's loss (metrics["loss"], a tensor
    on the device or a host number) is NaN or infinite.  Reading it
    waits for the device, so under nan_policy "off" (or None) nothing is
    read.  `watchdog` (resilience.watchdog.StepWatchdog) bounds that
    read: a step whose device work does not finish raises
    HungStepTimeout here instead of blocking the host."""
    if nan_policy in (None, "off"):
        return
    loss = metrics.get("loss") if isinstance(metrics, dict) else None
    if loss is None:
        return

    def read():
        return float(loss.item() if torch.is_tensor(loss) else loss)

    val = watchdog.sync(read, step=step) if watchdog is not None else read()
    if not np.isfinite(val):
        raise NonFiniteLossError(val, step=step)


@dataclasses.dataclass(frozen=True)
class PipelineRegion:
    """The schedule's entry for the pipelined block stack: it runs at
    the place of its first block op (`guid`)."""

    guid: int


@dataclasses.dataclass(frozen=True)
class BNApplyPlan:
    """How one BatchNorm's apply runs: P1 adds the tensor `residual`
    (a guid, or None) and applies the ReLU when `relu`; its output
    stands for tensor `out`; the ops in `absorbed` (the add, the ReLU)
    do not run on their own; it runs at op `at`'s place in the
    topological order (the last op of the chain, after both operands
    of the add)."""

    residual: Optional[int]
    relu: bool
    out: int
    absorbed: Tuple[int, ...]
    at: int


def _is_relu(op) -> bool:
    return (op.op_type == OperatorType.ELEMENT_UNARY
            and op.params.op == OpUnary.RELU)


def plan_bn_applies(graph: Graph,
                    t_layout: Dict[int, str]) -> Dict[int, BNApplyPlan]:
    """{BatchNorm op guid: its BNApplyPlan} (see the module's note)."""
    consumers = collections.defaultdict(list)
    for op in graph.ops:
        for t in op.inputs:
            consumers[t.guid].append(op)
    sink_outs = {t.guid for t in graph.sink_op().outputs}

    def only_consumer(t):
        ops = consumers[t.guid]
        if t.guid in sink_outs or len(ops) != 1:
            return None
        return ops[0]

    plans = {}
    for op in graph.topo_order():
        if op.op_type != OperatorType.BATCH_NORM:
            continue
        out = op.outputs[0]
        plan = BNApplyPlan(None, op.params.relu, out.guid, (), op.guid)
        nxt = only_consumer(out)
        if nxt is not None and not op.params.relu:
            if _is_relu(nxt):
                plan = BNApplyPlan(None, True, nxt.outputs[0].guid,
                                   (nxt.guid,), nxt.guid)
            elif (nxt.op_type == OperatorType.ELEMENT_BINARY
                  and nxt.params.op == OpBinary.ADD
                  and nxt.inputs[0] is out and nxt.inputs[1] is not out
                  and nxt.inputs[1].shape.logical_shape
                  == out.shape.logical_shape
                  and t_layout.get(nxt.inputs[1].guid) == NHWC):
                relu = only_consumer(nxt.outputs[0])
                if relu is not None and _is_relu(relu):
                    plan = BNApplyPlan(nxt.inputs[1].guid, True,
                                       relu.outputs[0].guid,
                                       (nxt.guid, relu.guid), relu.guid)
        plans[op.guid] = plan
    return plans


class GraphExecutor:
    def __init__(self, graph: Graph, device: torch.device,
                 compute_dtype: Optional[torch.dtype] = None,
                 loss=None, metrics=None, optimizer=None,
                 label_replication: int = 1, mesh=None,
                 zero_stage: int = 0, wus_axis: Optional[str] = "data",
                 remat: bool = False,
                 remat_segments: Optional[List[int]] = None,
                 pipeline_plan=None, hier_axis: Optional[str] = None):
        self.graph = graph
        self.label_replication = label_replication
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.loss = loss
        self.metrics = metrics
        self.optimizer = optimizer
        self.order = graph.topo_order()
        self.sink = graph.sink_op()
        self.t_layout, self.op_layout = assign_layouts(graph)
        self.bn_plans = plan_bn_applies(graph, self.t_layout)
        self.mesh = mesh
        self.remat = bool(remat)
        # the pipelined block stack: block op guid -> (block, template
        # op index); those ops run only through the region
        self.pipeline_plan = pipeline_plan
        self._block_pos = {} if pipeline_plan is None else {
            op.guid: (l, j) for l, blk in enumerate(pipeline_plan.blocks)
            for j, op in enumerate(blk)}
        self._block_guids = set(self._block_pos)
        # the ZeRO ladder is active only on a mesh axis of size > 1
        self.wus_axis = (wus_axis if mesh is not None and zero_stage
                         and mesh.axis_sizes.get(wus_axis, 1) > 1 else None)
        self.zero_stage = int(zero_stage) if self.wus_axis else 0
        # the intra-slice remainder the hierarchical grad reduction
        # scatters over: on a mesh with a slice axis, with the ladder
        # off (on, its reduce-scatter over the remainder already is the
        # hierarchical form)
        self.hier_axis = (hier_axis if mesh is not None and self.wus_axis
                          is None and mesh.axis_sizes.get(SLICE_AXIS, 1) > 1
                          and mesh.axis_sizes.get(hier_axis, 1) > 1
                          else None)
        # the ladder's reduce-scatter runs before the sum between slices
        self._slice_after_scatter = (
            self.wus_axis is not None and self.wus_axis != SLICE_AXIS
            and mesh.axis_sizes.get(SLICE_AXIS, 1) > 1)
        plan = (self._build_remat_plan(remat_segments)
                if remat or remat_segments is not None else None)
        if plan is not None and not any(pure for *_, pure in plan):
            plan = None  # nothing checkpoints: the flat interpreter
        self._remat_plan = plan
        self.schedule = self._schedule()
        # stage 3's scattered weights: key -> the strategy layout the
        # forward gathers them to
        self._z3: Dict[Tuple[str, str], Layout] = {}
        if mesh is not None:
            self._plan_sharding()
        self._z3_next = self._z3_order()
        # what build_step made of the step: see capture.py
        self.capture_status: Dict[str, object] = {}
        # each op under record_function(op.name) (a profile window)
        self.op_scopes = False
        # a captured step maps its warm-up's kernels to their ops
        # (capture.py; fit's profile window with a trace_dir)
        self.map_kernels = False
        # each Cache op's input batch of the last training step, for the
        # host's ring (FFModel folds them in; the identity on the device)
        self.cache_taps: Dict[str, torch.Tensor] = {}
        # stage 2: bytes of grads the last step's ScatterBuckets held,
        # from their shapes ("peak", "after_backward")
        self.grad_bytes: Dict[str, int] = {}

    # -- plans -------------------------------------------------------------
    def _schedule(self) -> List[Tuple[object, Optional[BNApplyPlan]]]:
        """(op, its BatchNorm plan or None) in execution order: the
        topological order with each fused chain run at its last op."""
        by_guid = {op.guid: op for op in self.order}
        runs_at = {p.at: g for g, p in self.bn_plans.items() if p.at != g}
        skip = set(runs_at.values()) | {
            g for p in self.bn_plans.values() for g in p.absorbed}
        first = next((op.guid for op in self.order
                      if op.guid in self._block_guids), None)
        out = []
        for op in self.order:
            if op.guid == first:
                out.append((PipelineRegion(first), None))
            elif op.guid in self._block_guids:
                continue
            elif op.guid in runs_at:
                bn = by_guid[runs_at[op.guid]]
                out.append((bn, self.bn_plans[bn.guid]))
            elif op.guid not in skip:
                out.append((op, self.bn_plans.get(op.guid)))
        return out

    def _build_remat_plan(self, selected: Optional[List[int]] = None):
        """[(op guids, in guids, out guids, pure)] per segment of
        the single-tensor cuts; `selected` (a strategy's plan) restricts
        the checkpointed segments to those indices.  A fused BatchNorm
        chain that crosses a cut runs unfused."""
        from .pcg.segments import external_inputs, split_segments

        sel = None if selected is None else {int(i) for i in selected}
        segments, _ = split_segments(self.graph)
        seg_of = {op.guid: i for i, seg in enumerate(segments)
                  for op in seg}
        for g, p in list(self.bn_plans.items()):
            if any(seg_of[a] != seg_of[g] for a in p.absorbed):
                op = next(o for o in self.order if o.guid == g)
                self.bn_plans[g] = BNApplyPlan(None, op.params.relu,
                                               op.outputs[0].guid, (), g)
        sink_out = self.sink.outputs[0].guid
        consumers: Dict[int, List[int]] = {}
        for op in self.graph.ops:
            for t in op.inputs:
                consumers.setdefault(t.guid, []).append(seg_of[op.guid])
        plan = []
        for i, seg in enumerate(segments):
            outs = [t.guid for op in seg for t in op.outputs
                    if t.guid == sink_out
                    or any(c > i for c in consumers.get(t.guid, ()))]
            pure = (sel is None or i in sel) and all(
                op.op_type != OperatorType.INPUT
                and op.guid not in self._block_guids
                and op.num_trainable_weights() == len(op.weight_specs)
                and not _draws(op) for op in seg)
            plan.append(({op.guid for op in seg}, external_inputs(seg),
                         outs, pure))
        return plan

    def _plan_sharding(self):
        """Layouts of every tensor's view, each op's plan, each weight's
        stored and update layouts, the inputs' feed layouts and the
        labels' layout."""
        mesh = self.mesh
        self.view = {}
        for op in self.order:
            for pt in list(op.outputs):
                self.view[pt.guid] = layout_of(pt)
        self.op_plans = {}
        for op in self.order:
            if (op.op_type in (OperatorType.INPUT, OperatorType.CACHE)
                    or op.is_parallel_op() or op.guid in self._block_guids):
                continue
            self.op_plans[op.guid] = plan_op(
                op, mesh, [self.view[t.guid] for t in op.inputs])
        # stored layout of every weight and state entry; the update
        # layout (None: the replicated update) of each trainable one
        self.w_store, self.w_update = {}, {}
        for key, lay, shape, trainable in self._weight_layouts():
            upd = None
            if trainable and self.wus_axis is not None:
                z = shard_update_spec(lay.spec, shape, self.wus_axis,
                                      mesh.size(self.wus_axis))
                upd = None if z is None else Layout(z)
                # the stacked leaves stay whole at stage 3: the region
                # reads each rank's chunk of them directly
                if (upd is not None and self.zero_stage >= 3
                        and key[0] != PIPELINE):
                    self._z3[key] = lay
                    lay = upd
            if trainable:
                self.w_update[key] = upd
            self.w_store[key] = lay
        # an input lands in the layout its chain of parallel ops gives
        consumers = collections.defaultdict(list)
        for op in self.order:
            for t in op.inputs:
                consumers[t.guid].append(op)
        self.feed = {}
        for op in self.graph.source_ops():
            t = op.outputs[0]
            while (len(consumers[t.guid]) == 1
                   and consumers[t.guid][0].op_type
                   == OperatorType.REPARTITION):
                t = consumers[t.guid][0].outputs[0]
            self.feed[op.name] = self.view[t.guid]
        sink = self.view[self.sink.outputs[0].guid]
        self.loss_layout = Layout(
            (sink.spec[0],) + ((),) * (len(sink.spec) - 1))
        self.label_layout = Layout((sink.spec[0],))
        self.loss_axes = tuple(sink.spec[0])

    def _weight_layouts(self):
        """(key, strategy layout, global shape, trainable) of every
        weight and state entry: the ops' own, the block ops' stacked
        under PIPELINE."""
        for op in self.order:
            if op.guid in self._block_guids:
                continue
            nt = op.num_trainable_weights()
            for i, (spec, pt) in enumerate(zip(op.weight_specs, op.weights)):
                yield ((op.name, spec.name), layout_of(pt),
                       tuple(pt.shape.logical_shape), i < nt)
        plan = self.pipeline_plan
        if plan is not None:
            for j, op in enumerate(plan.blocks[0]):
                for spec, pt in zip(op.weight_specs, op.weights):
                    shape = (plan.num_blocks,) + tuple(pt.shape.logical_shape)
                    yield ((PIPELINE, f"{j}.{spec.name}"),
                           stacked_param_sharding(len(shape), plan.pp_axis),
                           shape, True)

    def _sharded_update(self, key) -> bool:
        """Whether a weight is updated on its wus shard after a
        reduce-scatter of its grad: at ZeRO stages 1 and 2, and at stage
        3 for the stacked leaves, which it does not keep scattered."""
        if self.w_update.get(key) is None:
            return False
        return self.zero_stage in (1, 2) or (self.zero_stage == 3
                                             and key[0] == PIPELINE)

    def zero_fallback_leaves(self) -> List[str]:
        """'op.weight' names whose update falls back to the replicated
        path while the ZeRO ladder is on (no free logical dim the
        wus axis divides, or the axis already shards the weight)."""
        if self.wus_axis is None:
            return []
        return [f"{op}.{w}" for (op, w), upd in self.w_update.items()
                if upd is None]

    # -- inputs and weights ---------------------------------------------------
    def _layout_in(self, op, t, v: torch.Tensor) -> torch.Tensor:
        """v as op wants it: channels_last for an NHWC op, as stored for
        a pass-through op, NCHW-contiguous for any other consumer."""
        if v.dim() != 4:
            return v
        want = self.op_layout.get(op.guid)
        if want == NHWC:
            return v.contiguous(memory_format=torch.channels_last)
        if want != PASS and self.t_layout.get(t.guid) == NHWC:
            return v.contiguous()
        return v

    def init_weights(self, seed: int = 0) -> Tuple[Weights, Weights]:
        """Weight and state dictionaries, drawn from one generator on
        the executor's device, op by op in topological order; on a mesh
        every rank draws the same global tensors and keeps its shard of
        each.  Under a pipeline each block op draws its own weights as
        it would without one, and they are stacked over the blocks: the
        weights do not depend on the strategy."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        weights: Weights = {}
        state: Weights = {}
        stacks: Dict[str, Dict[int, torch.Tensor]] = {}
        for op in self.order:
            nt = op.num_trainable_weights()
            for i, spec in enumerate(op.weight_specs):
                dtype = spec.shape.dtype.torch_dtype
                if (i >= nt and spec.name in ("k_cache", "v_cache")
                        and self.compute_dtype is not None):
                    # decode caches live in the compute dtype
                    dtype = self.compute_dtype
                arr = spec.initializer(gen, spec.shape.logical_shape, dtype,
                                       self.device)
                if op.guid in self._block_pos:
                    blk, j = self._block_pos[op.guid]
                    stacks.setdefault(f"{j}.{spec.name}", {})[blk] = arr
                    continue
                if self.mesh is not None:
                    arr = self.local(arr, op.name, spec.name)
                dst = weights if i < nt else state
                dst.setdefault(op.name, {})[spec.name] = arr
        for key, layers in stacks.items():
            arr = torch.stack([layers[b] for b in range(len(layers))])
            if self.mesh is not None:
                arr = self.local(arr, PIPELINE, key)
            weights.setdefault(PIPELINE, {})[key] = arr
        return weights, state

    def local(self, arr, op_name: str, name: str):
        """This rank's stored shard of a global weight or state entry
        (a tensor or a numpy array)."""
        out = local_slice(arr, self.w_store[(op_name, name)], self.mesh)
        return out.contiguous() if torch.is_tensor(out) else out

    def gathered(self, op_name: str, name: str, v: torch.Tensor):
        """The global tensor of a stored weight or state entry (every rank
        must call it)."""
        if self.mesh is None:
            return v
        return gather_global(v.detach(), self.w_store[(op_name, name)],
                             self.mesh)

    def update_views(self, weights: Weights) -> Weights:
        """What the optimizer updates: the weights, with each rank's shard
        (a view) in place of every weight it updates sharded (ZeRO
        stages 1 and 2; the stacked leaves at 3)."""
        if self.zero_stage == 0:
            return weights
        out: Weights = {}
        for op, entries in weights.items():
            for k, w in entries.items():
                out.setdefault(op, {})[k] = (
                    local_slice(w, self._shard_only(self.w_update[(op, k)],
                                                    (op, k)), self.mesh)
                    if self._sharded_update((op, k)) else w)
        return out

    def _shard_only(self, upd, key):
        """The update layout with only the wus axis left to slice (the
        stored local tensor already carries the strategy's axes)."""
        spec = tuple((self.wus_axis,) if self.wus_axis in axes else ()
                     for axes in upd.spec)
        return Layout(spec)

    def _to_compute(self, x: torch.Tensor) -> torch.Tensor:
        if (self.compute_dtype is not None and x.is_floating_point()
                and x.dtype != self.compute_dtype):
            return x.to(self.compute_dtype)
        return x

    # -- forward ---------------------------------------------------------------
    def _feed(self, op, x: torch.Tensor):
        """(value, layout) of an input: the global tensor or its feed
        layout's shard (what put_batch and fit's loader cut)."""
        x = self._to_compute(x)
        if self.mesh is None:
            return x, None
        shape = op.outputs[0].shape.logical_shape
        for lay in (self.feed[op.name], self.view[op.outputs[0].guid]):
            if tuple(x.shape) == lay.local_shape(shape, self.mesh):
                return x, lay
        raise ValueError(f"input {op.name} of shape {tuple(x.shape)} is "
                         f"neither the global {shape} nor a shard of it")

    def _exec(self, op, plan, env, lay, weights, state, new_state, ctx):
        """Run one schedule entry into env (and, on a mesh, its layout
        into lay)."""
        training, generator, aux_losses, inputs, z3 = ctx
        if op.op_type == OperatorType.INPUT:
            env[op.outputs[0].guid], layout = self._feed(op, inputs[op.name])
            if layout is not None:
                lay[op.outputs[0].guid] = layout
            return
        if op.op_type == OperatorType.CACHE:
            self._exec_cache(op, env, lay, inputs, training)
            return
        ins = [self._layout_in(op, t, env[t.guid]) for t in op.inputs]
        nt = op.num_trainable_weights()
        ws = []
        for i, spec in enumerate(op.weight_specs):
            src = weights if i < nt else state
            ws.append(self._to_compute(src[op.name][spec.name]))
        kw = {}
        if plan is not None:
            kw = {"residual": None if plan.residual is None
                  else env[plan.residual], "relu": plan.relu}
        if self.mesh is None:
            results = op.forward(ins, ws, training=training,
                                 generator=generator, **kw)
        else:
            with traffic_scope(type(op).__name__):
                results = self._exec_sharded(op, ins, ws, kw, lay, training,
                                             generator, z3)
        outs = results[:len(op.outputs)]
        aux = getattr(op, "_last_aux", None)
        if aux is not None:
            if aux_losses is not None:
                aux_losses.append(aux)
            op._last_aux = None
        for spec, given, val in zip(op.weight_specs[nt:], ws[nt:],
                                    results[len(op.outputs):]):
            dst = state[op.name][spec.name]
            # an entry handed back as given is unchanged (eval-mode
            # BatchNorm): copying its compute-dtype cast back would
            # round the state
            if val is not dst and val is not given:
                with torch.no_grad():
                    dst.copy_(val)
            new_state[op.name][spec.name] = dst
        if plan is not None:
            env[plan.out] = outs[0]
        else:
            for pt, val in zip(op.outputs, outs):
                env[pt.guid] = val

    def _exec_cache(self, op, env, lay, inputs, training):
        """The expert-activation cache: its input passes as it is (in its
        layout), and a training step keeps a copy of the global batch in
        `cache_taps` for the host; under use_cached the host's cached
        batch (`inputs["__cache__<name>"]`, global) stands in for it."""
        src = op.inputs[0].guid
        x = env[src]
        layout = (lay.get(src, self.view[src]) if self.mesh is not None
                  else None)
        if getattr(op, "_load_cached", False):
            x = inputs[f"__cache__{op.name}"].to(x.device, x.dtype)
            if layout is not None:
                x = local_slice(x, layout, self.mesh)
        elif training:
            tap = x.detach()
            if layout is not None:
                tap = gather_global(tap, layout, self.mesh)
            self.cache_taps[op.name] = tap.clone()
        env[op.outputs[0].guid] = x
        if layout is not None:
            lay[op.outputs[0].guid] = layout

    def _exec_sharded(self, op, ins, ws, kw, lay, training, generator, z3):
        """One op on this rank's shards: its inputs and weights brought
        to the plan's layouts (a stage-3 weight from the step's gather
        cache `z3` when there is one), the op's forward, each output
        brought to its view (parallel ops: the identity, then the
        view)."""
        mesh = self.mesh
        cur = [lay.get(t.guid, self.view[t.guid]) for t in op.inputs]
        if op.is_parallel_op():
            out = op.outputs[0]
            val = redistribute(ins[0], cur[0], self.view[out.guid], mesh)
            return [val]
        plan = self.op_plans[op.guid]
        ins = [redistribute(x, src, dst, mesh)
               for x, src, dst in zip(ins, cur, plan.ins)]
        nt = op.num_trainable_weights()
        ws = [self._weight_in((op.name, s.name), w, dst, z3)
              if i < nt else w
              for i, (w, s, dst) in enumerate(zip(ws, op.weight_specs,
                                                   plan.weights))]
        if kw.get("residual") is not None:
            res_guid = self.bn_plans[op.guid].residual
            kw["residual"] = redistribute(
                kw["residual"], lay.get(res_guid, self.view[res_guid]),
                plan.ins[0], mesh)
        if plan.fn is not None:
            results = plan.fn(ins, ws, training=training,
                              generator=generator)
        else:
            results = op.forward(ins, ws, training=training,
                                 generator=generator, **plan.kwargs, **kw)
        results = list(results)
        outs = [self.bn_plans[op.guid].out] if kw else [
            t.guid for t in op.outputs]
        for i, guid in enumerate(outs):
            results[i] = redistribute(results[i], plan.outs[i],
                                      self.view[guid], mesh)
            if i == 0 and plan.post is not None:
                results[i] = plan.post(results[i])
        return results

    def _weight_in(self, key, w, dst: Layout, z3) -> torch.Tensor:
        """A trainable weight in the plan's layout `dst`: a stage-3 one
        taken out of the step's gather cache (the prefetch issued its
        gather; one issued here otherwise), so that the cache holds no
        gather past its use; any other (and every one under a remat
        plan, whose segments gather inline) redistributed from its
        stored layout."""
        if z3 is not None and key in self._z3:
            finish = z3.pop(key, None) or self._z3_gather(key, w)
            return redistribute(finish(), self._z3[key], dst, self.mesh)
        return redistribute(w, self.w_store[key], dst, self.mesh)

    def _z3_gather(self, key, w):
        """Issue the gather of a stage-3 weight (its compute-dtype
        shard) to its strategy layout; returns its finisher."""
        return prefetch_gather(w, self.mesh, self.wus_axis,
                               self._scatter_dim(key))

    def _z3_prefetch(self, op, weights: Weights, z3) -> None:
        """Issue the gathers of `op`'s scattered weights into the cache,
        counted under op's scope."""
        nt = op.num_trainable_weights()
        with traffic_scope(type(op).__name__):
            for spec in op.weight_specs[:nt]:
                key = (op.name, spec.name)
                if key in self._z3 and key not in z3:
                    z3[key] = self._z3_gather(
                        key, self._to_compute(weights[op.name][spec.name]))

    def _z3_order(self) -> Dict[int, object]:
        """{op guid: the next schedule op with scattered weights} over
        the ops that have them, the first under None."""
        ops = [op for op, _ in self.schedule
               if not isinstance(op, PipelineRegion)
               and any((op.name, s.name) in self._z3 for s in
                       op.weight_specs[:op.num_trainable_weights()])]
        nxt = {a.guid: b for a, b in zip(ops, ops[1:])}
        if ops:
            nxt[None] = ops[0]
        return nxt

    def run_forward(self, weights: Weights, state: Weights,
                    inputs: Dict[str, torch.Tensor],
                    training: bool = False,
                    generator: Optional[torch.Generator] = None,
                    aux_losses: Optional[List[torch.Tensor]] = None):
        """Interpret the PCG.  Returns (sink_output, new_state); the
        state's tensors are updated in place.  Random ops (Dropout,
        attention dropout) draw from `generator`.  The ops' auxiliary
        losses are appended to `aux_losses` when it is given.  On a mesh
        the sink output is this rank's shard of its view."""
        env: Dict[int, torch.Tensor] = {}
        lay: Dict[int, object] = {}
        new_state = {k: dict(v) for k, v in state.items()}
        flat = self._remat_plan is None or not training
        # stage 3's gather cache: the flat path only (a remat segment
        # gathers inside, so that its backward gathers again)
        z3 = {} if self._z3 and flat else None
        z3_next = self._z3_next if z3 is not None else {}
        ctx = (training, generator, aux_losses, inputs, z3)

        def run(entries, env):
            for op, plan in entries:
                if isinstance(op, PipelineRegion):
                    self._run_pipeline_region(weights, env, lay, training,
                                              generator)
                    continue
                if op.guid in z3_next:
                    self._z3_prefetch(z3_next[op.guid], weights, z3)
                if self.op_scopes:
                    with record_function(op.name):
                        self._exec(op, plan, env, lay, weights, state,
                                   new_state, ctx)
                else:
                    self._exec(op, plan, env, lay, weights, state, new_state,
                               ctx)

        if None in z3_next:
            self._z3_prefetch(z3_next[None], weights, z3)
        if not flat:
            for guids, in_guids, out_guids, pure in self._remat_plan:
                entries = [(op, p) for op, p in self.schedule
                           if op.guid in guids
                           or (p is not None and p.at in guids)]
                if not pure:
                    run(entries, env)
                    continue

                def seg_fn(*vals, _e=entries, _in=in_guids, _out=out_guids):
                    local = dict(zip(_in, vals))
                    run(_e, local)
                    return tuple(local[g] for g in _out)

                # a pure segment draws nothing: no RNG state to keep
                outs = checkpoint(seg_fn, *(env[g] for g in in_guids),
                                  use_reentrant=False,
                                  preserve_rng_state=False)
                env.update(zip(out_guids, outs))
        else:
            run(self.schedule, env)
        out = env[self.sink.outputs[0].guid]
        if self.t_layout.get(self.sink.outputs[0].guid) == NHWC:
            out = out.contiguous()
        if self.compute_dtype is not None and out.is_floating_point():
            out = out.float()  # loss/metrics in full precision
        return out, new_state

    # -- the pipeline region ---------------------------------------------------
    def _region_layout(self, rank: int) -> Layout:
        """The layout the region computes in: the batch sharded over the
        pipeline's data axis, the rest whole (replicated over the pipe
        axis and any other)."""
        dp = self.pipeline_plan.dp_axis
        return Layout(((dp,) if dp else (),) + ((),) * (rank - 1))

    def _run_pipeline_region(self, weights, env, lay, training, generator):
        """The block stack through the GPipe schedule: the region input's
        data shard through this rank's blocks, the template block's ops
        once per block (their weights the stacked entries' rows).  A
        random op in a block draws from a generator seeded by one draw
        of the step's generator, its template op and its block: every
        microbatch of a block gets the same draws, as in the reference,
        and a rematerialized block redraws them."""
        plan = self.pipeline_plan
        template = plan.blocks[0]
        act = env[plan.region_in_guid]
        if self.t_layout.get(plan.region_in_guid) == NHWC:
            act = act.contiguous()
        if self.mesh is not None:
            g = plan.region_in_guid
            act = redistribute(act, lay.get(g, self.view[g]),
                               self._region_layout(act.dim()), self.mesh)
        stacked = {k: self._to_compute(v)
                   for k, v in weights[PIPELINE].items()}
        # each local block's global index, on the host
        n = plan.num_blocks // plan.num_stages
        first = (self.mesh.coord(plan.pp_axis) * n
                 if self.mesh is not None else 0)
        stacked["__block__"] = torch.arange(first, first + n)
        draws = training and generator is not None and any(
            _draws(op) for op in template)
        base = (int(torch.randint(0, 2 ** 31, (1,), generator=generator,
                                  device=generator.device))
                if draws else 0)

        def block_fn(params, a):
            local = {plan.region_in_guid: a}
            blk = int(params["__block__"])
            for j, op in enumerate(template):
                ins = [self._layout_in(op, t, local[t.guid])
                       for t in op.inputs]
                ws = [params[f"{j}.{s.name}"] for s in op.weight_specs]
                gen = None
                if draws and _draws(op):
                    gen = torch.Generator(device=a.device)
                    gen.manual_seed(((base * 1000003 + j) * 1000003 + blk)
                                    % 2 ** 63)
                outs = op.forward(ins, ws, training=training, generator=gen)
                for pt, val in zip(op.outputs, outs):
                    local[pt.guid] = val
            return local[plan.template_out_guid]

        out = pipelined_apply(block_fn, stacked, act, mesh=self.mesh,
                              num_microbatches=plan.num_microbatches,
                              pp_axis=plan.pp_axis,
                              remat=self.remat and training)
        env[plan.region_out_guid] = out
        if self.mesh is not None:
            lay[plan.region_out_guid] = self._region_layout(out.dim())

    # -- the sharded step's pieces ------------------------------------------
    def _local_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """This rank's labels: the global labels sliced as the logits'
        batch dim, or already the rank's rows."""
        n = self.sink.outputs[0].shape.logical_shape[0] // \
            self.label_replication
        if labels.shape[0] != n:
            return labels
        return local_slice(labels, self.label_layout, self.mesh)

    def feed_index(self, name: Optional[str], shape) -> Tuple[slice, ...]:
        """This rank's index into a global input of `shape` (its feed
        layout) or into the global labels (name None: the logits' batch
        layout)."""
        lay = self.label_layout if name is None else self.feed[name]
        return lay.local_index(shape, self.mesh)

    def host_shard(self, name: Optional[str], arr):
        """This rank's shard of a global numpy input (its feed layout) or
        of the global labels (name None: the logits' batch layout); any
        other array or tensor as it is."""
        if not isinstance(arr, np.ndarray):
            return arr
        if name is None:
            n = self.sink.outputs[0].shape.logical_shape[0] // \
                self.label_replication
            if arr.ndim == 0 or arr.shape[0] != n:
                return arr
        else:
            op = next((o for o in self.graph.source_ops()
                       if o.name == name), None)
            if op is None or arr.shape != op.outputs[0].shape.logical_shape:
                return arr
        return arr[self.feed_index(name, arr.shape)]

    def _sum_over(self, t: torch.Tensor, axes) -> torch.Tensor:
        for a in axes:
            if self.mesh.size(a) > 1:
                all_reduce_(t, self.mesh.group(a))
        return t

    def _grad_sum(self, flat: torch.Tensor, axes) -> torch.Tensor:
        """A flat grad bucket summed over `axes`: in the hierarchical
        form when they hold the slice axis and hier_axis (the other
        axes first, each by an all-reduce), else by an all-reduce per
        axis."""
        h = self.hier_axis
        if h is None or h not in axes or SLICE_AXIS not in axes:
            return self._sum_over(flat, axes)
        self._sum_over(flat, [a for a in axes if a not in (h, SLICE_AXIS)])
        mesh = self.mesh
        n, numel = mesh.size(h), flat.numel()
        pad = -numel % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        shard = reduce_scatter(flat, 0, n, mesh.coord(h), mesh.group(h))
        all_reduce_(shard, mesh.group(SLICE_AXIS))
        return all_gather(shard, 0, n, mesh.group(h))[:numel]

    def _grad_axes(self, key) -> List[str]:
        """The axes a trainable weight's grad is partial over: those its
        stored layout does not shard."""
        used = set(self.w_store[key].axes())
        return [a for a in self.mesh.names
                if a not in used and self.mesh.size(a) > 1]

    def _sum_buckets(self, grads: Weights, buckets) -> None:
        """Each bucket's grads ({axes: keys}) summed over its axes as one
        flat tensor, written back as views of it."""
        for axes, keys in buckets.items():
            flat = torch.cat([grads[o][k].reshape(-1) for o, k in keys])
            flat = self._grad_sum(flat, axes)
            off = 0
            for o, k in keys:
                g = grads[o][k]
                grads[o][k] = flat[off:off + g.numel()].view_as(g)
                off += g.numel()

    def _sync_and_update(self, weights: Weights, grads: Weights,
                         opt_state, scattered=frozenset()) -> None:
        """Sum each grad over its partial axes (by bucket; hierarchically
        on a two-level mesh, `_grad_sum`), with a reduce-scatter over the
        wus axis at ZeRO stages 1 and 2 (on a two-level mesh before the
        sum between slices, which then moves the shard); run the
        optimizer on what each rank owns; all-gather the updated shards
        at stages 1 and 2.  The grads of the keys in `scattered` are
        their shards already (stage 2's backward reduce-scattered them):
        they are summed over their other partial axes, the slice axis
        included, and updated."""
        mesh = self.mesh
        buckets = collections.defaultdict(list)
        shard_sums = collections.defaultdict(list)
        scatter, slice_after = [], []
        for op, entries in grads.items():
            for k, g in entries.items():
                axes = self._grad_axes((op, k))
                if self._sharded_update((op, k)):
                    axes = [a for a in axes if a != self.wus_axis]
                    scatter.append((op, k))
                    if (op, k) in scattered:
                        if axes:
                            shard_sums[tuple(axes)].append((op, k))
                        continue
                    if self._slice_after_scatter and SLICE_AXIS in axes:
                        axes.remove(SLICE_AXIS)
                        slice_after.append((op, k))
                if axes:
                    buckets[tuple(axes)].append((op, k))
        self._sum_buckets(grads, buckets)
        views = self.update_views(weights)
        if scatter:
            n, c = mesh.size(self.wus_axis), mesh.coord(self.wus_axis)
            group = mesh.group(self.wus_axis)
            for o, k in scatter:
                if (o, k) not in scattered:
                    grads[o][k] = reduce_scatter(
                        grads[o][k], self._scatter_dim((o, k)), n, c, group)
            for o, k in slice_after:
                all_reduce_(grads[o][k], mesh.group(SLICE_AXIS))
            self._sum_buckets(grads, shard_sums)
        self.optimizer.update(views, grads, opt_state)
        for o, k in scatter:
            weights[o][k].copy_(all_gather(views[o][k],
                                           self._scatter_dim((o, k)), n,
                                           group))

    def _scatter_dim(self, key) -> int:
        upd = self.w_update[key]
        return next(d for d, axes in enumerate(upd.spec)
                    if self.wus_axis in axes)

    def opt_state_bytes(self, opt_state) -> int:
        """Bytes of the optimizer's slots on this rank."""
        total = 0
        for sub in opt_state.values():
            if isinstance(sub, dict):
                for entries in sub.values():
                    total += sum(t.numel() * t.element_size()
                                 for t in entries.values())
        return total

    # -- steps -------------------------------------------------------------------
    def full_grad_bytes(self, weights: Weights) -> int:
        """Bytes of every trainable weight's grad in its strategy layout
        (what stages 0 and 1 hold after the backward)."""
        total = 0
        for op, entries in weights.items():
            for k, w in entries.items():
                n = w.numel()
                if (op, k) in self._z3:  # stored scattered
                    n *= self.mesh.size(self.wus_axis)
                total += n * w.element_size()
        return total

    def _scattered_backward(self, seed, weights: Weights, names):
        """Stage 2's backward: `seed.backward()` with ScatterBuckets on
        the leaves.  Returns (grads in `names`' order, the scattered
        ones as their shards; the keys scattered)."""
        keys = [key for key in names if self._sharded_update(key)]
        order = {op.name: i for i, (op, _) in enumerate(self.schedule)
                 if not isinstance(op, PipelineRegion)}
        # the backward makes the last op's grads first
        keys.sort(key=lambda key: -order.get(key[0], -1))
        mesh = self.mesh
        others = [weights[o][k] for o, k in names if (o, k) not in keys]
        scat = ScatterBuckets(
            [(key, weights[key[0]][key[1]], self._scatter_dim(key))
             for key in keys], others, mesh.size(self.wus_axis),
            mesh.coord(self.wus_axis), mesh.group(self.wus_axis))
        try:
            # the grads' reduce-scatters count as the update's
            with traffic_scope("update"):
                seed.backward()
        except BaseException:
            scat.remove()
            raise
        shards = scat.finish()
        flat = []
        for o, k in names:
            w = weights[o][k]
            g = shards.get((o, k))
            if g is None:
                g, w.grad = w.grad, None
                if g is None:
                    g = torch.zeros_like(w)
            flat.append(g)
        self.grad_bytes = {"peak": scat.peak, "after_backward": scat.held}
        return flat, set(keys)

    def build_step(self, capture: bool = True):
        """step(weights, opt_state, state, inputs, labels, generator) ->
        metrics: forward, loss (plus the ops' auxiliary losses), grads
        of the trainable weights, the optimizer's in-place update, then
        the metrics of the float32 logits (the loss under "loss"); on a
        mesh, of the global batch.  With `capture` (off only for an
        eager comparison) and nothing in `capture_blockers`, the step is
        a CapturedStep:
        it runs as one CUDA graph after its warm-up (capture.py).
        `capture_status` holds what became of it."""
        loss_obj, metrics, opt = self.loss, self.metrics, self.optimizer
        lrep = self.label_replication
        mesh = self.mesh

        def step(weights, opt_state, state, inputs, labels, generator=None):
            if mesh is not None:
                labels = self._local_labels(labels)
            if lrep > 1:
                # AggregateSpec emits sample-major [s0k0, s0k1, s1k0, ...];
                # the output size given, the repeat reads nothing back
                labels = torch.repeat_interleave(
                    labels, lrep, dim=0, output_size=labels.shape[0] * lrep)
            names = [(op, k) for op, entries in weights.items()
                     for k in entries]
            scattered = frozenset()
            with torch.enable_grad():
                aux = []
                logits, _ = self.run_forward(weights, state, inputs,
                                             training=True,
                                             generator=generator,
                                             aux_losses=aux)
                logits = self._loss_logits(logits)
                loss_val = loss_obj(logits, labels)
                for a in aux:
                    loss_val = loss_val + a
                seed = loss_val if mesh is None else loss_val / mesh.world
                # a graph with no trainable weight (shape ops alone)
                # still steps, as the reference's does
                if self.zero_stage == 2 and names:
                    flat, scattered = self._scattered_backward(seed, weights,
                                                               names)
                else:
                    flat = torch.autograd.grad(
                        seed, [weights[op][k] for op, k in names]
                    ) if names else []
            grads: Weights = {}
            for (op, k), g in zip(names, flat):
                grads.setdefault(op, {})[k] = g
            with torch.no_grad():
                if mesh is None:
                    opt.update(weights, grads, opt_state)
                else:
                    with traffic_scope("update"):
                        self._sync_and_update(weights, grads, opt_state,
                                              scattered)
                m = self._global_metrics(metrics.compute(logits.detach(),
                                                         labels))
                m["loss"] = self._global_loss(loss_val.detach())
            if self.cache_taps:
                m["__cache_taps__"] = self.cache_taps
                self.cache_taps = {}
            return m

        blockers = ([] if capture else [CAPTURE_OFF]) + capture_blockers(self)
        self.capture_status = {"mode": "eager" if blockers else "graph",
                               "blockers": blockers}
        if blockers:
            return step
        return CapturedStep(step, self)

    def _loss_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The logits with only their batch dim sharded (the rest
        gathered), for a loss over this rank's rows."""
        if self.mesh is None:
            return logits
        return redistribute(logits, self.view[self.sink.outputs[0].guid],
                            self.loss_layout, self.mesh)

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return loss
        n = math.prod(self.mesh.size(a) for a in self.loss_axes)
        return self._sum_over(loss.clone(), self.loss_axes) / n

    def _global_metrics(self, m: Dict[str, torch.Tensor]):
        if self.mesh is not None:
            for v in m.values():
                self._sum_over(v, self.loss_axes)
        return m

    def build_eval_step(self):
        """eval_step(weights, state, inputs, labels) -> metrics, with the
        loss under "loss"."""
        loss_obj, metrics = self.loss, self.metrics
        lrep = self.label_replication

        def eval_step(weights, state, inputs, labels):
            if self.mesh is not None:
                labels = self._local_labels(labels)
            if lrep > 1:
                labels = torch.repeat_interleave(
                    labels, lrep, dim=0, output_size=labels.shape[0] * lrep)
            with torch.no_grad():
                logits, _ = self.run_forward(weights, state, inputs,
                                             training=False)
                logits = self._loss_logits(logits)
                m = self._global_metrics(metrics.compute(logits, labels))
                m["loss"] = self._global_loss(loss_obj(logits, labels))
            return m

        return eval_step


def _draws(op) -> bool:
    """Whether op draws random numbers in training (Dropout, attention
    dropout)."""
    if op.op_type == OperatorType.DROPOUT:
        return op.params.rate > 0.0
    return getattr(op.params, "dropout", 0.0) > 0.0
