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
Sharding, ZeRO, remat, pipelines and cache taps come with later slices.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .fftype import OpBinary, OperatorType, OpUnary
from .pcg.graph import Graph
from .pcg.layout import NHWC, PASS, assign_layouts

Weights = Dict[str, Dict[str, torch.Tensor]]


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
                 label_replication: int = 1):
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
        self.schedule = self._schedule()

    def _schedule(self) -> List[Tuple[object, Optional[BNApplyPlan]]]:
        """(op, its BatchNorm plan or None) in execution order: the
        topological order with each fused chain run at its last op."""
        by_guid = {op.guid: op for op in self.order}
        runs_at = {p.at: g for g, p in self.bn_plans.items() if p.at != g}
        skip = set(runs_at.values()) | {
            g for p in self.bn_plans.values() for g in p.absorbed}
        out = []
        for op in self.order:
            if op.guid in runs_at:
                bn = by_guid[runs_at[op.guid]]
                out.append((bn, self.bn_plans[bn.guid]))
            elif op.guid not in skip:
                out.append((op, self.bn_plans.get(op.guid)))
        return out

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
        the executor's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        weights: Weights = {}
        state: Weights = {}
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
                dst = weights if i < nt else state
                dst.setdefault(op.name, {})[spec.name] = arr
        return weights, state

    def _to_compute(self, x: torch.Tensor) -> torch.Tensor:
        if (self.compute_dtype is not None and x.is_floating_point()
                and x.dtype != self.compute_dtype):
            return x.to(self.compute_dtype)
        return x

    def run_forward(self, weights: Weights, state: Weights,
                    inputs: Dict[str, torch.Tensor],
                    training: bool = False,
                    generator: Optional[torch.Generator] = None,
                    aux_losses: Optional[List[torch.Tensor]] = None):
        """Interpret the PCG.  Returns (sink_output, new_state); the
        state's tensors are updated in place.  Random ops (Dropout,
        attention dropout) draw from `generator`.  The ops' auxiliary
        losses are appended to `aux_losses` when it is given."""
        env: Dict[int, torch.Tensor] = {}
        new_state = {k: dict(v) for k, v in state.items()}
        for op, plan in self.schedule:
            if op.op_type == OperatorType.INPUT:
                env[op.outputs[0].guid] = self._to_compute(inputs[op.name])
                continue
            ins = [self._layout_in(op, t, env[t.guid]) for t in op.inputs]
            nt = op.num_trainable_weights()
            ws = []
            for i, spec in enumerate(op.weight_specs):
                src = weights if i < nt else state
                ws.append(self._to_compute(src[op.name][spec.name]))
            if plan is None:
                results = op.forward(ins, ws, training=training,
                                     generator=generator)
            else:
                res = None if plan.residual is None else env[plan.residual]
                results = op.forward(ins, ws, training=training,
                                     generator=generator, residual=res,
                                     relu=plan.relu)
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
        out = env[self.sink.outputs[0].guid]
        if self.t_layout.get(self.sink.outputs[0].guid) == NHWC:
            out = out.contiguous()
        if self.compute_dtype is not None and out.is_floating_point():
            out = out.float()  # loss/metrics in full precision
        return out, new_state

    def build_step(self):
        """step(weights, opt_state, state, inputs, labels, generator) ->
        metrics: forward, loss (plus the ops' auxiliary losses), grads
        of the trainable weights, the optimizer's in-place update, then
        the metrics of the float32 logits (the loss under "loss")."""
        loss_obj, metrics, opt = self.loss, self.metrics, self.optimizer
        lrep = self.label_replication

        def step(weights, opt_state, state, inputs, labels, generator=None):
            if lrep > 1:
                # AggregateSpec emits sample-major [s0k0, s0k1, s1k0, ...]
                labels = torch.repeat_interleave(labels, lrep, dim=0)
            names = [(op, k) for op, entries in weights.items()
                     for k in entries]
            with torch.enable_grad():
                aux = []
                logits, _ = self.run_forward(weights, state, inputs,
                                             training=True,
                                             generator=generator,
                                             aux_losses=aux)
                loss_val = loss_obj(logits, labels)
                for a in aux:
                    loss_val = loss_val + a
                # a graph with no trainable weight (shape ops alone)
                # still steps, as the reference's does
                flat = torch.autograd.grad(
                    loss_val, [weights[op][k] for op, k in names]
                ) if names else []
            grads: Weights = {}
            for (op, k), g in zip(names, flat):
                grads.setdefault(op, {})[k] = g
            with torch.no_grad():
                opt.update(weights, grads, opt_state)
                m = metrics.compute(logits.detach(), labels)
            m["loss"] = loss_val.detach()
            return m

        return step

    def build_eval_step(self):
        """eval_step(weights, state, inputs, labels) -> metrics, with the
        loss under "loss"."""
        loss_obj, metrics = self.loss, self.metrics
        lrep = self.label_replication

        def eval_step(weights, state, inputs, labels):
            if lrep > 1:
                labels = torch.repeat_interleave(labels, lrep, dim=0)
            with torch.no_grad():
                logits, _ = self.run_forward(weights, state, inputs,
                                             training=False)
                m = metrics.compute(logits, labels)
                m["loss"] = loss_obj(logits, labels)
            return m

        return eval_step
