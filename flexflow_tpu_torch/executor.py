"""Graph executor of the PyTorch port (flexflow_tpu/executor.py).

Runs the PCG on one device under the trivial strategy: `init_weights`
builds the weight and state dictionaries ({op name: {weight name:
tensor}}), and `run_forward` interprets the graph op by op, eagerly.
The reference's flat path is kept: floating inputs and weights are cast
to the compute dtype (`to_compute`), decode caches live in the compute
dtype, and the sink output is cast to float32.  State entries (the
paged KV pools) are updated in place, so the returned state holds the
same tensors it was given.

`build_step` and `build_eval_step` are the training surface.  Autograd
takes the place of `jax.value_and_grad`: the forward runs with
training=True, `torch.autograd.grad` differentiates the loss over the
trainable weights, and the optimizer writes weights and slots in place
under torch.no_grad(), where the reference's jitted step donated them.
Sharding, ZeRO, remat, pipelines and cache taps come with later slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .fftype import OperatorType
from .pcg.graph import Graph

Weights = Dict[str, Dict[str, torch.Tensor]]


class GraphExecutor:
    def __init__(self, graph: Graph, device: torch.device,
                 compute_dtype: Optional[torch.dtype] = None,
                 loss=None, metrics=None, optimizer=None):
        self.graph = graph
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.loss = loss
        self.metrics = metrics
        self.optimizer = optimizer
        self.order = graph.topo_order()
        self.sink = graph.sink_op()

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
                    generator: Optional[torch.Generator] = None):
        """Interpret the PCG.  Returns (sink_output, new_state); the
        state's tensors are updated in place.  Random ops (attention
        dropout) draw from `generator`."""
        env: Dict[int, torch.Tensor] = {}
        new_state = {k: dict(v) for k, v in state.items()}
        for op in self.order:
            if op.op_type == OperatorType.INPUT:
                env[op.outputs[0].guid] = self._to_compute(inputs[op.name])
                continue
            ins = [env[t.guid] for t in op.inputs]
            nt = op.num_trainable_weights()
            ws = []
            for i, spec in enumerate(op.weight_specs):
                src = weights if i < nt else state
                ws.append(self._to_compute(src[op.name][spec.name]))
            results = op.forward(ins, ws, training=training,
                                 generator=generator)
            outs = results[:len(op.outputs)]
            for spec, val in zip(op.weight_specs[nt:],
                                 results[len(op.outputs):]):
                dst = state[op.name][spec.name]
                if val is not dst:
                    dst.copy_(val)
                new_state[op.name][spec.name] = dst
            for pt, val in zip(op.outputs, outs):
                env[pt.guid] = val
        out = env[self.sink.outputs[0].guid]
        if self.compute_dtype is not None and out.is_floating_point():
            out = out.float()  # loss/metrics in full precision
        return out, new_state

    def build_step(self):
        """step(weights, opt_state, state, inputs, labels, generator) ->
        metrics: forward, loss, grads of the trainable weights, the
        optimizer's in-place update, then the metrics of the float32
        logits (the loss under "loss")."""
        loss_obj, metrics, opt = self.loss, self.metrics, self.optimizer

        def step(weights, opt_state, state, inputs, labels, generator=None):
            names = [(op, k) for op, entries in weights.items()
                     for k in entries]
            with torch.enable_grad():
                logits, _ = self.run_forward(weights, state, inputs,
                                             training=True,
                                             generator=generator)
                loss_val = loss_obj(logits, labels)
                flat = torch.autograd.grad(
                    loss_val, [weights[op][k] for op, k in names])
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

        def eval_step(weights, state, inputs, labels):
            with torch.no_grad():
                logits, _ = self.run_forward(weights, state, inputs,
                                             training=False)
                m = metrics.compute(logits, labels)
                m["loss"] = loss_obj(logits, labels)
            return m

        return eval_step
