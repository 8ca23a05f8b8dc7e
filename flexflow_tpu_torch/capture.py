"""The train step as one CUDA graph: the port's counterpart of the
reference's jitted step (`jax.jit(step)` in flexflow_tpu/executor.py
`build_step`).

The reference traces its step once and runs it as one compiled program;
the port's step is eager Python that launches each op's kernels, so the
host's dispatch sets the pace of every path whose kernels are short.
`CapturedStep` records the step's launches once into a
`torch.cuda.CUDAGraph` and replays the graph for every later step:

- the first `WARMUP_STEPS` calls (per shape of inputs and labels) run
  the eager step on a side stream: they are real steps, and they do
  what must not happen during a capture (NCCL's communicators, the
  kernels' first-use build, cuBLAS's workspace on that stream, cuDNN's
  choice of algorithm);
- the next call copies its batch into static input and label buffers,
  captures the step on that stream (the captured work does not run)
  and replays the graph once, so it makes its one update like any
  other call;
- every later call copies its batch into those buffers and replays.

So N calls make N updates.  The weights, the optimizer's slots and the
op state are updated in place, so the graph reads and writes the same
tensors every replay, and must be handed the same ones every call; the
learning rate is a device tensor (optimizer.py), so `set_learning_rate`
reaches a captured step.  The step's generator is registered with the
graph, so every replay draws fresh random numbers.  Each call returns
copies of the metric tensors, which the next replay overwrites.  The
graph's private memory pool keeps the step's activations between
replays.  Python's cyclic collector is run before the capture and kept
off during it: a dead graph destroyed mid-capture frees its pool,
which invalidates the capture.  A capture that fails raises: nothing
falls back.

A profile window of fit replays the graph like any other step, so it
profiles the program the run executes.  A replay runs no host code, so
its kernels sit under no op's `record_function` range: while the
executor's `map_kernels` is set (fit's profile window, with a
trace_dir), the warm-up step runs under torch.profiler with the op
scopes on, and `status["kernel_ops"]` keeps each kernel it launched, in
order, with its op (obs/attribution.py), which the window's export
writes onto the replays' kernels.  A warm-up that an open profiler
already records (a window from step 0) sits in that window in its own
ranges, and leaves no map.

The kernels' launch counters count in their wrappers, which run at
capture only; `status["launches_at_capture"]` holds what the capture
counted, which every replay launches again, and
`status["traffic_at_capture"]` the collective bytes per step, which the
host counts once, at capture.

`capture_blockers(executor)` lists, from the compiled plan alone, what
keeps a step from being captured; `GraphExecutor.build_step` captures
only when it is empty (and the caller did not ask for an eager step,
`build_step(capture=False)`).
"""
from __future__ import annotations

import collections
import gc
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from .fftype import OperatorType
from .parallel import collectives
from .parallel.spmd import _token_axis

#: eager steps on the side stream before the capture (per input shapes)
WARMUP_STEPS = 1

CAPTURE_OFF = "capture turned off (build_step(capture=False))"

#: tiny launches the profiler of a mapped warm-up step sees before it
#: records: late in a long run on the card, a recording whose warm-up
#: launched one kernel lost the step's first ~25, while a window warmed
#: up over a whole step lost none
MAP_WARMUP_LAUNCHES = 512


def capture_blockers(executor) -> List[str]:
    """What keeps `executor`'s train step from running as one CUDA
    graph, from its plan alone (empty: it is captured on the card)."""
    out = []
    dev = executor.device
    if dev.type != "cuda":
        out.append(f"the {dev.type} device: a CUDA graph runs on a CUDA "
                   "device")
    mesh = executor.mesh
    if mesh is not None:
        gloo = [a for a in mesh.names if mesh.size(a) > 1
                and dist.get_backend(mesh.group(a)) == "gloo"]
        if gloo:
            out.append(f"a gloo group (axes {', '.join(gloo)}): its "
                       "collectives are staged through host memory")
        for op in executor.order:
            if (op.op_type == OperatorType.GROUP_BY
                    and _token_axis(mesh, executor.view[
                        op.inputs[0].guid].spec[0]) is not None):
                out.append(f"expert-parallel exchange ({op.name}): its "
                           "split sizes are read on the host "
                           "(parallel/expert_parallel.py route)")
    caches = [op.name for op in executor.order
              if op.op_type == OperatorType.CACHE]
    if caches:
        out.append(f"the expert-activation cache ({', '.join(caches)}): "
                   "each step hands its input batch to the host "
                   "(FFModel.cache)")
    plan = executor.pipeline_plan
    if plan is not None:
        from .executor import _draws

        if any(_draws(op) for op in plan.blocks[0]):
            out.append("a pipelined block draws random numbers: its "
                       "per-block seeds are read on the host")
    return out


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' launch counters, by id."""
    from .ops.kernels import bn_apply, flash_attention, paged_attention

    return {"K1": flash_attention.flash_fwd.launches,
            "K2": flash_attention.flash_bwd_dq.launches,
            "K3": flash_attention.flash_bwd_dkv.launches,
            "K4": paged_attention.paged_attention.launches,
            "P1": bn_apply.bn_apply.launches}


class _Graph:
    """One captured graph (per input and label shapes): its warm-up
    count, static buffers and outputs."""

    def __init__(self):
        self.warmups = 0
        self.graph = None
        self.inputs: Dict[str, torch.Tensor] = {}
        self.labels = None
        self.out: Dict[str, torch.Tensor] = {}


class CapturedStep:
    """The eager `step` (GraphExecutor.build_step's) run as a CUDA graph
    (see the module's note); `executor.capture_status` is its record."""

    def __init__(self, step, executor):
        self._step = step
        self._executor = executor
        self.device = executor.device
        self.status = executor.capture_status
        self.status.update(warmup_steps=0, captures=0, replays=0,
                           capture_s=0.0, launches_at_capture={},
                           traffic_at_capture={})
        self._graphs: Dict[tuple, _Graph] = {}
        self._bound = None
        self._stream = None

    def reset(self) -> None:
        """Drop the graphs (and their memory pools): the next calls warm
        up and capture again, as after a change of what the step bakes
        in on the host (FFModel.set_iteration_config)."""
        self._graphs = {}

    def __call__(self, weights, opt_state, state, inputs, labels,
                 generator=None):
        bound = (weights, opt_state, state, generator)
        if self._bound is None:
            self._bound = bound
        elif any(a is not b for a, b in zip(bound, self._bound)):
            raise ValueError(
                "a captured step replays on the weights, optimizer state, "
                "op state and generator it was captured with; it was "
                "handed others")
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(inputs.items())) + (
            (tuple(labels.shape), labels.dtype),)
        g = self._graphs.setdefault(key, _Graph())
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        if g.graph is None and g.warmups < WARMUP_STEPS:
            g.warmups += 1
            self.status["warmup_steps"] += 1
            self._stream.wait_stream(cur)
            step = (self._mapped_step if self._executor.map_kernels
                    and not torch.autograd.profiler._is_profiler_enabled
                    else self._step)
            with torch.cuda.stream(self._stream):
                out = step(weights, opt_state, state, inputs, labels,
                           generator)
            cur.wait_stream(self._stream)
            return out
        if g.graph is None:
            self._capture(g, weights, opt_state, state, inputs, labels,
                          generator)
        else:
            for k, v in inputs.items():
                g.inputs[k].copy_(v)
            g.labels.copy_(labels)
        g.graph.replay()
        self.status["replays"] += 1
        return {k: v.clone() for k, v in g.out.items()}

    def _mapped_step(self, *args):
        """The eager step under torch.profiler with each op in its range:
        `status["kernel_ops"]` is the map of its kernels to their ops.
        The profiler warms up first (its schedule's warmup) over
        MAP_WARMUP_LAUNCHES launches, and records settled
        (obs.settle)."""
        from torch.profiler import ProfilerActivity, profile, schedule

        from .obs import settle
        from .obs.attribution import device_launches, kernel_ops

        ex = self._executor
        scopes, ex.op_scopes = ex.op_scopes, True
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                x = torch.zeros(1, device=self.device)
                for _ in range(MAP_WARMUP_LAUNCHES):
                    x.add_(1)
                settle()
                prof.step()  # the warm-up is over: record
                settle()
                out = self._step(*args)
                settle()
        finally:
            ex.op_scopes = scopes
        self.status["kernel_ops"] = kernel_ops(
            prof.events(), {op.name for op in ex.order},
            device_launches(prof))
        return out

    def _capture(self, g: _Graph, weights, opt_state, state, inputs,
                 labels, generator) -> None:
        g.inputs = {k: v.clone() for k, v in inputs.items()}
        g.labels = labels.clone()
        graph = torch.cuda.CUDAGraph()
        if generator is not None and generator.device.type == "cuda":
            graph.register_generator_state(generator)
        launches = kernel_launches()
        traffic = collections.Counter(collectives.traffic)
        t0 = time.perf_counter()
        # a dead graph that the cyclic collector destroyed during the
        # capture would free its memory pool, which the capture refuses
        # (the capture is then invalidated): collect before, not during
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: only this thread's calls may break the
            # capture (the loader's worker and NCCL's watchdog go on in
            # theirs)
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                g.out = self._step(weights, opt_state, state, g.inputs,
                                   g.labels, generator)
        finally:
            if collecting:
                gc.enable()
        g.graph = graph
        st = self.status
        st["captures"] += 1
        st["capture_s"] += time.perf_counter() - t0
        after = kernel_launches()
        st["launches_at_capture"] = {k: after[k] - launches[k]
                                     for k in after}
        st["traffic_at_capture"] = {
            f"{scope}/{kind}": n - traffic.get((scope, kind), 0)
            for (scope, kind), n in collectives.traffic.items()
            if n != traffic.get((scope, kind), 0)}
