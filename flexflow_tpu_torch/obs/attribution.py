"""Op attribution of a captured step's kernels in a profile window: the
counterpart, for a CUDA graph's replays, of the reference's
`jax.named_scope(op.name)` in its profile.

A replay runs no host code, so the kernels of a window's replays sit
under no `record_function(op.name)` range.  The warm-up step before the
capture is eager: when the executor's `map_kernels` is set (fit's
profile window with a trace_dir), CapturedStep runs that step under
torch.profiler with the op scopes on, and `kernel_ops` reads from its
profile every kernel the step launched, in the order the device ran
them, with the op whose forward or backward launched it.  The capture
records the same launches, so `attribute_trace` lines that list up with
each replay's kernels in the window's exported Chrome trace (the
kernels that carry the correlation id of one `cudaGraphLaunch`): the
n-th launch of a kernel in a replay is the n-th in the map, for every
kernel the two launch equally often, and its op is written into its
`args["op"]`.  Where the eager step and the graph launch a kernel a
different number of times (a library picking another GEMM), that
kernel stays unmarked.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

#: (kernel name, the op that launched it or None), in the device's order
KernelOps = List[Tuple[str, Optional[str]]]


def _chain(evt):
    """evt and its enclosing CPU events, innermost first."""
    while evt is not None:
        yield evt
        evt = evt.cpu_parent


def _backward_node(evt):
    """(whether evt runs in the backward, the record of the autograd node
    it runs for or None).  The engine's own work for a node (the sums
    that undo a broadcast) sits beside the node's record (scope 1),
    under the engine's evaluate_function range."""
    for p in _chain(evt):
        if p.scope == 1:
            return True, p
        if p.name.startswith("autograd::engine::evaluate_function:"):
            return True, next((c for c in p.cpu_children if c.scope == 1),
                              None)
    return False, None


def _scope(evt, op_names) -> Optional[str]:
    return next((p.name for p in _chain(evt) if p.name in op_names), None)


def device_launches(prof) -> List[Tuple[int, str, int]]:
    """(start ns, name, the id of the CPU event that launched it) of
    every device event of a stopped torch.profiler.profile, read from its
    kineto results (FunctionEvent has no link to its launcher in every
    torch release)."""
    from torch.autograd import DeviceType

    return [(k.start_ns(), k.name(), k.linked_correlation_id())
            for k in prof.profiler.kineto_results.events()
            if k.device_type() == DeviceType.CUDA]


def kernel_ops(events, op_names, device) -> KernelOps:
    """Every kernel of a profiled eager step, in the order the device ran
    them, with its op: a forward launch's enclosing op range, a backward
    launch's through its autograd node's sequence number to the forward
    op that made the node.  `events` are torch.profiler's FunctionEvents,
    `device` the step's device events (`device_launches`), each linked
    to the id of its launching CPU event; copies and memsets are left
    out, as the trace's "kernel" events leave them."""
    from torch.autograd import DeviceType

    fwd: Dict[tuple, str] = {}
    for e in events:
        if e.sequence_nr >= 0 and not _backward_node(e)[0]:
            s = _scope(e, op_names)
            if s is not None:
                fwd.setdefault((e.sequence_nr, e.thread), s)
    op_of: Dict[int, Optional[str]] = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        backward, node = _backward_node(e)
        if backward:
            op_of[e.id] = None if node is None else fwd.get(
                (node.sequence_nr, node.fwd_thread))
        else:
            op_of[e.id] = _scope(e, op_names)
    # the launching event's start does not order its kernels against
    # its children's (an autograd node launches after the ops inside
    # it): the device's own times do
    return [(name, op_of[link]) for _, name, link in sorted(device)
            if link in op_of and not name.startswith(("Memcpy", "Memset"))]


def _align(names: Sequence[str], ops: KernelOps) -> List[Optional[str]]:
    """The op of each of `names` (one replay's kernels, in order): the
    n-th launch of a kernel takes the op of the map's n-th launch of it,
    for each kernel launched as often in both; None for the others."""
    by_name: Dict[str, List[Optional[str]]] = {}
    for name, op in ops:
        by_name.setdefault(name, []).append(op)
    counts = Counter(names)
    seen: Counter = Counter()
    out: List[Optional[str]] = []
    for name in names:
        mapped = by_name.get(name, ())
        out.append(mapped[seen[name]] if len(mapped) == counts[name]
                   else None)
        seen[name] += 1
    return out


def attribute_trace(path: str, ops: KernelOps) -> Dict[str, int]:
    """Write the op of each replayed kernel into `args["op"]` of the
    Chrome trace at `path` (torch.profiler's export), in place.  Returns
    the counts: the window's kernels, those of its graph replays, the
    replays, and the kernels given an op."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    launches = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") == "cuda_runtime"
                and e.get("name") == "cudaGraphLaunch"}
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    replays: Dict[int, list] = {}
    for e in kernels:
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            replays.setdefault(corr, []).append(e)
    attributed = 0
    for group in replays.values():
        for e, op in zip(group, _align([e["name"] for e in group], ops)):
            if op is not None:
                e["args"]["op"] = op
                attributed += 1
    with open(path, "w") as f:
        json.dump(trace, f)
    return {"kernels": len(kernels),
            "replayed_kernels": sum(map(len, replays.values())),
            "replays": len(replays), "attributed": attributed}
