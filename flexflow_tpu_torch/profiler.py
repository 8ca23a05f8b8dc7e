"""Per-operator profiling on the card (flexflow_tpu/profiler.py).

`measure_op_forward` times one op's forward on its own, at shard shapes
(one device's share of the work), on inputs and weights drawn from an
explicit torch.Generator, under torch.no_grad(): warm-up runs first,
then `repeats` windows of `chain` forwards, each between two CUDA events
on the card (time.perf_counter on the CPU); the best window's mean is
the result.  `make_measure_fn` adapts it into the simulator's
OpCostModel measured-override hook, so the strategy search ranks
candidates by the card's own op times (the reference's
inner_measure_operator_cost, model.cu:38-75).  An attention op measured
at a KV length of at least its `_flash_min_seq` launches the flash
kernel K1.

Only an op that cannot run on its own returns None: its forward raises
ShapeError or NotImplementedError (a sequence-sharded attention, whose
ring form is the multi-GPU executor's), or it has no input.  Its
analytic cost then stands, and the measure fn counts it.  Every other
failure, a CUDA error or a kernel's failed launch among them,
propagates.

`measure_segment_costs` times forward + backward of fused regions of a
compiled model (consecutive single-tensor segments), for
Simulator.simulate's `segment_costs`.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .config import resolve_device
from .fftype import OperatorType
from .ops.op import Op, ShapeError

_log = logging.getLogger("flexflow_tpu_torch.calib")

# what an op that cannot run on its own raises: a sequence-sharded
# attention still cannot (ring attention needs the ranks of a
# torch.distributed group, which one process timing an op has not)
NOT_STANDALONE = (ShapeError, NotImplementedError)


def _rand(shape, dtype, gen: torch.Generator,
          device: torch.device) -> torch.Tensor:
    """Normal draws for a floating tensor; zeros (in-range indices) for
    an integer one."""
    td = dtype.torch_dtype
    if td.is_floating_point:
        return torch.randn(tuple(shape), generator=gen, device=device,
                           dtype=torch.float32).to(td)
    return torch.zeros(tuple(shape), dtype=td, device=device)


def time_calls(fn: Callable[[], object], device: torch.device,
               warmup: int, repeats: int, chain: int) -> float:
    """Best over `repeats` windows of the mean seconds of one `fn()`,
    each window `chain` calls after `warmup` calls: between two CUDA
    events on a card, by time.perf_counter on the CPU."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            for _ in range(max(1, repeats)):
                start.record()
                for _ in range(chain):
                    fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) * 1e-3 / chain)
        return best
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(chain):
            fn()
        best = min(best, (time.perf_counter() - t0) / chain)
    return best


def measure_op_forward(op: Op, device=None, warmup: int = 1,
                       repeats: int = 3, shard_shapes: bool = True,
                       chain: int = 16, seed: int = 0,
                       flash_min_seq: Optional[int] = None
                       ) -> Optional[float]:
    """Seconds of one forward of `op` on `device` (default "cuda"), at
    its shard shapes; None when the op cannot run on its own (see the
    module's note).  `flash_min_seq`, when given, is stamped on the op
    for the measurement, as compile stamps FFConfig.flash_min_seq."""
    device = resolve_device(device if device is not None else "cuda")
    if not op.inputs:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def shape_of(pshape):
        return pshape.shard_shape if shard_shapes else pshape.logical_shape

    ins = [_rand(shape_of(t.shape), t.shape.dtype, gen, device)
           for t in op.inputs]
    ws = [_rand(shape_of(s.shape), s.shape.dtype, gen, device)
          for s in op.weight_specs]
    saved = getattr(op, "_flash_min_seq", None)
    if flash_min_seq is not None and saved is not None:
        op._flash_min_seq = flash_min_seq

    def run():
        op.forward(ins, ws, training=False, generator=gen)

    try:
        with torch.no_grad():
            try:
                run()  # the first warm-up run
            except NOT_STANDALONE:
                return None
            return time_calls(run, device, warmup - 1, repeats, chain)
    finally:
        if saved is not None:
            op._flash_min_seq = saved


class OpMeasurer:
    """OpCostModel measure_fn: op -> forward seconds, or None for an op
    that cannot run on its own.  Counts what it measured (`measured`)
    and names what it could not (`unmeasurable`)."""

    def __init__(self, device=None, warmup: int = 1, repeats: int = 3,
                 chain: int = 16, flash_min_seq: Optional[int] = None):
        self.device = resolve_device(device if device is not None
                                     else "cuda")
        self.warmup, self.repeats, self.chain = warmup, repeats, chain
        self.flash_min_seq = flash_min_seq
        self.measured = 0
        self.unmeasurable: List[str] = []

    def __call__(self, op: Op) -> Optional[float]:
        t = measure_op_forward(op, device=self.device, warmup=self.warmup,
                               repeats=self.repeats, chain=self.chain,
                               flash_min_seq=self.flash_min_seq)
        if t is None:
            self.unmeasurable.append(op.name)
        else:
            self.measured += 1
        return t


def make_measure_fn(device=None, warmup: int = 1, repeats: int = 3,
                    chain: int = 16,
                    flash_min_seq: Optional[int] = None) -> OpMeasurer:
    """The simulator's measure_fn over `device` (default "cuda")."""
    return OpMeasurer(device=device, warmup=warmup, repeats=repeats,
                      chain=chain, flash_min_seq=flash_min_seq)


_SKIP = {OperatorType.INPUT, OperatorType.WEIGHT, OperatorType.NOOP}


def profile_operators(ff, device=None, warmup: int = 2,
                      repeats: int = 5) -> List[Dict[str, object]]:
    """Per-op timing table of a compiled FFModel (the reference's
    --profiling printout), on the model's device unless `device` names
    another.  Rows: name, type, fwd_ms (None for an op that cannot run
    on its own), flops, shard shapes."""
    graph = ff.operators if ff.operators is not None else ff.layers
    device = device if device is not None else ff.device
    rows: List[Dict[str, object]] = []
    for op in graph.topo_order():
        if op.op_type in _SKIP or op.is_parallel_op():
            continue
        t = measure_op_forward(op, device=device, warmup=warmup,
                               repeats=repeats,
                               flash_min_seq=ff.config.flash_min_seq)
        rows.append({
            "name": op.name,
            "type": op.op_type.name,
            "fwd_ms": None if t is None else t * 1e3,
            "flops": op.flops(),
            "out_shape": [tuple(o.shape.shard_shape) for o in op.outputs],
        })
    return rows


def print_profile(rows: List[Dict[str, object]]):
    name_w = max((len(str(r["name"])) for r in rows), default=4) + 2
    print(f"{'op':<{name_w}}{'type':<20}{'fwd ms':>10}{'GFLOP':>12}")
    for r in rows:
        ms = "n/a" if r["fwd_ms"] is None else f"{r['fwd_ms']:.3f}"
        gf = r["flops"] / 1e9
        print(f"{r['name']:<{name_w}}{r['type']:<20}{ms:>10}{gf:>12.3f}")
    # unmeasurable ops are left out of the total, and the row says so
    measured = [r for r in rows if r["fwd_ms"] is not None]
    total = sum(r["fwd_ms"] for r in measured)
    qualifier = f"({len(measured)} measured / {len(rows)} total ops"
    excluded = len(rows) - len(measured)
    if excluded:
        qualifier += f", {excluded} excluded"
    qualifier += ")"
    print(f"{'TOTAL':<{name_w}}{'':<20}{total:>10.3f}  {qualifier}")


# ---------------------------------------------------------------------------
# Region-granularity calibration (fused segments)
# ---------------------------------------------------------------------------

def _merge_regions(raw_segments: Sequence[List[Op]],
                   max_regions: int) -> List[List[Op]]:
    """Merge runs of single-tensor segments into at most ~max_regions
    regions (transformer-layer or bottleneck-block size)."""
    group_size = max(1, -(-len(raw_segments) // max_regions))
    regions, run, pending = [], [], 0
    for rseg in raw_segments:
        run = run + list(rseg)
        pending += 1
        if pending >= group_size:
            regions.append(run)
            run, pending = [], 0
    if run:
        regions.append(run)
    return regions


def measure_segment_costs(ff, device=None, chain: int = 8,
                          repeats: int = 3, max_regions: int = 16
                          ) -> List[Tuple[List[int], float]]:
    """Measured forward + backward seconds of fused regions of a
    compiled model: [(member op guids, seconds)].

    Standalone per-op times miss what one op does to the next, so the
    single-tensor segments (pcg/segments.py) are merged into
    ~max_regions regions, and each region's forward over random
    boundary inputs, then the gradient of the sum of the tensors that
    leave it over its boundary input and its weights, is timed as the
    executor runs it (its layouts, its compute dtype).  The sum of the
    regions is rescaled to one measurement of their union.  A region
    that cannot run on its own (ShapeError, NotImplementedError) is
    logged and left to the analytic model; any other failure
    propagates."""
    from .pcg.layout import NHWC
    from .pcg.segments import external_inputs, split_segments

    ex = ff.executor
    device = resolve_device(device if device is not None else ff.device)
    graph = ex.graph
    raw_segments, _ = split_segments(graph)
    regions = _merge_regions(raw_segments, max_regions)
    tensor_by_guid = {t.guid: t for op in graph.ops for t in op.outputs}
    consumed_by: Dict[int, set] = {}
    for op in graph.ops:
        for t in op.inputs:
            consumed_by.setdefault(t.guid, set()).add(op.guid)
    gen = torch.Generator(device=device)
    gen.manual_seed(17)

    def measure_region(region, chain_n):
        body_ops = [op for op in region if op.op_type
                    not in (OperatorType.INPUT, OperatorType.NOOP)]
        moved = sum(t.shape.shard_bytes() for op in body_ops
                    for t in list(op.outputs) + list(op.weights))
        if not body_ops or (moved < (1 << 16)
                            and all(op.flops() <= 0 for op in body_ops)):
            return None, []
        in_guids = external_inputs(body_ops)
        if not in_guids or any(g not in tensor_by_guid for g in in_guids):
            return None, []
        in_vals = []
        for g in in_guids:
            t = tensor_by_guid[g]
            v = ex._to_compute(_rand(t.shape.shard_shape, t.shape.dtype, gen,
                                     device))
            if ex.t_layout.get(g) == NHWC and v.dim() == 4:
                v = v.contiguous(memory_format=torch.channels_last)
            in_vals.append(v)
        member = {op.guid for op in body_ops}
        # backward seeds only from tensors leaving the region
        out_guids = [t.guid for op in body_ops for t in op.outputs
                     if consumed_by.get(t.guid, set()) - member
                     or not consumed_by.get(t.guid)]
        weights = {op.name: {k: w.detach().requires_grad_(True)
                             for k, w in ff._weights[op.name].items()}
                   for op in body_ops if op.name in ff._weights}
        leaves = [w for entries in weights.values()
                  for w in entries.values()]
        if in_vals[0].is_floating_point():
            in_vals[0] = in_vals[0].detach().requires_grad_(True)
            leaves.insert(0, in_vals[0])
        if not out_guids or not leaves:
            return None, []

        def run():
            env = dict(zip(in_guids, in_vals))
            for op in body_ops:
                ins = [ex._layout_in(op, t, env[t.guid]) for t in op.inputs]
                nt = op.num_trainable_weights()
                ws = [ex._to_compute(weights[op.name][s.name] if i < nt
                                     else ff._state[op.name][s.name])
                      for i, s in enumerate(op.weight_specs)]
                outs = op.forward(ins, ws, training=True, generator=gen)
                op._last_aux = None
                for pt, val in zip(op.outputs, outs):
                    env[pt.guid] = val
            loss = sum(env[g].float().sum() for g in out_guids)
            torch.autograd.grad(loss, leaves, allow_unused=True)

        try:
            with torch.enable_grad():
                run()  # the warm-up
                t = time_calls(run, device, warmup=0, repeats=repeats,
                               chain=chain_n)
        except NOT_STANDALONE as e:
            _log.info("region %s... left analytic: %r",
                      [op.name for op in body_ops][:4], e)
            return None, []
        return t, sorted(member)

    results, measured_regions = [], []
    for region in regions:
        t, member = measure_region(region, chain)
        if t is not None:
            results.append((member, t))
            measured_regions.append(region)
    # per-region sums miss what crosses the cuts; one measurement of the
    # union of the measured regions pins the scale, the regions keep the
    # relative attribution
    if len(results) > 1:
        whole = [op for r in measured_regions for op in r]
        t_whole, _ = measure_region(whole, max(2, chain // 4))
        s = sum(c for _, c in results)
        if t_whole is not None and s > 0:
            results = [(g, c * t_whole / s) for g, c in results]
    return results
