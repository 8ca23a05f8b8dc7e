"""Unity search: substitution-guided DP over graph splits.

Reference: the Unity (OSDI'22) search stack —
`GraphSearchHelper::graph_optimize` (substitution.cc:1898-1945),
`generic_sequence_optimize` (DP over sequence splits at bottleneck
nodes, cached by graph hash, substitution.cc:2430+), `base_optimize`
(budget-bounded rewrite enumeration :2229-2320), `find_split_node`
(:2094), the machine-view assignment DP (`SearchHelper`,
graph.h:170-284 with cached_graph_costs graph.h:280), and the
memory-aware lambda binary search (graph.cc:2056-2131).

Counterpart of flexflow_tpu/pcg/unity.py.  The reference enumerates PCG
rewrites (inserting Repartition/Combine/... nodes) and assigns
MachineViews by DP.  Here the
mesh-realizable strategy space is (mesh factorization) x (per-op
ShardConfig from the xfer catalog), and the DP decomposes the graph at
single-tensor bottleneck cuts exactly like generic_sequence_optimize:

  * a DP state at a cut is the crossing tensor's ParallelTensorShape
    (which encodes partition degrees + replica degree — the analogue of
    the reference's possible_split_output_tensor_shapes);
  * each segment is evaluated for every (in-state, assignment of xfer
    options to its ops) with a per-(segment-structure, in-state) cache —
    so the 12 identical BERT layers are costed once, the analogue of
    Unity's cached_graph_costs keyed by subgraph hash;
  * segment cost = sharded compute (roofline/measured OpCostModel)
    + partial-sum collectives + weight-gradient sync, i.e. the same
    terms the simulator charges;
  * the memory objective enters as `time + lambda * bytes` with the
    reference's 10-iteration binary search on lambda when the best
    strategy exceeds the per-device HBM budget.

The outer loop enumerates mesh factorizations (data x model x expert),
runs the DP for each, and ranks the resulting Strategies with the full
simulator.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..fftype import OperatorType
from ..ops.op import Op, ShapeError, ShardConfig
from ..parallel.machine import assign_axes
from ..strategy import (_PARAM_CLASSES, Strategy, apply_strategy,
                        assign_op_views, assign_views)
from ..tensor import ParallelTensor, ParallelTensorShape
from ..sim.simulator import Z3_PREFETCH_OVERLAP
from .evaluator import IncrementalEvaluator
from .graph import Graph
from .mcmc import (
    _factorizations,
    search_remat_enabled,
    search_stage_candidates,
)
from .substitution import (
    GraphXfer,
    XferChoice,
    generate_all_pcg_xfers,
    load_substitution_rules,
    op_options,
)

_MAX_SEGMENT_ASSIGNMENTS = 4096


@dataclasses.dataclass
class _SegResult:
    # (region-local topo index, choice): structural, NOT guid-keyed —
    # cached results are reused across structurally-identical regions
    # (stacked BERT layers, rewritten graph variants) whose ops differ
    assignment: Tuple[Tuple[int, XferChoice], ...]
    time: float
    memory: int
    out_shapes: Tuple[ParallelTensorShape, ...]


#: max states a region evaluation hands back to its parent (best per
#: out-shape signature first, then scalarized-cost beam)
_MAX_REGION_STATES = 64


class UnitySearch:
    def __init__(
        self,
        graph: Graph,
        num_devices: int,
        machine,
        cost_model,
        xfers: Optional[Sequence[GraphXfer]] = None,
        enable_parameter_parallel: bool = False,
        enable_attribute_parallel: bool = False,
        budget: int = 0,
        memory_budget: Optional[int] = None,
        optimizer_slots: int = 2,
        overlap_fraction: float = 0.3,
        rewrite_rules: Optional[Sequence] = None,
        rewrite_depth: int = 2,
        rewrite_max_variants: int = 8,
        event_rerank: bool = True,
        # r04: 8 (was 4) — a mis-ranked analytic #5 was never
        # re-examined by the event re-rank (VERDICT r03 Weak #4)
        event_topk: int = 8,
        sync_overlap_fraction: Optional[float] = None,
        parameter_sync: str = "allreduce",
        max_assignments: Optional[int] = None,
        enable_sample_parallel: bool = False,
        remat: bool = False,
        compute_scale: float = 1.0,
        eval_cache: bool = True,
        weight_update_sharding: bool = False,
        wus_axis: str = "data",
        zero_stage: Optional[int] = None,
        zero_stages: Optional[Sequence[int]] = None,
        enable_pipeline: bool = True,
        remat_search: bool = False,
        dcn_bucket_bytes: Optional[float] = None,
        registry=None,
    ):
        # obs.metrics.MetricsRegistry (or None): the final counters also
        # land in the run's telemetry, not only on the log line
        self.registry = registry
        self.event_rerank = event_rerank
        self.event_topk = event_topk
        self.sync_overlap = (
            sync_overlap_fraction if sync_overlap_fraction is not None
            else overlap_fraction
        )
        self.parameter_sync = parameter_sync
        # reference --simulator-segment-size: bounds per-region search
        # work; never raises the built-in cap
        self.max_assignments = max_assignments
        self.enable_sample_parallel = enable_sample_parallel
        self.graph = graph
        self._base_graph = graph
        self.rewrite_rules = rewrite_rules  # None -> built-in catalog
        self.rewrite_depth = rewrite_depth
        self.rewrite_max_variants = rewrite_max_variants
        self._variants_memo = None
        self.n = num_devices
        self.machine = machine
        self.cost_model = cost_model
        self.xfers = list(xfers) if xfers is not None else generate_all_pcg_xfers()
        self.enable_parameter_parallel = enable_parameter_parallel
        self.enable_attribute_parallel = enable_attribute_parallel
        # pipeline-parallel candidates (_pp_candidates) can be switched
        # off by callers whose carried state cannot map onto the GPipe
        # stacked weight layout (the supervisor's elastic re-search —
        # checkpoint reshard-restore is per-op-keyed)
        self.enable_pipeline = enable_pipeline
        self.budget = budget  # 0 = unbounded; else cap on segment evaluations
        self.memory_budget = memory_budget
        self.optimizer_slots = optimizer_slots
        self.overlap = overlap_fraction
        self.evals = 0  # segment-assignment evaluations (budget counter)
        self.cache_hits = 0
        # (segment structural sig, in-shapes sig) -> List[_SegResult]
        self._seg_cache: Dict[Tuple, List[_SegResult]] = {}
        self._segments_memo = None
        self._options_memo: Dict[Tuple, Dict[int, List[XferChoice]]] = {}
        from ..sim.simulator import DEFAULT_DCN_BUCKET_BYTES, Simulator

        self.remat = remat
        # ZeRO ladder: zero_stage is the BASE stage the DP costs every
        # segment under; zero_stages (when longer than one) are the
        # rungs each collected candidate is additionally re-scored at
        # through the memoized evaluator (_stage_variants), so the
        # search — not the user — picks the memory/comm trade-off.
        # weight_update_sharding=True is the deprecated stage-1 alias.
        self.zero_stage = (
            int(zero_stage) if zero_stage is not None
            else (1 if weight_update_sharding else 0)
        )
        self.zero_stages = (
            tuple(zero_stages) if zero_stages else (self.zero_stage,)
        )
        self.weight_update_sharding = self.zero_stage >= 1
        self.wus_axis = wus_axis
        # searched remat (docs/PERF.md): each collected candidate is
        # additionally re-scored at a bounded family of per-segment
        # remat plans (_remat_variants) — the _stage_variants shape for
        # the activation term of the memory ladder
        self.remat_search = remat_search
        self._sim = Simulator(machine, cost_model,
                              overlap_fraction=overlap_fraction,
                              optimizer_slots=optimizer_slots,
                              sync_overlap_fraction=sync_overlap_fraction,
                              parameter_sync=parameter_sync,
                              remat=remat,
                              compute_scale=compute_scale,
                              zero_stage=self.zero_stage,
                              wus_axis=wus_axis,
                              dcn_bucket_bytes=(
                                  DEFAULT_DCN_BUCKET_BYTES
                                  if dcn_bucket_bytes is None
                                  else dcn_bucket_bytes))
        # multi-slice hierarchy (topology/hierarchy.py): each collected
        # candidate is also re-scored at every legal placement (the
        # mesh axis that spans the slices) through the memoized
        # evaluator, as the ZeRO-stage variants are; other machines skip
        # the expansion
        self.slices = max(1, int(getattr(machine, "slices", 1) or 1))
        self._hier = self.slices > 1 and hasattr(machine, "collective_cost")
        # the mesh the sequence DP is costing (in its axis order, which
        # decides which axes span nodes); None outside _dp
        self._dp_mesh: Optional[Dict[str, int]] = None
        # memoized whole-strategy evaluator per (possibly rewritten)
        # graph variant: the sp/sample candidate families and the
        # memory-aware lambda binary search revisit identical strategies
        # across optimize() passes — those re-evaluations become memo
        # lookups (pcg/evaluator.py)
        self.eval_cache = eval_cache
        self._evaluators: Dict[Graph, "IncrementalEvaluator"] = {}

    # ------------------------------------------------------------------
    # graph splitting (reference find_split_node substitution.cc:2094)
    # ------------------------------------------------------------------
    def _segments(self) -> Tuple[List[List[Op]], List[Optional[int]]]:
        """Split topo order at single-tensor cuts (cached — the graph is
        immutable for the lifetime of a search); pcg/segments.py holds
        the shared implementation."""
        if self._segments_memo is None:
            from .segments import split_segments

            self._segments_memo = split_segments(self.graph)
        return self._segments_memo

    # ------------------------------------------------------------------
    # segment evaluation (reference SearchHelper::graph_cost + simulator)
    # ------------------------------------------------------------------
    def _seg_sig(self, seg: List[Op], boundary_in: List[int]) -> Tuple:
        """Structural signature: identical stacked layers share it."""
        from .segments import segment_signature

        return segment_signature(seg, boundary_in)

    def _comm_time(self, kind: str, size: int, group: int,
                   spans_nodes: bool = False) -> float:
        m = self.machine
        if hasattr(m, "axis_allreduce_time"):  # axis-aware (GpuNodeModel)
            if kind == "allreduce":
                return m.axis_allreduce_time(size, group, spans_nodes)
            return m.axis_allgather_time(size, group, spans_nodes)
        g = list(range(group))
        if kind == "allreduce":
            return m.allreduce_time(size, g)
        return m.allgather_time(size, g)

    def _op_cost(self, op: Op, training: bool = True,
                 mesh_axes: Optional[Dict[str, int]] = None
                 ) -> Tuple[float, int]:
        """(time, per-device bytes) for one instantiated op — the same
        terms Simulator.simulate charges per op.  Given the mesh, a
        collective whose group holds an axis spanning nodes is costed
        across nodes (the op's views are assigned to tell)."""
        span = self._sim.spanning_axes(mesh_axes)
        if span:
            assign_op_views(op, mesh_axes)
        cm = self.cost_model.cost(op)
        t = cm.forward_time + (cm.backward_time if training else 0.0)
        comm = 0.0
        sync = 0.0
        if op.outputs:
            out_rep = op.outputs[0].shape.replica_degree
            in_rep = max((x.shape.replica_degree for x in op.inputs), default=1)
            if out_rep > in_rep:  # contraction-dim partials -> psum
                k = out_rep // max(1, in_rep)
                c = self._comm_time("allreduce", op.outputs[0].shape.shard_bytes(), k,
                                    self._sim.partial_crosses(op, span))
                comm += 2.0 * c if training else c
        gather = 0.0
        mem = 0
        stage = self.zero_stage
        for w in op.weights:
            rep = w.shape.replica_degree
            sb = w.shape.shard_bytes()
            # Simulator.wus_group carries every guard (knob, sync mode,
            # per-leaf divisibility); no mesh context at this DP stage,
            # so the group falls back to the replica degree — exact on
            # pure-dp meshes, and the authoritative evaluator re-scores
            # with mesh_axes
            g = self._sim.wus_group(w) if w.create_gradients else 1
            if training and rep > 1 and w.create_gradients:
                if g > 1:
                    # reduce-scatter + the stage's gathers (the
                    # post-update gather takes the generic comm credit
                    # like Simulator.simulate_ops; the stage-3
                    # per-layer gathers take the prefetch credit)
                    s, x, gx = self._sim.weight_update_comm(
                        sb, g, cross=self.wus_axis in span)
                    sync += s
                    comm += x
                    gather += gx
                else:
                    sync += self._sim.sync_time(
                        sb, rep, self._sim.weight_rep_crosses(w, span))
            if not training:
                mem += sb
            elif g > 1:
                # ZeRO ladder residency: slots 1/g (stage 1+), grads
                # 1/g (stage 2+), master 1/g (stage 3; the 2-layer
                # gather window is charged by the authoritative
                # evaluator, not per-op here)
                master = sb // g if stage >= 3 else sb
                grads = sb // g if stage >= 2 else sb
                mem += master + grads + self.optimizer_slots * (sb // g)
            else:
                mem += sb * (2 + self.optimizer_slots)
        for o in op.outputs:
            mem += o.shape.shard_bytes()
        time = (t + comm * (1.0 - self.overlap)
                + sync * (1.0 - self.sync_overlap)
                + gather * (1.0 - Z3_PREFETCH_OVERLAP))
        return time, mem

    def _realizable(self, shapes, mesh_axes: Dict[str, int]) -> bool:
        """Every shape's degrees must factor onto the mesh axes — the
        reference's get_valid_machine_views filter (graph.h:205-210)."""
        try:
            for s in shapes:
                assign_axes(s, mesh_axes)
            return True
        except ValueError:
            return False

    def _chain_apply(
        self, shape: ParallelTensorShape, chain, mesh_axes: Dict[str, int],
        training: bool,
    ) -> Tuple[ParallelTensorShape, float]:
        """Propagate + cost a parallel-op chain on an output tensor."""
        from ..parallel.parallel_op import PARALLEL_OP_KINDS

        time = 0.0
        for kind, items in chain:
            params = _PARAM_CLASSES[kind](**dict(items))
            pop = PARALLEL_OP_KINDS[kind](params, [ParallelTensor(shape)])
            c = self._sim.xfer_cost(pop, mesh_axes)
            time += (2.0 * c if training else c) * (1.0 - self.overlap)
            shape = pop.outputs[0].shape
        return shape, time

    def _options_by_op(self, mesh_axes: Dict[str, int]) -> Dict[int, List[XferChoice]]:
        key = (id(self.graph), tuple(sorted(mesh_axes.items())))
        memo = self._options_memo.get(key)
        if memo is not None:
            return memo
        out = {}
        for op in self.graph.ops:
            opts = op_options(
                op, mesh_axes, self.xfers,
                self.enable_parameter_parallel, self.enable_attribute_parallel,
            )
            if len(opts) > 1:
                out[op.guid] = opts
        self._options_memo[key] = out
        return out

    # -- region evaluation: enumerate / horizontal / vertical ----------
    #
    # Reference: SearchHelper::graph_cost's DP over sequential, vertical
    # and horizontal graph splits (graph.h:170-284, split_at_node /
    # split_horizontal graph.h:346-349).  A region whose joint
    # assignment space exceeds _MAX_SEGMENT_ASSIGNMENTS is decomposed:
    # horizontally into independent branch components (Inception-style
    # parallel branches get per-branch choices, combined only through
    # their output shapes at the join), else vertically at a
    # multi-tensor topo cut; only irreducible single-op regions fall
    # back to exhaustive/grouped enumeration.

    def _boundary_in(self, seg: List[Op]) -> List[int]:
        """External input tensor guids, ordered by first consumption."""
        from .segments import external_inputs

        return external_inputs(seg)

    def _out_refs(self, seg: List[Op], out_guids: List[int]) -> Tuple:
        """Structural refs of exported tensors (cache-key component)."""
        ref = {}
        for j, op in enumerate(seg):
            for oi, t in enumerate(op.outputs):
                ref[t.guid] = (j, oi)
        return tuple(ref[g] for g in out_guids)

    def _n_assignments(self, seg, options) -> int:
        total = 1
        for op in seg:
            opts = options.get(op.guid)
            if opts:
                total *= len(opts)
        return total

    def _cap(self) -> int:
        """Per-region assignment cap; --simulator-segment-size can only
        lower the built-in bound (its reference role: limit per-segment
        simulation work)."""
        cap = _MAX_SEGMENT_ASSIGNMENTS
        if self.max_assignments is not None:
            cap = min(cap, max(1, self.max_assignments))
        return cap

    def _prune_states(self, results: List[_SegResult], lam: float) -> List[_SegResult]:
        """Best result per out-shape signature, then a scalarized-cost
        beam of _MAX_REGION_STATES (the analogue of the reference's
        bounded per-subgraph state sets)."""
        best: Dict[Tuple, _SegResult] = {}
        for r in results:
            cur = best.get(r.out_shapes)
            if cur is None or (r.time + lam * r.memory) < (cur.time + lam * cur.memory):
                best[r.out_shapes] = r
        out = sorted(best.values(), key=lambda r: r.time + lam * r.memory)
        return out[:_MAX_REGION_STATES]

    def _eval_region(
        self,
        seg: List[Op],
        shape_env: Dict[int, ParallelTensorShape],
        out_guids: List[int],
        options: Dict[int, List[XferChoice]],
        input_dp: int,
        axes_sig: Tuple,
        lam: float,
    ) -> List[_SegResult]:
        boundary_in = self._boundary_in(seg)
        in_shapes = tuple(shape_env[g] for g in boundary_in)
        sig = (
            self._seg_sig(seg, boundary_in),
            self._out_refs(seg, out_guids),
            in_shapes, input_dp, axes_sig, lam,
            tuple(self._dp_mesh.items()) if self._dp_mesh else None,
        )
        cached = self._seg_cache.get(sig)
        if cached is not None:
            self.cache_hits += 1
            return cached
        n = self._n_assignments(seg, options)
        results: Optional[List[_SegResult]] = None
        if n > self._cap() and len(seg) >= 2:
            results = self._eval_horizontal(
                seg, shape_env, out_guids, options, input_dp, axes_sig, lam
            )
            if results is None:
                results = self._eval_vertical(
                    seg, shape_env, out_guids, options, input_dp, axes_sig, lam
                )
        if results is None:
            results = self._eval_enumerate(
                seg, shape_env, out_guids, options, input_dp, axes_sig
            )
        results = self._prune_states(results, lam)
        self._seg_cache[sig] = results
        return results

    def _components(self, seg: List[Op]) -> List[List[Op]]:
        """Weakly-connected components of the region's INTERNAL dataflow
        (edges through externally-produced tensors don't connect)."""
        parent = {op.guid: op.guid for op in seg}

        def find(g):
            while parent[g] != g:
                parent[g] = parent[parent[g]]
                g = parent[g]
            return g

        producer = {t.guid: op.guid for op in seg for t in op.outputs}
        for op in seg:
            for t in op.inputs:
                p = producer.get(t.guid)
                if p is not None:
                    ra, rb = find(p), find(op.guid)
                    if ra != rb:
                        parent[ra] = rb
        comps: Dict[int, List[Op]] = {}
        for op in seg:
            comps.setdefault(find(op.guid), []).append(op)
        return list(comps.values())

    def _eval_horizontal(
        self, seg, shape_env, out_guids, options, input_dp, axes_sig, lam
    ) -> Optional[List[_SegResult]]:
        """Peel the join op and evaluate independent branch components
        separately (reference split_horizontal, graph.h:346-349)."""
        sink, rest = seg[-1], seg[:-1]
        comps = self._components(rest)
        if len(comps) <= 1:
            return None
        sink_in = {t.guid for t in sink.inputs}
        out_set = set(out_guids)
        parent_pos = {op.guid: j for j, op in enumerate(seg)}
        combos: List[Tuple[Tuple, float, int, Dict[int, ParallelTensorShape]]] = [
            ((), 0.0, 0, {})
        ]
        for comp in comps:
            comp_outs = [
                t.guid
                for op in comp
                for t in op.outputs
                if t.guid in sink_in or t.guid in out_set
            ]
            rs = self._eval_region(
                comp, shape_env, comp_outs, options, input_dp, axes_sig, lam
            )
            if not rs:
                return []
            # child indices are local to the component; lift to parent
            lift = [parent_pos[op.guid] for op in comp]
            new_combos = []
            for asg0, t0, m0, env0 in combos:
                for r in rs:
                    env = dict(env0)
                    env.update(zip(comp_outs, r.out_shapes))
                    asg = tuple((lift[j], c) for j, c in r.assignment)
                    new_combos.append(
                        (asg0 + asg, t0 + r.time, m0 + r.memory, env)
                    )
            # keep the combination frontier bounded
            new_combos.sort(key=lambda c: c[1] + lam * c[2])
            combos = new_combos[:_MAX_REGION_STATES]
        sink_idx = len(seg) - 1
        results: List[_SegResult] = []
        for asg0, t0, m0, env0 in combos:
            env = dict(shape_env)
            env.update(env0)
            sink_outs = [g for g in out_guids if g not in env0]
            for r in self._eval_region(
                [sink], env, sink_outs, options, input_dp, axes_sig, lam
            ):
                env2 = dict(env)
                env2.update(zip(sink_outs, r.out_shapes))
                asg = tuple((sink_idx, c) for _, c in r.assignment)
                results.append(
                    _SegResult(
                        assignment=asg0 + asg,
                        time=t0 + r.time,
                        memory=m0 + r.memory,
                        out_shapes=tuple(env2[g] for g in out_guids),
                    )
                )
        return results

    def _eval_vertical(
        self, seg, shape_env, out_guids, options, input_dp, axes_sig, lam
    ) -> List[_SegResult]:
        """Split at a mid topo position; the crossing state is the tuple
        of ALL crossing tensor shapes (reference split_at_node's
        non-dominator generalization)."""
        k = len(seg) // 2
        first, second = seg[:k], seg[k:]
        consumed2 = {t.guid for op in second for t in op.inputs}
        out_set = set(out_guids)
        first_out = [
            t.guid
            for op in first
            for t in op.outputs
            if t.guid in consumed2 or t.guid in out_set
        ]
        results: List[_SegResult] = []
        for r1 in self._eval_region(
            first, shape_env, first_out, options, input_dp, axes_sig, lam
        ):
            env = dict(shape_env)
            env.update(zip(first_out, r1.out_shapes))
            second_out = [g for g in out_guids if g not in env]
            for r2 in self._eval_region(
                second, env, second_out, options, input_dp, axes_sig, lam
            ):
                env2 = dict(env)
                env2.update(zip(second_out, r2.out_shapes))
                asg2 = tuple((j + k, c) for j, c in r2.assignment)
                results.append(
                    _SegResult(
                        assignment=r1.assignment + asg2,
                        time=r1.time + r2.time,
                        memory=r1.memory + r2.memory,
                        out_shapes=tuple(env2[g] for g in out_guids),
                    )
                )
        return results

    def _enumerate_assignments(
        self, seg: List[Op], options: Dict[int, List[XferChoice]]
    ) -> List[Tuple[Tuple[int, XferChoice], ...]]:
        cand = [(j, options[op.guid]) for j, op in enumerate(seg) if op.guid in options]
        if not cand:
            return [()]
        total = 1
        for _, opts in cand:
            total *= len(opts)
        if total > self._cap():
            # irreducible over-cap region: group identical (type, params)
            # ops and force a uniform choice per group
            from ..logger import search_logger as slog

            slog.debug(
                "assignment cap hit on irreducible region (%d ops, %d "
                "assignments > %d): grouping identical ops",
                len(seg), total, self._cap(),
            )
            groups: Dict[Tuple, List[int]] = {}
            for j, _ in cand:
                key = (seg[j].op_type, seg[j].params)
                groups.setdefault(key, []).append(j)
            gkeys = list(groups)
            gopts = [options[seg[groups[k][0]].guid] for k in gkeys]
            out = []
            for combo in itertools.product(*gopts):
                a = []
                for k, cfg in zip(gkeys, combo):
                    a.extend((j, cfg) for j in groups[k])
                out.append(tuple(a))
            return out
        return [
            tuple(zip((j for j, _ in cand), combo))
            for combo in itertools.product(*(opts for _, opts in cand))
        ]

    def _eval_enumerate(
        self,
        seg: List[Op],
        shape_env: Dict[int, ParallelTensorShape],
        out_guids: List[int],
        options: Dict[int, List[XferChoice]],
        input_dp: int,
        axes_sig: Tuple,
    ) -> List[_SegResult]:
        mesh_axes = dict(axes_sig)
        results: List[_SegResult] = []
        for assignment in self._enumerate_assignments(seg, options):
            if self.budget and self.evals >= self.budget:
                if results:
                    break
            self.evals += 1
            choice_of = dict(assignment)
            shapes: Dict[int, ParallelTensorShape] = dict(shape_env)
            time = 0.0
            mem = 0
            ok = True
            for j, op in enumerate(seg):
                if op.op_type == OperatorType.INPUT:
                    s = op.outputs[0].shape
                    if input_dp > 1:
                        if s.logical_shape and s.logical_shape[0] % input_dp == 0:
                            s = s.data_parallel(input_dp)
                        else:
                            ok = False
                            break
                    shapes[op.outputs[0].guid] = s
                    continue
                choice = choice_of.get(j, XferChoice())
                try:
                    new_inputs = [ParallelTensor(shapes[t.guid]) for t in op.inputs]
                    new_op = type(op)(
                        op.params, new_inputs, name=op.name,
                        shard=choice.shard, **op.ctor_kwargs(),
                    )
                except (ShapeError, ValueError):
                    ok = False
                    break
                out_shapes = [pt.shape for pt in new_op.outputs]
                chain_time = 0.0
                if choice.out_chain:
                    try:
                        out_shapes[0], chain_time = self._chain_apply(
                            out_shapes[0], choice.out_chain, mesh_axes, True
                        )
                    except (ShapeError, ValueError):
                        ok = False
                        break
                if not self._realizable(
                    out_shapes + [w.shape for w in new_op.weights], mesh_axes
                ):
                    ok = False
                    break
                t, m = self._op_cost(new_op, mesh_axes=self._dp_mesh)
                time += t + chain_time
                mem += m
                for pt, s in zip(op.outputs, out_shapes):
                    shapes[pt.guid] = s
            if not ok:
                continue
            results.append(
                _SegResult(
                    assignment=assignment,
                    time=time,
                    memory=mem,
                    out_shapes=tuple(shapes[g] for g in out_guids),
                )
            )
        return results

    # ------------------------------------------------------------------
    # sequence DP (reference generic_sequence_optimize substitution.cc:2430)
    # ------------------------------------------------------------------
    def _dp(self, mesh_axes: Dict[str, int], dp_degree: int,
            lam: float) -> Optional[Tuple[Dict[str, ShardConfig], Dict, float, int]]:
        options = self._options_by_op(mesh_axes)
        axes_sig = tuple(sorted(mesh_axes.items()))
        self._dp_mesh = dict(mesh_axes)
        try:
            return self._dp_states(mesh_axes, dp_degree, lam, options,
                                   axes_sig)
        finally:
            self._dp_mesh = None

    def _dp_states(self, mesh_axes, dp_degree, lam, options, axes_sig):
        segments, boundaries = self._segments()
        # states: in-shapes tuple -> (objective, time, mem,
        #         {opname: ShardConfig}, {tensor name: edge chain})
        states: Dict[Tuple, Tuple] = {(): (0.0, 0.0, 0, {}, {})}
        incoming: List[int] = []  # guids crossing into current segment
        for seg, out_guid in zip(segments, boundaries):
            out_guids = [out_guid] if out_guid is not None else []
            new_states: Dict[Tuple, Tuple] = {}
            for in_shapes, (obj0, t0, m0, asg0, edges0) in states.items():
                shape_env = dict(zip(incoming, in_shapes))
                for res in self._eval_region(
                    seg, shape_env, out_guids, options, dp_degree,
                    axes_sig, lam,
                ):
                    obj = obj0 + res.time + lam * res.memory
                    key = res.out_shapes
                    cur = new_states.get(key)
                    if cur is None or obj < cur[0]:
                        asg = dict(asg0)
                        edges = dict(edges0)
                        for j, choice in res.assignment:
                            op = seg[j]
                            if not choice.shard.is_trivial():
                                asg[op.name] = choice.shard
                            if choice.out_chain:
                                edges[op.outputs[0].name] = (
                                    choice.chain_as_lists()
                                )
                        new_states[key] = (
                            obj, t0 + res.time, m0 + res.memory, asg, edges
                        )
            if not new_states:
                return None
            states = new_states
            incoming = out_guids
        best = min(states.values(), key=lambda v: v[0])
        return best[3], best[4], best[1], best[2]

    # ------------------------------------------------------------------
    # top level (reference graph_optimize_task graph.cc:2046-2160)
    # ------------------------------------------------------------------
    def _mesh_axes(self, dp: int, tp: int, ep: int) -> Dict[str, int]:
        axes = {}
        if dp > 1:
            axes["data"] = dp
        if tp > 1:
            axes["model"] = tp
        if ep > 1:
            axes["expert"] = ep
        if not axes:
            axes["data"] = 1
        return axes

    def _mesh_variants(self, dp: int, tp: int, ep: int):
        """Mesh-axes candidates for one (dp, tp, ep) factorization: the
        plain mesh, plus — for composite tp — a FACTORED model axis
        ({"model0": a, "model1": b}) under which ops may shard at
        different degrees, i.e. per-op submesh machine views (reference
        machine_view.h:31; SURVEY §7 hard-part 4's mesh-realizable
        subset)."""
        yield self._mesh_axes(dp, tp, ep)
        if tp > 3:
            a = next((p for p in range(2, tp) if tp % p == 0), tp)
            if a < tp:
                axes = {}
                if dp > 1:
                    axes["data"] = dp
                axes["model0"] = tp // a
                axes["model1"] = a
                if ep > 1:
                    axes["expert"] = ep
                yield axes

    def _build_strategy(self, mesh_axes: Dict[str, int], dp: int,
                        shard_configs: Dict[str, ShardConfig],
                        edges: Optional[Dict] = None) -> Strategy:
        s = Strategy(mesh_axes=mesh_axes, shard_configs=dict(shard_configs))
        if dp > 1:
            s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": dp})]
        for tname, chain in (edges or {}).items():
            s.edge_ops[tname] = chain
        return s

    def _variants(self):
        """Rewritten-graph candidates (reference base_optimize's bounded
        rewrite enumeration, substitution.cc:2229-2320); [(graph, trace)]
        with the original graph first."""
        if self._variants_memo is None:
            from .rewrite import enumerate_variants, generate_rewrite_rules

            rules = (list(self.rewrite_rules) if self.rewrite_rules is not None
                     else generate_rewrite_rules())
            if self.rewrite_max_variants <= 1 or not rules:
                self._variants_memo = [(self._base_graph, [])]
            else:
                self._variants_memo = enumerate_variants(
                    self._base_graph, rules,
                    max_depth=self.rewrite_depth,
                    max_variants=self.rewrite_max_variants,
                )
        return self._variants_memo

    def _set_graph(self, graph: Graph):
        if graph is self.graph:
            return
        self.graph = graph
        self._segments_memo = None

    def _evaluator(self) -> IncrementalEvaluator:
        """Memoized evaluator for the CURRENT self.graph (keyed by the
        Graph object itself — identity hash — which also pins the graph
        alive for the evaluator's cached records)."""
        ev = self._evaluators.get(self.graph)
        if ev is None:
            ev = IncrementalEvaluator(self.graph, self._sim, training=True,
                                      use_cache=self.eval_cache)
            self._evaluators[self.graph] = ev
        return ev

    def eval_stats(self) -> Dict[str, float]:
        """Aggregate evaluator counters across graph variants, plus the
        segment-DP cache counters — the search-observability payload
        attached to returned strategies."""
        agg: Dict[str, float] = {}
        for ev in self._evaluators.values():
            for k, v in ev.stats.as_dict().items():
                agg[k] = agg.get(k, 0) + v
        n_evals = agg.get("evals", 0)
        agg["evals_per_sec"] = (
            n_evals / agg["eval_seconds"] if agg.get("eval_seconds") else 0.0
        )
        agg["mean_dirty_frontier"] = (
            agg.get("dirty_ops", 0) / agg["delta_evals"]
            if agg.get("delta_evals") else 0.0
        )
        agg["segment_evals"] = self.evals
        agg["segment_cache_hits"] = self.cache_hits
        agg["term_hits"] = self._sim.term_hits
        agg["term_misses"] = self._sim.term_misses
        agg["op_cost_hits"] = getattr(self.cost_model, "cost_hits", 0)
        # the rewritten graphs a TASO catalog rule's match produced (the
        # built-in rules' are not counted)
        agg["catalog_variants"] = sum(
            any(str(name).startswith("taso_rule_") for name, _ in trace)
            for _, trace in (self._variants_memo or ()))
        return agg

    def _stage_variants(self, strategy: Strategy, time: float,
                        mem: int) -> List[Tuple[Strategy, float, int]]:
        """The candidate scored at every allowed ZeRO stage:
        [(strategy', time', mem')].  The base stage keeps the caller's
        analytic (time, mem); other rungs correct them by the memoized
        evaluator's stage delta (the applied graph is stage-invariant,
        so the delta is exactly the ladder's update/residency terms).
        Ascending stage order + strict objective comparison downstream
        keep ties on the LOWEST stage."""
        out = [(strategy, time, mem)]
        extra = [s for s in self.zero_stages if s != self.zero_stage]
        if not extra:
            return out
        base = self._evaluator().evaluate(strategy)
        if base is None:
            return out
        bt, bm = base.total_time, base.per_device_memory
        for s in sorted(extra):
            cand = dataclasses.replace(strategy, zero_stage=s)
            res = self._evaluator().evaluate(cand)
            if res is None:
                continue
            out.append((cand, time + res.total_time - bt,
                        mem + res.per_device_memory - bm))
        return out

    def _remat_variants(self, strategy: Strategy, time: float, mem: int,
                        lam: float) -> List[Tuple[Strategy, float, int]]:
        """The candidate re-scored at a bounded family of per-segment
        remat plans (docs/PERF.md "Searched rematerialization"):
        [(strategy', time', mem')].  Per pure segment, a single-ON plan
        prices its marginal (recompute seconds vs activation bytes);
        segments then stack in objective-ascending order (each prefix
        plan evaluated through the memoized evaluator — a zero-frontier
        delta re-sum, the applied graph is plan-invariant), plus the
        all-ON plan (the legacy --remat shape).  No plan = the dense
        base, which always stays in the family, so remat is only ever
        chosen when the objective says it wins."""
        out = [(strategy, time, mem)]
        if not self.remat_search or strategy.pipeline:
            return out
        base = self._evaluator().evaluate(strategy)
        if base is None:
            return out
        from ..sim.simulator import MAX_REMAT_SEGMENTS, remat_segments

        idx = [
            i for i, (_, pure) in enumerate(remat_segments(base.ops))
            if pure
        ][:MAX_REMAT_SEGMENTS]
        if not idx:
            return out
        bt, bm = base.total_time, base.per_device_memory

        def scored(plan):
            cand = dataclasses.replace(strategy, remat=sorted(plan))
            res = self._evaluator().evaluate(cand)
            if res is None:
                return None
            return (cand, time + res.total_time - bt,
                    mem + res.per_device_memory - bm)

        marginals = []
        for i in idx:
            r = scored([i])
            if r is not None:
                marginals.append((self._objective(r[1], r[2], lam), i))
        marginals.sort()
        prefix: List[int] = []
        for _, i in marginals:
            prefix.append(i)
            r = scored(prefix)
            if r is not None:
                out.append(r)
        if len(prefix) != len(idx):
            r = scored(idx)  # all-ON even when some marginals pruned
            if r is not None:
                out.append(r)
        return out

    def _placement_variants(self, strategy: Strategy, time: float,
                            mem: int) -> List[Tuple[Strategy, float, int]]:
        """The candidate re-scored at every legal multi-slice placement:
        [(strategy', time', mem')].  The default placement keeps the
        caller's (time, mem); the others correct them by the memoized
        evaluator's placement delta (the applied graph does not depend
        on the placement, so the delta is the re-cost of the tiers).
        Off a hierarchy the candidate comes back alone."""
        out = [(strategy, time, mem)]
        if not self._hier or strategy.pipeline:
            return out
        from ..topology.hierarchy import legal_placements, resolve_placement

        legal = legal_placements(strategy.mesh_axes, self.slices)
        default = resolve_placement(strategy.mesh_axes, self.slices)
        extra = [p for p in legal if p != default]
        if not extra:
            return out
        base = self._evaluator().evaluate(strategy)
        if base is None:
            return out
        bt, bm = base.total_time, base.per_device_memory
        for p in extra:
            cand = dataclasses.replace(strategy, placement=p)
            res = self._evaluator().evaluate(cand)
            if res is None:
                continue
            out.append((cand, time + res.total_time - bt,
                        mem + res.per_device_memory - bm))
        return out

    def _optimize_graph(self, lam: float, collector: List[Tuple]):
        """Append every valid (obj, strategy, graph) for the CURRENT
        self.graph to collector (mesh factorizations, sp, pp) — each
        non-pipeline candidate expanded across the legal placements (on
        a hierarchy), the allowed ZeRO stages and remat plans."""
        from ..logger import search_logger as slog

        has_moe = any(op.op_type == OperatorType.GROUP_BY for op in self.graph.ops)
        best_obj = math.inf

        def collect(strategy, time, mem, label):
            nonlocal best_obj
            for pcand, pt, pm in self._placement_variants(strategy, time,
                                                          mem):
                for scand, st, sm in self._stage_variants(pcand, pt, pm):
                    for cand, ct, cm in self._remat_variants(scand, st, sm,
                                                             lam):
                        obj = self._objective(ct, cm, lam)
                        slog.debug(
                            "candidate %s%s%s%s: obj=%.3g%s", label,
                            (f" zero{cand.zero_stage}"
                             if cand.zero_stage is not None else ""),
                            (f" place={cand.placement}"
                             if cand.placement is not None else ""),
                            (f" remat={len(cand.remat)}on"
                             if cand.remat else ""),
                            obj, " *best*" if obj < best_obj else "",
                        )
                        best_obj = min(best_obj, obj)
                        collector.append((obj, cand, self.graph))

        for dp, tp, ep in _factorizations(self.n, allow_expert=has_moe):
            for mesh_axes in self._mesh_variants(dp, tp, ep):
                if tp > 1 and not self._options_by_op(mesh_axes):
                    continue  # no op can use the model axis
                r = self._dp(mesh_axes, dp, lam)
                if r is None:
                    continue
                shard_configs, edges, time, mem = r
                strategy = self._build_strategy(
                    mesh_axes, dp, shard_configs, edges
                )
                # validate with the strategy actually applied — through
                # the memoized evaluator, so the lambda binary search's
                # repeat passes validate revisited candidates by lookup
                if self._evaluator().evaluate(strategy) is None:
                    continue
                collect(strategy, time, mem,
                        f"{mesh_axes} time={time * 1e3:.3g}ms "
                        f"mem={mem / 2**20:.1f}MB")
        for strategy, time, mem, label in self._sp_candidates():
            collect(strategy, time, mem, label)
        # pipeline candidates stay on the base stage: their memory
        # model scales block terms by 1/S, which the evaluator's stage
        # delta cannot see (docs/SEARCH.md)
        for strategy, obj, label in self._pp_candidates(lam):
            slog.debug(
                "candidate %s: obj=%.3g%s", label, obj,
                " *best*" if obj < best_obj else "",
            )
            best_obj = min(best_obj, obj)
            collector.append((obj, strategy, self.graph))
        for strategy, time, mem, label in self._sample_candidates():
            collect(strategy, time, mem, label)

    def _event_objective(
        self, strategy: Strategy, graph: Graph, lam: float
    ) -> Optional[float]:
        """Contention-aware objective from the event-driven taskgraph
        simulator (reference simulate_runtime, simulator.cc:822-1250;
        ring expansion :1690-1800) — replaces the analytic model's flat
        overlap credit for the final top-K ranking.

        Pipeline candidates stay on the same scale: the event sim runs
        the applied graph WITHOUT the GPipe schedule (it cannot express
        it), then the block region's share of the makespan is scaled by
        the bubble factor (M+S-1)/(M*S) — so pp is never compared via
        its optimistic analytic number against others' event numbers."""
        from ..logger import search_logger as slog

        try:
            from ..sim.taskgraph import TaskGraphSimulator

            g = apply_strategy(graph, strategy)
            assign_views(g, strategy.mesh_axes)
            res = TaskGraphSimulator(self.machine, self.cost_model).simulate(
                g, strategy.mesh_axes, training=True
            )
            time = res.total_time
            op_scale = None
            if strategy.pipeline:
                from ..parallel.pipeline_plan import plan_pipeline

                plan = plan_pipeline(g, strategy.pipeline, strategy.mesh_axes)
                block_guids = {
                    op.guid for blk in plan.blocks for op in blk
                }
                t_block = t_rest = 0.0
                for op in g.topo_order():
                    if op.op_type == OperatorType.INPUT or op.is_parallel_op():
                        continue
                    t, _ = self._op_cost(op)
                    if op.guid in block_guids:
                        t_block += t
                    else:
                        t_rest += t
                total = t_block + t_rest
                frac = t_block / total if total > 0 else 0.0
                S = plan.num_stages
                M = plan.num_microbatches
                factor = (M + S - 1) / (M * S)
                time = time * ((1.0 - frac) + frac * factor)

                def op_scale(op, _g=block_guids, _s=S):  # noqa: E731
                    return 1.0 / _s if op.guid in _g else 1.0

            # the event simulator models none of the ladder's stage
            # terms (sharded update, opt_xfer, per-layer gather_xfer)
            # nor the hierarchy's tiers, while the memory below IS
            # stage- and placement-aware — uncorrected, the highest
            # stage of a mesh would always win the rerank (same event
            # time, less memory).  Correct the makespan with the
            # analytic stage and placement delta from the memoized
            # evaluator, the same delta the variant expansions priced
            # the candidate with.
            if ((strategy.zero_stage is not None
                    and strategy.zero_stage != self.zero_stage)
                    or strategy.placement is not None
                    or strategy.remat is not None):
                prev = self.graph
                try:
                    self._set_graph(graph)
                    rb = self._evaluator().evaluate(dataclasses.replace(
                        strategy, zero_stage=self.zero_stage,
                        placement=None, remat=None))
                    rs = self._evaluator().evaluate(strategy)
                finally:
                    self._set_graph(prev)
                if rb is not None and rs is not None:
                    time += rs.total_time - rb.total_time
            if strategy.remat is not None and op_scale is None:
                # plan-carrying candidates (never pipeline) price the
                # remat-aware activation accounting
                mem = self._sim.remat_memory_from_terms(
                    g.topo_order(), strategy.mesh_axes, strategy.remat,
                    training=True, zero_stage=strategy.zero_stage,
                    placement=strategy.placement,
                )
            else:
                mem = self._sim.per_device_memory(
                    g, training=True, op_scale=op_scale,
                    mesh_axes=strategy.mesh_axes,
                    zero_stage=strategy.zero_stage,
                    placement=strategy.placement,
                )
            return self._objective(time, mem, lam)
        except (ShapeError, ValueError) as e:
            # a candidate the event model cannot lay out keeps its
            # analytic objective; anything else (a failed measurement on
            # the card) propagates
            slog.info(
                "event rerank unavailable for %s: %s: %s",
                strategy.mesh_axes, type(e).__name__, e,
            )
            return None

    def optimize(self, lam: float = 0.0) -> Optional[Strategy]:
        from ..logger import search_logger as slog

        collector: List[Tuple] = []
        with slog.enter(f"unity optimize n={self.n} lambda={lam:g}"):
            for graph, trace in self._variants():
                self._set_graph(graph)
                if trace:
                    slog.debug("rewritten variant: %s",
                               "+".join(f"{n}[{i}]" for n, i in trace))
                before = len(collector)
                self._optimize_graph(lam, collector)
                for i in range(before, len(collector)):
                    collector[i][1].rewrites = [list(r) for r in trace]
            self._set_graph(self._base_graph)
            if not collector:
                return None
            collector.sort(key=lambda c: c[0])
            # diagnostic: winning analytic objective, read by tests and
            # search reporting (not serialized with the strategy)
            for obj, strategy, _g in collector:
                strategy.search_cost = obj
            if not self.event_rerank:
                return self._finish(collector[0][1])
            # re-rank the analytic top-K with the event simulator's
            # contention-aware makespan (reference: candidates are
            # ultimately judged by simulate_runtime, not the analytic
            # estimators)
            # distinct (mesh, zero stage, placement, remat on-count)
            # only — pp candidates differing solely in microbatch count
            # (or remat prefixes differing by one segment) would
            # otherwise crowd the top-K, while stage/placement/remat
            # variants of one mesh are genuinely different trade-offs
            seen_keys = set()
            top: List[Tuple] = []
            for c in collector:
                key = (tuple(sorted(c[1].mesh_axes.items())),
                       c[1].pipeline is None, c[1].zero_stage,
                       c[1].placement,
                       len(c[1].remat) if c[1].remat is not None else None)
                if key in seen_keys:
                    continue
                seen_keys.add(key)
                top.append(c)
                if len(top) >= self.event_topk:
                    break
            best, best_obj = None, math.inf
            for obj, strategy, graph in top:
                e = self._event_objective(strategy, graph, lam)
                final = e if e is not None else obj
                slog.debug(
                    "event rerank %s: analytic=%.3g event=%s%s",
                    strategy.mesh_axes, obj,
                    f"{e:.3g}" if e is not None else "n/a",
                    " *best*" if final < best_obj else "",
                )
                if final < best_obj:
                    best, best_obj = strategy, final
            return self._finish(best if best is not None else collector[0][1])

    def _finish(self, strategy: Strategy) -> Strategy:
        """Attach the observability counters to the winning strategy and
        log them."""
        from ..logger import search_logger as slog
        from ..obs.metrics import emit_counters

        strategy.search_stats = self.eval_stats()
        from .mcmc import remat_stats

        # the winner's per-segment remat plan ("" when no plan chosen)
        strategy.search_stats.update(remat_stats(strategy))
        # the winner's placement ("" off a hierarchy) and whether its
        # grad reduction is hierarchical
        from ..topology.hierarchy import placement_stats

        strategy.search_stats.update(placement_stats(
            strategy, self.slices if self._hier else 1))
        emit_counters(slog, "unity eval stats", strategy.search_stats,
                      registry=self.registry, group="search/unity")
        return strategy

    def _objective(self, time: float, mem: int, lam: float) -> float:
        """Single ranking formula for ALL candidate families (dp/tp/ep
        and sp): time + lambda*mem, with an over-budget penalty in the
        lam=0 pass."""
        obj = time + lam * mem
        if (
            self.memory_budget is not None
            and lam == 0.0
            and mem > self.memory_budget
        ):
            obj *= 1.0 + (mem / self.memory_budget - 1.0)
        return obj

    def _sp_candidates(self):
        """Sequence-parallel (context-parallel) candidates: dp x sp
        meshes where activations are seq-sharded and attention lowers to
        ring attention (the reference's parallel/ring_attention.py) — the
        long-context strategy slot the reference leaves empty (SURVEY
        §5).  Costed with the same Simulator terms as the DP search plus
        the ring's KV-rotation traffic."""
        has_attn = any(
            op.op_type == OperatorType.MULTIHEAD_ATTENTION for op in self.graph.ops
        )
        if not has_attn:
            return
        sources = [op for op in self.graph.ops
                   if op.op_type == OperatorType.INPUT]
        seq_ok = all(
            op.outputs[0].shape.logical_rank >= 3 for op in sources
        )
        if not seq_ok:
            return
        training = True
        for sp in range(2, self.n + 1):
            if self.n % sp:
                continue
            dp = self.n // sp
            if any(
                op.outputs[0].shape.logical_shape[1] % sp
                for op in sources
            ):
                continue
            mesh_axes = {"seq": sp}
            if dp > 1:
                mesh_axes["data"] = dp
            s = Strategy(mesh_axes=dict(mesh_axes))
            chain = []
            if dp > 1:
                chain.append(("repartition", {"dim": 0, "degree": dp}))
            chain.append(("repartition", {"dim": 1, "degree": sp}))
            s.edge_ops["__inputs__"] = chain
            res = self._evaluator().evaluate(s)
            if res is None:
                continue
            # ring attention KV rotation: ~an allgather of the group's
            # K+V per attention forward; backward re-rotates KV and
            # rotates dK/dV (~2x more); comm overlaps blockwise compute
            ring = 0.0
            seq_spans = "seq" in self._sim.spanning_axes(mesh_axes)
            for op in res.ops:
                if op.op_type != OperatorType.MULTIHEAD_ATTENTION:
                    continue
                kv_bytes = (
                    op.inputs[1].shape.shard_bytes()
                    + op.inputs[2].shape.shard_bytes()
                ) * sp
                ring += 3.0 * self._comm_time("allgather", kv_bytes, sp,
                                              seq_spans)
            time = res.total_time + ring * (1.0 - self.overlap)
            mem = res.per_device_memory
            yield s, time, mem, f"dp={dp} sp={sp} (ring attention)"

    def _sample_candidates(self):
        """Sample parallelism (reference --enable-sample-parallel,
        config.h:134: partition along non-batch sample dims): shard
        inputs' dim 1 (sequence rows / flattened spatial) over a
        'sample' axis.  Attention graphs get this via the richer
        ring-attention sp candidates instead."""
        if not self.enable_sample_parallel:
            return
        if any(op.op_type == OperatorType.MULTIHEAD_ATTENTION
               for op in self.graph.ops):
            return
        sources = [op for op in self.graph.ops
                   if op.op_type == OperatorType.INPUT]
        if not sources or any(
            op.outputs[0].shape.logical_rank < 3 for op in sources
        ):
            return
        for sp in range(2, self.n + 1):
            if self.n % sp:
                continue
            dp = self.n // sp
            if any(
                op.outputs[0].shape.logical_shape[1] % sp
                or op.outputs[0].shape.logical_shape[0] % max(1, dp)
                for op in sources
            ):
                continue
            mesh_axes = {"sample": sp}
            if dp > 1:
                mesh_axes = {"data": dp, "sample": sp}
            s = Strategy(mesh_axes=dict(mesh_axes))
            chain = []
            if dp > 1:
                chain.append(("repartition", {"dim": 0, "degree": dp}))
            chain.append(("repartition", {"dim": 1, "degree": sp}))
            s.edge_ops["__inputs__"] = chain
            res = self._evaluator().evaluate(s)
            if res is None:
                continue
            yield (s, res.total_time, res.per_device_memory,
                   f"dp={dp} sample={sp} (sample parallel)")

    def _pp_candidates(self, lam: float):
        """Pipeline-parallel candidates: dp x pp meshes over the graph's
        homogeneous block stack (parallel/pipeline_plan.py), ranked with
        the standard GPipe terms — bubble fraction (S-1)/(M+S-1) on the
        block region plus per-tick point-to-point traffic.  The
        reference's vestigial PIPELINE_* hooks (model.h:190-192) made a
        searchable strategy per SURVEY §2.3."""
        from ..parallel.pipeline_plan import plan_pipeline
        from .segments import find_repeated_blocks

        if not self.enable_pipeline:
            return
        blocks = find_repeated_blocks(self.graph)
        L = len(blocks)
        if L < 2:
            return
        block_names = {op.name for blk in blocks for op in blk}
        sources = [op for op in self.graph.ops
                   if op.op_type == OperatorType.INPUT]
        if not sources:
            return
        b = sources[0].outputs[0].shape.logical_shape[0]
        # boundary activation: block 1's single external input tensor
        from .segments import external_inputs

        ext = external_inputs(blocks[1])
        if len(ext) != 1:
            return  # plan_pipeline would reject this region too
        by_guid = {t.guid: t for op in self.graph.ops for t in op.outputs}
        boundary_t = by_guid[ext[0]]
        for pp in range(2, min(self.n, L) + 1):
            if self.n % pp or L % pp:
                continue
            dp = self.n // pp
            if b % dp:
                continue
            local_b = b // dp
            mbs = sorted({m for m in (pp, 2 * pp, 4 * pp, local_b)
                          if 1 < m <= local_b and local_b % m == 0})
            if not mbs:
                continue
            s0 = Strategy(mesh_axes={"data": dp})
            if dp > 1:
                s0.edge_ops["__inputs__"] = [
                    ("repartition", {"dim": 0, "degree": dp})
                ]
            try:
                g = apply_strategy(self.graph, s0)
            except (ShapeError, ValueError):
                continue
            t_block = t_rest = 0.0
            mem_block = mem_rest = 0
            # the mesh the candidates run on: which of its axes span
            # nodes decides where the block's collectives go
            pp_axes = {"data": dp, "pipe": pp} if dp > 1 else {"pipe": pp}
            span = self._sim.spanning_axes(pp_axes)
            if span:
                assign_views(g, pp_axes)
            for op in g.topo_order():
                if op.op_type == OperatorType.INPUT:
                    continue
                if op.is_parallel_op():
                    t = (2.0 * self._sim.xfer_cost(op, pp_axes)
                         * (1.0 - self.overlap))
                    m = 0
                else:
                    t, m = self._op_cost(op, mesh_axes=pp_axes)
                if op.name in block_names:
                    t_block += t
                    mem_block += m
                else:
                    t_rest += t
                    mem_rest += m
            act_bytes = max(1, boundary_t.shape.size_bytes() // dp)

            def mk_strategy(M: int) -> Strategy:
                s = Strategy(
                    mesh_axes=dict(pp_axes),
                    pipeline={
                        "degree": pp,
                        "num_microbatches": M,
                        "axis": "pipe",
                        "dp_axis": "data" if dp > 1 else None,
                    },
                )
                if dp > 1:
                    s.edge_ops["__inputs__"] = [
                        ("repartition", {"dim": 0, "degree": dp})
                    ]
                return s

            # validate once per pp degree — the applied graph and plan
            # are independent of M (mbs already guarantees divisibility)
            probe = mk_strategy(mbs[0])
            try:
                gg = apply_strategy(self.graph, probe)
                assign_views(gg, probe.mesh_axes)
                plan_pipeline(gg, probe.pipeline, probe.mesh_axes)
            except (ShapeError, ValueError):
                continue
            for M in mbs:
                # region wall time: (M+S-1)/(M*S) of the dp-sharded
                # block total (compute+sync), i.e. /S with GPipe bubble
                region = t_block * (M + pp - 1) / (M * pp)
                # fwd activation shift + bwd grad shift per tick
                ring = 2.0 * (M + pp - 2) * self._comm_time(
                    "allgather", max(1, act_bytes // M), 2, "pipe" in span
                )
                time = t_rest + region + ring * (1.0 - self.overlap)
                mem = mem_rest + mem_block // pp
                obj = self._objective(time, mem, lam)
                yield mk_strategy(M), obj, f"dp={dp} pp={pp} M={M} (gpipe)"

    def pipeline_candidates(self) -> List[Tuple[float, float, Strategy]]:
        """(analytic step s, event-simulated step s, strategy) of every
        pipeline candidate the search prices on the base graph, cheapest
        analytic step first: the GPipe terms of `_pp_candidates`, and the
        event simulator's makespan scaled by the bubble as the re-rank
        scales it (None where it cannot lay the candidate out)."""
        self._set_graph(self._base_graph)
        out = [(obj, self._event_objective(s, self.graph, 0.0), s)
               for s, obj, _ in self._pp_candidates(0.0)]
        return sorted(out, key=lambda c: c[0])

    def optimize_with_memory(self) -> Optional[Strategy]:
        """Lambda binary search (reference try_one_lambda + binary search,
        graph.cc:2056-2131): smallest lambda whose best strategy fits the
        per-device memory budget, 10 iterations."""
        best = self.optimize(0.0)
        if best is None or self.memory_budget is None:
            return best
        if self._strategy_memory(best) <= self.memory_budget:
            return best
        lo, hi = 0.0, self._lambda_hi()
        chosen = best
        for _ in range(10):
            mid = (lo + hi) / 2.0
            cand = self.optimize(mid)
            if cand is not None and self._strategy_memory(cand) <= self.memory_budget:
                chosen, hi = cand, mid
            else:
                lo = mid
        # the winner's stats snapshot dates from the pass that found it;
        # re-attach the whole-search cumulative counters
        return self._finish(chosen)

    def _lambda_hi(self) -> float:
        # scale so the memory term can dominate: time-per-byte at HBM speed
        dev = self.machine.device()
        return 100.0 / dev.hbm_bandwidth

    def _strategy_memory(self, strategy: Strategy) -> int:
        from ..sim.simulator import Simulator

        base = self._base_graph
        if strategy.rewrites:
            from .rewrite import apply_rewrites, generate_rewrite_rules

            rules = (list(self.rewrite_rules) if self.rewrite_rules is not None
                     else generate_rewrite_rules())
            base = apply_rewrites(base, strategy.rewrites, rules)
        g = apply_strategy(base, strategy)
        assign_views(g, strategy.mesh_axes)
        # mirror the cost simulator's gating exactly (parameter_sync
        # and the candidate's own ZeRO stage included) so the memory
        # the lambda search constrains is the memory the time model
        # believes in
        sim = Simulator(self.machine, self.cost_model,
                        optimizer_slots=self.optimizer_slots,
                        remat=self.remat,
                        parameter_sync=self.parameter_sync,
                        zero_stage=(
                            strategy.zero_stage
                            if strategy.zero_stage is not None
                            else self.zero_stage
                        ),
                        wus_axis=self.wus_axis)
        op_scale = None
        if strategy.pipeline:
            # each device holds only its stage's 1/S of the block stack
            from ..parallel.pipeline_plan import plan_pipeline

            plan = plan_pipeline(g, strategy.pipeline, strategy.mesh_axes)
            block_guids = {op.guid for blk in plan.blocks for op in blk}
            S = plan.num_stages

            def op_scale(op, _g=block_guids, _s=S):  # noqa: E731
                return 1.0 / _s if op.guid in _g else 1.0

        if getattr(strategy, "remat", None) is not None and op_scale is None:
            # a searched per-segment plan prices the remat-aware
            # activation accounting — the same model the variants were
            # ranked with, so the budget check and the ranking agree
            return sim.remat_memory_from_terms(
                g.topo_order(), strategy.mesh_axes, strategy.remat,
                training=True, placement=strategy.placement,
            )
        return sim.per_device_memory(g, training=True, op_scale=op_scale,
                                     mesh_axes=strategy.mesh_axes,
                                     placement=strategy.placement)


def _sync_mode(pst) -> str:
    """ParameterSyncType -> Simulator.parameter_sync string."""
    from ..fftype import ParameterSyncType

    if pst == ParameterSyncType.PS:
        return "ps"
    if pst == ParameterSyncType.NONE:
        return "none"
    return "allreduce"


def unity_optimize(model, num_devices: int,
                   enable_pipeline: bool = True) -> Strategy:
    """Entry used by FFModel.compile (reference GRAPH_OPTIMIZE_TASK_ID ->
    Graph::graph_optimize_task graph.cc:2046)."""
    search, cost_model = make_unity_search(model, num_devices,
                                           enable_pipeline)
    cfg = model.config
    best = search.optimize_with_memory() if cfg.memory_search else search.optimize()
    cost_model.save_persistent()
    if best is None:
        from ..strategy import data_parallel_strategy

        best = data_parallel_strategy(num_devices)
        best.search_stats = cost_model.stats()
        return best
    best.search_stats.update(cost_model.stats())
    # surface the ZeRO stage the winner was scored under (and the
    # legacy bool it subsumes)
    chosen = best.zero_stage if best.zero_stage is not None else cfg.zero_stage
    best.search_stats["zero_stage"] = int(chosen)
    best.search_stats["weight_update_sharding"] = chosen >= 1
    return best


def make_unity_search(model, num_devices: int, enable_pipeline: bool = True):
    """(UnitySearch, cost model) over `model`'s layer graph with the
    machine, costs and search settings of its FFConfig."""
    from ..sim.machine_model import make_machine_model
    from ..sim.simulator import make_cost_model

    cfg = model.config
    machine = make_machine_model(cfg, num_devices)
    cost_model = make_cost_model(cfg, machine)
    from .rewrite import catalog_for_config, rules_for_config

    xfers = generate_all_pcg_xfers()
    catalog = catalog_for_config(cfg)
    if catalog:
        xfers = xfers + load_substitution_rules(catalog)
    rewrite_rules = rules_for_config(cfg)
    # fitted overlap constants (sim/calibrate.py) take precedence over
    # the hand-set priors when a calibration has been persisted
    from ..sim.calibrate import load_overlap_constants
    from ..sim.simulator import device_name

    fitted = load_overlap_constants(backend=device_name(cfg.device))
    overlap_kw = {}
    if fitted is not None:
        overlap_kw["overlap_fraction"] = fitted["overlap_fraction"]
        overlap_kw["compute_scale"] = fitted.get("compute_scale", 1.0)
    search = UnitySearch(
        model.layers,
        num_devices,
        machine,
        cost_model,
        xfers=xfers,
        enable_parameter_parallel=cfg.enable_parameter_parallel,
        enable_attribute_parallel=cfg.enable_attribute_parallel,
        budget=max(0, cfg.search_budget),
        memory_budget=cfg.memory_per_device if cfg.memory_search else None,
        rewrite_rules=rewrite_rules,
        # backward/update overlap: credit gradient sync as mostly hidden
        # behind remaining backward compute (reference config.h:130);
        # a fitted constant replaces the 0.7 prior
        sync_overlap_fraction=(
            fitted["sync_overlap_fraction"] if fitted is not None
            else (0.7 if cfg.search_overlap_backward_update else None)
        ),
        **overlap_kw,
        parameter_sync=_sync_mode(cfg.parameter_sync),
        max_assignments=cfg.simulator_segment_size,
        enable_sample_parallel=cfg.enable_sample_parallel,
        remat=cfg.remat,
        rewrite_depth=cfg.rewrite_depth,
        rewrite_max_variants=cfg.rewrite_max_variants,
        eval_cache=cfg.search_eval_cache,
        zero_stage=cfg.zero_stage,
        zero_stages=search_stage_candidates(cfg),
        wus_axis=cfg.wus_axis,
        enable_pipeline=enable_pipeline,
        remat_search=search_remat_enabled(cfg),
        dcn_bucket_bytes=float(cfg.dcn_bucket_mb) * 2**20,
        registry=getattr(getattr(model, "telemetry", None), "metrics", None),
    )
    return search, cost_model
