"""Parallelization strategy: representation, application, (de)serialization.

A Strategy says, for a frontend (degree-1) PCG:
  * per-op ShardConfig (op-internal parallelism: channel/reduction/
    attribute/expert degrees);
  * parallel-op insertions on tensor edges (repartition/combine/
    replicate/reduction/all_to_all chains);
  * the mesh axis sizes the degrees map onto.

Applying a strategy rebuilds the PCG with propagated parallel shapes and
assigns every tensor a MachineView.  Counterpart of
flexflow_tpu/strategy.py: the JSON is the same text, so a strategy file
written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from .fftype import OperatorType
from .ops.op import Op, ShardConfig
from .parallel.machine import MachineView, assign_axes, validate_view
from .parallel.parallel_op import (
    PARALLEL_OP_KINDS,
    AllToAllParams,
    CombineParams,
    FusedParallelParams,
    ReductionParams,
    RepartitionParams,
    ReplicateParams,
)
from .pcg.graph import Graph


def _fused_params(**pdict) -> FusedParallelParams:
    """JSON {"ops": [[kind, {...}], ...]} -> nested frozen params
    (reference FusedParallelOp, fused_parallel_op.cc — one boundary,
    one fused resharding chain)."""
    ops = tuple(
        (kind, _PARAM_CLASSES[kind](**dict(pp)))
        for kind, pp in pdict["ops"]
    )
    return FusedParallelParams(ops=ops)


_PARAM_CLASSES = {
    "repartition": RepartitionParams,
    "combine": CombineParams,
    "replicate": ReplicateParams,
    "reduction": ReductionParams,
    "all_to_all": AllToAllParams,
    "fused": _fused_params,
}


@dataclasses.dataclass
class Strategy:
    """mesh_axes: ordered axis name -> size.
    shard_configs: frontend op NAME -> ShardConfig.
    edge_ops: frontend tensor NAME -> list of (kind, params-dict) chains
        inserted after the producing tensor (applies to all consumers).
    """

    mesh_axes: Dict[str, int]
    shard_configs: Dict[str, ShardConfig] = dataclasses.field(default_factory=dict)
    edge_ops: Dict[str, List[Tuple[str, dict]]] = dataclasses.field(default_factory=dict)
    # graph-rewrite trace: [(rule name, match index), ...] replayed on
    # the frontend graph by pcg/rewrite.py before the strategy applies
    # (reference: the rewrites GraphXfer::run applied to the winning
    # graph, substitution.cc:1898-1945)
    rewrites: List[List] = dataclasses.field(default_factory=list)
    # pipeline parallelism payload {"degree", "num_microbatches",
    # "axis", "dp_axis"} lowered by parallel/pipeline_plan.py (the
    # reference's vestigial PIPELINE_* hooks, model.h:190-192, made
    # first-class)
    pipeline: Optional[Dict] = None
    # identity of the TASO catalog the rewrites were searched with
    # ({"path", "sha256", "engine"}), recorded whenever `rewrites`
    # references catalog rules: replay resolves rule names to match
    # INDICES, so the replaying host must load byte-identical rules or
    # fail loudly (rewrite.rules_for_replay checks this)
    catalog: Optional[Dict] = None
    # search-chosen ZeRO ladder stage (0-3, docs/PERF.md); None means
    # "not chosen by the search" — the executor falls back to
    # FFConfig.zero_stage.  Rides the strategy so a store-restored or
    # imported winner replays with the stage it was costed under.
    zero_stage: Optional[int] = None
    # search-chosen multi-slice placement (topology/hierarchy.py): the
    # mesh axis that spans the boundary between slices.  None means not
    # chosen: compile and the simulator take resolve_placement's
    # default.  Ignored on single-slice runs, so flat strategies
    # serialize unchanged.
    placement: Optional[str] = None
    # search-chosen per-segment remat plan (docs/PERF.md "Searched
    # rematerialization"): sorted indices of the single-tensor-boundary
    # segments whose internals recompute in backward (activation checkpointing).
    # None means "not chosen" — the executor falls back to the global
    # FFConfig.remat bool (all pure segments).  [] is an explicit
    # all-off plan.  Serialized ONLY when set, so remat-free strategies
    # keep byte-identical JSON (and store-entry digests) to before the
    # dimension existed — the single-slice key guarantee's pattern.
    remat: Optional[List[int]] = None

    # -- serialization ---------------------------------------------------
    def to_json(self) -> str:
        payload = {
            "mesh_axes": self.mesh_axes,
            "shard_configs": {
                k: dataclasses.asdict(v) for k, v in self.shard_configs.items()
            },
            "edge_ops": self.edge_ops,
            "rewrites": [list(r) for r in self.rewrites],
            "pipeline": self.pipeline,
            "catalog": self.catalog,
            "zero_stage": self.zero_stage,
            "placement": self.placement,
        }
        if self.remat is not None:
            payload["remat"] = [int(i) for i in self.remat]
        return json.dumps(payload, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Strategy":
        d = json.loads(text)
        return cls(
            mesh_axes=dict(d["mesh_axes"]),
            shard_configs={
                k: ShardConfig(**v) for k, v in d.get("shard_configs", {}).items()
            },
            edge_ops={
                k: [(kind, dict(p)) for kind, p in v]
                for k, v in d.get("edge_ops", {}).items()
            },
            rewrites=[list(r) for r in d.get("rewrites", [])],
            pipeline=d.get("pipeline"),
            catalog=d.get("catalog"),
            zero_stage=d.get("zero_stage"),
            placement=d.get("placement"),
            remat=(
                [int(i) for i in d["remat"]] if d.get("remat") is not None
                else None
            ),
        )

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Strategy":
        with open(path) as f:
            return cls.from_json(f.read())

    @property
    def total_devices(self) -> int:
        n = 1
        for v in self.mesh_axes.values():
            n *= v
        return n


def data_parallel_strategy(num_devices: int) -> Strategy:
    """The reference's default / --only-data-parallel strategy
    (get_basic_data_parallel_config model.h:250, model.cc:2638-2642):
    Repartition every input's sample dim across all devices."""
    s = Strategy(mesh_axes={"data": num_devices})
    s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": num_devices})]
    return s


def reapply_op(op: Op, new_inputs: Sequence, strategy: Strategy) -> Op:
    """Re-instantiate one frontend op under a strategy's ShardConfig —
    the unit apply step shared by apply_strategy and the incremental
    evaluator (pcg/evaluator.py), so search-time costing and execution
    can never instantiate ops differently."""
    if op.op_type == OperatorType.INPUT:
        return type(op)(op.params, [], name=op.name)
    shard = strategy.shard_configs.get(op.name, ShardConfig())
    return type(op)(op.params, list(new_inputs), name=op.name, shard=shard,
                    **op.ctor_kwargs())


def edge_chain_for(op: Op, out, strategy: Strategy,
                   input_chain: List) -> List:
    """The parallel-op chain a strategy inserts after one output tensor
    (INPUT ops fall back to the __inputs__ chain)."""
    if op.op_type == OperatorType.INPUT:
        return strategy.edge_ops.get(out.name, input_chain)
    return strategy.edge_ops.get(out.name, [])


def build_edge_chain(pt, chain, add_op):
    """Instantiate a parallel-op chain on `pt`, handing each new op to
    `add_op`; returns the chain's final output tensor."""
    for kind, pdict in chain:
        params = _PARAM_CLASSES[kind](**dict(pdict))
        pop = PARALLEL_OP_KINDS[kind](params, [pt], name=f"{kind}_{pt.name}")
        add_op(pop)
        pt = pop.outputs[0]
    return pt


def apply_strategy(graph: Graph, strategy: Strategy) -> Graph:
    """Rebuild the frontend PCG under a strategy.

    Walks the graph in topo order; for each frontend op instantiates a
    fresh op of the same class with the strategy's ShardConfig and
    re-propagated input tensors, inserting the strategy's parallel-op
    chains on edges.  Shape rules raise ShapeError on illegal combos —
    the search catches that to prune candidates.
    """
    new_graph = Graph()
    tensor_map: Dict[int, object] = {}  # old tensor guid -> new ParallelTensor
    input_chain = strategy.edge_ops.get("__inputs__", [])
    for op in graph.topo_order():
        if op.op_type == OperatorType.INPUT:
            new_op = reapply_op(op, [], strategy)
            new_graph.add_op(new_op)
            chain = edge_chain_for(op, op.outputs[0], strategy, input_chain)
            tensor_map[op.outputs[0].guid] = build_edge_chain(
                new_op.outputs[0], chain, new_graph.add_op
            )
            continue
        new_inputs = [tensor_map[t.guid] for t in op.inputs]
        new_op = reapply_op(op, new_inputs, strategy)
        # carry user-supplied initializers and grad flags from the frontend op
        old_by_name = {s.name: s for s in op.weight_specs}
        new_op.weight_specs = [
            dataclasses.replace(s, initializer=old_by_name[s.name].initializer)
            if s.name in old_by_name
            else s
            for s in new_op.weight_specs
        ]
        for old_out, new_out in zip(op.outputs, new_op.outputs):
            new_out.create_gradients = old_out.create_gradients
        new_graph.add_op(new_op)
        for old_out, new_out in zip(op.outputs, new_op.outputs):
            chain = edge_chain_for(op, old_out, strategy, input_chain)
            tensor_map[old_out.guid] = build_edge_chain(
                new_out, chain, new_graph.add_op
            )
    return new_graph


def assign_op_views(op: Op, mesh_axes: Dict[str, int]):
    """Assign MachineViews to one op's outputs and weights — the unit
    step of assign_views, also used by the incremental evaluator to
    re-view only a delta's rebuilt frontier (pcg/evaluator.py)."""
    for pt in list(op.outputs) + list(op.weights):
        try:
            view = assign_axes(pt.shape, mesh_axes)
            validate_view(view, pt.shape, mesh_axes)
        except ValueError as e:
            raise ValueError(f"{pt.name} {pt.shape}: {e}") from e
        pt.machine_view = view


def assign_views(graph: Graph, mesh_axes: Dict[str, int]):
    """Assign a MachineView to every tensor by factoring its degrees onto
    the mesh axes (the view normalizer; SURVEY §7 hard part 4)."""
    for op in graph.topo_order():
        assign_op_views(op, mesh_axes)
