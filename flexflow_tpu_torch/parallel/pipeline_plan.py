"""Pipeline-parallel strategy planning (flexflow_tpu/parallel/
pipeline_plan.py): PCG -> (prefix, blocks, suffix).

A `Strategy.pipeline` entry names a pipeline degree and microbatch
count; `plan_pipeline` validates and plans it:

  * `find_repeated_blocks` (pcg/segments.py) locates the homogeneous
    block stack (a transformer's encoder layers);
  * the plan splits the topo order into prefix ops, the pipelined
    region (the blocks, one stage per pp rank) and suffix ops;
  * validation rejects regions a GPipe schedule cannot host: stateful
    ops (BatchNorm running stats), aux-loss ops (MoE load balance),
    non-trivial ShardConfigs, and microbatch counts that don't divide
    the per-dp-shard batch.

The Unity search calls it to cost pipeline candidates, and compile to
run a strategy's pipeline (executor.py, parallel/pipeline.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..fftype import OperatorType
from ..ops.op import Op, trainable_weight_count
from ..pcg.graph import Graph
from ..pcg.segments import find_repeated_blocks

#: op types whose forward has side state/aux the scanned block body
#: cannot thread (BatchNorm is excluded by the state check already)
_EXCLUDED_TYPES = {
    OperatorType.GROUP_BY,
    OperatorType.AGGREGATE,
    OperatorType.AGGREGATE_SPEC,
}


@dataclasses.dataclass
class PipelinePlan:
    prefix: List[Op]
    blocks: List[List[Op]]  # L homogeneous blocks, topo order each
    suffix: List[Op]
    region_in_guid: int   # tensor entering block 0 == the template
    #                       block's external input (single by validation)
    region_out_guid: int  # tensor leaving the last block
    template_out_guid: int  # block 0's boundary-output tensor guid
    num_stages: int
    num_microbatches: int
    pp_axis: str
    dp_axis: Optional[str]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)


def plan_pipeline(
    graph: Graph, pipeline: Dict, mesh_axes: Dict[str, int]
) -> PipelinePlan:
    """Build and validate the pipeline plan for a strategy-applied PCG.

    pipeline: {"degree": S, "num_microbatches": M, "axis": "pipe",
    "dp_axis": "data"|None} — the Strategy.pipeline payload."""
    S = int(pipeline["degree"])
    M = int(pipeline["num_microbatches"])
    pp_axis = pipeline.get("axis", "pipe")
    dp_axis = pipeline.get("dp_axis")
    if pp_axis not in mesh_axes or mesh_axes[pp_axis] != S:
        raise ValueError(
            f"pipeline degree {S} does not match mesh axis "
            f"{pp_axis!r}={mesh_axes.get(pp_axis)}"
        )
    if dp_axis is not None and dp_axis not in mesh_axes:
        raise ValueError(f"pipeline dp_axis {dp_axis!r} not in mesh")
    blocks = find_repeated_blocks(graph)
    L = len(blocks)
    if L < 2:
        raise ValueError(
            "no repeated homogeneous block stack found to pipeline "
            "(need >= 2 structurally identical single-tensor-boundary "
            "blocks)"
        )
    if L % S != 0:
        raise ValueError(f"{L} blocks not divisible by pipeline degree {S}")

    block_guids = {op.guid for blk in blocks for op in blk}
    for blk in blocks:
        for op in blk:
            if op.op_type in _EXCLUDED_TYPES:
                raise ValueError(
                    f"op {op.name} ({op.op_type.value}) cannot run inside "
                    f"a pipelined block (MoE blocks in a pipeline: ROADMAP "
                    f"§1 item 10)"
                )
            if trainable_weight_count(op) != len(op.weight_specs):
                raise ValueError(
                    f"stateful op {op.name} cannot run inside a pipelined "
                    f"block (running stats don't thread through the GPipe "
                    f"scan)"
                )
            if not op.shard.is_trivial():
                raise ValueError(
                    f"op {op.name} has a non-trivial ShardConfig; "
                    f"tensor parallelism inside pipeline stages is not "
                    f"supported"
                )

    topo = graph.topo_order()
    first_pos = min(i for i, op in enumerate(topo) if op.guid in block_guids)
    last_pos = max(i for i, op in enumerate(topo) if op.guid in block_guids)
    prefix = [op for op in topo[:first_pos]]
    suffix = [op for op in topo[last_pos + 1:]]
    interleaved = [
        op for op in topo[first_pos:last_pos + 1] if op.guid not in block_guids
    ]
    if interleaved:
        raise ValueError(
            f"ops interleaved with the pipelined region: "
            f"{[op.name for op in interleaved]}"
        )

    def external_in(blk: List[Op]) -> int:
        from ..pcg.segments import external_inputs

        ext = external_inputs(blk)
        if len(ext) != 1:
            raise ValueError(
                f"pipelined block has {len(ext)} external inputs, need 1"
            )
        return ext[0]

    region_in = external_in(blocks[0])
    template_out = external_in(blocks[1])  # block0's boundary output
    produced_last = [t.guid for op in blocks[-1] for t in op.outputs]
    if suffix:
        consumed_by_suffix = {t.guid for op in suffix for t in op.inputs}
        region_out = [g for g in produced_last if g in consumed_by_suffix]
    else:
        consumed = {t.guid for op in graph.ops for t in op.inputs}
        region_out = [g for g in produced_last if g not in consumed]
    if len(region_out) != 1:
        raise ValueError(
            f"pipelined region must hand exactly one tensor to the "
            f"suffix, found {len(region_out)}"
        )

    # microbatch divisibility on the per-dp-shard batch
    in_t = None
    for op in graph.ops:
        for t in op.outputs:
            if t.guid == region_in:
                in_t = t
    assert in_t is not None
    b = in_t.shape.logical_shape[0]
    dp = mesh_axes.get(dp_axis, 1) if dp_axis else 1
    if b % dp or (b // dp) % M:
        raise ValueError(
            f"batch {b} not divisible by dp={dp} x microbatches={M}"
        )
    return PipelinePlan(
        prefix=prefix,
        blocks=blocks,
        suffix=suffix,
        region_in_guid=region_in,
        region_out_guid=region_out[0],
        template_out_guid=template_out,
        num_stages=S,
        num_microbatches=M,
        pp_axis=pp_axis,
        dp_axis=dp_axis,
    )
