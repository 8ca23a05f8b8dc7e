"""Parallel Computation Graph structure (flexflow_tpu/pcg/graph.py): the
op list plus the edges derived from ParallelTensor.owner_op."""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Set

from ..fftype import OperatorType
from ..ops.op import Op


class Graph:
    def __init__(self, ops: Optional[Sequence[Op]] = None):
        self.ops: List[Op] = list(ops) if ops else []

    def add_op(self, op: Op):
        self.ops.append(op)
        return op

    def producers(self, op: Op) -> List[Op]:
        return [t.owner_op for t in op.inputs
                if t.owner_op is not None and t.owner_op is not op]

    def topo_order(self) -> List[Op]:
        indeg: Dict[int, int] = {}
        by_guid = {op.guid: op for op in self.ops}
        edges = collections.defaultdict(list)
        for op in self.ops:
            preds = {p.guid for p in self.producers(op) if p.guid in by_guid}
            indeg[op.guid] = len(preds)
            for p in preds:
                edges[p].append(op.guid)
        # stable: seed the queue in insertion order
        queue = [op.guid for op in self.ops if indeg[op.guid] == 0]
        order: List[Op] = []
        qi = 0
        while qi < len(queue):
            g = queue[qi]
            qi += 1
            order.append(by_guid[g])
            for c in edges[g]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(self.ops):
            raise RuntimeError("PCG has a cycle")
        return order

    def source_ops(self) -> List[Op]:
        return [op for op in self.ops if op.op_type == OperatorType.INPUT]

    def sink_op(self) -> Op:
        consumed: Set[int] = set()
        for op in self.ops:
            for t in op.inputs:
                consumed.add(t.guid)
        sinks = [
            op for op in self.ops
            if op.op_type != OperatorType.INPUT
            and not any(t.guid in consumed for t in op.outputs)
        ]
        if not sinks:
            raise RuntimeError("no sink op")
        return sinks[-1]
