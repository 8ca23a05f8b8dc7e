"""Parallel Computation Graph structure (flexflow_tpu/pcg/graph.py): the
op list plus the edges derived from ParallelTensor.owner_op, the
structural hash the search caches by, and a dot export."""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Set, Tuple

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

    def consumers(self, op: Op) -> List[Op]:
        return [other for other in self.ops if other is not op
                and any(t.owner_op is op for t in other.inputs)]

    def in_edges(self) -> Dict[Op, List[Op]]:
        return {op: self.producers(op) for op in self.ops}

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

    def compute_ops(self) -> List[Op]:
        return [op for op in self.ops if op.op_type != OperatorType.INPUT]

    def hash_key(self) -> Tuple:
        """Structural key (reference dp_state_hash, graph.h:149): the
        node keys in topological order."""
        return tuple(op.node_key() for op in self.topo_order())

    def export_dot(self, path: str, include_costs: bool = False,
                   cost_fn=None):
        """Graphviz dot of the PCG (reference --compgraph); parallel ops
        are ellipses."""
        lines = ["digraph PCG {"]
        for op in self.ops:
            label = f"{op.name}\\n{op.op_type.value}"
            for t in op.outputs:
                label += f"\\n{t.shape}"
            if include_costs and cost_fn is not None:
                label += f"\\ncost={cost_fn(op):.3g}"
            shape = "ellipse" if op.is_parallel_op() else "box"
            lines.append(f'  n{op.guid} [label="{label}", shape={shape}];')
        for op in self.ops:
            for t in op.inputs:
                if t.owner_op is not None:
                    lines.append(f"  n{t.owner_op.guid} -> n{op.guid};")
        lines.append("}")
        with open(path, "w") as f:
            f.write("\n".join(lines))
