"""Graph-substitution (xfer) catalog for the Unity search.

Reference: src/runtime/substitution.cc — `GraphXfer` rewrite rules built
by `generate_all_pcg_xfers` (substitution.cc:1726-1868): for every
parallel degree, rules like `create_partition_linear_combine`
(:1755-1760), `create_replicate_linear_combine`, the attention pair
`create_partition_attention_combine` / `create_replicate_attention_reduce`
(:1762-1770), conv/embedding partitions, plus JSON-loaded TASO-style
rules (substitution_loader.h:143-179).

Counterpart of flexflow_tpu/pcg/substitution.py.  An xfer here is the
semantic payload of the reference rule: "op X may run with ShardConfig
kind=k degree=d on mesh axis a".  Applying a set of xfers to a graph
yields a Strategy; the collectives the reference's inserted parallel
ops would perform are costed by the simulator's partial-sum, xfer and
gradient-sync estimators.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from ..fftype import OperatorType
from ..ops.op import Op, ShardConfig

# which FFConfig gate each shard kind sits behind (reference:
# --enable-parameter-parallel / --enable-attribute-parallel,
# config.h:135-136; channel/expert TP rules are always generated)
_KIND_GATE = {
    "channel": None,
    "reduction": "parameter",
    "attribute": "attribute",
    "expert": None,
}

# which mesh axis a shard kind's degree maps onto
KIND_AXIS = {
    "channel": "model",
    "reduction": "model",
    "attribute": "model",
    "expert": "expert",
}

_OP_TYPE_NAMES = {t.value: t for t in OperatorType}


@dataclasses.dataclass(frozen=True)
class GraphXfer:
    """One rewrite rule: ops of `op_type` may shard `kind`.

    `name` mirrors the reference constructor that builds the analogous
    rule (substitution.cc:1726-1868) so parity is auditable.
    """

    name: str
    op_type: OperatorType
    kind: str  # "channel" | "reduction" | "attribute" | "expert"

    def gate(self) -> Optional[str]:
        return _KIND_GATE[self.kind]


def generate_all_pcg_xfers() -> List[GraphXfer]:
    """The built-in rule catalog (reference substitution.cc:1726-1868)."""
    X = GraphXfer
    T = OperatorType
    return [
        X("create_partition_linear_combine", T.LINEAR, "channel"),
        X("create_replicate_linear_reduce", T.LINEAR, "reduction"),
        X("create_partition_attention_combine", T.MULTIHEAD_ATTENTION, "channel"),
        X("create_partition_conv2d_combine", T.CONV2D, "channel"),
        X("create_partition_embedding_combine", T.EMBEDDING, "attribute"),
        X("create_partition_experts_combine", T.GROUP_BY, "expert"),
    ]


def load_substitution_rules(path: str) -> List[GraphXfer]:
    """JSON rule collection (reference substitution_loader.cc + TASO
    schema substitutions/graph_subst_3_v2.json).  Schema:
      {"rules": [{"name": str, "op_type": "linear", "kind": "channel"}]}
    TASO RuleCollection files (JSON or binary .pb) carry no per-op
    shard-option xfers — they load through pcg/taso.py instead — so
    they resolve to [] here.
    """
    try:
        with open(path) as f:
            d = json.load(f)
    except (UnicodeDecodeError, json.JSONDecodeError):
        from .taso_pb import looks_like_pb

        if looks_like_pb(path):
            return []  # binary TASO catalog
        raise
    out = []
    for r in d.get("rules", []):
        t = _OP_TYPE_NAMES.get(r["op_type"])
        if t is None:
            raise ValueError(f"unknown op_type in substitution rule: {r['op_type']}")
        if r["kind"] not in _KIND_GATE:
            raise ValueError(f"unknown shard kind: {r['kind']}")
        out.append(GraphXfer(r.get("name", f"json_{r['op_type']}_{r['kind']}"),
                             t, r["kind"]))
    return out


def _shard_limit(op: Op, kind: str) -> int:
    """Max legal degree for a shard kind on this op (divisibility source)."""
    t = op.op_type
    p = op.params
    if kind == "channel":
        if t == OperatorType.LINEAR:
            # ExpertsDense is a LINEAR whose params name out_dim (the
            # reference reads out_channels and raises AttributeError)
            return getattr(p, "out_channels", None) or p.out_dim
        if t == OperatorType.CONV2D:
            return p.out_channels
        if t == OperatorType.MULTIHEAD_ATTENTION:
            return p.num_heads
    elif kind == "reduction":
        if t == OperatorType.LINEAR:
            ishape = op.inputs[0].shape if op.inputs else None
            return ishape.logical_shape[-1] if ishape is not None else 0
    elif kind == "attribute":
        if t == OperatorType.EMBEDDING:
            return p.num_entries
    elif kind == "expert":
        if t == OperatorType.GROUP_BY:
            return p.n
    return 0


@dataclasses.dataclass(frozen=True)
class XferChoice:
    """One applicable xfer on an op: the ShardConfig plus an optional
    parallel-op chain on the op's (first) output.

    The chain is the reference rules' trailing Combine/Reduction — e.g.
    `create_partition_linear_combine` shards out-channels AND gathers the
    output back (substitution.cc:1755-1760); the chain-free variant keeps
    the tensor sharded for the next op to consume (Megatron-style
    alternating column/row parallelism, which the reference reaches by
    cancelling adjacent combine+partition pairs during rewrite search).
    Chain params are stored as hashable item-tuples.
    """

    shard: ShardConfig = ShardConfig()
    out_chain: tuple = ()  # ((kind, ((param, value), ...)), ...)

    def chain_as_lists(self):
        return [(kind, dict(items)) for kind, items in self.out_chain]


def _channel_dim_index(op: Op) -> Optional[int]:
    """Logical index of the output dim a channel shard partitions."""
    if op.op_type == OperatorType.LINEAR:
        return op.outputs[0].shape.logical_rank - 1 if op.outputs else -1
    if op.op_type == OperatorType.CONV2D:
        return 1  # NCHW channel dim
    return None  # attention: heads contract away (partials, not a dim)


def axis_degrees(mesh_axes: Dict[str, int], axis_name: str) -> List[int]:
    """All shard degrees realizable on a logical axis family: products
    of subsets of mesh axes named `axis_name` or `axis_name<digit>`.

    A factored mesh ({"model0": 2, "model1": 2}) expresses the
    reference's per-op MachineViews
    (machine_view.h:31): different ops may shard at different degrees —
    i.e. live on different submeshes — within one SPMD program."""
    sizes = [
        v for k, v in mesh_axes.items()
        if k == axis_name
        or (k.startswith(axis_name) and k[len(axis_name):].isdigit())
    ]
    degs = {1}
    for s in sizes:
        degs |= {d * s for d in degs}
    return sorted(d for d in degs if d > 1)


def op_options(
    op: Op,
    mesh_axes: Dict[str, int],
    xfers: Sequence[GraphXfer],
    enable_parameter_parallel: bool = False,
    enable_attribute_parallel: bool = False,
) -> List[XferChoice]:
    """All XferChoices the catalog allows for `op` on this mesh, always
    including the trivial (unsharded) choice first."""
    gates = {"parameter": enable_parameter_parallel,
             "attribute": enable_attribute_parallel}
    opts = [XferChoice()]
    seen = {opts[0]}

    def add(choice: XferChoice):
        if choice not in seen:
            seen.add(choice)
            opts.append(choice)

    for xf in xfers:
        if xf.op_type != op.op_type:
            continue
        g = xf.gate()
        if g is not None and not gates.get(g, False):
            continue
        limit = _shard_limit(op, xf.kind)
        for degree in axis_degrees(mesh_axes, KIND_AXIS[xf.kind]):
            if limit <= 0 or limit % degree != 0:
                continue
            cfg = ShardConfig(**{xf.kind: degree})
            add(XferChoice(cfg))
            if xf.kind == "channel":
                ci = _channel_dim_index(op)
                if ci is not None:
                    # the reference rule's trailing Combine: gather the
                    # channel-sharded output back to degree 1
                    add(XferChoice(cfg, (
                        ("combine", (("dim", ci), ("degree", degree))),
                    )))
                else:
                    # attention: head contraction leaves partial sums
                    # (replica degree) — Reduction collapses them, the
                    # create_replicate_attention_reduce shape
                    add(XferChoice(cfg, (
                        ("reduction", (("degree", degree),)),
                    )))
            elif xf.kind in ("reduction", "attribute"):
                # partial-sum output -> optional explicit Reduction
                add(XferChoice(cfg, (
                    ("reduction", (("degree", degree),)),
                )))
    return opts
