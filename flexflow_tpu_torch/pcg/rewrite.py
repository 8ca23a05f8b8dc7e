"""Graph-rewrite substitution engine (flexflow_tpu/pcg/rewrite.py):
match and apply rules over the PCG.

Unlike pcg/substitution.py (whose xfers annotate per-op shard options),
these rules rewrite the operator graph: a matched subgraph is replaced
by a different subgraph computing the same function.  Built-in rules:

  * fuse_{linear,conv2d}_activation: fold a trailing elementwise
    activation into the producing op's fused-activation slot;
  * merge_parallel_{linear,conv2d}: N sibling ops reading one tensor
    with identical attributes merge into one op with summed
    out_channels, followed by a Split (TASO's merge rule);
  * cancel_inverse_parallel_ops: adjacent Combine(dim, d) and
    Repartition(dim, d) (either order) cancel;
  * cancel_split_concat: Concat(Split(x)) on one axis is x.

`enumerate_variants` is the bounded enumeration the Unity DP ranks;
`fuse_activations` is the --fusion compile pass (the fuse rules to a
fixpoint).
Applied rewrites are recorded on the Strategy as (rule name, match
index) pairs, so that strategy import and export replay them.  A TASO
RuleCollection catalog compiles through pcg/taso.py into pattern rules
named taso_rule_N@d, the names either package's strategy files replay.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from ..fftype import ActiMode, OperatorType, OpUnary
from ..ops.op import Op, ShapeError
from ..tensor import ParallelTensor
from .graph import Graph


def clone_op(op: Op, new_inputs, name=None, shard=None, params=None) -> Op:
    """Re-instantiate an op on new input tensors, carrying user
    initializers and grad flags (same contract as apply_strategy)."""
    new_op = type(op)(
        params if params is not None else op.params,
        new_inputs,
        name=name or op.name,
        shard=shard if shard is not None else op.shard,
        **op.ctor_kwargs(),
    )
    old_by_name = {s.name: s for s in op.weight_specs}
    new_op.weight_specs = [
        dataclasses.replace(s, initializer=old_by_name[s.name].initializer)
        if s.name in old_by_name
        else s
        for s in new_op.weight_specs
    ]
    for old_out, new_out in zip(op.outputs, new_op.outputs):
        new_out.create_gradients = old_out.create_gradients
    return new_op


def _consumer_counts(graph: Graph) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for op in graph.ops:
        for t in op.inputs:
            counts[t.guid] = counts.get(t.guid, 0) + 1
    return counts


@dataclasses.dataclass
class Match:
    rule: "RewriteRule"
    ops: Tuple[Op, ...]


class RewriteRule:
    """A pattern -> replacement rewrite (reference GraphXfer,
    substitution.h:218-228)."""

    name: str = "abstract"

    def find_matches(self, graph: Graph) -> List[Match]:
        raise NotImplementedError

    def build_replacement(
        self, match: Match, ext: Dict[int, ParallelTensor], new_graph: Graph
    ) -> Dict[int, ParallelTensor]:
        """Emit replacement ops into `new_graph`.

        ext maps old external-input tensor guid -> new tensor.  Returns
        old matched-output tensor guid -> replacement tensor, for every
        matched output with consumers outside the match."""
        raise NotImplementedError

    def apply(self, graph: Graph, match: Match) -> Optional[Graph]:
        """Rebuild the graph with the match replaced.  Returns None when
        the match is non-convex (an unmatched op needs a matched output
        before all matched inputs exist) or shapes reject it."""
        matched = {op.guid for op in match.ops}
        matched_outs = {t.guid for op in match.ops for t in op.outputs}
        topo = graph.topo_order()
        last_pos = max(i for i, op in enumerate(topo) if op.guid in matched)
        new_graph = Graph()
        tensor_map: Dict[int, ParallelTensor] = {}
        try:
            for i, op in enumerate(topo):
                if op.guid in matched:
                    if i == last_pos:
                        ext = {}
                        for mop in match.ops:
                            for t in mop.inputs:
                                if t.guid not in matched_outs:
                                    ext[t.guid] = tensor_map[t.guid]
                        tensor_map.update(
                            self.build_replacement(match, ext, new_graph)
                        )
                    continue
                if any(
                    t.guid in matched_outs and t.guid not in tensor_map
                    for t in op.inputs
                ):
                    return None  # consumer of a matched output before emit
                new_inputs = [tensor_map[t.guid] for t in op.inputs]
                new_op = clone_op(op, new_inputs)
                new_graph.add_op(new_op)
                for o_t, n_t in zip(op.outputs, new_op.outputs):
                    tensor_map[o_t.guid] = n_t
        except (ShapeError, ValueError, KeyError):
            return None
        return new_graph


_ACT_OF_UNARY = {
    OpUnary.RELU: ActiMode.RELU,
    OpUnary.GELU: ActiMode.GELU,
    OpUnary.SIGMOID: ActiMode.SIGMOID,
    OpUnary.TANH: ActiMode.TANH,
}


class FuseActivation(RewriteRule):
    """linear/conv2d(activation=NONE) -> unary activation  ==>  fused op.

    Reference analogue: the fuse rules of the TASO catalog consumed by
    substitution_loader.cc; the fused-activation slot mirrors the
    reference kernels' built-in activation (linear_kernels.cu)."""

    def __init__(self, op_type: OperatorType = OperatorType.LINEAR):
        self.op_type = op_type
        self.name = f"fuse_{op_type.value}_activation"

    def find_matches(self, graph: Graph) -> List[Match]:
        counts = _consumer_counts(graph)
        out = []
        for op in graph.topo_order():
            if op.op_type != OperatorType.ELEMENT_UNARY:
                continue
            act = _ACT_OF_UNARY.get(op.params.op)
            if act is None or not op.inputs:
                continue
            prod = op.inputs[0].owner_op
            if prod is None or prod.op_type != self.op_type:
                continue
            if prod.params.activation != ActiMode.NONE:
                continue
            if counts.get(prod.outputs[0].guid, 0) != 1:
                continue
            out.append(Match(self, (prod, op)))
        return out

    def build_replacement(self, match, ext, new_graph):
        prod, act = match.ops
        params = dataclasses.replace(
            prod.params, activation=_ACT_OF_UNARY[act.params.op]
        )
        new_op = clone_op(
            prod, [ext[t.guid] for t in prod.inputs], params=params
        )
        new_graph.add_op(new_op)
        return {
            prod.outputs[0].guid: new_op.outputs[0],
            act.outputs[0].guid: new_op.outputs[0],
        }


class MergeParallelOps(RewriteRule):
    """N>=2 sibling linear/conv2d ops on one input, identical attributes
    except out_channels  ==>  one op with summed out_channels + Split.

    The TASO merge rule (graph_subst_3_v2.json's matmul/conv merge
    family): one big matmul replaces N small ones — exactly the
    shape of Inception branch heads (parallel 1x1 convs on the same
    tensor)."""

    def __init__(self, op_type: OperatorType = OperatorType.LINEAR):
        self.op_type = op_type
        self.name = f"merge_parallel_{op_type.value}"

    def _group_key(self, op: Op):
        return (
            op.inputs[0].guid,
            dataclasses.replace(op.params, out_channels=0),
            op.shard,
        )

    @staticmethod
    def _mergeable(op: Op) -> bool:
        # merging re-initializes weights as one array: only legal when
        # every spec still carries the op-class default initializer and
        # all outputs are trainable (a user-pinned init or a frozen
        # branch must survive rewrites untouched)
        from ..initializer import DEFAULT_BIAS_INIT, DEFAULT_WEIGHT_INIT

        for s in op.weight_specs:
            if s.initializer not in (DEFAULT_WEIGHT_INIT, DEFAULT_BIAS_INIT):
                return False
        return all(t.create_gradients for t in op.outputs)

    def find_matches(self, graph: Graph) -> List[Match]:
        groups: Dict[Tuple, List[Op]] = {}
        for op in graph.topo_order():
            if op.op_type != self.op_type or len(op.inputs) != 1:
                continue
            if not op.shard.is_trivial() or not self._mergeable(op):
                continue
            if not hasattr(op.params, "out_channels"):
                # ExpertsDense (a LINEAR over stacked experts) does not
                # merge; the reference's _group_key raises TypeError
                continue
            groups.setdefault(self._group_key(op), []).append(op)
        return [
            Match(self, tuple(ops)) for ops in groups.values() if len(ops) >= 2
        ]

    def build_replacement(self, match, ext, new_graph):
        from ..ops.shape import Split, SplitParams

        ops = match.ops
        base = ops[0]
        sizes = tuple(o.params.out_channels for o in ops)
        params = dataclasses.replace(base.params, out_channels=sum(sizes))
        merged = type(base)(
            params,
            [ext[base.inputs[0].guid]],
            name=f"merged_{base.name}",
            shard=base.shard,
        )
        new_graph.add_op(merged)
        if self.op_type == OperatorType.CONV2D:
            axis = 1  # NCHW channel dim
        else:
            axis = merged.outputs[0].shape.logical_rank - 1
        sp = Split(
            SplitParams(sizes=sizes, axis=axis),
            [merged.outputs[0]],
            name=f"split_{base.name}",
        )
        new_graph.add_op(sp)
        return {
            op.outputs[0].guid: sp.outputs[k] for k, op in enumerate(ops)
        }


_INVERSE_PAIRS = {
    (OperatorType.COMBINE, OperatorType.REPARTITION),
    (OperatorType.REPARTITION, OperatorType.COMBINE),
}


class CancelInverseParallel(RewriteRule):
    """Combine(dim,d) ∘ Repartition(dim,d) (either order) is the
    identity on the parallel shape — drop both.  This is the parallel-op
    chain cancellation the reference performs during rewrite search
    (substitution.cc — what lets Megatron column->row emerge: linear1's
    trailing Combine cancels linear2's leading Repartition, leaving the
    tensor sharded across the boundary)."""

    name = "cancel_inverse_parallel_ops"

    def find_matches(self, graph: Graph) -> List[Match]:
        counts = _consumer_counts(graph)
        out = []
        for op in graph.topo_order():
            if not op.inputs:
                continue
            prod = op.inputs[0].owner_op
            if prod is None:
                continue
            if (prod.op_type, op.op_type) not in _INVERSE_PAIRS:
                continue
            if (
                prod.params.dim != op.params.dim
                or prod.params.degree != op.params.degree
            ):
                continue
            if counts.get(prod.outputs[0].guid, 0) != 1:
                continue
            out.append(Match(self, (prod, op)))
        return out

    def build_replacement(self, match, ext, new_graph):
        prod, op = match.ops
        src = ext[prod.inputs[0].guid]
        return {prod.outputs[0].guid: src, op.outputs[0].guid: src}


class CancelSplitConcat(RewriteRule):
    """Concat(Split(x)) with the same axis, outputs in order and
    unconsumed elsewhere, is the identity — drop both (the reference's
    Graph::simplify / remove-trivial-ops family, graph.cc; the TASO
    closure needs it so branch-merge chains can terminate: merge two
    linears -> split -> [relu,relu] -> concat becomes one linear+relu
    once taso_rule_543 hoists the relu past the concat)."""

    name = "cancel_split_concat"

    def find_matches(self, graph: Graph) -> List[Match]:
        counts = _consumer_counts(graph)
        out = []
        for op in graph.topo_order():
            if op.op_type != OperatorType.CONCAT or not op.inputs:
                continue
            prod = op.inputs[0].owner_op
            if prod is None or prod.op_type != OperatorType.SPLIT:
                continue
            if len(op.inputs) != len(prod.outputs):
                continue
            if any(t.owner_op is not prod or t.owner_idx != k
                   for k, t in enumerate(op.inputs)):
                continue
            rank = op.inputs[0].shape.logical_rank
            if op.params.axis % rank != prod.params.axis % rank:
                continue
            if any(counts.get(t.guid, 0) != 1 for t in prod.outputs):
                continue
            out.append(Match(self, (prod, op)))
        return out

    def build_replacement(self, match, ext, new_graph):
        prod, cat = match.ops
        src = ext[prod.inputs[0].guid]
        out = {cat.outputs[0].guid: src}
        for t in prod.outputs:
            out.setdefault(t.guid, src)  # unreferenced externally (checked)
        return out


def generate_rewrite_rules() -> List[RewriteRule]:
    """Built-in rewrite catalog (reference generate_all_pcg_xfers +
    TASO JSON rules)."""
    return [
        FuseActivation(OperatorType.LINEAR),
        FuseActivation(OperatorType.CONV2D),
        MergeParallelOps(OperatorType.LINEAR),
        MergeParallelOps(OperatorType.CONV2D),
        CancelInverseParallel(),
        CancelSplitConcat(),
    ]


_RULE_FACTORIES = {
    "fuse_activation": lambda r: FuseActivation(OperatorType(r["op_type"])),
    "merge_parallel": lambda r: MergeParallelOps(OperatorType(r["op_type"])),
    "cancel_inverse_parallel_ops": lambda r: CancelInverseParallel(),
}


def load_rewrite_rules(path: str, degrees=(2,)) -> List[RewriteRule]:
    """JSON-loadable rewrite rules (reference substitution_loader.cc).

    Two schemas are accepted:
      * the reference's TASO RuleCollection format (its 640-rule
        graph_subst_3_v2 catalog, JSON or binary .pb), detected by its
        "RuleCollection" tag and compiled by pcg/taso.py into pattern
        rules at the given parallel degrees;
      * this repo's own list format: {"rewrites": [{"type":
        "fuse_activation", "op_type": "linear"}, {"type":
        "merge_parallel", "op_type": "conv2d"},
        {"type": "cancel_inverse_parallel_ops"}]}.
    """
    from .taso import is_taso_rule_file, load_taso_rules

    if is_taso_rule_file(path):
        rules, _report = load_taso_rules(path, degrees=degrees)
        return list(rules)
    with open(path) as f:
        d = json.load(f)
    out = []
    for r in d.get("rewrites", []):
        fac = _RULE_FACTORIES.get(r.get("type"))
        if fac is None:
            raise ValueError(f"unknown rewrite rule type: {r.get('type')}")
        out.append(fac(r))
    return out


def rules_by_name(rules: Optional[Sequence[RewriteRule]] = None) -> Dict[str, RewriteRule]:
    return {r.name: r for r in (rules if rules is not None else generate_rewrite_rules())}


# Parallel degrees at which TASO catalog rules are instantiated.  The
# reference derives its considered_parallel_degrees from the machine at
# hand (substitution.cc:1773-1778), but a strategy records
# degree-qualified rule names ("taso_rule_N@16"), so the replay host
# must build the IDENTICAL list — a canonical environment-independent
# set keeps shipped artifacts loadable anywhere.  Degrees that don't
# divide the actual mesh simply never match (PatternRule checks the
# op's concrete degree).
CATALOG_DEGREES: Tuple[int, ...] = (2, 4, 8, 16)


def default_substitution_catalog() -> Optional[str]:
    """Default TASO catalog path for runs that don't pass
    --substitution-json.  Resolution order (first hit wins):
      1. $FLEXFLOW_TPU_SUBSTITUTIONS: a catalog file path; set empty to
         disable the default;
      2. <repo-root>/substitutions/ then ./substitutions/: the first
         graph_subst*.pb or graph_subst*.json.
    This repo ships no catalog, so by default none resolves.
    """
    import glob
    import os

    env = os.environ.get("FLEXFLOW_TPU_SUBSTITUTIONS")
    if env is not None:
        return env or None
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for d in (os.path.join(repo_root, "substitutions"), "substitutions"):
        for pat in ("graph_subst*.pb", "graph_subst*.json"):
            hits = sorted(glob.glob(os.path.join(d, pat)))
            if hits:
                return hits[0]
    return None


def catalog_for_config(cfg) -> Optional[str]:
    """The substitution catalog a config resolves to: an explicit
    --substitution-json wins ("none"/"" disables), else the default-on
    resolution above."""
    explicit = getattr(cfg, "substitution_json", None)
    if explicit is not None:
        return None if explicit in ("", "none") else explicit
    return default_substitution_catalog()


def catalog_fingerprint(path: str) -> Dict[str, object]:
    """Identity of a catalog file for strategy replay checks: replay
    resolves (rule name, match index) pairs, so the replaying host must
    see byte-identical rules compiled by the same engine semantics."""
    import hashlib
    import os

    from .taso import ENGINE_VERSION

    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"path": os.path.abspath(path), "sha256": digest,
            "engine": ENGINE_VERSION}


def rules_for_config(cfg) -> List[RewriteRule]:
    """THE rule list for a given FFConfig — search and compile-time
    replay must build the identical ordered list or strategy.rewrites'
    (name, match index) pairs replay a different match.  (This is why
    the TASO catalog degrees are a fixed constant, not derived from the
    replaying host's device count.)"""
    rules = generate_rewrite_rules()
    catalog = catalog_for_config(cfg)
    if catalog:
        rules = rules + load_rewrite_rules(catalog, degrees=CATALOG_DEGREES)
    return rules


def rules_for_replay(cfg, strategy) -> List[RewriteRule]:
    """Rule list for replaying an imported strategy's rewrite trace.

    Default-on catalog resolution is environment-dependent (env var,
    cwd, colocated checkouts), so a strategy whose trace references
    taso_rule_* records the catalog's identity at search time
    (Strategy.catalog) and replay pins to it: the recorded path is used
    when the config doesn't name one explicitly, and whatever file
    resolves must hash to the recorded sha256 under the same engine
    version — otherwise match indices would silently select different
    subgraphs, so we fail loudly instead."""
    import os

    from .taso import ENGINE_VERSION

    rec = getattr(strategy, "catalog", None)
    needs = any(str(n).startswith("taso_rule_")
                for n, _ in getattr(strategy, "rewrites", []))
    if not needs:
        return rules_for_config(cfg)
    path = catalog_for_config(cfg)
    if rec:
        if getattr(cfg, "substitution_json", None) in (None, "", "none"):
            path = rec["path"] if os.path.exists(rec["path"]) else path
        if path is None:
            raise ValueError(
                "strategy references TASO catalog rules but no catalog "
                f"is findable (searched with {rec['path']})"
            )
        fp = catalog_fingerprint(path)
        if fp["sha256"] != rec.get("sha256"):
            raise ValueError(
                f"catalog {path} differs from the one this strategy was "
                "searched with — rewrite match indices would not replay"
            )
        if rec.get("engine") != ENGINE_VERSION:
            raise ValueError(
                "strategy was searched under TASO engine "
                f"v{rec.get('engine')}, this host runs v{ENGINE_VERSION} "
                "— re-run the search"
            )
    elif path is None:
        raise ValueError(
            "strategy references TASO catalog rules but no catalog is "
            "findable (set --substitution-json)"
        )
    return generate_rewrite_rules() + load_rewrite_rules(
        path, degrees=CATALOG_DEGREES
    )


def apply_rewrites(
    graph: Graph,
    rewrites: Sequence[Sequence],
    rules: Optional[Sequence[RewriteRule]] = None,
) -> Graph:
    """Replay a Strategy's recorded (rule name, match index) rewrite
    trace on a frontend graph (strategy import path)."""
    byname = rules_by_name(rules)
    for name, idx in rewrites:
        rule = byname.get(name)
        if rule is None:
            raise ValueError(f"unknown rewrite rule in strategy: {name}")
        matches = rule.find_matches(graph)
        if idx >= len(matches):
            raise ValueError(
                f"rewrite {name}[{idx}] does not match the graph "
                f"({len(matches)} matches)"
            )
        g2 = rule.apply(graph, matches[idx])
        if g2 is None:
            raise ValueError(f"rewrite {name}[{idx}] is not applicable")
        graph = g2
    return graph


def enumerate_variants(
    graph: Graph,
    rules: Optional[Sequence[RewriteRule]] = None,
    max_depth: int = 2,
    max_variants: int = 12,
) -> List[Tuple[Graph, List[List]]]:
    """Bounded enumeration of rewritten graphs (reference base_optimize's
    budget-bounded priority-queue backtracking, substitution.cc:2229).
    Returns [(graph, rewrite trace)], original first, deduped by
    structural hash."""
    rules = list(rules) if rules is not None else generate_rewrite_rules()
    seen = {graph.hash_key()}
    out: List[Tuple[Graph, List[List]]] = [(graph, [])]
    frontier = [(graph, [])]
    for _ in range(max_depth):
        nxt = []
        for g, hist in frontier:
            for rule in rules:
                for mi, m in enumerate(rule.find_matches(g)):
                    if len(out) >= max_variants:
                        return out
                    g2 = rule.apply(g, m)
                    if g2 is None:
                        continue
                    try:
                        k = g2.hash_key()
                    except TypeError:
                        continue
                    if k in seen:
                        continue
                    seen.add(k)
                    entry = (g2, hist + [[rule.name, mi]])
                    out.append(entry)
                    nxt.append(entry)
        frontier = nxt
    return out


def fuse_activations(graph: Graph, protected_names=()) -> Graph:
    """The --fusion compile pass (flexflow_tpu/pcg/rewrite.py
    `fuse_activations`, the reference's apply_fusion): fold trailing
    activations into their linear/conv2d producers until none is left.
    A match that touches an op or tensor named in `protected_names` (the
    strategy's edge chains and shard configs) is left alone, so that the
    strategy still resolves."""
    rules = [FuseActivation(OperatorType.LINEAR),
             FuseActivation(OperatorType.CONV2D)]
    protected = set(protected_names)

    def eligible(rule):
        for m in rule.find_matches(graph):
            prod, act = m.ops
            if (prod.name in protected or act.name in protected
                    or any(t.name in protected for t in prod.outputs)
                    or any(t.name in protected for t in act.outputs)):
                continue
            yield m

    # each fold removes one op, so the op count bounds the fixpoint
    for _ in range(len(graph.ops)):
        applied = False
        for rule in rules:
            for m in eligible(rule):
                g2 = rule.apply(graph, m)
                if g2 is not None:
                    graph, applied = g2, True
                    break
            if applied:
                break
        if not applied:
            break
    return graph


def cancel_all_inverse_parallel_ops(graph: Graph, max_iters: int = 32) -> Graph:
    """Fixed-point cancellation pass run on the applied (post-strategy)
    PCG before execution, so redundant gather+rescatter boundaries never
    run."""
    rule = CancelInverseParallel()
    for _ in range(max_iters):
        matches = rule.find_matches(graph)
        if not matches:
            break
        g2 = rule.apply(graph, matches[0])
        if g2 is None:
            break
        graph = g2
    return graph
