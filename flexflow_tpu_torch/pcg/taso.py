"""TASO pattern-graph substitution rules (flexflow_tpu/pcg/taso.py): the
catalog loader and the generic match and apply.

The reference's substitution catalog (`graph_subst_3_v2`, 640 rules over
Partition, Combine, Replicate, Reduction, Linear, Relu, EwAdd, EwMul,
Concat and Split; schema in substitution_loader.{h,cc}) parses into a
neutral rule IR (`TasoRule`), and each rule compiles into a generic
`PatternRule`: a `RewriteRule` (pcg/rewrite.py) whose src pattern is
matched by backtracking subgraph isomorphism and whose dst subgraph is
built from the pattern (create_xfer, can_match and create_new_operator,
substitution.cc:235-414, :832-1120, :1456-1680).  The catalog then takes
part in `enumerate_variants` and the Unity search like any built-in
rule.

Deliberate divergences from the reference, all load-bearing and all the
JAX package's own:

  * PM_ACTI values in the catalog are TASO-native (0=NONE, 1=SIGMOID,
    2=RELU, 3=TANH); the reference compares them raw against its
    AC_MODE_* values (10..14), so its linear rules never match.  They
    are remapped here, so that they can fire.
  * PM_NUMDIM is answered by no reference op, so its concat rules never
    match.  Here it is the tensor's logical rank.
  * Catalog dims are column-major (0 = innermost); the port's tensors
    are row-major logical, converted per match by the tensor's rank.
  * Catalog OP_REPLICATE and OP_REDUCE carry the reference's
    size-changing semantics (d stacked copies, the fold-sum of d
    slices).  They map to the StackReplicate and FoldReduce compute ops
    (parallel/parallel_op.py), not to the size-preserving Replicate and
    Reduction annotations.
  * As in the reference (get_num_inputs, substitution.cc:1416), a
    linear's declared weight input is dropped; a rule whose src pattern
    that leaves disconnected is rejected (`convert_rules` counts it)
    rather than matching unrelated subgraphs.

Each rule is verified numerically before it is used (`verify_rule`), on
float32 CPU tensors: the check is host work, whatever the config's
device.  Verdicts are cached per catalog file under the port's cache
directory, apart from the JAX package's, so the port always runs its
own verifier.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..fftype import ActiMode, OperatorType, OpBinary, OpUnary
from ..ops.op import Op
from ..tensor import ParallelTensor
from .graph import Graph
from .rewrite import Match, RewriteRule, clone_op
from .taso_pb import looks_like_pb, pb_to_dict

# the engine version a catalog fingerprint records, the reference's own:
# a strategy searched with a catalog by either package replays in the
# other.  Bump it when matching or realization semantics change.
ENGINE_VERSION = 2


# --------------------------------------------------------------------------
# Rule IR and parser (reference substitution_loader.{h,cc})
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorRef:
    """A pattern tensor: output `ts_id` of pattern op `op_id`, or an
    external input when op_id < 0 (reference sl::Tensor)."""

    op_id: int
    ts_id: int


@dataclasses.dataclass(frozen=True)
class TasoOp:
    """One pattern operator (reference sl::Operator)."""

    type: str  # catalog name, e.g. "OP_PARTITION"
    inputs: Tuple[TensorRef, ...]
    params: Tuple[Tuple[str, int], ...]  # ordered (key, value)

    def at(self, key: str) -> Optional[int]:
        for k, v in self.params:
            if k == key:
                return v
        return None


@dataclasses.dataclass(frozen=True)
class MapOutput:
    src_op_id: int
    src_ts_id: int
    dst_op_id: int
    dst_ts_id: int


@dataclasses.dataclass(frozen=True)
class TasoRule:
    name: str
    src_ops: Tuple[TasoOp, ...]
    dst_ops: Tuple[TasoOp, ...]
    mapped_outputs: Tuple[MapOutput, ...]


def _parse_op(j: dict) -> TasoOp:
    return TasoOp(
        type=j["type"],
        inputs=tuple(TensorRef(t["opId"], t["tsId"])
                     for t in j.get("input", [])),
        params=tuple((p["key"], p["value"]) for p in j.get("para", [])),
    )


def parse_rule_collection(path: str) -> List[TasoRule]:
    """Every rule of a substitution catalog, the JSON twin or the binary
    .pb, including the ones this engine later rejects."""
    d = None
    if looks_like_pb(path):
        try:
            d = pb_to_dict(path)
        except ValueError:
            d = None  # a newline-led JSON file sniffed as pb
    if d is None:
        with open(path) as f:
            d = json.load(f)
    if d.get("_t") != "RuleCollection" or "rule" not in d:
        raise ValueError(f"{path}: not a TASO RuleCollection file")
    return [
        TasoRule(
            name=rj["name"],
            src_ops=tuple(_parse_op(o) for o in rj["srcOp"]),
            dst_ops=tuple(_parse_op(o) for o in rj["dstOp"]),
            mapped_outputs=tuple(
                MapOutput(m["srcOpId"], m["srcTsId"], m["dstOpId"],
                          m["dstTsId"])
                for m in rj["mappedOutput"]),
        )
        for rj in d["rule"]
    ]


def is_taso_rule_file(path: str) -> bool:
    """True for a TASO RuleCollection catalog, JSON or binary .pb."""
    if looks_like_pb(path):
        try:
            with open(path, "rb") as f:
                head = f.read(4096)
        except OSError:
            return False
        if head.lstrip()[:1] == b"{":
            # newline-led JSON sniffed as pb: decided by its content, so
            # that the repo's own rewrite JSON is not misrouted
            return b'"RuleCollection"' in head
        # binary: a catalog or an error either way, which
        # parse_rule_collection diagnoses
        return True
    try:
        with open(path) as f:
            head = f.read(4096)
        return '"RuleCollection"' in head
    except (OSError, UnicodeDecodeError):
        return False


# --------------------------------------------------------------------------
# Catalog-op semantics tables
# --------------------------------------------------------------------------

class UnsupportedRule(ValueError):
    """A rule this IR cannot compile; carries the reason."""


_EW_BINARY = {"OP_EW_ADD": OpBinary.ADD, "OP_EW_SUB": OpBinary.SUB,
              "OP_EW_MUL": OpBinary.MUL, "OP_EW_DIV": OpBinary.DIV,
              "OP_EW_MAX": OpBinary.MAX, "OP_EW_MIN": OpBinary.MIN}

_EW_UNARY = {"OP_RELU": OpUnary.RELU, "OP_SIGMOID": OpUnary.SIGMOID,
             "OP_TANH": OpUnary.TANH, "OP_EXP": OpUnary.EXP,
             "OP_IDENTITY": OpUnary.IDENTITY}

_PARALLEL_TYPES = {"OP_PARTITION": OperatorType.REPARTITION,
                   "OP_COMBINE": OperatorType.COMBINE,
                   "OP_REPLICATE": OperatorType.REPLICATE_STACK,
                   "OP_REDUCE": OperatorType.REDUCTION_FOLD}

# TASO-native ActiMode (the catalog generator's enum), see the docstring
_TASO_ACTI = {0: ActiMode.NONE, 1: ActiMode.SIGMOID, 2: ActiMode.RELU,
              3: ActiMode.TANH}

SUPPORTED_TYPES = (set(_PARALLEL_TYPES) | set(_EW_BINARY) | set(_EW_UNARY)
                   | {"OP_LINEAR", "OP_CONCAT", "OP_SPLIT"})


def _num_inputs(op: TasoOp) -> int:
    """The reference's get_num_inputs (substitution.cc:1416-1454): binary
    ops take 2, concat PM_NUM_INPUTS, everything else 1 (a linear's
    declared weight input is dropped)."""
    if op.type in _EW_BINARY:
        return 2
    if op.type == "OP_CONCAT":
        n = op.at("PM_NUM_INPUTS")
        if n is None:
            raise UnsupportedRule("concat without PM_NUM_INPUTS")
        return n
    return 1


def _num_outputs(op: TasoOp) -> int:
    if op.type == "OP_SPLIT":
        n = op.at("PM_NUM_OUTPUTS")
        if n is None:
            raise UnsupportedRule("split without PM_NUM_OUTPUTS")
        return n
    return 1


def _graph_key(t: str) -> str:
    """The OperatorType value a catalog op type matches."""
    if t in _PARALLEL_TYPES:
        return _PARALLEL_TYPES[t].value
    if t in _EW_UNARY:
        return OperatorType.ELEMENT_UNARY.value
    if t in _EW_BINARY:
        return OperatorType.ELEMENT_BINARY.value
    return t[3:].lower()


def _col_to_row(dim: int, rank: int) -> int:
    """Catalog column-major dim -> row-major logical index."""
    if dim < 0 or dim >= rank:
        raise UnsupportedRule(f"dim {dim} out of range for rank {rank}")
    return rank - 1 - dim


# --------------------------------------------------------------------------
# The generic pattern rule
# --------------------------------------------------------------------------

class PatternRule(RewriteRule):
    """A catalog rule compiled at a concrete parallel degree, named
    `<rule>@<degree>`.

    Matching is GraphXfer::can_match's (substitution.cc:235): per pattern
    op, the op type, the parameter constraints and the exact input
    wiring (pattern input slot j is the matched producer's output, or a
    consistently bound external), found by backtracking in the
    pattern's dependency order over candidates indexed by type."""

    def __init__(self, rule: TasoRule, degree: int):
        self.rule = rule
        self.degree = degree
        self.name = f"{rule.name}@{degree}"
        self._src = self._compile_side(rule.src_ops)
        self._dst = self._compile_side(rule.dst_ops)
        self._validate()

    # -- compilation -----------------------------------------------------
    @staticmethod
    def _compile_side(ops: Sequence[TasoOp]):
        compiled = []
        for i, op in enumerate(ops):
            if op.type not in SUPPORTED_TYPES:
                raise UnsupportedRule(f"op type {op.type}")
            n_in = _num_inputs(op)
            inputs = op.inputs[:n_in]
            if len(inputs) < n_in:
                raise UnsupportedRule(f"{op.type} missing inputs")
            if any(ref.op_id >= i for ref in inputs):
                raise UnsupportedRule("pattern not in dependency order")
            compiled.append((op, inputs))
        return compiled

    def _validate(self):
        # whether the rule is instantiated per degree (convert_rules)
        self.uses_parallel = any(op.type in _PARALLEL_TYPES
                                 for op, _ in self._src + self._dst)
        # the reference's create_xfers skips trivial 1->1 rules
        if len(self._src) == 1 and len(self._dst) == 1:
            raise UnsupportedRule("trivial 1->1 rule")
        # the src pattern must stay connected after the weight inputs
        # are dropped (a shared external connects its users), else a
        # match would pair unrelated subgraphs
        n = len(self._src)
        adj = [set() for _ in range(n)]
        ext_users: Dict[int, List[int]] = {}
        for i, (_op, inputs) in enumerate(self._src):
            for ref in inputs:
                if ref.op_id >= 0:
                    adj[i].add(ref.op_id)
                    adj[ref.op_id].add(i)
                else:
                    ext_users.setdefault(ref.op_id, []).append(i)
        for users in ext_users.values():
            for u in users[1:]:
                adj[users[0]].add(u)
                adj[u].add(users[0])
        seen, stack = {0}, [0]
        while stack:
            for y in adj[stack.pop()]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        if len(seen) != n:
            raise UnsupportedRule("src pattern disconnected after truncation")
        # a dst linear copies its attributes from exactly one src linear
        # (the reference's find_opx_with_type asserts it)
        src_linears = [i for i, (op, _) in enumerate(self._src)
                       if op.type == "OP_LINEAR"]
        if (any(op.type == "OP_LINEAR" for op, _ in self._dst)
                and len(src_linears) != 1):
            raise UnsupportedRule(
                f"dst linear needs exactly 1 src linear, have "
                f"{len(src_linears)}")
        self._src_linear_idx = src_linears[0] if src_linears else None
        # every external the dst reads must be bound by the src match
        src_exts = {r.op_id for _, inputs in self._src for r in inputs
                    if r.op_id < 0}
        if any(r.op_id < 0 and r.op_id not in src_exts
               for _, inputs in self._dst for r in inputs):
            raise UnsupportedRule("dst uses external unbound by src")
        # a sink src op none of whose outputs is mapped could never apply
        mapped = {(m.src_op_id, m.src_ts_id)
                  for m in self.rule.mapped_outputs}
        consumed = {r.op_id for _, inputs in self._src for r in inputs}
        for s in range(n):
            if s in consumed:
                continue
            if not any((s, t) in mapped
                       for t in range(_num_outputs(self._src[s][0]))):
                raise UnsupportedRule(f"sink src op {s} output unmapped")

    # -- matching --------------------------------------------------------
    def _op_matches(self, pat: TasoOp, op: Op) -> bool:
        t = pat.type
        if t in _PARALLEL_TYPES:
            if op.op_type != _PARALLEL_TYPES[t]:
                return False
            if (pat.at("PM_PARALLEL_DEGREE") is not None
                    and op.params.degree != self.degree):
                return False
            dim = pat.at("PM_PARALLEL_DIM")
            if dim is not None:
                rank = op.inputs[0].shape.logical_rank
                if dim >= rank:
                    return False
                actual = (op.params.dim if t in ("OP_PARTITION", "OP_COMBINE")
                          else op.params.axis)
                if actual % rank != _col_to_row(dim, rank):
                    return False
            return True
        if t in _EW_UNARY:
            return (op.op_type == OperatorType.ELEMENT_UNARY
                    and op.params.op == _EW_UNARY[t])
        if t in _EW_BINARY:
            return (op.op_type == OperatorType.ELEMENT_BINARY
                    and op.params.op == _EW_BINARY[t])
        if t == "OP_LINEAR":
            if op.op_type != OperatorType.LINEAR:
                return False
            acti = pat.at("PM_ACTI")
            return acti is None or (_TASO_ACTI.get(acti) is not None
                                    and op.params.activation
                                    == _TASO_ACTI[acti])
        if t in ("OP_CONCAT", "OP_SPLIT"):
            if op.op_type != (OperatorType.CONCAT if t == "OP_CONCAT"
                              else OperatorType.SPLIT):
                return False
            if t == "OP_CONCAT":
                n, have = pat.at("PM_NUM_INPUTS"), len(op.inputs)
            else:
                n, have = pat.at("PM_NUM_OUTPUTS"), len(op.outputs)
            if n is not None and have != n:
                return False
            rank = op.inputs[0].shape.logical_rank
            numdim = pat.at("PM_NUMDIM")
            if t == "OP_CONCAT" and numdim is not None and rank != numdim:
                return False
            axis = pat.at("PM_AXIS")
            return axis is None or (
                axis < rank
                and op.params.axis % rank == _col_to_row(axis, rank))
        return False

    def find_matches(self, graph: Graph) -> List[Match]:
        by_type: Dict[str, List[Op]] = {}
        for op in graph.topo_order():
            by_type.setdefault(op.op_type.value, []).append(op)
        # every pattern type must occur in the graph
        if any(_graph_key(pat.type) not in by_type for pat, _ in self._src):
            return []

        out: List[Match] = []
        n = len(self._src)
        assignment: List[Optional[Op]] = [None] * n
        used: set = set()
        ext: Dict[int, int] = {}  # external id -> tensor guid

        def wire_ok(i: int, op: Op, new_ext: Dict[int, int]) -> bool:
            _pat, inputs = self._src[i]
            if len(op.inputs) != len(inputs):
                return False
            for j, ref in enumerate(inputs):
                actual = op.inputs[j]
                if ref.op_id >= 0:
                    if (actual.owner_op is not assignment[ref.op_id]
                            or actual.owner_idx != ref.ts_id):
                        return False
                else:
                    bound = ext.get(ref.op_id, new_ext.get(ref.op_id))
                    if bound is None:
                        new_ext[ref.op_id] = actual.guid
                    elif bound != actual.guid:
                        return False
            return True

        def backtrack(i: int):
            if i == n:
                out.append(Match(self, tuple(assignment)))
                return
            pat, _ = self._src[i]
            for op in by_type.get(_graph_key(pat.type), []):
                if op.guid in used or not self._op_matches(pat, op):
                    continue
                new_ext: Dict[int, int] = {}
                if not wire_ok(i, op, new_ext):
                    continue
                assignment[i] = op
                used.add(op.guid)
                ext.update(new_ext)
                backtrack(i + 1)
                assignment[i] = None
                used.discard(op.guid)
                for k in new_ext:
                    ext.pop(k, None)

        backtrack(0)
        return out

    # -- replacement -----------------------------------------------------
    def _make_dst_op(self, pat: TasoOp, new_inputs: List[ParallelTensor],
                     match: Match, name: str) -> Op:
        from ..ops.element import (ElementBinary, ElementBinaryParams,
                                   ElementUnary, ElementUnaryParams)
        from ..ops.shape import Concat, ConcatParams, Split, SplitParams
        from ..parallel.parallel_op import (Combine, CombineParams,
                                            FoldReduce, FoldReduceParams,
                                            Repartition, RepartitionParams,
                                            StackReplicate,
                                            StackReplicateParams)

        t = pat.type
        if t in _PARALLEL_TYPES:
            rank = new_inputs[0].shape.logical_rank
            dim = pat.at("PM_PARALLEL_DIM")
            if dim is None:
                raise UnsupportedRule(f"{t} without PM_PARALLEL_DIM")
            row = _col_to_row(dim, rank)  # raises: apply returns None
            cls, pcls, key = {
                "OP_PARTITION": (Repartition, RepartitionParams, "dim"),
                "OP_COMBINE": (Combine, CombineParams, "dim"),
                "OP_REPLICATE": (StackReplicate, StackReplicateParams, "axis"),
                "OP_REDUCE": (FoldReduce, FoldReduceParams, "axis"),
            }[t]
            return cls(pcls(**{key: row, "degree": self.degree}), new_inputs,
                       name=name)
        if t in _EW_UNARY:
            return ElementUnary(ElementUnaryParams(op=_EW_UNARY[t]),
                                new_inputs, name=name)
        if t in _EW_BINARY:
            return ElementBinary(ElementBinaryParams(op=_EW_BINARY[t]),
                                 new_inputs, name=name)
        if t == "OP_LINEAR":
            matched = match.ops[self._src_linear_idx]
            acti = pat.at("PM_ACTI")
            params = matched.params
            if acti is not None:
                if acti not in _TASO_ACTI:
                    raise UnsupportedRule(f"unknown PM_ACTI {acti}")
                params = dataclasses.replace(params,
                                             activation=_TASO_ACTI[acti])
            return clone_op(matched, new_inputs, name=name, params=params)
        rank = new_inputs[0].shape.logical_rank
        axis = pat.at("PM_AXIS")
        if axis is None:
            raise UnsupportedRule(f"{t[3:].lower()} without PM_AXIS")
        row = _col_to_row(axis, rank)
        if t == "OP_CONCAT":
            return Concat(ConcatParams(axis=row), new_inputs, name=name)
        if t == "OP_SPLIT":
            nout = _num_outputs(pat)
            size = new_inputs[0].shape.logical_shape[row]
            if size % nout != 0:
                # the reference's INVALID_NODE (substitution.cc:884-890)
                raise UnsupportedRule("split size not divisible")
            return Split(SplitParams(sizes=(size // nout,) * nout, axis=row),
                         new_inputs, name=name)
        raise UnsupportedRule(f"dst op type {t}")

    def build_replacement(self, match: Match, ext: Dict[int, ParallelTensor],
                          new_graph: Graph) -> Dict[int, ParallelTensor]:
        # the external bindings, derived as matching derived them
        ext_bind: Dict[int, ParallelTensor] = {}
        for i, (_pat, inputs) in enumerate(self._src):
            op = match.ops[i]
            for j, ref in enumerate(inputs):
                if ref.op_id < 0 and ref.op_id not in ext_bind:
                    ext_bind[ref.op_id] = ext[op.inputs[j].guid]
        base = match.ops[0].name
        one_linear = sum(1 for p, _ in self._dst
                         if p.type == "OP_LINEAR") == 1
        new_ops: List[Op] = []
        for i, (pat, inputs) in enumerate(self._dst):
            new_inputs = []
            for ref in inputs:
                if ref.op_id < 0:
                    if ref.op_id not in ext_bind:
                        raise UnsupportedRule(
                            f"dst references unbound external {ref.op_id}")
                    new_inputs.append(ext_bind[ref.op_id])
                else:
                    new_inputs.append(new_ops[ref.op_id].outputs[ref.ts_id])
            # a rule's only dst linear keeps the matched linear's name, so
            # that its weights carry over by name
            if pat.type == "OP_LINEAR" and one_linear:
                name = match.ops[self._src_linear_idx].name
            else:
                name = f"{base}.{self.rule.name}.{i}"
            op = self._make_dst_op(pat, new_inputs, match, name)
            new_graph.add_op(op)
            new_ops.append(op)
        return {
            match.ops[m.src_op_id].outputs[m.src_ts_id].guid:
                new_ops[m.dst_op_id].outputs[m.dst_ts_id]
            for m in self.rule.mapped_outputs
        }


# --------------------------------------------------------------------------
# Catalog conversion and per-rule numerical verification
# --------------------------------------------------------------------------

def _probe_seed(op_name: str, weight_name: str) -> int:
    """A verification weight's seed: a stable digest of its names (the
    reference's hash() of the names is salted per process)."""
    digest = hashlib.sha256(f"{op_name}/{weight_name}".encode()).digest()
    return int.from_bytes(digest[:4], "little") % 2**31


def _run_probes(graph: Graph, feeds: Dict[str, "object"]) -> Dict:
    """Every probe op's output of `graph` on float32 CPU tensors, the
    weights drawn from `_probe_seed`."""
    import numpy as np
    import torch

    vals, out = {}, {}
    with torch.no_grad():
        for op in graph.topo_order():
            if op.op_type == OperatorType.INPUT:
                vals[op.outputs[0].guid] = torch.from_numpy(feeds[op.name])
                continue
            ws = []
            for spec in op.weight_specs:
                shape = tuple(d.size for d in spec.shape.dims
                              if not d.is_replica_dim)
                ws.append(torch.from_numpy(
                    np.random.RandomState(_probe_seed(op.name, spec.name))
                    .randn(*shape).astype(np.float32) * 0.1))
            res = op.forward([vals[t.guid] for t in op.inputs], ws)
            for t, v in zip(op.outputs, res):
                vals[t.guid] = v
            if op.name.startswith("probe"):
                out[op.name] = res[0].numpy()
    return out


def verify_rule(prule: PatternRule) -> str:
    """Verify one compiled rule numerically under the realized
    semantics: instantiate its src pattern, match it, apply, and compare
    the probe outputs.  The verdict:

      "exact"      the rewrite is a numerical identity;
      "family"     shapes kept but a linear's input changed (a
                   weight-repacking equivalence: the same function
                   class at the same FLOPs);
      "fail: ..."  not validated; the rule must not be used.

    TASO verifies every generated rule; the reference ingests the
    catalog unverified.  The StackReplicate and FoldReduce realization
    fixes a block order, so the few catalog rules that hold only in the
    layout-free parallel-tensor algebra fail here."""
    import numpy as np

    inst = instantiate_src(prule, probes=True)
    if inst is None:
        return "fail: could not instantiate src pattern"
    g, _ = inst
    matches = prule.find_matches(g)
    if not matches:
        return "fail: src pattern does not self-match"
    g2 = None
    for m in matches:
        g2 = prule.apply(g, m)
        if g2 is not None:
            break
    if g2 is None:
        return "fail: apply rejected by shape rules"
    feeds = {
        op.name: np.random.RandomState(7).randn(
            *op.outputs[0].shape.logical_shape).astype(np.float32)
        for op in g.ops if op.op_type == OperatorType.INPUT
    }
    try:
        o1, o2 = _run_probes(g, feeds), _run_probes(g2, feeds)
    except Exception as e:  # noqa: BLE001 — any forward failure fails it
        return f"fail: execution error {type(e).__name__}"
    if set(o1) != set(o2) or any(o1[k].shape != o2[k].shape for k in o1):
        return "fail: probe shape mismatch"
    if all(np.allclose(o1[k], o2[k], rtol=1e-4, atol=1e-4) for k in o1):
        return "exact"
    src_lin = sorted(tuple(op.inputs[0].shape.logical_shape)
                     for op in g.ops if op.op_type == OperatorType.LINEAR)
    dst_lin = sorted(tuple(op.inputs[0].shape.logical_shape)
                     for op in g2.ops if op.op_type == OperatorType.LINEAR)
    if src_lin != dst_lin:
        return "family"
    return "fail: numeric mismatch"


def _verify_cache_path() -> str:
    """The port's verdict cache, under its own cache directory
    ($FLEXFLOW_TPU_TORCH_CACHE_DIR), never the JAX package's."""
    from ..sim.simulator import cache_dir

    base = cache_dir()
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, "taso_verify.json")


def _verified_verdicts(path: str, rules: Sequence[TasoRule]
                       ) -> Dict[str, str]:
    """Per-rule verdicts for a catalog file, cached on disk under (file
    identity, engine version).  Verification does not depend on the
    degree; it runs at 2, the catalog's template degree."""
    key = f"{os.path.abspath(path)}:{os.path.getmtime(path)}:v{ENGINE_VERSION}"
    cache_file = _verify_cache_path()
    try:
        with open(cache_file) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        cache = {}
    if isinstance(cache, dict) and key in cache:
        return cache[key]
    verdicts: Dict[str, str] = {}
    for r in rules:
        try:
            pr = PatternRule(r, degree=2)
        except UnsupportedRule as e:
            verdicts[r.name] = f"skip: {e.args[0] if e.args else 'unsupported'}"
            continue
        verdicts[r.name] = verify_rule(pr)
    try:
        with open(cache_file, "w") as f:
            json.dump({key: verdicts}, f)  # the latest file identity only
    except OSError:
        pass
    return verdicts


def convert_rules(
    rules: Sequence[TasoRule],
    degrees: Sequence[int] = (2,),
    verdicts: Optional[Dict[str, str]] = None,
) -> Tuple[List[PatternRule], Dict[str, int]]:
    """Compile parsed rules into PatternRules: a parallel-op rule once
    per degree (the reference calls create_xfers per considered degree,
    substitution.cc:1779-1786), a purely algebraic one once.  With
    `verdicts` (`_verified_verdicts`) only rules verified "exact" or
    "family" are kept.  Returns (rules, report), the report counting
    "converted", "instantiated" and each "skip: <reason>"."""
    out: List[PatternRule] = []
    report: Dict[str, int] = {"converted": 0, "instantiated": 0}

    def skip(reason: str):
        key = f"skip: {reason}"
        report[key] = report.get(key, 0) + 1

    for r in rules:
        if verdicts is not None:
            v = verdicts.get(r.name, "fail: unverified")
            if v.startswith("skip: "):
                skip(v[6:])
                continue
            if v.startswith("fail"):
                skip(f"verification ({v})")
                continue
        try:
            first = PatternRule(r, degree=int(degrees[0]) if degrees else 2)
        except UnsupportedRule as e:
            skip(e.args[0] if e.args else "unsupported")
            continue
        report["converted"] += 1
        out.append(first)
        if first.uses_parallel:
            out.extend(PatternRule(r, degree=int(d)) for d in degrees[1:])
    report["instantiated"] = len(out)
    return out, report


def load_taso_rules(
    path: str, degrees: Sequence[int] = (2,), verify: bool = True
) -> Tuple[List[PatternRule], Dict[str, int]]:
    """The catalog at `path` parsed, verified and compiled at `degrees`:
    (rules, convert_rules' report)."""
    rules = parse_rule_collection(path)
    verdicts = _verified_verdicts(path, rules) if verify else None
    return convert_rules(rules, degrees, verdicts=verdicts)


# --------------------------------------------------------------------------
# Pattern instantiation: a rule's src pattern as a concrete graph, so that
# match, apply and numerics can be checked per rule
# --------------------------------------------------------------------------

def _make_src_op(prule: PatternRule, pat: TasoOp,
                 new_inputs: List[ParallelTensor], name: str) -> Op:
    """The concrete op of a src pattern node (a linear, with no match to
    copy attributes from, gets synthetic params)."""
    if pat.type == "OP_LINEAR":
        from ..ops.dense import Linear, LinearParams

        acti = pat.at("PM_ACTI")
        return Linear(
            LinearParams(out_channels=8, use_bias=True,
                         activation=_TASO_ACTI.get(acti, ActiMode.NONE)
                         if acti is not None else ActiMode.NONE),
            new_inputs, name=name)
    return prule._make_dst_op(pat, new_inputs, Match(prule, ()), name)


def instantiate_src(
    prule: PatternRule, probes: bool = True
) -> Optional[Tuple[Graph, List[str]]]:
    """A Graph realizing the rule's src pattern, over a small family of
    external shapes and degrees until the shape rules accept one, with an
    identity probe op after each mapped src output (so that the
    rewritten graph keeps a same-named handle to compare).  Returns
    (graph, external input names), or None if no seed config builds."""
    from ..ops.element import ElementUnary, ElementUnaryParams
    from ..ops.sources import InputOp, SourceParams
    from ..tensor import ParallelTensorShape

    ext_ids = sorted({r.op_id for _, inputs in prule._src for r in inputs
                      if r.op_id < 0})
    d = prule.degree
    seed_cfgs = [
        ((1, 1, 1), 1), ((1, 1, 1), d), ((d, d, d), d), ((d, d, 1), d),
        ((1, d, 1), 1), ((d, 1, 1), d), ((1, 1, d), d), ((d, d, d), 1),
        ((1, d, d), d), ((d, d, 1), 1),
    ]
    size = 8 * d  # divisible through chained partitions up to d * d
    for degrees, rep in seed_cfgs:
        try:
            g = Graph()
            ext_map: Dict[int, ParallelTensor] = {}
            names = []
            for e in ext_ids:
                shape = ParallelTensorShape.make(
                    (size, size, size), degrees=degrees, replica_degree=rep)
                inp = InputOp(SourceParams(shape=shape), [], name=f"ext{-e}")
                g.add_op(inp)
                ext_map[e] = inp.outputs[0]
                names.append(inp.name)
            ops: List[Op] = []
            for i, (pat, inputs) in enumerate(prule._src):
                new_inputs = [ext_map[r.op_id] if r.op_id < 0
                              else ops[r.op_id].outputs[r.ts_id]
                              for r in inputs]
                op = _make_src_op(prule, pat, new_inputs, f"pat{i}")
                g.add_op(op)
                ops.append(op)
            if probes:
                for k, m in enumerate(prule.rule.mapped_outputs):
                    t = ops[m.src_op_id].outputs[m.src_ts_id]
                    g.add_op(ElementUnary(
                        ElementUnaryParams(op=OpUnary.IDENTITY), [t],
                        name=f"probe{k}"))
            return g, names
        except (ValueError, KeyError, IndexError):
            continue
    return None
