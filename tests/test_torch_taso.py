"""The port's TASO catalog engine (flexflow_tpu_torch/pcg/taso.py,
taso_pb.py) against flexflow_tpu's on catalogs these tests write, as JSON
and as proto2 wire bytes (the port's encoder against one built from the
reference's protowire codec): the parse, every rule's verdict and the
conversion report (a disconnected src pattern, a rule that fails
verification, a weight-repacking "family" rule among them), degree
instantiation, matching and apply on the same graphs (the relu-concat
hoist, the axis convention, external binding, the linear merge chain,
the split/concat cancel), StackReplicate and FoldReduce, seeded random
graphs whose rewritten forward is the reference's plain forward, Unity
with the catalog picking the reference's strategy at its cost, and a
catalog-searched strategy file replaying in either package."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_simulator import REL, simple_machines  # noqa: E402

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu.onnx_frontend import protowire as r_wire  # noqa: E402
from flexflow_tpu.pcg import rewrite as r_rewrite  # noqa: E402
from flexflow_tpu.pcg import taso as r_taso  # noqa: E402
from flexflow_tpu.pcg import taso_pb as r_pb  # noqa: E402
from flexflow_tpu.pcg import unity as r_unity  # noqa: E402
from flexflow_tpu.sim import simulator as r_sim  # noqa: E402
from flexflow_tpu_torch.convert import from_jax_weights  # noqa: E402
from flexflow_tpu_torch.fftype import OperatorType  # noqa: E402
from flexflow_tpu_torch.pcg import rewrite as p_rewrite  # noqa: E402
from flexflow_tpu_torch.pcg import taso as p_taso  # noqa: E402
from flexflow_tpu_torch.pcg import taso_pb as p_pb  # noqa: E402
from flexflow_tpu_torch.pcg import unity as p_unity  # noqa: E402
from flexflow_tpu_torch.sim import simulator as p_sim  # noqa: E402
from flexflow_tpu_torch.strategy import (Strategy,  # noqa: E402
                                         data_parallel_strategy)


# -- the catalog ----------------------------------------------------------

def _op(t, ins=(), **params):
    return {"_t": "Operator", "type": t,
            "input": [{"_t": "Tensor", "opId": a, "tsId": b} for a, b in ins],
            "para": [{"_t": "Parameter", "key": k, "value": v}
                     for k, v in params.items()]}


def _rule(src, dst, mapped):
    return {"_t": "Rule", "srcOp": src, "dstOp": dst,
            "mappedOutput": [{"_t": "MapOutput", "srcOpId": a,
                              "dstOpId": c, "srcTsId": b, "dstTsId": d}
                             for a, b, c, d in mapped]}


def _concat(ins, axis):
    return _op("OP_CONCAT", ins, PM_NUM_INPUTS=len(ins), PM_AXIS=axis,
               PM_NUMDIM=3)


def _par(t, ins, dim):
    return _op(t, ins, PM_PARALLEL_DIM=dim, PM_PARALLEL_DEGREE=2)


# (rule, the port's and the reference's verdict); the catalog's dims and
# axes are column-major, PM_ACTI TASO-native (0 = none)
RULES = [
    # 0: concat(relu, relu) on the innermost axis -> relu(concat)
    (_rule([_op("OP_RELU", [(-1, 0)]), _op("OP_RELU", [(-2, 0)]),
            _concat([(0, 0), (1, 0)], 0)],
           [_concat([(-1, 0), (-2, 0)], 0), _op("OP_RELU", [(0, 0)])],
           [(2, 0, 1, 0)]), "exact"),
    # 1: the same on axis 1 of a rank-3 tensor
    (_rule([_op("OP_RELU", [(-1, 0)]), _op("OP_RELU", [(-2, 0)]),
            _concat([(0, 0), (1, 0)], 1)],
           [_concat([(-1, 0), (-2, 0)], 1), _op("OP_RELU", [(0, 0)])],
           [(2, 0, 1, 0)]), "exact"),
    # 2: z + (x + y) -> (z + x) + y
    (_rule([_op("OP_EW_ADD", [(-1, 0), (-2, 0)]),
            _op("OP_EW_ADD", [(-3, 0), (0, 0)])],
           [_op("OP_EW_ADD", [(-3, 0), (-1, 0)]),
            _op("OP_EW_ADD", [(0, 0), (-2, 0)])],
           [(1, 0, 1, 0)]), "exact"),
    # 3: two linears sharing only their (dropped) weight: disconnected
    (_rule([_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0),
            _op("OP_LINEAR", [(-3, 0), (-2, 0)], PM_ACTI=0)],
           [_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0),
            _op("OP_LINEAR", [(-3, 0), (-2, 0)], PM_ACTI=0)],
           [(0, 0, 0, 0), (1, 0, 1, 0)]),
     "skip: src pattern disconnected after truncation"),
    # 4: concat(fold(x), fold(y)) -> fold(concat(x, y)): true only in the
    # layout-free algebra, not under FoldReduce's block order
    (_rule([_par("OP_REDUCE", [(-1, 0)], 0), _par("OP_REDUCE", [(-2, 0)], 0),
            _concat([(0, 0), (1, 0)], 0)],
           [_concat([(-1, 0), (-2, 0)], 0), _par("OP_REDUCE", [(0, 0)], 0)],
           [(2, 0, 1, 0)]), "fail: numeric mismatch"),
    # 5: linear(concat(x, y)) -> linear(x) + linear(y): a weight repacking
    (_rule([_concat([(-1, 0), (-2, 0)], 0),
            _op("OP_LINEAR", [(0, 0), (-3, 0)], PM_ACTI=0)],
           [_op("OP_LINEAR", [(-1, 0), (-3, 0)], PM_ACTI=0),
            _op("OP_LINEAR", [(-2, 0), (-3, 0)], PM_ACTI=0),
            _op("OP_EW_ADD", [(0, 0), (1, 0)])],
           [(1, 0, 2, 0)]), "family"),
    # 6: linear -> combine(linear(partition(x))) on the outermost dim
    (_rule([_op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0)],
           [_par("OP_PARTITION", [(-1, 0)], 2),
            _op("OP_LINEAR", [(0, 0), (-2, 0)], PM_ACTI=0),
            _par("OP_COMBINE", [(1, 0)], 2)],
           [(0, 0, 2, 0)]), "exact"),
    # 7: x + y -> fold(concat(x, y))
    (_rule([_op("OP_EW_ADD", [(-1, 0), (-2, 0)])],
           [_concat([(-1, 0), (-2, 0)], 0), _par("OP_REDUCE", [(0, 0)], 0)],
           [(0, 0, 1, 0)]), "exact"),
    # 8: a trivial 1 -> 1 rule
    (_rule([_op("OP_RELU", [(-1, 0)])], [_op("OP_SIGMOID", [(-1, 0)])],
           [(0, 0, 0, 0)]), "skip: trivial 1->1 rule"),
    # 9: the dst reads an external the src never binds
    (_rule([_op("OP_RELU", [(-1, 0)]), _op("OP_RELU", [(0, 0)])],
           [_op("OP_EW_ADD", [(-1, 0), (-2, 0)])], [(1, 0, 0, 0)]),
     "skip: dst uses external unbound by src"),
    # 10: an op type the engine does not take
    (_rule([_op("OP_CONV2D", [(-1, 0)]), _op("OP_RELU", [(0, 0)])],
           [_op("OP_CONV2D", [(-1, 0)])], [(1, 0, 0, 0)]),
     "skip: op type OP_CONV2D"),
    # 11: z * (x * y) -> (z * x) * y
    (_rule([_op("OP_EW_MUL", [(-1, 0), (-2, 0)]),
            _op("OP_EW_MUL", [(-3, 0), (0, 0)])],
           [_op("OP_EW_MUL", [(-3, 0), (-1, 0)]),
            _op("OP_EW_MUL", [(0, 0), (-2, 0)])],
           [(1, 0, 1, 0)]), "exact"),
    # 12: concat(x + y, z + w) -> concat(x, z) + concat(y, w)
    (_rule([_op("OP_EW_ADD", [(-1, 0), (-2, 0)]),
            _op("OP_EW_ADD", [(-3, 0), (-4, 0)]),
            _concat([(0, 0), (1, 0)], 0)],
           [_concat([(-1, 0), (-3, 0)], 0), _concat([(-2, 0), (-4, 0)], 0),
            _op("OP_EW_ADD", [(0, 0), (1, 0)])],
           [(2, 0, 2, 0)]), "exact"),
]
VERDICTS = {f"taso_rule_{i}": v for i, (_, v) in enumerate(RULES)}
CATALOG = {"_t": "RuleCollection",
           "rule": [dict(r, name=f"taso_rule_{i}")
                    for i, (r, _) in enumerate(RULES)]}


def _reference_wire(d) -> bytes:
    """The catalog as wire bytes, built with the reference's protowire
    encoder (every field, in the schema's order)."""
    ld, vi = r_wire._ld, r_wire._vi

    def oper(o):
        out = vi(1, r_pb.OP_TYPE_NAMES.index(o["type"]))
        for t in o["input"]:
            out += ld(2, vi(1, t["opId"]) + vi(2, t["tsId"]))
        for p in o["para"]:
            out += ld(3, vi(1, r_pb.PARAM_NAMES.index(p["key"]))
                      + vi(2, p["value"]))
        return out

    out = b""
    for r in d["rule"]:
        body = b"".join(ld(1, oper(o)) for o in r["srcOp"])
        body += b"".join(ld(2, oper(o)) for o in r["dstOp"])
        for m in r["mappedOutput"]:
            body += ld(3, vi(1, m["srcOpId"]) + vi(2, m["dstOpId"])
                       + vi(3, m["srcTsId"]) + vi(4, m["dstTsId"]))
        out += ld(1, body)
    return out


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    """Both packages' verdict caches (and the port's measured costs) in
    this test's directory."""
    monkeypatch.setenv("FLEXFLOW_TPU_CACHE_DIR", str(tmp_path / "ref_cache"))
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR",
                       str(tmp_path / "port_cache"))


@pytest.fixture
def catalog(tmp_path):
    """{"json": path, "pb": path} of the test catalog."""
    js, pb = tmp_path / "graph_subst.json", tmp_path / "graph_subst.pb"
    js.write_text(json.dumps(CATALOG))
    pb.write_bytes(p_pb.dict_to_pb(CATALOG))
    return {"json": str(js), "pb": str(pb)}


def _ir(rules):
    """A package-neutral form of parsed rules."""
    return [(r.name,
             [(o.type, [(t.op_id, t.ts_id) for t in o.inputs], o.params)
              for o in r.src_ops],
             [(o.type, [(t.op_id, t.ts_id) for t in o.inputs], o.params)
              for o in r.dst_ops],
             [(m.src_op_id, m.src_ts_id, m.dst_op_id, m.dst_ts_id)
              for m in r.mapped_outputs]) for r in rules]


# -- parse and conversion -------------------------------------------------

def test_wire_bytes_match_the_reference_encoder(catalog):
    wire = p_pb.dict_to_pb(CATALOG)
    assert wire == _reference_wire(CATALOG)
    assert p_pb.pb_to_dict(wire) == r_pb.pb_to_dict(wire) == CATALOG
    assert p_pb.looks_like_pb(catalog["pb"])
    assert not p_pb.looks_like_pb(catalog["json"])


@pytest.mark.parametrize("form", ["json", "pb"])
def test_parse_matches_the_reference(catalog, form):
    mine = p_taso.parse_rule_collection(catalog[form])
    ref = r_taso.parse_rule_collection(catalog[form])
    assert _ir(mine) == _ir(ref)
    assert _ir(mine) == _ir(p_taso.parse_rule_collection(catalog["json"]))
    assert len(mine) == len(RULES)
    assert p_taso.is_taso_rule_file(catalog[form])


def test_newline_led_json_catalog_parses(tmp_path):
    path = tmp_path / "nl.json"
    path.write_text("\n" + json.dumps(CATALOG))
    assert p_pb.looks_like_pb(str(path)) and p_taso.is_taso_rule_file(
        str(path))
    assert _ir(p_taso.parse_rule_collection(str(path))) == _ir(
        r_taso.parse_rule_collection(str(path)))
    own = tmp_path / "rewrites.json"
    own.write_text("\n" + json.dumps({"rewrites": []}))
    assert not p_taso.is_taso_rule_file(str(own))


@pytest.mark.parametrize("form", ["json", "pb"])
def test_verdicts_and_report_match_the_reference(catalog, form):
    path = catalog[form]
    mine = p_taso._verified_verdicts(path, p_taso.parse_rule_collection(path))
    ref = r_taso._verified_verdicts(path, r_taso.parse_rule_collection(path))
    assert mine == ref == VERDICTS
    p_rules, p_report = p_taso.load_taso_rules(path, degrees=(2, 4))
    r_rules, r_report = r_taso.load_taso_rules(path, degrees=(2, 4))
    assert p_report == r_report
    assert p_report["converted"] == sum(v in ("exact", "family")
                                        for v in VERDICTS.values())
    assert [p.name for p in p_rules] == [r.name for r in r_rules]
    assert all(isinstance(p, p_taso.PatternRule) for p in p_rules)


def test_the_verdict_cache_is_the_ports_own(catalog, tmp_path):
    """A reference cache that holds other verdicts for the same file and
    engine version is not read: the port runs its own verifier and keeps
    its verdicts under FLEXFLOW_TPU_TORCH_CACHE_DIR."""
    path = catalog["json"]
    rules = p_taso.parse_rule_collection(path)
    key = (f"{os.path.abspath(path)}:{os.path.getmtime(path)}"
           f":v{r_taso.ENGINE_VERSION}")
    ref_file = r_taso._verify_cache_path()
    with open(ref_file, "w") as f:
        json.dump({key: {r.name: "exact" for r in rules}}, f)
    assert p_taso._verified_verdicts(path, rules) == VERDICTS
    port_file = p_taso._verify_cache_path()
    assert port_file.startswith(str(tmp_path / "port_cache"))
    with open(port_file) as f:
        assert json.load(f) == {key: VERDICTS}
    assert p_taso.ENGINE_VERSION == r_taso.ENGINE_VERSION == 2


def test_degree_instantiation(catalog):
    rules = p_taso.parse_rule_collection(catalog["json"])
    one, _ = p_taso.convert_rules(rules, degrees=(2,))
    four, _ = p_taso.convert_rules(rules, degrees=(2, 4, 8, 16))
    parallel = [p for p in one if p.uses_parallel]
    assert [p.rule.name for p in parallel] == [
        "taso_rule_4", "taso_rule_6", "taso_rule_7"]
    assert len(four) == 4 * len(parallel) + (len(one) - len(parallel))
    assert {p.name for p in four if p.rule.name == "taso_rule_6"} == {
        "taso_rule_6@2", "taso_rule_6@4", "taso_rule_6@8", "taso_rule_6@16"}
    ref, _ = r_taso.convert_rules(r_taso.parse_rule_collection(
        catalog["json"]), degrees=(2, 4, 8, 16))
    assert [p.name for p in four] == [r.name for r in ref]


def test_rule_lists_take_the_catalog(catalog):
    """load_rewrite_rules, rules_for_config and rules_for_replay take a
    RuleCollection, the rules named as the reference names them."""
    loaded = p_rewrite.load_rewrite_rules(catalog["pb"], degrees=(2,))
    assert loaded and all(isinstance(r, p_taso.PatternRule) for r in loaded)
    cfg = P.FFConfig(device="cpu", substitution_json=catalog["json"])
    rcfg = R.FFConfig(substitution_json=catalog["json"])
    mine = [r.name for r in p_rewrite.rules_for_config(cfg)]
    assert mine == [r.name for r in r_rewrite.rules_for_config(rcfg)]
    assert "taso_rule_6@16" in mine and len(mine) > 6
    s = data_parallel_strategy(1)
    s.rewrites = [["taso_rule_0@2", 0]]
    assert [r.name for r in p_rewrite.rules_for_replay(cfg, s)] == mine


# -- matching and apply ---------------------------------------------------

def _branchy(pkg, concat_axis=2):
    ff = (pkg.FFModel(pkg.FFConfig(batch_size=8, device="cpu"))
          if pkg is P else pkg.FFModel(pkg.FFConfig(batch_size=8,
                                                    num_devices=1)))
    x = ff.create_tensor([8, 4, 16], name="x")
    a = ff.relu(ff.dense(x, 32, name="fa"), inplace=False)
    b = ff.relu(ff.dense(x, 32, name="fb"), inplace=False)
    t = ff.concat([a, b], axis=concat_axis)
    t = ff.dense(t, 8, name="head")
    ff.softmax(t)
    return ff


def _rule_pair(catalog, name):
    mine = {r.name: r for r in p_taso.load_taso_rules(catalog["json"])[0]}
    ref = {r.name: r for r in r_taso.load_taso_rules(catalog["json"])[0]}
    return mine[name], ref[name]


def _ops(graph):
    """A package-neutral form of a graph's ops in topological order."""
    return [(op.name, op.op_type.value, [t.name for t in op.inputs],
             [tuple(t.shape.logical_shape) for t in op.outputs])
            for op in graph.topo_order()]


def _apply_both(rules, graphs):
    """Every match of each package's rule applied: the same matched op
    names and the same rewritten graphs."""
    out = []
    for rule, g in zip(rules, graphs):
        ms = rule.find_matches(g)
        out.append(([[o.name for o in m.ops] for m in ms],
                    [_ops(rule.apply(g, m)) for m in ms]))
    assert out[0] == out[1]
    return out[0]


def test_relu_concat_hoist_matches_and_applies(catalog):
    rules = _rule_pair(catalog, "taso_rule_0@2")
    graph = _branchy(P).layers
    names, _ = _apply_both(rules, (graph, _branchy(R).layers))
    assert len(names) == 1
    g2 = rules[0].apply(graph, rules[0].find_matches(graph)[0])
    relus = [op for op in g2.ops if op.op_type == OperatorType.ELEMENT_UNARY]
    assert len(relus) == 1
    assert relus[0].inputs[0].owner_op.op_type == OperatorType.CONCAT


def test_axis_convention_respected(catalog):
    """Catalog axes are column-major: the innermost-axis rule does not
    match a concat on axis 1 of a rank-3 tensor, its axis-1 sibling
    does."""
    inner = _rule_pair(catalog, "taso_rule_0@2")
    middle = _rule_pair(catalog, "taso_rule_1@2")
    graphs = (_branchy(P, 1).layers, _branchy(R, 1).layers)
    assert _apply_both(inner, graphs) == ([], [])
    assert len(_apply_both(middle, graphs)[0]) == 1


def test_external_binding_is_positional_and_consistent(catalog):
    rules = _rule_pair(catalog, "taso_rule_2@2")

    def chain(pkg, nested_first):
        ff = (pkg.FFModel(pkg.FFConfig(batch_size=4, device="cpu"))
              if pkg is P else pkg.FFModel(pkg.FFConfig(batch_size=4,
                                                        num_devices=1)))
        x, y, z = (ff.create_tensor([4, 4, 8], name=n) for n in "xyz")
        inner = ff.add(x, y)
        ff.add(inner, z) if nested_first else ff.add(z, inner)
        return ff.layers

    assert len(_apply_both(rules, (chain(P, False), chain(R, False)))[0]) >= 1
    assert _apply_both(rules, (chain(P, True), chain(R, True))) == ([], [])


def test_merge_chain_reaches_one_matmul(catalog):
    """merge_parallel_linear, the relu-concat hoist and cancel_split_concat
    collapse the two dense+relu branches into one dense+relu, in the
    same variants as the reference's enumeration."""
    def variants(pkg_rewrite, pkg_taso, graph):
        rules = (pkg_rewrite.generate_rewrite_rules()
                 + pkg_taso.load_taso_rules(catalog["json"])[0])
        return pkg_rewrite.enumerate_variants(graph, rules, max_depth=3,
                                              max_variants=24)

    mine = variants(p_rewrite, p_taso, _branchy(P).layers)
    ref = variants(r_rewrite, r_taso, _branchy(R).layers)
    assert [t for _, t in mine] == [t for _, t in ref]
    assert [_ops(g) for g, _ in mine] == [_ops(g) for g, _ in ref]
    # the whole catalog fills the 24 variants before the chain's third
    # step; the built-in rules and the hoist alone reach it
    hoist = [r for r in p_taso.load_taso_rules(catalog["json"])[0]
             if r.name == "taso_rule_0@2"]
    mine = p_rewrite.enumerate_variants(
        _branchy(P).layers, p_rewrite.generate_rewrite_rules() + hoist,
        max_depth=3, max_variants=24)
    ref = r_rewrite.enumerate_variants(
        _branchy(R).layers, r_rewrite.generate_rewrite_rules()
        + [r for r in r_taso.load_taso_rules(catalog["json"])[0]
           if r.name == "taso_rule_0@2"], max_depth=3, max_variants=24)
    assert [_ops(g) for g, _ in mine] == [_ops(g) for g, _ in ref]
    merged = [t for g, t in mine
              if [op.op_type.value for op in g.compute_ops()].count(
                  "linear") == 2
              and not any(op.op_type in (OperatorType.CONCAT,
                                         OperatorType.SPLIT)
                          for op in g.ops)]
    assert merged and ["taso_rule_0@2", 0] in merged[0]


def test_split_concat_cancel_matches_the_reference():
    def graph(pkg):
        ff = (pkg.FFModel(pkg.FFConfig(batch_size=4, device="cpu"))
              if pkg is P else pkg.FFModel(pkg.FFConfig(batch_size=4,
                                                        num_devices=1)))
        x = ff.create_tensor([4, 16], name="x")
        parts = ff.split(x, [8, 8], axis=1)
        ff.dense(ff.concat(list(parts), axis=1), 4, name="head")
        return ff.layers

    rules = (p_rewrite.CancelSplitConcat(), r_rewrite.CancelSplitConcat())
    names, graphs = _apply_both(rules, (graph(P), graph(R)))
    assert len(names) == 1
    assert [k for _, k, _, _ in graphs[0]] == ["input", "linear"]


def test_stack_replicate_and_fold_reduce_forwards():
    import jax.numpy as jnp
    from flexflow_tpu.ops.sources import InputOp as RInput
    from flexflow_tpu.ops.sources import SourceParams as RSource
    from flexflow_tpu.parallel import parallel_op as r_pop
    from flexflow_tpu.tensor import ParallelTensorShape as RShape

    from flexflow_tpu_torch.ops.sources import InputOp, SourceParams
    from flexflow_tpu_torch.parallel import parallel_op as p_pop
    from flexflow_tpu_torch.tensor import ParallelTensorShape

    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    for axis, degree in ((1, 3), (0, 2)):
        p_in = InputOp(SourceParams(shape=ParallelTensorShape.make((4, 6))),
                       [], name="x").outputs[0]
        r_in = RInput(RSource(shape=RShape.make((4, 6))), [],
                      name="x").outputs[0]
        p_st = p_pop.StackReplicate(p_pop.StackReplicateParams(axis, degree),
                                    [p_in])
        r_st = r_pop.StackReplicate(r_pop.StackReplicateParams(axis, degree),
                                    [r_in])
        assert (p_st.outputs[0].shape.logical_shape
                == r_st.outputs[0].shape.logical_shape)
        y = p_st.forward([torch.from_numpy(x)], [])[0]
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(r_st.forward([jnp.asarray(x)], [])[0]))
        p_fd = p_pop.FoldReduce(p_pop.FoldReduceParams(axis, degree),
                                [p_st.outputs[0]])
        r_fd = r_pop.FoldReduce(r_pop.FoldReduceParams(axis, degree),
                                [r_st.outputs[0]])
        z = p_fd.forward([y], [])[0]
        np.testing.assert_allclose(
            z.numpy(), np.asarray(r_fd.forward([jnp.asarray(y.numpy())],
                                               [])[0]), rtol=1e-6)
        np.testing.assert_allclose(z.numpy(), degree * x, rtol=1e-6)


def _random_graph(pkg, seed):
    """A seeded soup of the catalog's shapes on [4, 4, 8] tensors (add
    and multiply chains with a shared operand, concat of relus and of
    adds, dense layers), every dangling tensor projected by a dense head
    and summed into one sink."""
    rs = np.random.RandomState(seed)
    ff = (pkg.FFModel(pkg.FFConfig(batch_size=4, device="cpu"))
          if pkg is P else pkg.FFModel(pkg.FFConfig(batch_size=4,
                                                    num_devices=1)))
    pool = [ff.create_tensor([4, 4, 8], name=f"in{k}") for k in range(3)]
    wide = []
    for step in range(8):
        k = rs.randint(0, 5)
        pick = lambda: pool[rs.randint(0, len(pool))]  # noqa: E731
        if k == 0:
            x, y, z = pick(), pick(), pick()
            op = ff.add if rs.rand() < 0.5 else ff.multiply
            c = op(x, y)
            pool += [c, op(z, c) if rs.rand() < 0.5 else op(c, z)]
        elif k == 1:
            x, y = pick(), pick()
            wide.append(ff.concat([ff.relu(x, inplace=False),
                                   ff.relu(y, inplace=False)], axis=2))
        elif k == 2:
            x, y, z = pick(), pick(), pick()
            wide.append(ff.concat([ff.add(x, y), ff.add(y, z)], axis=2))
        elif k == 3:
            pool.append(ff.dense(pick(), 8, name=f"d{step}"))
        else:
            pool.append(ff.relu(pick(), inplace=False))
    consumed = {t.guid for op in ff.layers.ops for t in op.inputs}
    dangling = [t for t in pool + wide if t.guid not in consumed]
    out = None
    for i, t in enumerate(dangling):
        h = ff.dense(t, 8, name=f"head{i}")
        out = h if out is None else ff.add(out, h)
    return ff


@pytest.mark.parametrize("seed", range(4))
def test_random_graph_rewrites_keep_the_forward(catalog, devices8, seed):
    """Every match of every exact algebraic catalog rule on a seeded
    random graph, replayed by the port's compile: the rewritten forward
    is the reference's plain forward, the weights carried over by
    from_jax_weights (rtol = atol = 1e-5)."""
    ref = _random_graph(R, seed)
    ref.compile(devices=devices8[:1])
    feeds = {f"in{k}": np.random.RandomState(100 + k).randn(4, 4, 8)
             .astype(np.float32) for k in range(3)}
    want = np.asarray(ref.forward(feeds))
    weights = ref.get_weights()
    algebraic = [r for r in p_taso.load_taso_rules(catalog["json"])[0]
                 if not r.uses_parallel and VERDICTS[r.rule.name] == "exact"]
    graph = _random_graph(P, seed).layers
    checked = 0
    for rule in algebraic:
        for idx, m in enumerate(rule.find_matches(graph)):
            if rule.apply(graph, m) is None:
                continue  # a match that is not convex
            s = data_parallel_strategy(1)
            s.rewrites = [[rule.name, idx]]
            ff = _random_graph(P, seed)
            ff.config.substitution_json = catalog["json"]
            ff.compile(strategy=s)
            ff.set_weights({k: {n: v.numpy() for n, v in d.items()}
                            for k, d in from_jax_weights(weights,
                                                         ff).items()})
            np.testing.assert_allclose(ff.forward(feeds).numpy(), want,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{rule.name}[{idx}]")
            checked += 1
    assert checked >= 1, checked


# -- search and replay ----------------------------------------------------

def test_unity_with_the_catalog_picks_the_reference_strategy(catalog):
    rm, pm = simple_machines(4)

    def search(pkg_unity, pkg_rewrite, pkg_taso, pkg_sim, ff, machine):
        rules = (pkg_rewrite.generate_rewrite_rules()
                 + pkg_taso.load_taso_rules(catalog["json"])[0])
        return pkg_unity.UnitySearch(
            ff.layers, 4, machine, pkg_sim.OpCostModel(machine), budget=20,
            rewrite_rules=rules, rewrite_depth=3,
            rewrite_max_variants=24).optimize()

    mine = search(p_unity, p_rewrite, p_taso, p_sim, _branchy(P), pm)
    ref = search(r_unity, r_rewrite, r_taso, r_sim, _branchy(R), rm)
    assert json.loads(mine.to_json()) == json.loads(ref.to_json())
    assert mine.search_cost == pytest.approx(ref.search_cost, rel=REL)
    assert mine.search_stats["catalog_variants"] > 0
    plain = p_unity.UnitySearch(
        _branchy(P).layers, 4, pm, p_sim.OpCostModel(pm), budget=20,
        rewrite_depth=3, rewrite_max_variants=24).optimize()
    assert plain.search_stats["catalog_variants"] == 0


def _replay_strategy(catalog_path):
    s = data_parallel_strategy(1)
    s.rewrites = [["taso_rule_0@2", 0]]
    s.catalog = p_rewrite.catalog_fingerprint(catalog_path)
    return s


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_catalog_strategy_file_replays_in_either_package(catalog, devices8,
                                                         tmp_path, writer,
                                                         monkeypatch):
    """A strategy whose trace holds a catalog rule, written by one
    package, replays in both (the catalog pinned by its recorded path and
    sha256): the same compiled graph and the reference's forward."""
    monkeypatch.delenv("FLEXFLOW_TPU_SUBSTITUTIONS", raising=False)
    path = str(tmp_path / "s.json")
    s = _replay_strategy(catalog["pb"])
    if writer == "port":
        s.save(path)
    else:
        from flexflow_tpu.strategy import Strategy as RStrategy

        RStrategy.from_json(s.to_json()).save(path)
    assert (p_rewrite.catalog_fingerprint(catalog["pb"])
            == r_rewrite.catalog_fingerprint(catalog["pb"]))
    ref = _branchy(R)
    ref.config.import_strategy_file = path
    ref.compile(devices=devices8[:1])
    mine = _branchy(P)
    mine.config.import_strategy_file = path
    mine.compile()
    assert mine.strategy.to_json() == Strategy.load(path).to_json()
    hoisted = [op.name for op in mine.operators.topo_order()
               if op.op_type == OperatorType.ELEMENT_UNARY]
    assert len(hoisted) == 1
    mine.set_weights(ref.get_weights())
    x = np.random.RandomState(3).randn(8, 4, 16).astype(np.float32)
    np.testing.assert_allclose(mine.forward({"x": x}).numpy(),
                               np.asarray(ref.forward({"x": x})),
                               rtol=1e-5, atol=1e-5)


def test_replay_refuses_a_changed_catalog(catalog, tmp_path, monkeypatch):
    monkeypatch.delenv("FLEXFLOW_TPU_SUBSTITUTIONS", raising=False)
    cfg = P.FFConfig(device="cpu")
    s = _replay_strategy(catalog["pb"])
    assert any(r.name == "taso_rule_0@2"
               for r in p_rewrite.rules_for_replay(cfg, s))
    bad = _replay_strategy(catalog["pb"])
    bad.catalog = dict(bad.catalog, sha256="0" * 64)
    with pytest.raises(ValueError, match="differs"):
        p_rewrite.rules_for_replay(cfg, bad)
    old = _replay_strategy(catalog["pb"])
    old.catalog = dict(old.catalog, engine=-1)
    with pytest.raises(ValueError, match="engine"):
        p_rewrite.rules_for_replay(cfg, old)
    edited = tmp_path / "edited.json"
    edited.write_text(json.dumps(dict(CATALOG, rule=CATALOG["rule"][:-1])))
    with pytest.raises(ValueError, match="differs"):
        p_rewrite.rules_for_replay(
            P.FFConfig(device="cpu", substitution_json=str(edited)), s)
    monkeypatch.setenv("FLEXFLOW_TPU_SUBSTITUTIONS", "")
    gone = _replay_strategy(catalog["pb"])
    gone.catalog = dict(gone.catalog, path="/nonexistent/catalog.pb")
    with pytest.raises(ValueError, match="no catalog"):
        p_rewrite.rules_for_replay(cfg, gone)


def test_compile_stamps_only_its_own_search(catalog):
    ff = _branchy(P)
    ff.config.substitution_json = catalog["json"]
    fresh = data_parallel_strategy(1)
    fresh.rewrites = [["taso_rule_0@2", 0]]
    ff._stamp_catalog(fresh)
    assert fresh.catalog == p_rewrite.catalog_fingerprint(catalog["json"])
    pinned = _replay_strategy(catalog["pb"])
    ff._stamp_catalog(pinned)
    assert pinned.catalog == p_rewrite.catalog_fingerprint(catalog["pb"])
    builtin = data_parallel_strategy(1)
    builtin.rewrites = [["fuse_linear_activation", 0]]
    ff._stamp_catalog(builtin)
    assert builtin.catalog is None


def test_event_rerank_keeps_the_analytic_price_of_a_layout_it_cannot_group(
        catalog):
    """The catalog's partition around ffn2 on {data: 2, model: 4} moves
    the batch dim from the model axis to the data axis at its combine,
    which the event simulator cannot group by mesh axes: that is a
    layout it cannot lay out (ValueError), so the Unity rerank keeps the
    candidate's analytic price instead of the search failing (found by
    the 8-GPU catalog search on the card)."""
    from flexflow_tpu_torch.models.transformer import build_bert
    from flexflow_tpu_torch.pcg.unity import assign_views
    from flexflow_tpu_torch.sim.machine_model import (machine_file,
                                                      make_machine_model)
    from flexflow_tpu_torch.sim.simulator import make_cost_model
    from flexflow_tpu_torch.sim.taskgraph import TaskGraphSimulator
    from flexflow_tpu_torch.strategy import apply_strategy

    cfg = P.FFConfig(device="cpu", batch_size=8,
                     substitution_json=catalog["json"],
                     machine_model_file=machine_file("hgx_h100_8"))
    ff = P.FFModel(cfg)
    build_bert(ff, batch_size=8, seq_length=16, hidden_size=32, num_layers=1,
               num_heads=4, intermediate_size=64)
    rules = p_rewrite.rules_for_config(cfg)
    s = Strategy(mesh_axes={"data": 2, "model": 4})
    s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": 2})]
    s.rewrites = [["taso_rule_6@2", 0]]
    rewritten = p_rewrite.apply_rewrites(ff.layers, s.rewrites, rules)
    g = apply_strategy(rewritten, s)
    assign_views(g, s.mesh_axes)
    machine = make_machine_model(cfg, 8)
    cm = make_cost_model(cfg, machine)
    with pytest.raises(ValueError, match="views disagree"):
        TaskGraphSimulator(machine, cm).simulate(g, s.mesh_axes,
                                                 training=True)
    search = p_unity.UnitySearch(ff.layers, 8, machine, cm,
                                 rewrite_rules=rules)
    assert search._event_objective(s, rewritten, 0.0) is None
