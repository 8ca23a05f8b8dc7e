"""The port's run telemetry (flexflow_tpu_torch/obs/) against
flexflow_tpu's tests/test_telemetry.py, test_topology.py's tier-split
tests and test_strategy_store.py's store counters: the same fit in both
packages (weights carried over) gives the same span names and categories
in the same order, the same metric names and kinds and the same
deterministic counters; the fidelity record's predicted fields equal the
reference's within 1e-9 under the same explicit H100 DeviceSpec, flat
and over two slices; the registry, the counters line, the log handler,
the CLI knobs and their refusals as the reference's; the disabled path
makes no span; the profile window's torch.profiler trace names the ops.
"""
import json
import logging
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu.fftype import ActiMode as RAct  # noqa: E402
from flexflow_tpu.models.transformer import build_bert as r_bert  # noqa: E402
from flexflow_tpu.sim import machine_model as r_mm  # noqa: E402
from flexflow_tpu_torch.fftype import ActiMode as PAct  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_bert  # noqa: E402
from flexflow_tpu_torch.obs import (RunTelemetry,  # noqa: E402
                                    parse_profile_steps, span_allocations)
from flexflow_tpu_torch.obs.metrics import (MetricsRegistry,  # noqa: E402
                                            emit_counters, to_prometheus)
from flexflow_tpu_torch.sim import machine_model as p_mm  # noqa: E402

# one H100 SXM5, given to both packages (tests/test_torch_simulator.py)
SPEC = dict(peak_flops=989.4e12, peak_flops_f32=66.9e12,
            hbm_bandwidth=3.35e12, hbm_capacity=80e9)
REL = 1e-9
NVLINK, NV_LAT = 450e9, 1e-6  # the port's NVLink rate and latency
# the losses of the same steps in the two packages (the training tests')
LOSS_ATOL = 1e-5
BERT = dict(batch_size=4, seq_length=16, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128, num_classes=2)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Both packages' caches in this test's directory, and the same
    explicit H100 spec for both machine models."""
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR", str(tmp_path / "pc"))
    monkeypatch.setenv("FLEXFLOW_TPU_CACHE_DIR", str(tmp_path / "rc"))
    for var in ("FLEXFLOW_TPU_TORCH_STORE_DIR", "FLEXFLOW_TPU_STORE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(r_mm, "detect_device_spec",
                        lambda: r_mm.DeviceSpec(**SPEC))
    monkeypatch.setattr(p_mm, "detect_device_spec",
                        lambda: p_mm.DeviceSpec(**SPEC))


def _mlp(pkg, **cfg):
    act = RAct if pkg is R else PAct
    if pkg is P:
        cfg["device"] = "cpu"
    else:
        cfg.setdefault("num_devices", 1)
    ff = pkg.FFModel(pkg.FFConfig(batch_size=16, search_calibrate=False,
                                  **cfg))
    x = ff.create_tensor([16, 32], name="input")
    t = ff.dense(x, 64, activation=act.RELU)
    ff.dense(t, 10)
    return ff


def _compile(ff, **kw):
    pkg = R if isinstance(ff, R.FFModel) else P
    if pkg is R:
        kw.setdefault("devices", jax.devices("cpu")[:1])
    ff.compile(optimizer=pkg.SGDOptimizer(lr=0.01),
               loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy", "sparse_categorical_crossentropy"],
               **kw)
    return ff


def _data(n=64, in_dim=32, classes=10):
    rng = np.random.RandomState(0)
    return (rng.randn(n, in_dim).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int32))


def _match_be_pairs(events):
    """B/E events per (pid, tid) with stack discipline: the matched
    (name, cat, duration) list; nothing may dangle."""
    stacks, pairs = {}, []
    for ev in events:
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev)
        elif ev["ph"] == "E":
            stack = stacks.get(key)
            assert stack, f"E event with empty stack: {ev}"
            b = stack.pop()
            assert ev["ts"] >= b["ts"]
            pairs.append((b["name"], b["cat"], ev["ts"] - b["ts"]))
    for key, stack in stacks.items():
        assert not stack, f"unclosed B events on {key}: {stack}"
    return pairs


def _begins(trace_path):
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    _match_be_pairs(events)
    return [(e["name"], e["cat"]) for e in events if e["ph"] == "B"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# -- a traced fit against the reference's ----------------------------------

@pytest.mark.parametrize("model", ["mlp", "bert"])
def test_traced_fit_matches_the_reference(tmp_path, model):
    """The same fit (2 epochs, weights carried over) with trace_dir in
    both packages: the same spans in the same order, the same metric
    names and kinds, fit/metrics/* equal (the losses within the training
    tests' 1e-5), one fidelity record with the reference's fields."""
    if model == "mlp":
        r = _compile(_mlp(R, trace_dir=str(tmp_path / "r")))
        p = _compile(_mlp(P, trace_dir=str(tmp_path / "p")))
        x, y = _data(64)
    else:
        r = R.FFModel(R.FFConfig(batch_size=4, num_devices=1,
                                 search_calibrate=False,
                                 trace_dir=str(tmp_path / "r")))
        r_bert(r, **BERT)
        _compile(r)
        p = P.FFModel(P.FFConfig(batch_size=4, device="cpu",
                                 search_calibrate=False,
                                 trace_dir=str(tmp_path / "p")))
        build_bert(p, **BERT)
        _compile(p)
        rng = np.random.RandomState(0)
        x = rng.randn(16, 16, 64).astype(np.float32)
        y = rng.randint(0, 2, (16, 1)).astype(np.int32)
    p.set_weights(r.get_weights())
    b = 16 if model == "mlp" else 4
    r.fit(x, y, batch_size=b, epochs=2, verbose=False)
    p.fit(x, y, batch_size=b, epochs=2, verbose=False)
    want = _begins(os.path.join(tmp_path, "r", "trace.json"))
    got = _begins(os.path.join(tmp_path, "p", "trace.json"))
    assert got == want
    assert [n for n, _ in got].count("step") == 8
    assert [n for n, _ in got].count("host_transfer") == 8
    rr = _records(os.path.join(tmp_path, "r", "run_telemetry.jsonl"))
    pr = _records(os.path.join(tmp_path, "p", "run_telemetry.jsonl"))
    assert all(rec["schema"] == 1 for rec in pr)
    assert sorted((q["kind"], q["name"]) for q in pr) == \
        sorted((q["kind"], q["name"]) for q in rr)
    rg = {q["name"]: q for q in rr if q["kind"] in ("gauge", "counter")}
    pg = {q["name"]: q for q in pr if q["kind"] in ("gauge", "counter")}
    for name in ("fit/metrics/train_all", "fit/metrics/train_correct",
                 "fit/metrics/accuracy"):
        assert pg[name]["value"] == rg[name]["value"], name
    assert pg["fit/metrics/sparse_cce_loss"]["value"] == pytest.approx(
        rg["fit/metrics/sparse_cce_loss"]["value"], abs=LOSS_ATOL * 16)
    ph = {q["name"]: q for q in pr if q["kind"] == "histogram"}
    assert ph["fit/step_ms"]["count"] == 8
    assert ph["fit/epoch_s"]["count"] == 2
    (rf,) = [q for q in rr if q["kind"] == "fidelity"]
    (pf,) = [q for q in pr if q["kind"] == "fidelity"]
    assert sorted(pf) == sorted(rf)
    assert pf["predicted_vs_measured"] == pytest.approx(
        pf["predicted_step_ms"] / pf["measured_step_ms"], abs=1e-4)
    assert pf["steps_measured"] == rf["steps_measured"] == 8
    assert pf["mesh_axes"] == rf["mesh_axes"] and pf["num_devices"] == 1


def test_crashed_fit_still_writes_artifacts(tmp_path):
    class Boom(Exception):
        pass

    class Crasher:
        def on_train_begin(self, ff):
            pass

        def on_epoch_end(self, ff, epoch, pm):
            raise Boom()

    td = str(tmp_path / "t")
    p = _compile(_mlp(P, trace_dir=td))
    x, y = _data(64)
    with pytest.raises(Boom):
        p.fit(x, y, epochs=2, verbose=False, callbacks=[Crasher()])
    names = [n for n, _ in _begins(os.path.join(td, "trace.json"))]
    assert names.count("step") == 4  # epoch 0's steps reached the disk
    assert os.path.exists(os.path.join(td, "run_telemetry.jsonl"))


def test_disabled_fit_allocates_no_spans():
    p = _compile(_mlp(P))
    assert not p.telemetry.enabled
    x, y = _data(64)
    before = span_allocations()
    p.fit(x, y, epochs=2, verbose=False)
    assert span_allocations() == before
    assert p.executor.op_scopes is False


@pytest.mark.parametrize("window,scopes", [
    ("1:2", [False, True, True, False]), ("0:2", [True, True, False, False])])
def test_profile_window_names_the_ops(tmp_path, window, scopes):
    """profile_steps "1:2" (the profiler warmed up over step 0) and "0:2"
    (no step before it): torch.profiler records the window's 2 steps
    only, its Chrome trace parses, every op of the graph has
    record_function ranges in it (2 steps' worth), and the op scopes are
    off again after the window."""
    td = str(tmp_path / "t")
    p = _compile(_mlp(P, trace_dir=td, profile_steps=window))
    seen = []
    step_fn = p._step_fn

    def recording(*a):
        seen.append(p.executor.op_scopes)
        return step_fn(*a)

    p._step_fn = recording
    x, y = _data(64)
    p.fit(x, y, epochs=1, verbose=False)
    assert seen == scopes
    assert p.executor.op_scopes is False
    with open(p.telemetry.profile_path) as f:
        prof = json.load(f)
    ranges = [e["name"] for e in prof["traceEvents"]
              if e.get("cat") == "user_annotation"]
    for op in p.operators.ops:
        assert ranges.count(op.name) == 2, op.name
    names = [n for n, _ in _begins(os.path.join(td, "trace.json"))]
    assert names.count("step") == 4
    with open(os.path.join(td, "trace.json")) as f:
        inst = [e["name"] for e in json.load(f)["traceEvents"]
                if e["ph"] == "i"]
    assert inst == ["torch_profiler_start", "torch_profiler_stop"]


# -- the registry -----------------------------------------------------------

def _strip_ts(records):
    return [{k: v for k, v in rec.items() if k != "ts"} for rec in records]


def _evt(name, parent=None, seq=-1, thread=1, fwd_thread=0, scope=0,
         kernels=(), t=0.0):
    """A stand-in for one of torch.profiler's CPU FunctionEvents;
    `kernels` are (name, device start) pairs, each made a device launch
    linked to it (in `_evt.device`, as `device_launches` gives them)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    _evt.ids += 1
    e = SimpleNamespace(
        id=_evt.ids, name=name, cpu_parent=parent, cpu_children=[],
        sequence_nr=seq, thread=thread, fwd_thread=fwd_thread, scope=scope,
        device_type=DeviceType.CPU,
        kernels=[SimpleNamespace(name=k) for k, _ in kernels],
        time_range=SimpleNamespace(start=t))
    _evt.device.extend((at, k, e.id) for k, at in kernels)
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def test_kernel_ops_maps_forward_and_backward_launches():
    """A forward launch takes its enclosing op range; a backward launch
    the op whose forward made its autograd node (by sequence number and
    thread), also when the node launches after an op inside it; a launch
    outside every op gets None; copies are left out; the order is the
    device's."""
    from flexflow_tpu_torch.obs.attribution import kernel_ops

    _evt.ids, _evt.device = 0, []
    attn = _evt("attn_0", t=1.0)
    fa = _evt("FlashAttention", attn, seq=5, kernels=[("flash_fwd", 10)],
              t=1.5)
    dense = _evt("dense_1", t=2.0)
    lin = _evt("aten::addmm", dense, seq=6,
               kernels=[("gemm_g", 11), ("bias", 12)], t=2.5)
    copy = _evt("aten::copy_", dense, kernels=[("Memcpy HtoD", 13)], t=2.7)
    ev1 = _evt("autograd::engine::evaluate_function: AddmmBackward0",
               thread=2, t=3.0)
    node1 = _evt("AddmmBackward0", ev1, seq=6, thread=2, fwd_thread=1,
                 scope=1, t=3.1)
    k1 = _evt("aten::mm", node1, thread=2, kernels=[("gemm_dg", 14)],
              t=3.2)
    ev2 = _evt("autograd::engine::evaluate_function: FlashAttentionBackward",
               thread=2, t=4.0)
    node2 = _evt("FlashAttentionBackward", ev2, seq=5, thread=2,
                 fwd_thread=1, scope=1, kernels=[("flash_bwd_dq", 16)],
                 t=4.1)
    zeros = _evt("aten::zeros", node2, thread=2, kernels=[("fill", 15)],
                 t=4.2)
    adam = _evt("aten::_foreach_add_", kernels=[("adam", 20)], t=9.0)
    events = [adam, zeros, node2, ev2, k1, node1, ev1, copy, lin, dense,
              fa, attn]
    assert kernel_ops(events, {"attn_0", "dense_1"}, _evt.device[::-1]) == [
        ("flash_fwd", "attn_0"), ("gemm_g", "dense_1"), ("bias", "dense_1"),
        ("gemm_dg", "dense_1"), ("fill", "attn_0"),
        ("flash_bwd_dq", "attn_0"), ("adam", None)]


def test_attribute_trace_marks_each_replay(tmp_path):
    """The kernels of each cudaGraphLaunch get the map's ops, the n-th
    launch of a kernel the n-th's of the map; a kernel a replay launches
    another number of times than the map, and a kernel outside the
    graph, get none."""
    from flexflow_tpu_torch.obs.attribution import attribute_trace

    ops = [("k_a", "attn_0"), ("k_b", "attn_0"), ("k_c", "dense_1"),
           ("k_d", None)]
    events = [{"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 0,
               "args": {"correlation": 7}},
              {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 50,
               "args": {"correlation": 9}},
              {"cat": "kernel", "name": "copy", "ts": 40,
               "args": {"correlation": 8}}]
    ts = iter(range(1, 100))
    for corr, names in ((7, ["k_a", "k_b", "k_c", "k_d"]),
                        (9, ["k_a", "k_c", "k_c", "k_d"])):
        for n in names:
            events.append({"cat": "kernel", "name": n,
                           "ts": next(ts) + (50 if corr == 9 else 0),
                           "args": {"correlation": corr}})
    path = str(tmp_path / "prof.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    got = attribute_trace(path, ops)
    assert got == {"kernels": 9, "replayed_kernels": 8, "replays": 2,
                   "attributed": 4}
    with open(path) as f:
        marked = [(e["args"]["correlation"], e["name"], e["args"].get("op"))
                  for e in json.load(f)["traceEvents"]
                  if e["cat"] == "kernel"]
    assert sorted(marked) == sorted([
        (8, "copy", None), (7, "k_a", "attn_0"), (7, "k_b", "attn_0"),
        (7, "k_c", "dense_1"), (7, "k_d", None), (9, "k_a", "attn_0"),
        (9, "k_c", None), (9, "k_c", None), (9, "k_d", None)])


def test_registry_semantics_match_the_reference():
    from flexflow_tpu.obs.metrics import MetricsRegistry as RReg
    from flexflow_tpu.obs.metrics import to_prometheus as r_prom

    regs = []
    for cls in (RReg, MetricsRegistry):
        reg = cls()
        c = reg.counter("c")
        c.inc()
        c.inc(4)
        assert reg.counter("c") is c and c.value == 5
        with pytest.raises(ValueError):
            c.inc(-1)
        g = reg.gauge("g/x")
        g.set(2.5)
        g.set(1.0)
        h = reg.histogram("serving/ttft_ms")
        for v, ex in ((1.0, None), (3.0, "t-1"), (2.0, "t-2")):
            h.observe(v, exemplar=ex)
        assert (h.count, h.sum, h.min, h.max) == (3, 6.0, 1.0, 3.0)
        with pytest.raises(TypeError):
            reg.gauge("c")
        reg.fold_counters("search/mcmc", {"evals": 3, "flag": True,
                                          "name": "x", "rate": 0.5})
        reg.event("log", message="m")
        reg.fidelity({"predicted_step_ms": 1.0})
        regs.append(reg)
    assert to_prometheus(regs[1]) == r_prom(regs[0])
    assert _strip_ts(regs[1].drain()) == _strip_ts(regs[0].drain())
    # the exemplar resets at the drain, the cumulative values stay
    assert _strip_ts(regs[1].drain()) == _strip_ts(regs[0].drain())


def test_emit_counters_keeps_log_line_format(caplog):
    from flexflow_tpu_torch.logger import search_logger

    reg = MetricsRegistry()
    stats = {"evals": 12, "evals_per_sec": 123.4567, "flag": True}
    with caplog.at_level(logging.INFO, logger="flexflow_tpu_torch.search"):
        emit_counters(search_logger, "mcmc eval stats", stats,
                      registry=reg, group="search/mcmc")
    assert caplog.messages == [
        "mcmc eval stats: evals=12 evals_per_sec=123.5 flag=True"]
    gauges = {r["name"]: r["value"] for r in reg.drain()
              if r["kind"] == "gauge"}
    assert gauges == {"search/mcmc/evals": 12,
                      "search/mcmc/evals_per_sec": pytest.approx(123.4567),
                      "search/mcmc/flag": 1}


def test_logger_depth_and_set_level():
    from flexflow_tpu_torch.logger import RecursiveLogger

    lg = RecursiveLogger("flexflow_tpu_torch.test_depth")
    assert lg.depth == 0
    with lg.enter("outer"):
        assert lg.depth == 1
        with lg.enter():
            assert lg.depth == 2
    assert lg.depth == 0
    lg.set_level(logging.WARNING)
    assert logging.getLogger("flexflow_tpu_torch.test_depth").level == \
        logging.WARNING


def test_calib_logger_lands_in_telemetry():
    from flexflow_tpu_torch.logger import calib_logger

    tel = RunTelemetry(enabled=True)
    try:
        calib_logger.info("region %s failed: %r", ["dense_0"], "boom")
        events = [r for r in tel.metrics.drain() if r["kind"] == "event"]
        assert any(r["fields"]["logger"] == "flexflow_tpu_torch.calib"
                   and "dense_0" in r["fields"]["message"] for r in events)
    finally:
        tel.close()


@pytest.mark.parametrize("algo", ["mcmc", "unity"])
def test_search_counters_reach_the_registry(algo):
    """The search's counters fold into the model's registry under
    search/<algo>/, with the compile/search_ms gauge and a "search"
    span; every counter that is not a time equals the reference's (the
    port's Unity also counts its catalog variants)."""
    kw = dict(telemetry=True, search_budget=2, search_algo=algo)
    r, p = _compile(_mlp(R, **kw)), _compile(_mlp(P, **kw))
    assert p.strategy.search_stats
    names = [e["name"] for e in p.telemetry.tracer.events if e["ph"] == "B"]
    assert names[:2] == ["compile", "search"]
    pg = {q["name"]: q["value"] for q in p.telemetry.metrics.drain()
          if q["kind"] == "gauge"}
    rg = {q["name"]: q["value"] for q in r.telemetry.metrics.drain()
          if q["kind"] == "gauge"}
    assert "compile/search_ms" in pg
    group = f"search/{algo}/"
    timed = ("eval_seconds", "evals_per_sec")
    want = {n: v for n, v in rg.items() if n.startswith(group)
            and not n.endswith(timed)}
    got = {n: v for n, v in pg.items() if n.startswith(group)
           and not n.endswith(timed) and n != group + "catalog_variants"}
    assert len(want) >= 10 and got == want


def test_store_metrics_reach_telemetry(tmp_path):
    """tests/test_strategy_store.py's: a miss and a publish on the
    searching model's registry, a hit with one lookup on the next; each
    package in its own store, the store/* counters (and the lookups'
    count) equal to the reference's."""
    def compiled(pkg, store):
        return _compile(_mlp(pkg, telemetry=True, search_budget=4,
                             strategy_store=str(store)))

    def store_recs(ff):
        return {r["name"]: r["value"] if r["kind"] == "counter"
                else r["count"] for r in ff.telemetry.metrics.drain()
                if r.get("name", "").startswith("store/")}

    runs = {pkg: [store_recs(compiled(pkg, tmp_path / pkg.__name__))
                  for _ in range(2)] for pkg in (R, P)}
    first, second = runs[P]
    assert first["store/misses"] == 1 and first["store/publishes"] == 1
    assert second["store/hits"] == 1 and second["store/lookup_ms"] == 1
    assert runs[P] == runs[R]


# -- fidelity ------------------------------------------------------------------

FIDELITY_FIELDS = ("predicted_step_ms", "predicted_compute_ms",
                   "predicted_comm_ms", "predicted_sync_ms",
                   "predicted_activation_bytes", "predicted_recompute_ms",
                   "predicted_ici_ms", "predicted_dcn_ms",
                   "predicted_ici_bytes", "predicted_dcn_bytes")


def _fidelity_pair(**cfg):
    """The reference's record on its 8-device CPU mesh and the port's for
    the same graph and data_parallel_strategy(8) (its PCG built as
    compile builds it on 8 ranks, over the execution mesh), both under
    the explicit H100 spec."""
    from flexflow_tpu.obs.fidelity import report_fidelity as r_report
    from flexflow_tpu.strategy import data_parallel_strategy as r_dp
    from flexflow_tpu_torch.obs.fidelity import report_fidelity
    from flexflow_tpu_torch.strategy import data_parallel_strategy
    from flexflow_tpu_torch.topology.hierarchy import execution_mesh

    r = _compile(_mlp(R, telemetry=True, num_devices=8, **cfg),
                 devices=jax.devices("cpu")[:8], strategy=r_dp(8))
    p = _mlp(P, telemetry=True, **cfg)
    strategy = data_parallel_strategy(8)
    p.strategy = strategy
    axes = strategy.mesh_axes
    if p.config.slices > 1:
        axes, _ = execution_mesh(axes, p.config.slices, 8, None, None)
    p.operators = p._operators_for(strategy, axes)
    return (r, r_report(r, measured_step_s=1e-3, steps_measured=1),
            p, report_fidelity(p, measured_step_s=1e-3, steps_measured=1))


@pytest.mark.parametrize("cfg", [
    {}, {"slices": 2, "dcn_bandwidth": 2e9, "dcn_latency": 5e-6}],
    ids=["flat", "two_slices"])
def test_fidelity_record_matches_the_reference(cfg, monkeypatch):
    """ref test_topology.py::test_fidelity_record_carries_tier_split and
    ::test_flat_fidelity_tier_split_is_all_ici: every predicted field
    within 1e-9, the tier counters equal to the record's.  Over two
    slices the reference's hierarchy runs at the port's rates (a ring
    whose links carry half NVLink's rate each way, as
    tests/test_torch_topology.py compares them)."""
    from flexflow_tpu.topology import hierarchy as r_hier

    def at_port_rates(c, n):
        return r_hier.SliceHierarchy(
            topology=(n // c.slices,), slices=c.slices,
            device=r_mm.DeviceSpec(**SPEC), ici_bw_per_link=NVLINK / 2,
            ici_latency=NV_LAT, dcn_bw_per_host=c.dcn_bandwidth,
            dcn_latency=c.dcn_latency)

    monkeypatch.setattr(r_hier, "hierarchy_from_config", at_port_rates)
    r, rrec, p, prec = _fidelity_pair(**cfg)
    assert prec is not None and rrec is not None
    for f in FIDELITY_FIELDS:
        assert prec[f] == pytest.approx(rrec[f], rel=REL, abs=1e-9), f
    assert prec["predicted_ici_bytes"] > 0
    if cfg:
        assert prec["predicted_dcn_bytes"] > 0
    else:
        assert prec["predicted_dcn_bytes"] == 0
    m = p.telemetry.metrics
    assert m.counter("comm/dcn_bytes").value == prec["predicted_dcn_bytes"]
    assert m.counter("comm/ici_bytes").value == prec["predicted_ici_bytes"]
    assert m.gauge("comm/ici_ms").value == prec["predicted_ici_ms"]
    assert prec["num_devices"] == 8 and prec["mesh_axes"] == {"data": 8}


def test_failed_fidelity_prediction_is_logged_not_raised(monkeypatch):
    from flexflow_tpu_torch.obs import fidelity

    p = _compile(_mlp(P, telemetry=True))

    def broken(ff, segment_costs=None):
        raise RuntimeError("no simulator")

    monkeypatch.setattr(fidelity, "predicted_step", broken)
    assert fidelity.report_fidelity(p, 1e-3) is None
    events = [r for r in p.telemetry.metrics.drain()
              if r["kind"] == "event"]
    assert any("no simulator" in r["fields"]["message"] for r in events)


# -- knobs -------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["--trace-dir", "T", "--profile-steps", "3:2", "--telemetry"],
    ["--checkpoint-every", "4", "--checkpoint-dir", "C"]])
def test_cli_knobs_match_the_reference(argv):
    fields = ("trace_dir", "telemetry", "profile_steps", "checkpoint_every",
              "checkpoint_dir")
    r, p = R.FFConfig.from_args(argv), P.FFConfig.from_args(argv)
    assert {f: getattr(p, f) for f in fields} == \
        {f: getattr(r, f) for f in fields}
    assert parse_profile_steps("3:2") == (3, 5)


@pytest.mark.parametrize("kw", [
    {"profile_steps": "3:2"}, {"trace_dir": "T", "profile_steps": "nope"},
    {"trace_dir": "T", "profile_steps": "3:0"},
    {"trace_dir": "T", "profile_steps": "-1:2"}, {"checkpoint_every": -1},
    {"nan_policy": "ignore"}, {"checkpoint_keep": 0}, {"max_restarts": -1},
    {"retry_backoff": -0.1}, {"step_timeout": -1.0}, {"offload_every": 0},
    {"remote_keep": 0}, {"barrier_timeout": 0.0}])
def test_config_refusals_match_the_reference(kw):
    with pytest.raises(ValueError):
        R.FFConfig(**kw)
    with pytest.raises(ValueError):
        P.FFConfig(device="cpu", **kw)


@pytest.mark.parametrize("field,value,flag", [
    ("nan_policy", "skip_step", "--nan-policy"),
    ("step_timeout", 2.5, "--step-timeout")])
def test_supervisor_knobs_wait_for_the_supervisor(field, value, flag):
    """The reference's step_timeout and nan_policy are read by its
    supervisor, which the port now has (resilience/supervisor.py): the
    field and its flag set the same value in both packages, with the
    same default."""
    assert getattr(R.FFConfig(**{field: value}), field) == value
    assert getattr(P.FFConfig(device="cpu", **{field: value}),
                   field) == value
    assert getattr(P.FFConfig.from_args([flag, str(value)]), field) == value
    assert getattr(P.FFConfig(device="cpu"), field) == \
        getattr(R.FFConfig(), field)
