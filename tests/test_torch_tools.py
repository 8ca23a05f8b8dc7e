"""The port's operator tools (flexflow_tpu_torch/tools/) against
flexflow_tpu's tools/ on the same inputs.

Each reference tool is imported from tools/ (as the reference's tests
import it) and run beside the port's through main(argv), on the same
argv: the exit codes, stdout and stderr must be identical (the --json
report too).  The inputs:
  * pb_to_json and substitutions_to_dot: chip_smoke's store catalog as
    JSON and as the wire bytes of the port's taso_pb.dict_to_pb, a JSON
    rules file, and the built-in catalog;
  * telemetry_summary: run_telemetry.jsonl files written by a traced fit
    in each package (the same MLP and weights, a strategy store and a
    search on), and synthetic records of each section the reference's
    tests render (request-trace spans, the prefix cache, the
    disaggregated fleet, the comm split, the store, the durability
    tier), written by each package's MetricsRegistry; a torn tail, a
    corrupt middle, a missing file;
  * checkpoint_fsck: directories written by the port's
    LocalCheckpointManager under the supervisor with the remote tier
    (tests/test_offload.py's fsck case), clean, with a flipped byte, a
    dangling LATEST, a diverged tier, a corrupt mirror, a missing
    manifest, a missing directory and a bad URI; and the port-only DCP
    format of CheckpointManager, against its expected exit codes;
  * strategy_store_import: the three shipped artifacts promoted into a
    store, each entry the shipped strategy, and a search of the job's
    graph a store hit (tests/test_strategy_store.py's import case);
  * check_metric_docs: the port passes, and on a copy of the port under
    both package names both tools print the same verdict, clean and
    with an undocumented metric.
"""
import contextlib
import importlib
import io
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, os.path.dirname(__file__))
import chip_smoke  # noqa: E402
import torch_dist_ranks as G  # noqa: E402

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu.obs.metrics import MetricsRegistry as RRegistry  # noqa: E402
from flexflow_tpu.obs.reqtrace import ReqTracer  # noqa: E402
from flexflow_tpu_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                           LocalCheckpointManager)
from flexflow_tpu_torch.obs.metrics import \
    MetricsRegistry as PRegistry  # noqa: E402
from flexflow_tpu_torch.resilience import offload as p_off  # noqa: E402
from flexflow_tpu_torch.resilience import supervisor as p_sup  # noqa: E402
from flexflow_tpu_torch.store import blobstore as p_blob  # noqa: E402

NO_SLEEP = lambda s: None  # noqa: E731
STRATEGIES = ROOT / "examples" / "strategies"


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR", str(tmp_path / "pc"))
    monkeypatch.setenv("FLEXFLOW_TPU_CACHE_DIR", str(tmp_path / "rc"))


def _run(module, argv):
    """(exit code, stdout, stderr) of module.main(argv)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = module.main(argv)
        except SystemExit as e:  # argparse's usage errors
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _both(name, argv):
    """The reference's tool and the port's on the same argv: the same
    (exit code, stdout, stderr), returned."""
    ref = _run(importlib.import_module(f"tools.{name}"), argv)
    port = _run(importlib.import_module(f"flexflow_tpu_torch.tools.{name}"),
                argv)
    assert port == ref
    return port


# -- the catalog tools ------------------------------------------------------

@pytest.fixture
def catalogs(tmp_path):
    """chip_smoke's store catalog as JSON and wire bytes, and a rules
    file of the built-in format."""
    paths = chip_smoke.write_store_catalog(str(tmp_path))
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"rules": [
        {"name": "lin", "op_type": "linear", "kind": "channel"},
        {"op_type": "embedding", "kind": "attribute"}]}))
    return dict(paths, rules=str(rules))


def test_pb_to_json_matches_reference(catalogs, tmp_path):
    from flexflow_tpu_torch.pcg.taso_pb import pb_to_dict

    outs = {}
    for name in ("ref", "port"):
        outs[name] = tmp_path / f"{name}.json"
        mod = importlib.import_module(
            "tools.pb_to_json" if name == "ref"
            else "flexflow_tpu_torch.tools.pb_to_json")
        outs[name + "_run"] = _run(mod, ["pb_to_json", catalogs["pb"],
                                         str(outs[name])])
    assert outs["port_run"] == outs["ref_run"] == (0, "Loaded 3 rules.\n",
                                                   "")
    assert outs["port"].read_text() == outs["ref"].read_text()
    assert json.loads(outs["port"].read_text()) == pb_to_dict(
        catalogs["pb"]) == chip_smoke.store_catalog()
    assert _both("pb_to_json", ["pb_to_json"])[0] == 1


@pytest.mark.parametrize("source", ["builtin", "rules", "json", "pb",
                                    "pb_limit"])
def test_substitutions_to_dot_matches_reference(catalogs, monkeypatch,
                                                source):
    """The same dot text; the reference's main() reads sys.argv."""
    argv = {"builtin": [], "rules": [catalogs["rules"]],
            "json": [catalogs["json"]], "pb": [catalogs["pb"]],
            "pb_limit": [catalogs["pb"], "2"]}[source]
    ref = importlib.import_module("tools.substitutions_to_dot")
    monkeypatch.setattr(sys, "argv", ["substitutions_to_dot"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.main()
    port = importlib.import_module(
        "flexflow_tpu_torch.tools.substitutions_to_dot")
    assert _run(port, argv) == (0, out.getvalue(), "")
    assert out.getvalue().startswith("digraph")


# -- telemetry_summary --------------------------------------------------------

def _mlp(ff, acti):
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 32, activation=acti.RELU, name="d0")
    t = ff.dense(t, 4, name="d1")
    ff.softmax(t, name="sm")


@pytest.fixture(scope="module")
def fit_telemetry(tmp_path_factory):
    """{package: run_telemetry.jsonl} of a traced fit of the same MLP
    from the same weights, with a strategy store and a search of budget
    2 (the Search, Store, Comm and Memory sections)."""
    root = tmp_path_factory.mktemp("telemetry")
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = rng.randint(0, 4, 64).astype(np.int32)
    kw = dict(batch_size=16, search_budget=2)
    ff = P.FFModel(P.FFConfig(device="cpu", trace_dir=str(root / "port"),
                              strategy_store=str(root / "pstore"), **kw))
    _mlp(ff, P.fftype.ActiMode)
    ff.compile(optimizer=P.SGDOptimizer(lr=0.05), seed=0)
    rf = R.FFModel(R.FFConfig(num_devices=1, trace_dir=str(root / "ref"),
                              strategy_store=str(root / "rstore"), **kw))
    _mlp(rf, R.fftype.ActiMode)
    rf.compile(optimizer=R.SGDOptimizer(lr=0.05),
               devices=jax.devices("cpu")[:1])
    rf.set_weights(ff.get_weights())
    for m in (ff, rf):
        m.fit(x, y, epochs=1, verbose=False)
        m.telemetry.flush()
    return {"port": root / "port" / "run_telemetry.jsonl",
            "ref": root / "ref" / "run_telemetry.jsonl"}


def _trace_records():
    """tests/test_reqtrace.py's make_trace_recs: two request traces."""
    reg = RRegistry()
    tr = ReqTracer(registry=reg)
    for n in (3, 1):
        ctx = tr.trace("request")
        ctx.begin("queue")
        ctx.end("queue")
        ctx.begin("decode")
        ctx.end("decode")
        ctx.finish(ok=True, n_generated=n)
    return [r for r in reg.drain() if r.get("kind") == "span"]


def _section_records(registry_cls):
    """The metrics whose sections the reference's tests render (the
    prefix cache, the disaggregated fleet, tensor parallel, the paged
    kernel, speculative decoding, the comm split, the store, the
    durability tier, resilience, a log event and a fidelity record),
    written by one package's registry."""
    reg = registry_cls()
    for name, v in (("serving/prefix_hits", 2),
                    ("serving/prefix_hit_tokens", 12),
                    ("serving/disagg_migrate_decisions", 1),
                    ("serving/disagg_reprefill_decisions", 1),
                    ("serving/kv_migration_done", 1),
                    ("serving/kv_migration_bytes", 4096),
                    ("serving/kv_migration_blocks", 2),
                    ("serving/paged_kernel_blocks_read", 7),
                    ("serving/spec_proposed", 8),
                    ("serving/spec_accepted", 5),
                    ("serving/spec_rounds", 2),
                    ("comm/ici_bytes", 1024), ("comm/dcn_bytes", 64),
                    ("store/misses", 1), ("store/publishes", 1),
                    ("store/remote_hits", 1),
                    ("resilience/offload_uploads", 3),
                    ("resilience/restarts", 2)):
        reg.counter(name).inc(v)
    for name, v in (("serving/kv_shared_blocks", 3),
                    ("serving/tp_degree", 2), ("serving/tp_chips", 2),
                    ("serving/spec_rounds_per_s", 12.5),
                    ("mem/activation_bytes", 3072)):
        reg.gauge(name).set(v)
    for name, vs in (("serving/ttft_ms", (1.5, 2.25)),
                     ("serving/spec_accepted_per_round", (2.0, 3.0)),
                     ("store/lookup_ms", (0.25,)),
                     ("resilience/offload_upload_ms", (4.0, 6.5)),
                     ("fit/step_ms", (10.0, 12.0, 11.0))):
        for v in vs:
            reg.histogram(name).observe(v)
    reg.event("log", level="INFO", logger="flexflow", message="hello")
    reg.fidelity({"source": "fit", "predicted_step_ms": 1.5,
                  "measured_step_ms": 2.0, "predicted_vs_measured": 0.75,
                  "mesh_axes": {"data": 2}, "calibrated": True})
    return reg.drain()


def _write_jsonl(path, recs, torn=None, torn_at=None):
    lines = [json.dumps(r) for r in recs]
    if torn is not None:
        lines.insert(len(lines) if torn_at is None else torn_at, torn)
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", [
    "port_fit", "ref_fit", "tracing", "disconnected", "port_sections",
    "ref_sections", "empty", "torn_tail", "torn_tail_allowed",
    "mid_file", "mid_file_allowed", "missing", "trace_dir"])
def test_telemetry_summary_matches_reference(fit_telemetry, tmp_path, case):
    path = tmp_path / "run_telemetry.jsonl"
    argv = [str(path)]
    if case in ("port_fit", "ref_fit"):
        shutil.copy(fit_telemetry[case[:-4]], path)
    elif case == "trace_dir":
        argv = [str(fit_telemetry["port"].parent)]
    elif case in ("tracing", "disconnected"):
        recs = _trace_records()
        if case == "disconnected":
            recs[0]["parent_id"] = 999999
        _write_jsonl(path, recs)
    elif case in ("port_sections", "ref_sections"):
        _write_jsonl(path, _section_records(
            PRegistry if case == "port_sections" else RRegistry))
    elif case == "empty":
        path.write_text("")
    elif case.startswith("torn_tail"):
        _write_jsonl(path, _trace_records(), torn='{"kind": "spa')
    elif case.startswith("mid_file"):
        _write_jsonl(path, _trace_records(), torn="{garbage", torn_at=2)
    if case.endswith("_allowed"):
        argv.append("--allow-torn-tail")
    rc, out, err = _both("telemetry_summary", argv)
    want_rc = 1 if case in ("torn_tail", "mid_file", "mid_file_allowed",
                            "missing") else 0
    assert rc == want_rc, (out, err)
    if case == "tracing":
        assert "Tracing" in out and "slowest req-00000" in out
    if case == "disconnected":
        assert "DISCONNECTED trees" in out
    if case == "port_sections":
        for title in ("Steps", "Store", "Resilience", "Durability", "Comm",
                      "Memory", "Serving", "Fidelity", "Log events"):
            assert f"\n{title}\n" in f"\n{out}", title
        assert "disaggregated fleet" in out and "prefix cache" in out
    if case == "mid_file_allowed":
        assert "[3]" in err and "mid-file" in err
    if case == "torn_tail_allowed":
        assert "torn tail" in err


def test_port_and_reference_fits_render_the_same_sections(fit_telemetry):
    """The port's obs/ writes the reference's schema: the same traced fit
    in both packages renders the same sections and rows, in order."""
    summary = importlib.import_module(
        "flexflow_tpu_torch.tools.telemetry_summary")

    def rows(path):
        recs, _ = summary.load_records(str(path))
        text = summary.summarize(recs)
        # the row names (and section titles), without the values; the
        # log lines name their package
        return [ln.split("  ")[0] for ln in text.splitlines()
                if ln and not ln.startswith("[")]

    port, ref = rows(fit_telemetry["port"]), rows(fit_telemetry["ref"])
    assert [r for r in port if r != "catalog_variants"] == ref
    assert {"Steps", "Compile (ms)", "Search", "Store", "Fidelity"} <= set(
        port)


# -- checkpoint_fsck ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The port's supervisor over tests/test_resilience.py's MLP: 4 steps,
    a checkpoint every 2 mirrored to a file:// tier (npz steps, the
    reference's format), and the same run with CheckpointManager (DCP
    steps, the port's own); the model, to write a diverging step."""
    root = tmp_path_factory.mktemp("fsck")
    rng = np.random.RandomState(0)
    xs = rng.randn(128, 8).astype(np.float32)
    ys = rng.randint(0, 4, 128).astype(np.int32)
    models = {}
    for backend in ("local", "dcp"):
        ff = P.FFModel(P.FFConfig(batch_size=16, device="cpu"))
        G.sup_mlp(ff)
        ff.compile(optimizer=P.SGDOptimizer(lr=0.05),
                   loss_type="sparse_categorical_crossentropy", seed=0)
        off = None
        if backend == "local":
            off = p_off.CheckpointOffloader(p_off.RemoteCheckpointStore(
                p_blob.LocalBlobStore(str(root / "remote"))), sleep=NO_SLEEP)
            off.MAX_PENDING_UPLOADS = 1 << 20
        p_sup.TrainingSupervisor(ff, str(root / backend),
                                 checkpoint_every=2, offloader=off,
                                 backend=backend, sleep=NO_SLEEP).run(
                                     xs, ys, num_steps=4)
        if off is not None:
            off.drain()
        models[backend] = ff
    ff = models["local"]
    ff.train_step({"x": xs[:16]}, ys[:16])
    return {"root": root, "model": ff}


def _flip_middle(path):
    raw = bytearray(Path(path).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    Path(path).write_bytes(bytes(raw))


@pytest.mark.parametrize("case", [
    "clean", "clean_json", "local_only", "flipped_leaf", "flipped_json",
    "dangling_latest", "diverged", "corrupt_mirror", "no_manifest",
    "torn_meta", "missing_dir", "bad_uri"])
def test_checkpoint_fsck_matches_reference(ckpt, tmp_path, case):
    local, remote = tmp_path / "ckpt", tmp_path / "remote"
    shutil.copytree(ckpt["root"] / "local", local)
    shutil.copytree(ckpt["root"] / "remote", remote)
    argv = [str(local), "--remote", str(remote)]
    step4 = local / "step_00000004"
    assert (step4 / "state.npz").is_file()
    want = 1
    if case.startswith("clean"):
        want = 0
    elif case == "local_only":
        argv, want = [str(local)], 0
    elif case.startswith("flipped"):
        _flip_middle(step4 / "state.npz")
    elif case == "dangling_latest":
        empty = tmp_path / "empty"
        empty.mkdir()
        (empty / "LATEST").write_text("42")
        argv = [str(empty)]
    elif case == "diverged":
        # the same step written again from a model one step further: both
        # tiers verify, their manifests disagree
        LocalCheckpointManager(str(local)).save(ckpt["model"], 4)
    elif case == "corrupt_mirror":
        _flip_middle(remote / "ckpt" / "step_00000004" / "state.npz")
    elif case == "no_manifest":
        (local / "step_00000002" / "manifest.json").unlink()
    elif case == "torn_meta":
        (step4 / "meta.json").write_text("{")
    elif case == "missing_dir":
        argv, want = [str(tmp_path / "nope")], 2
    elif case == "bad_uri":
        argv, want = [str(local), "--remote", "gs://bucket/ckpt"], 2
    if case.endswith("json"):
        argv.append("--json")
    rc, out, err = _both("checkpoint_fsck", argv)
    assert rc == want, (out, err)
    if case in ("flipped_leaf", "corrupt_mirror"):
        assert "step        4  CORRUPT" in out
    if case == "diverged":
        assert "! divergence: step 4: leaf" in out
    if case == "clean_json":
        assert json.loads(out)["clean"] is True
    if case == "dangling_latest":
        assert "LATEST pointer dangles" in out


@pytest.mark.parametrize("case", ["clean", "flipped", "no_leaves",
                                  "dangling_latest"])
def test_checkpoint_fsck_reads_the_dcp_format(ckpt, tmp_path, case):
    """CheckpointManager's steps (state/ through DCP): the port's tool
    verifies them; the reference's cannot read the format."""
    from flexflow_tpu_torch.tools import checkpoint_fsck

    local = tmp_path / "dcp"
    shutil.copytree(ckpt["root"] / "dcp", local)
    step4 = local / "step_00000004"
    assert (step4 / CheckpointManager.STATE).is_dir()
    if case == "flipped":
        # one byte of a weight's data (a byte of the files' padding
        # would leave every leaf whole)
        with CheckpointManager._open_leaves(str(step4)) as leaves:
            head = max((v for k, v in leaves.items()
                        if k.startswith("['weights']")),
                       key=lambda v: v.nbytes).tobytes()[:16]
        hits = [(f, f.read_bytes().find(head))
                for f in (step4 / "state").glob("*.distcp")]
        f, at = next((f, at) for f, at in hits if at >= 0)
        raw = bytearray(f.read_bytes())
        raw[at + 3] ^= 0xFF
        f.write_bytes(bytes(raw))
    elif case == "no_leaves":
        shutil.rmtree(step4 / "state")
    elif case == "dangling_latest":
        shutil.rmtree(step4)
    rc, out, err = _run(checkpoint_fsck, [str(local)])
    assert err == ""
    if case == "clean":
        assert rc == 0 and out.endswith("clean\n")
        assert "step        2  ok" in out and "step        4  ok" in out
        return
    assert rc == 1 and out.endswith("PROBLEMS FOUND\n")
    if case == "dangling_latest":
        assert "LATEST pointer dangles: names step 4" in out
    else:
        assert "step        4  CORRUPT" in out
        assert "step        2  ok" in out


# -- strategy_store_import ----------------------------------------------------------

def test_strategy_store_import_promotes_shipped_artifacts(tmp_path):
    from flexflow_tpu_torch.store import StrategyStore
    from flexflow_tpu_torch.strategy import Strategy
    from flexflow_tpu_torch.tools import strategy_store_import as si

    root = str(tmp_path / "store")
    argv = ["--store", root, "--device", "cpu"]
    rc, out, err = _run(si, argv)
    assert (rc, err) == (0, "")
    results = si.import_default_jobs(root, str(STRATEGIES), 8,
                                     device="cpu")
    assert [(n, w) for n, _, w in results] == [
        ("bert_encoder", False), ("inception_v3", False), ("dlrm", False)]
    assert out == "".join(f"{n}: imported -> {d[:16]}\n"
                          for n, d, _ in results)
    assert _run(si, argv)[1] == out.replace("imported", "kept existing")
    store = StrategyStore(root)
    assert len(store.entries()) == 3
    for name, digest, _ in results:
        shipped = Strategy.load(str(STRATEGIES / f"{name}.json"))
        with open(os.path.join(root, "strategies", digest,
                               "strategy.json")) as f:
            assert Strategy.from_json(f.read()).to_json() == \
                shipped.to_json()
    # a search of the job's graph under the job's config is a store hit
    ff = si.job_model("bert_encoder", si.job_config(
        "bert_encoder", "cpu", strategy_store=root))
    hit = ff.search_strategy(8)
    assert hit.search_stats["store_hit"] is True
    assert hit.search_stats["imported_job"] == "bert_encoder"
    assert hit.to_json() == Strategy.load(
        str(STRATEGIES / "bert_encoder.json")).to_json()
    assert _run(si, ["--store", str(tmp_path / "s2"), "--device", "cpu",
                     "--strategies", str(tmp_path)])[0] == 1


# -- check_metric_docs --------------------------------------------------------------

def test_check_metric_docs_passes_on_the_port():
    from flexflow_tpu_torch.tools import check_metric_docs

    rc, out, err = _run(check_metric_docs, [])
    assert (rc, err) == (0, "") and out.startswith("ok: ")


@pytest.mark.parametrize("drift", [False, True])
def test_check_metric_docs_matches_reference(tmp_path, drift):
    """The port under both package names: the reference's tool scans
    flexflow_tpu/, the port's flexflow_tpu_torch/; the same verdict."""
    (tmp_path / "docs").mkdir()
    shutil.copy(ROOT / "docs" / "OBSERVABILITY.md", tmp_path / "docs")
    for name in ("flexflow_tpu", "flexflow_tpu_torch"):
        shutil.copytree(ROOT / "flexflow_tpu_torch", tmp_path / name,
                        ignore=shutil.ignore_patterns("_build", "csrc",
                                                      "__pycache__"))
        if drift:
            (tmp_path / name / "drift.py").write_text(
                'def f(reg):\n    reg.counter("store/undocumented_x")\n')
    argv = ["--root", str(tmp_path)]
    ref = _run(importlib.import_module("tools.check_metric_docs"), argv)
    port = _run(importlib.import_module(
        "flexflow_tpu_torch.tools.check_metric_docs"), argv)
    assert port[:2] == ref[:2]
    assert port[2] == ref[2].replace("flexflow_tpu/", "flexflow_tpu_torch/")
    assert port[0] == (1 if drift else 0)
    if drift:
        assert "store/undocumented_x" in port[2]
