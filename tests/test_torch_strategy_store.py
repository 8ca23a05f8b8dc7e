"""The port's strategy store (flexflow_tpu_torch/store/) against
flexflow_tpu's tests/test_strategy_store.py, case by case: a warm hit
restores the strategy bit for bit and trains the same losses; the store
is off by default, on by its env var, off explicitly; a changed mesh,
graph, calibration, search config or catalog misses; a corrupt entry
falls back to the search and is repaired; an unwritable root means
store-off; gc, young tmp dirs, first-write-wins, the best-cost upgrade, a
newer manifest; import_strategy; the kernel cache under the store root;
the blob stores under a seeded FaultPlan; the fleet mirror.  And parity:
graph signatures equal the reference's, either package's entries list in
the other's store, a reference entry is a miss for the port, and the
slice fields join the key only at slices > 1."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as R  # noqa: E402
import flexflow_tpu_torch as P  # noqa: E402
from flexflow_tpu import store as r_store  # noqa: E402
from flexflow_tpu.resilience import faults as r_faults  # noqa: E402
from flexflow_tpu.store import blobstore as r_blob  # noqa: E402
from flexflow_tpu_torch import store as p_store  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_bert  # noqa: E402
from flexflow_tpu_torch.ops.kernels import _build  # noqa: E402
from flexflow_tpu_torch.resilience import faults as p_faults  # noqa: E402
from flexflow_tpu_torch.store import blobstore as p_blob  # noqa: E402
from flexflow_tpu_torch.store import (StrategyStore,  # noqa: E402
                                      cached_search, store_from_config,
                                      store_key_for)
from flexflow_tpu_torch.strategy import (Strategy,  # noqa: E402
                                         data_parallel_strategy)

BUDGET = 8  # a small Unity budget: the real search, quickly


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Caches and store env vars of this test's own."""
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR", str(tmp_path / "pc"))
    monkeypatch.setenv("FLEXFLOW_TPU_CACHE_DIR", str(tmp_path / "rc"))
    for var in ("FLEXFLOW_TPU_TORCH_STORE_DIR", "FLEXFLOW_TPU_STORE_DIR",
                "FLEXFLOW_TPU_SUBSTITUTIONS"):
        monkeypatch.delenv(var, raising=False)


def _mlp(cfg, extra_layer=False, pkg=P):
    ff = pkg.FFModel(cfg)
    x = ff.create_tensor([cfg.batch_size, 16], name="x")
    t = ff.relu(ff.dense(x, 32, name="fc1"))
    if extra_layer:
        t = ff.dense(t, 32, name="fc_extra")
    ff.softmax(ff.dense(t, 8, name="fc2"))
    return ff


def _cfg(store, **kw):
    kw.setdefault("search_budget", BUDGET)
    return P.FFConfig(device="cpu", batch_size=8,
                      strategy_store=None if store is None else str(store),
                      **kw)


def _entries(root):
    d = os.path.join(str(root), "strategies")
    return sorted(n for n in os.listdir(d)
                  if not n.startswith(".tmp-")) if os.path.isdir(d) else []


def _losses(ff, steps=2):
    rng = np.random.RandomState(0)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 8, (8,)).astype(np.int32)
    return [float(ff.train_step({"x": x}, y)["loss"]) for _ in range(steps)]


def _search(ff, n):
    """cached_search around the port's Unity search for n devices."""
    from flexflow_tpu_torch.pcg.search import unity_search

    return cached_search(ff, n, lambda: unity_search(ff, n))


# -- warm hit -------------------------------------------------------------

def test_warm_hit_is_bit_identical_and_trains_identically(tmp_path):
    ff1 = _mlp(_cfg(tmp_path)).compile()
    stats = ff1.strategy.search_stats
    assert stats["store_hit"] is False and len(stats["store_key"]) == 64
    assert _entries(tmp_path) == [stats["store_key"]]
    ff2 = _mlp(_cfg(tmp_path)).compile()
    assert ff2.strategy.search_stats["store_hit"] is True
    assert ff2.strategy.search_stats["store_key"] == stats["store_key"]
    assert "search_s" in ff2.strategy.search_stats  # the manifest's copy
    assert ff2.strategy.to_json() == ff1.strategy.to_json()
    assert ff2.strategy.search_cost == ff1.strategy.search_cost
    assert len(_entries(tmp_path)) == 1
    assert _losses(ff2) == _losses(ff1)


def test_a_hit_times_no_op(tmp_path, monkeypatch):
    """A restored strategy skips the search and with it every op timing
    (the CPU profiler stands in for the card's)."""
    from flexflow_tpu_torch.pcg import unity

    kw = dict(search_calibrate=True,
              op_cost_cache_file=str(tmp_path / "costs.json"))
    _mlp(_cfg(tmp_path, **kw)).compile()
    calls = []
    monkeypatch.setattr(unity, "unity_optimize",
                        lambda *a, **k: calls.append(1))
    ff = _mlp(_cfg(tmp_path, **kw)).compile()
    assert ff.strategy.search_stats["store_hit"] is True
    assert "measured_ops" in ff.strategy.search_stats
    assert calls == []


def test_store_off_by_default():
    ff = _mlp(_cfg(None)).compile()
    assert "store_hit" not in ff.strategy.search_stats


def test_env_var_store_and_explicit_off(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_STORE_DIR", str(tmp_path / "ref"))
    assert _cfg(None).resolve_store_dir() is None  # the reference's var
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_STORE_DIR", str(tmp_path))
    cfg = _cfg(None)
    assert cfg.resolve_store_dir() == str(tmp_path)
    ff = _mlp(cfg).compile()
    assert ff.strategy.search_stats["store_hit"] is False
    assert len(_entries(tmp_path)) == 1
    for off in ("none", ""):
        assert _cfg(off).resolve_store_dir() is None


# -- the key --------------------------------------------------------------

def test_changed_mesh_misses(tmp_path):
    ff = _mlp(_cfg(tmp_path))
    assert _search(ff, 1).search_stats["store_hit"] is False
    assert _search(ff, 2).search_stats["store_hit"] is False
    assert _search(ff, 2).search_stats["store_hit"] is True
    assert len(_entries(tmp_path)) == 2


def test_changed_graph_misses(tmp_path):
    _mlp(_cfg(tmp_path)).compile()
    ff = _mlp(_cfg(tmp_path), extra_layer=True).compile()
    assert ff.strategy.search_stats["store_hit"] is False
    assert len(_entries(tmp_path)) == 2


def test_changed_calibration_digest_misses(tmp_path):
    from flexflow_tpu_torch.sim.calibrate import (load_overlap_constants,
                                                  save_overlap_constants)

    _mlp(_cfg(tmp_path)).compile()
    save_overlap_constants({
        "compute_scale": 1.5, "comm_scale": 1.0, "sync_scale": 1.0,
        "overlap_fraction": 0.3, "sync_overlap_fraction": 0.3,
        "fitted_on": "cpu"})
    assert load_overlap_constants(backend="cpu") is not None
    ff = _mlp(_cfg(tmp_path)).compile()
    assert ff.strategy.search_stats["store_hit"] is False
    assert len(_entries(tmp_path)) == 2


@pytest.mark.parametrize("change", [
    {"enable_parameter_parallel": True}, {"rewrite_depth": 3},
    {"search_budget": BUDGET + 1}, {"zero_stage": 1}])
def test_changed_search_config_misses(tmp_path, change):
    _mlp(_cfg(tmp_path)).compile()
    ff = _mlp(_cfg(tmp_path, **change)).compile()
    assert ff.strategy.search_stats["store_hit"] is False
    assert len(_entries(tmp_path)) == 2


def test_changed_catalog_misses(tmp_path):
    def catalog(name, n_rules):
        rule = {"_t": "Rule", "name": "taso_rule_0",
                "srcOp": [{"_t": "Operator", "type": "OP_RELU",
                           "input": [{"_t": "Tensor", "opId": -1,
                                      "tsId": 0}], "para": []}],
                "dstOp": [], "mappedOutput": []}
        path = tmp_path / name
        path.write_text(json.dumps({"_t": "RuleCollection",
                                    "rule": [rule] * n_rules}))
        return str(path)

    a, b = catalog("a.json", 1), catalog("b.json", 2)
    first = _mlp(_cfg(tmp_path / "s", substitution_json=a)).compile()
    assert first.strategy.search_stats["store_hit"] is False
    again = _mlp(_cfg(tmp_path / "s", substitution_json=a)).compile()
    assert again.strategy.search_stats["store_hit"] is True
    other = _mlp(_cfg(tmp_path / "s", substitution_json=b)).compile()
    assert other.strategy.search_stats["store_hit"] is False
    off = _mlp(_cfg(tmp_path / "s", substitution_json="none")).compile()
    assert off.strategy.search_stats["store_hit"] is False
    assert len(_entries(tmp_path / "s")) == 3


@pytest.mark.parametrize("corruption", ["truncate", "garbage", "missing"])
def test_corrupt_entry_falls_back_to_search(tmp_path, corruption):
    _mlp(_cfg(tmp_path)).compile()
    (digest,) = _entries(tmp_path)
    spath = os.path.join(str(tmp_path), "strategies", digest,
                         "strategy.json")
    if corruption == "truncate":
        with open(spath) as f:
            text = f.read()
        with open(spath, "w") as f:
            f.write(text[: len(text) // 2])
    elif corruption == "garbage":
        with open(spath, "w") as f:
            f.write("{not json")
    else:
        os.unlink(spath)
    ff = _mlp(_cfg(tmp_path)).compile()
    assert ff.strategy.search_stats["store_hit"] is False
    assert _entries(tmp_path) == [digest]  # quarantined and published again
    assert _mlp(_cfg(tmp_path)).compile().strategy.search_stats[
        "store_hit"] is True


def test_unwritable_root_degrades_to_store_off(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    cfg = _cfg(blocker / "store")
    assert store_from_config(cfg) is None
    ff = _mlp(cfg).compile()
    assert "store_hit" not in ff.strategy.search_stats


def test_cached_search_passthrough_without_store():
    ff = _mlp(_cfg("none"))
    calls = []

    def fake_search():
        calls.append(1)
        return data_parallel_strategy(2)

    s = cached_search(ff, 2, fake_search)
    assert calls == [1] and getattr(s, "search_stats", None) is None


# -- the store's own API ----------------------------------------------------

def _keys(tmp_path, sizes=(1, 2, 4)):
    ff = _mlp(_cfg(tmp_path))
    return [store_key_for(ff.config, ff.layers, n) for n in sizes]


def test_gc_keeps_newest_entries(tmp_path):
    store = StrategyStore(str(tmp_path))
    keys = _keys(tmp_path)
    for i, key in enumerate(keys):
        assert store.publish(key, data_parallel_strategy(2),
                             created_at=1000.0 + i)
    assert store.gc(keep_last=2) == 1
    assert {d for d, _ in store.entries()} == {keys[1].digest,
                                               keys[2].digest}
    assert store.gc(keep_last=2) == 0
    assert store.gc(keep_last=0) == 2
    assert store.entries() == []
    with pytest.raises(ValueError):
        store.gc(keep_last=-1)


def test_newer_manifest_version_misses_without_quarantine(tmp_path):
    store = StrategyStore(str(tmp_path))
    (key,) = _keys(tmp_path, (2,))
    assert store.publish(key, data_parallel_strategy(2), created_at=1.0)
    mpath = os.path.join(str(tmp_path), "strategies", key.digest,
                         "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["manifest_version"] = 99
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    assert store.lookup(key) is None
    assert os.path.isdir(os.path.dirname(mpath))


def test_gc_spares_young_tmp_dirs(tmp_path):
    store = StrategyStore(str(tmp_path))
    young = os.path.join(store.strategies_dir, ".tmp-young-1-1")
    stale = os.path.join(store.strategies_dir, ".tmp-stale-1-1")
    os.makedirs(young)
    os.makedirs(stale)
    os.utime(stale, (1.0, 1.0))
    store.gc(keep_last=0)
    assert os.path.isdir(young) and not os.path.isdir(stale)


def test_publish_first_write_wins_and_overwrite(tmp_path):
    store = StrategyStore(str(tmp_path))
    (key,) = _keys(tmp_path, (2,))
    s2, s4 = data_parallel_strategy(2), data_parallel_strategy(4)
    assert store.publish(key, s2, created_at=1.0)
    assert not store.publish(key, s4, created_at=2.0)
    assert store.lookup(key).to_json() == s2.to_json()
    assert store.publish(key, s4, created_at=3.0, overwrite=True)
    assert store.lookup(key).to_json() == s4.to_json()


class _Registry:
    """The two calls the store makes of a metrics registry."""

    def __init__(self):
        self.counts, self.observed = {}, {}
        registry = self

        class _Counter:
            def __init__(self, name):
                self.name = name

            def inc(self, n=1):
                registry.counts[self.name] = registry.counts.get(
                    self.name, 0) + n

        class _Histogram:
            def __init__(self, name):
                self.name = name

            def observe(self, v):
                registry.observed.setdefault(self.name, []).append(v)

        self.counter, self.histogram = _Counter, _Histogram


def test_publish_best_cost_upgrades_entry(tmp_path):
    reg = _Registry()
    store = StrategyStore(str(tmp_path), registry=reg)
    (key,) = _keys(tmp_path, (2,))
    s2, s4 = data_parallel_strategy(2), data_parallel_strategy(4)
    assert store.publish(key, s2, searched_cost=10.0, created_at=1.0)
    assert not store.publish(key, s4, searched_cost=11.0, created_at=2.0)
    assert not store.publish(key, s4, searched_cost=10.0, created_at=3.0)
    assert not store.publish(key, s4, created_at=4.0)
    assert store.lookup(key).to_json() == s2.to_json()
    assert reg.counts.get("store/best_cost_upgrades", 0) == 0
    assert store.publish(key, s4, searched_cost=7.5, created_at=5.0)
    hit = store.lookup(key)
    assert hit.to_json() == s4.to_json() and hit.search_cost == 7.5
    assert reg.counts["store/best_cost_upgrades"] == 1
    assert reg.counts["store/publishes"] == 2
    assert reg.counts["store/hits"] == 2
    assert len(reg.observed["store/lookup_ms"]) == 2
    assert not store.publish(key, s2, searched_cost=8.0, created_at=6.0)


def test_import_strategy(tmp_path):
    store = StrategyStore(str(tmp_path / "store"))
    (key,) = _keys(tmp_path, (4,))
    s = data_parallel_strategy(4)
    s.rewrites = [["fuse_linear_activation", 0]]
    path = str(tmp_path / "shipped.json")
    s.save(path)
    assert store.import_strategy(key, path, created_at=1.0)
    hit = store.lookup(key)
    assert hit.to_json() == Strategy.load(path).to_json()
    assert hit.search_stats["imported_from"] == "shipped.json"
    assert not store.import_strategy(key, path)  # first write wins


# -- the kernel cache -------------------------------------------------------

def test_compilation_cache_auto_ties_to_store_root(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    ff = _mlp(_cfg(tmp_path, compilation_cache="auto")).compile()
    cache = os.path.join(str(tmp_path), "kernel_cache")
    assert os.path.isdir(cache) and str(_build.BUILD_DIR) == cache
    assert StrategyStore(str(tmp_path)).compilation_cache_dir == cache
    assert str(_build.library_path(_build.CSRC / "flash_attention.cu")
               ).startswith(cache)
    assert ff.strategy.search_stats["store_hit"] is False
    explicit = tmp_path / "kernels"
    assert p_store.enable_compilation_cache(
        _cfg(None, compilation_cache=str(explicit))) == str(explicit)
    assert _build.BUILD_DIR == explicit and explicit.is_dir()
    assert p_store.enable_compilation_cache(_cfg(None)) is None


def test_compilation_cache_auto_without_store_raises(monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    cfg = _cfg("none", compilation_cache="auto")
    with pytest.raises(ValueError, match="no store is configured"):
        p_store.enable_compilation_cache(cfg)
    with pytest.raises(ValueError, match="compilation_cache"):
        _cfg(None, compilation_cache=" ")


# -- blob stores and the mirror ---------------------------------------------

def test_local_blob_store(tmp_path):
    b = p_blob.LocalBlobStore(str(tmp_path))
    assert b.put("a/x.json", b"1") == 1
    assert b.put("a/x.json", b"22", if_generation_match=1) == 2
    with pytest.raises(p_blob.BlobPreconditionFailed):
        b.put("a/x.json", b"3", if_generation_match=1)
    with pytest.raises(p_blob.BlobPreconditionFailed):
        b.put("a/y.json", b"3", if_generation_match=5)
    assert b.put("a/y.json", b"3", if_generation_match=0) == 1
    assert b.get("a/x.json") == b"22" and b.stat("a/x.json").size == 2
    assert b.list("a/") == ["a/x.json", "a/y.json"] and b.list("b/") == []
    assert b.delete("a/x.json") and not b.delete("a/x.json")
    with pytest.raises(p_blob.BlobNotFound):
        b.get("a/x.json")
    for bad in ("/abs", "a/../b", "a//b", "dir/"):
        with pytest.raises(ValueError):
            b.put(bad, b"")
    assert isinstance(p_blob.blobstore_from_uri(f"file://{tmp_path}/u"),
                      p_blob.LocalBlobStore)
    with pytest.raises(NotImplementedError, match="gs"):
        p_blob.blobstore_from_uri("gs://bucket/prefix")
    assert p_blob.rmtree_blob_prefix(b, "a/") == 1 and b.list() == []


def _faulty_run(blob_mod, faults_mod, root):
    """A fixed sequence of blob ops through a FaultyBlobStore under a
    seeded plan: what each op returned or raised, the counters, the
    sleeps."""
    kinds = faults_mod.FaultKind
    plan = faults_mod.FaultPlan([
        faults_mod.Fault(step=2, kind=kinds.BLOB_TRANSIENT),
        faults_mod.Fault(step=4, kind=kinds.BLOB_PARTIAL_UPLOAD,
                         payload={"fraction": 0.25}),
        faults_mod.Fault(step=6, kind=kinds.BLOB_LATENCY,
                         payload={"delay_s": 0.5}),
        faults_mod.Fault(step=8, kind=kinds.BLOB_UNAVAILABLE,
                         payload={"ops": 2}),
    ])
    sleeps = []
    b = blob_mod.FaultyBlobStore(blob_mod.LocalBlobStore(root), plan,
                                 sleep=sleeps.append)
    out = []
    for i in range(12):
        try:
            if i % 3 == 2:
                out.append(("get", b.get("k/0")))
            else:
                out.append(("put", b.put(f"k/{i % 2}", b"abcdefgh")))
        except blob_mod.BlobStoreError as e:
            out.append((type(e).__name__,))
    return out, b.counters, sleeps, b.ops


def test_faulty_blob_store_follows_the_seeded_plan(tmp_path):
    mine = _faulty_run(p_blob, p_faults, str(tmp_path / "p"))
    ref = _faulty_run(r_blob, r_faults, str(tmp_path / "r"))
    assert mine == ref
    out, counters, sleeps, _ = mine
    assert counters == {"transient_errors": 1, "partial_uploads": 1,
                        "latency_injections": 1,
                        "unavailable_rejections": 3}
    assert sleeps == [0.5] and ("BlobUnavailableError",) in out
    plan = p_faults.FaultPlan.seeded(3, 10, kinds=list(
        p_faults.BLOB_FAULT_KINDS), count=3)
    ref_plan = r_faults.FaultPlan.seeded(3, 10, kinds=list(
        r_faults.BLOB_FAULT_KINDS), count=3)
    assert plan.to_json() == ref_plan.to_json()
    assert p_faults.FaultPlan.from_json(plan.to_json()).to_json() == \
        plan.to_json()


def test_the_fleet_mirror(tmp_path):
    remote_uri = str(tmp_path / "remote")
    first = _mlp(_cfg(tmp_path / "a", remote_store=remote_uri)).compile()
    assert first.strategy.search_stats["store_hit"] is False
    digest = first.strategy.search_stats["store_key"]
    remote = p_blob.LocalBlobStore(remote_uri)
    assert remote.list() == [f"strategies/{digest}/manifest.json",
                             f"strategies/{digest}/strategy.json"]
    # a new host: its local store is empty, the mirror serves the entry
    second = _mlp(_cfg(tmp_path / "b", remote_store=remote_uri)).compile()
    stats = second.strategy.search_stats
    assert stats["store_hit"] is True and stats["store_remote_hit"] is True
    assert second.strategy.to_json() == first.strategy.to_json()
    assert _entries(tmp_path / "b") == [digest]  # materialized locally
    # a torn remote pair is quarantined and misses
    remote.put(f"strategies/{digest}/strategy.json", b"{}")
    mirror = p_store.RemoteStrategyMirror(remote)
    assert mirror.fetch(digest) is None and remote.list() == []
    # an unusable mirror leaves the local store working
    cfg = _cfg(tmp_path / "c", remote_store="gs://bucket")
    assert store_from_config(cfg).remote is None


# -- parity with the reference's store ---------------------------------------

def _graph_pairs():
    def bert(pkg):
        ff = (pkg.FFModel(pkg.FFConfig(batch_size=4, device="cpu"))
              if pkg is P else pkg.FFModel(pkg.FFConfig(batch_size=4)))
        mod = build_bert if pkg is P else __import__(
            "flexflow_tpu.models.transformer", fromlist=["x"]).build_bert
        mod(ff, batch_size=4, seq_length=16, hidden_size=32, num_layers=2,
            num_heads=4, intermediate_size=64)
        return ff

    return {
        "mlp": (_mlp(_cfg(None)), _mlp(R.FFConfig(batch_size=8), pkg=R)),
        "mlp_extra": (_mlp(_cfg(None), True),
                      _mlp(R.FFConfig(batch_size=8), True, pkg=R)),
        "bert": (bert(P), bert(R)),
    }


def test_graph_signature_equals_the_references():
    sigs = {}
    for name, (mine, ref) in _graph_pairs().items():
        sig = p_store.graph_signature(mine.layers)
        assert sig == r_store.graph_signature(ref.layers), name
        sigs[name] = sig
    assert len(set(sigs.values())) == len(sigs)


def _ref_cfg(root, **kw):
    return R.FFConfig(batch_size=8, num_devices=1, search_budget=BUDGET,
                      strategy_store=str(root), **kw)


def test_either_packages_entries_list_in_the_other(tmp_path, devices8):
    root = str(tmp_path / "shared")
    ref = _mlp(_ref_cfg(root), pkg=R)
    ref.compile(devices=devices8[:1])
    mine = _mlp(_cfg(root)).compile()
    p_entries = StrategyStore(root).entries()
    r_entries = r_store.StrategyStore(root).entries()
    assert [d for d, _ in p_entries] == [d for d, _ in r_entries]
    assert len(p_entries) == 2
    for (_, pm), (_, rm) in zip(p_entries, r_entries):
        assert pm == rm
    by_digest = dict(p_entries)
    rm = by_digest[ref.strategy.search_stats["store_key"]]
    pm = by_digest[mine.strategy.search_stats["store_key"]]
    assert sorted(pm) == sorted(rm)
    assert sorted(pm["key"]) == sorted(rm["key"])
    assert pm["manifest_version"] == rm["manifest_version"] == 1


def test_a_reference_entry_is_a_miss_for_the_port(tmp_path, devices8):
    """Both packages say platform "cpu" here; the port's machine identity
    keeps its key apart from the reference's for the same graph and
    config, so the port searches rather than restore a strategy priced
    for another machine."""
    root = str(tmp_path / "shared")
    ref = _mlp(_ref_cfg(root), pkg=R)
    ref.compile(devices=devices8[:1])
    cfg = _cfg(root)
    r_key = r_store.store_key_for(ref.config, ref.layers, 1)
    p_key = store_key_for(cfg, _mlp(cfg).layers, 1)
    assert p_key.graph == r_key.graph
    mesh = dict(p_key.mesh)
    assert len(mesh.pop("port_machine")) == 64
    assert mesh == r_key.mesh
    assert p_key.digest != r_key.digest
    assert StrategyStore(root).lookup(p_key) is None
    ff = _mlp(cfg).compile()
    assert ff.strategy.search_stats["store_hit"] is False
    assert len(_entries(root)) == 2


@pytest.mark.parametrize("slices", [1, 2])
def test_slice_fields_join_the_key_only_at_slices_above_one(slices):
    # the memory cap named: the two packages' defaults differ (an H100's
    # 80 GB, a TPU's 16 GiB)
    kw = dict(slices=slices, slice_topology="4" if slices > 1 else None,
              dcn_bandwidth=1e9, dcn_latency=2e-5, dcn_bucket_mb=8.0,
              memory_per_device=80_000_000_000)
    cfg = _cfg(None, **kw)
    rcfg = R.FFConfig(batch_size=8, search_budget=BUDGET, **kw)
    mesh = p_store.mesh_fingerprint(cfg, 8)
    rmesh = r_store.mesh_fingerprint(rcfg, 8)
    sim = p_store.simulator_version(cfg)
    rsim = r_store.simulator_version(rcfg)
    fields = ("slices", "slice_topology", "dcn_bandwidth", "dcn_latency")
    if slices == 1:
        assert not set(fields) & set(mesh)
        assert "dcn_bucket_mb" not in sim["search"]
        flat = p_store.store_key_for(_cfg(None), _mlp(_cfg(None)).layers, 8)
        assert flat.digest == p_store.store_key_for(
            cfg, _mlp(cfg).layers, 8).digest
    else:
        assert {f: mesh[f] for f in fields} == {f: rmesh[f] for f in fields}
        assert sim["search"]["dcn_bucket_mb"] == rsim["search"][
            "dcn_bucket_mb"] == 8.0
    assert set(sim["search"]) <= set(rsim["search"])
    for k in sim["search"]:
        assert sim["search"][k] == rsim["search"][k], k
