"""The port's resumable decode handoff (flexflow_tpu_torch/serving/
handoff.py and the scheduler/front pause-resume path), the cases of
tests/test_serving_handoff.py that need neither the autoscaler nor the
load generator, mirrored on the port's fakes: ResumeRecord and
HandoffPaused, migrate-vs-replay pricing (and its formulas against the
reference's at one hop rate), live migration off a draining replica
(greedy and seeded sampling), death recovery through the resume record,
the five-way fault matrix, terminate() routing unfinishable
generations onto the handoff path, the config knobs, and the offline
frame verifier (flexflow_tpu_torch/tools/kvframe_fsck.py, whose output
equals the reference tool's on the same frames).  The real-engine
oracles are in tests/test_torch_handoff_engine.py."""
import threading
import time
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from flexflow_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from flexflow_tpu_torch.resilience.faults import (  # noqa: E402
    Fault, FaultKind, FaultPlan)
from flexflow_tpu_torch.serving import (  # noqa: E402
    ContinuousScheduler, InProcessFabric, KVMigrator, MigrationCostModel,
    ServingFront)
from flexflow_tpu_torch.serving.handoff import (  # noqa: E402
    HANDOFF_FAULTS, HandoffPaused, ResumeRecord, classify_handoff_fault)
from flexflow_tpu_torch.serving.kv_transfer import (  # noqa: E402
    KVTransferError, pack_kv_blocks)

V = 16
NO_SLEEP = lambda s: None  # noqa: E731


class FakeKVModel:
    """Deterministic next-token model with an exportable KV surface:
    token t emits t+1 mod V, so completions have a closed form and any
    corruption shows up as wrong tokens."""

    def __init__(self, batch_slots=2, max_seq=32, page_size=4):
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.max_blocks_per_seq = max_seq // page_size
        self.num_blocks = 1 + batch_slots * self.max_blocks_per_seq
        self.vocab = V
        self.steps = 0
        self.kv = np.zeros((self.num_blocks, page_size, 2), np.float32)

    def reset(self):
        pass

    def step(self, tokens, seq_lens, block_tables):
        self.steps += 1
        logits = np.zeros((self.batch_slots, V), np.float32)
        nxt = (np.asarray(tokens) + 1) % V
        logits[np.arange(self.batch_slots), nxt] = 1.0
        return logits

    def export_block(self, block):
        return {"kv": np.array(self.kv[block])}

    def import_block(self, block, arrays):
        self.kv[block] = arrays["kv"]


class GatedModel(FakeKVModel):
    """Pins a generation mid-decode: the step that would cross
    `block_at` waits on the gate, so the pause service (queued behind
    it) runs with the sequence deterministically in flight."""

    def __init__(self, block_at=0, **kw):
        super().__init__(**kw)
        self.block_at = block_at
        self.gate = threading.Event()

    def step(self, tokens, seq_lens, block_tables):
        if self.block_at and self.steps + 1 >= self.block_at:
            self.gate.wait(10.0)
        return super().step(tokens, seq_lens, block_tables)


def expected(prompt, mnt):
    out = list(prompt)
    t = prompt[-1]
    for _ in range(mnt):
        t = (t + 1) % V
        out.append(t)
    return out


def kill_on_steps(steps, kind=FaultKind.HUNG_STEP):
    return FaultPlan([Fault(step=s, kind=kind) for s in steps])


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.002)
    return False


def gated_fleet(reg=None, block_at=10, num_replicas=2, **kw):
    """Front over GatedModels (every replica gated at the same step
    count — dispatch decides the holder, the test finds it)."""
    models = {}

    def factory(rid, survivors=None):
        m = GatedModel(block_at=block_at)
        models[rid] = m
        return m

    front = ServingFront(factory, num_replicas=num_replicas,
                         handoff=True, registry=reg, sleep=NO_SLEEP,
                         **kw)
    return front, models


def find_pinned(front, models, timeout=10.0):
    """The replica whose gated model is blocked inside a step with a
    request in flight — the handoff source."""
    src = [None]

    def probe():
        for r in front.replicas:
            m = models.get(r.replica_id)
            if (m is not None and m.block_at
                    and m.steps >= m.block_at - 1 and r.outstanding):
                src[0] = r
                return True
        return False

    assert _wait_for(probe, timeout), "no replica pinned mid-decode"
    return src[0]


def release(models):
    for m in models.values():
        m.gate.set()


# -- resume record / fault classification units --------------------------

def test_resume_record_replays_prompt_plus_generated():
    rec = ResumeRecord([1, 2, 3], [4, 5], written=4, seed=9,
                       temperature=0.0, page_size=4)
    assert rec.replay_tokens() == [1, 2, 3, 4, 5]
    assert rec.written == 4 and rec.seed == 9
    assert rec.kv_tail is None  # stamped only by a verified handoff


def test_classify_handoff_fault_covers_the_matrix():
    assert classify_handoff_fault("no block verified") == "torn"
    assert classify_handoff_fault("torn") == "torn"
    assert classify_handoff_fault("capacity") == "capacity"
    for why in ("target gone", "target closed", "migrator closed",
                "device write"):
        assert classify_handoff_fault(why) == "dest_death"
    # a transfer failure splits on the exception: frame damage is
    # "header", anything else is the fabric itself
    assert classify_handoff_fault(
        "transfer", KVTransferError("bad magic")) == "header"
    assert classify_handoff_fault(
        "transfer", RuntimeError("link down")) == "fabric"
    assert classify_handoff_fault(None) == "fabric"
    for kind in ("torn", "header", "fabric", "capacity", "dest_death"):
        assert kind in HANDOFF_FAULTS


def test_decide_handoff_prices_blocks_against_replay():
    m = MigrationCostModel(fabric_kind="inproc")
    d = m.decide_handoff(written=40, page_size=4, block_bytes=4096,
                         chunk=4, step_s=5e-3)
    # 10 blocks over PCIe ~ microseconds vs replaying 40 tokens
    assert d["decision"] == "handoff" and d["blocks"] == 10
    assert d["handoff_s"] < d["replay_s"]
    # a giant payload over InfiniBand costs more than recomputing it
    big = MigrationCostModel(fabric_kind="blob").decide_handoff(
        written=8, page_size=4, block_bytes=10 << 30, chunk=0,
        step_s=5e-3)
    assert big["decision"] == "replay"
    assert big["handoff_s"] > big["replay_s"]
    # the longer a sequence has decoded, the more a handoff is worth
    short = m.decide_handoff(written=8, page_size=4, block_bytes=4096,
                             chunk=0, step_s=5e-3)
    assert d["replay_s"] > short["replay_s"]


def test_decide_handoff_nothing_written_replays():
    m = MigrationCostModel()
    d = m.decide_handoff(written=0, page_size=4, block_bytes=0,
                         chunk=0, step_s=5e-3)
    assert d["decision"] == "replay" and d["blocks"] == 0


# -- live mid-decode migration -------------------------------------------

def test_drain_migrates_live_generation_token_identical():
    """The tentpole e2e: a generation pinned mid-decode on a draining
    replica pauses, its KV blocks stream to a peer, and it resumes
    there token-identically — drain never waits out (or drops) the
    long generation."""
    reg = MetricsRegistry()
    front, models = gated_fleet(reg)
    try:
        prompt = [1, 2, 3, 4, 5, 6, 7]
        h = front.generate_async(prompt, 12)
        src = find_pinned(front, models)
        assert front.drain_replica(src)
        release(models)
        assert h.wait(30.0) == expected(prompt, 12)
        assert _wait_for(lambda: src.state == "retired")
        st = front.stats()
    finally:
        front.close()
    ho = st["handoff"]
    assert ho["requested"] >= 1 and ho["ok"] >= 1
    assert ho["migrate_decisions"] >= 1 and ho["faults"] == {}
    assert ho["kv_transfer"]["blocks_streamed"] >= 2
    assert ho["kv_transfer"]["bytes_streamed"] > 0
    assert reg.counter("serving/handoff_paused").value >= 1
    assert reg.counter("serving/handoff_resumed").value >= 1
    # a pause is not a failure: no retry burned, no requeue counted
    assert h.retries == 0
    assert h.resume is not None and h.resume.generated


def test_live_handoff_imports_the_partial_tail_block():
    """written = 7 prompt + ~3 generated is never page-aligned here,
    so the verified sub-page tail must land through import_block
    instead of replaying."""
    reg = MetricsRegistry()
    front, models = gated_fleet(reg)
    try:
        h = front.generate_async([1, 2, 3, 4, 5, 6, 7], 12)
        src = find_pinned(front, models)
        assert front.drain_replica(src)
        release(models)
        assert h.wait(30.0) == expected([1, 2, 3, 4, 5, 6, 7], 12)
    finally:
        front.close()
    assert reg.counter("serving/handoff_tail_imports").value >= 1
    # the resumed admission was a real prefix-cache hit on the dest
    assert h.resume.kv_tail is not None


def test_seeded_sampling_resumes_the_exact_rng_stream():
    """temperature > 0: the resume record carries the host RNG state,
    so the migrated continuation draws the exact tokens the
    uninterrupted run would have — same front seed, same output."""
    prompt, mnt, temp = [1, 2, 3, 4, 5, 6, 7], 12, 0.8
    oracle = ServingFront(
        lambda rid, survivors=None: FakeKVModel(), num_replicas=2,
        seed=42, sleep=NO_SLEEP)
    try:
        want = oracle.generate_async(prompt, mnt, temp).wait(30.0)
    finally:
        oracle.close()
    reg = MetricsRegistry()
    front, models = gated_fleet(reg, seed=42)
    try:
        h = front.generate_async(prompt, mnt, temp)
        src = find_pinned(front, models)
        assert front.drain_replica(src)
        release(models)
        got = h.wait(30.0)
    finally:
        front.close()
    assert got == want
    assert reg.counter("serving/handoff_resumed").value >= 1
    assert h.resume is not None and h.resume.rng_state is not None


# -- decode-death recovery through the resume record ---------------------

def test_replica_death_resumes_by_replay_not_from_scratch():
    """A dying scheduler stamps the resume record on its way out (the
    tokens live on the host — a dead device cannot tear them): the
    requeue replays prompt+generated and completes token-identically,
    counted as a handoff replay."""
    reg = MetricsRegistry()
    front = ServingFront(
        lambda rid, survivors=None: FakeKVModel(), num_replicas=2,
        registry=reg, sleep=NO_SLEEP, retry_backoff=0.0,
        fault_plans={0: kill_on_steps([4])},
    )
    try:
        reqs = [([1 + i, 2], 8) for i in range(6)]
        hs = [front.generate_async(p, m) for p, m in reqs]
        for h, (p, m) in zip(hs, reqs):
            assert h.wait(30.0) == expected(p, m)
        assert front.handoff_replays >= 1
    finally:
        front.close()
    assert reg.counter("serving/handoff_replays").value >= 1
    assert reg.counter("serving/handoff_resumed").value >= 1
    resumed = [h for h in hs if h.resume is not None]
    assert resumed and all(h.retries >= 1 for h in resumed)
    # death recovery replays the dead replica's progress, never
    # regenerates: the record held real generated tokens
    assert any(h.resume.generated for h in resumed)


# -- the five-way fault matrix -------------------------------------------

class TearingFabric(InProcessFabric):
    """Returns only the frame header: zero blocks verify."""

    def transfer(self, key, data):
        import struct

        got = super().transfer(key, data)
        hlen = struct.unpack("<I", got[4:8])[0]
        return got[:8 + hlen]


class MangledHeaderFabric(InProcessFabric):
    """Flips the magic: unpack raises KVTransferError."""

    def transfer(self, key, data):
        got = bytearray(super().transfer(key, data))
        got[0] ^= 0xFF
        return bytes(got)


class DeadFabric(InProcessFabric):
    def transfer(self, key, data):
        raise RuntimeError("fabric down")


def run_faulted_handoff(reg, front, models):
    prompt = [1, 2, 3, 4, 5, 6, 7]
    h = front.generate_async(prompt, 12)
    src = find_pinned(front, models)
    assert front.drain_replica(src)
    release(models)
    assert h.wait(30.0) == expected(prompt, 12)
    return h


@pytest.mark.parametrize("fabric_cls,kind", [
    (TearingFabric, "torn"),
    (MangledHeaderFabric, "header"),
    (DeadFabric, "fabric"),
])
def test_stream_faults_degrade_to_replay(fabric_cls, kind):
    """Torn stream / corrupt header / fabric outage: the live path
    fails, its own counter increments, and the resume record alone
    replays to the exact tokens."""
    reg = MetricsRegistry()
    front, models = gated_fleet(reg)
    front._handoff_mig = KVMigrator(fabric_cls(), registry=reg,
                                    logger=front.log)
    try:
        run_faulted_handoff(reg, front, models)
        st = front.stats()
    finally:
        front.close()
    ho = st["handoff"]
    assert ho["ok"] == 0 and ho["replays"] >= 1
    assert ho["faults"].get(kind, 0) >= 1
    assert reg.counter(f"serving/handoff_fault_{kind}").value >= 1
    assert reg.counter("serving/handoff_replays").value >= 1


class _StubDestFront(ServingFront):
    """Routes the KV stream at a caller-chosen destination engine (the
    request itself still resumes on the real fleet)."""

    stub_dest = None

    def _pick_handoff_dest(self, source, toks):
        return self.stub_dest


def gated_stub_fleet(reg, **kw):
    models = {}

    def factory(rid, survivors=None):
        m = GatedModel(block_at=12)
        models[rid] = m
        return m

    front = _StubDestFront(factory, num_replicas=2, handoff=True,
                           registry=reg, sleep=NO_SLEEP, **kw)
    return front, models


class TinyPoolModel(FakeKVModel):
    """One usable KV block: adoption of a multi-block stream must stop
    early — the capacity fault."""

    def __init__(self, num_blocks=2, **kw):
        super().__init__(**kw)
        self.num_blocks = num_blocks
        self.kv = np.zeros((num_blocks, self.page_size, 2), np.float32)


def test_capacity_exhaustion_on_destination_degrades_to_replay():
    reg = MetricsRegistry()
    front, models = gated_stub_fleet(reg)
    tiny = ContinuousScheduler(TinyPoolModel())
    front.stub_dest = types.SimpleNamespace(
        scheduler=tiny, replica_id=99, outstanding=0, role="decode")
    try:
        run_faulted_handoff(reg, front, models)
        st = front.stats()
    finally:
        front.close()
        tiny.close()
    ho = st["handoff"]
    assert ho["ok"] == 0 and ho["replays"] >= 1
    assert ho["faults"].get("capacity", 0) >= 1
    assert reg.counter("serving/handoff_fault_capacity").value >= 1


def test_destination_death_mid_stream_degrades_to_replay():
    reg = MetricsRegistry()
    front, models = gated_stub_fleet(reg)
    dead = ContinuousScheduler(FakeKVModel())
    dead.close()  # run_on_worker now refuses: the dest died
    front.stub_dest = types.SimpleNamespace(
        scheduler=dead, replica_id=99, outstanding=0, role="decode")
    try:
        run_faulted_handoff(reg, front, models)
        st = front.stats()
    finally:
        front.close()
    ho = st["handoff"]
    assert ho["ok"] == 0 and ho["replays"] >= 1
    assert ho["faults"].get("dest_death", 0) >= 1
    assert reg.counter("serving/handoff_fault_dest_death").value >= 1


# -- terminate / drain integration ---------------------------------------

def test_terminate_handoff_budget_is_deadline_over_step_ewma():
    """The unfinishable bar: remaining_over = time-left / measured
    per-step EWMA — a sequence that cannot finish inside the grace
    window takes the handoff path; one that can keeps decoding."""
    front, models = gated_fleet()
    try:
        captured = {}
        r = front.replicas[0]
        sched = r.scheduler
        sched.step_ms_ewma = 100.0  # 0.1s per step
        r.request_handoff = lambda **kw: captured.update(kw) or True
        front._terminate_handoff(r, time.monotonic() + 2.0)
        assert 15 <= captured["remaining_over"] <= 20  # ~2.0 / 0.1
        assert captured["export_kv"] is True
        # an unmeasured engine falls back to the default step cost
        sched.step_ms_ewma = 0.0
        front._terminate_handoff(r, time.monotonic() + 2.0)
        assert captured["remaining_over"] >= 1
        del r.request_handoff  # restore the class method for close()
    finally:
        release(models)
        front.close()


def test_unfinishable_generation_hands_off_before_the_bell():
    """A pinned long generation whose holder measures 100s/step can
    never finish inside the grace window: _terminate_handoff pauses
    it and it completes token-identically on the peer."""
    reg = MetricsRegistry()
    front, models = gated_fleet(reg)
    try:
        prompt = [1, 2, 3, 4, 5, 6, 7]
        h = front.generate_async(prompt, 12)
        src = find_pinned(front, models)
        src.scheduler.step_ms_ewma = 100_000.0
        front._terminate_handoff(src, time.monotonic() + 5.0)
        release(models)
        assert h.wait(30.0) == expected(prompt, 12)
    finally:
        front.close()
    assert reg.counter("serving/handoff_requested").value >= 1
    assert reg.counter("serving/handoff_resumed").value >= 1
    assert h.resume is not None


def test_terminate_completes_the_long_generation():
    """SIGTERM grace with handoff on: the in-flight long generation is
    never shed — terminate reports it completed and exact."""
    reg = MetricsRegistry()
    front, models = gated_fleet(reg)
    prompt = [1, 2, 3, 4, 5, 6, 7]
    h = front.generate_async(prompt, 20)
    find_pinned(front, models)
    release(models)
    report = front.terminate(deadline_s=20.0)
    assert h.wait(5.0) == expected(prompt, 20)
    assert report["shed"] == 0 and report["deadline_met"]
    assert report["completed_during_drain"] >= 1


# -- config knobs ---------------------------------------------------------

def test_config_handoff_knobs_parse_and_validate():
    """The front's knobs parse and validate as the reference's; the
    autoscaler's --serving-rebalance-kv waits for the autoscaler (a
    field with no reader stays out)."""
    from flexflow_tpu_torch.config import FFConfig

    cfg = FFConfig.from_args(["--serving-handoff"])
    assert cfg.serving_handoff is True
    assert FFConfig.from_args([]).serving_handoff is False
    assert not hasattr(cfg, "serving_rebalance_kv")


# -- offline FFKV frame verifier (tools/kvframe_fsck.py) -----------------

def _frame(pages=((1, 2, 3, 4), (5, 6))):
    pages = [list(p) for p in pages]
    blocks = [{"kv": np.full((4, 2), float(p[0]), np.float32)}
              for p in pages]
    return pack_kv_blocks(pages, blocks, 4)


def test_kvframe_fsck_passes_a_good_frame(tmp_path):
    from flexflow_tpu_torch.tools import kvframe_fsck

    (tmp_path / "a.ffkv").write_bytes(_frame())
    assert kvframe_fsck.main([str(tmp_path)]) == 0
    assert kvframe_fsck.fsck_frame(_frame()) == []


def test_kvframe_fsck_flags_torn_and_corrupt_frames(tmp_path):
    from flexflow_tpu_torch.tools import kvframe_fsck

    good = _frame()
    (tmp_path / "torn.ffkv").write_bytes(good[:len(good) - 3])
    flipped = bytearray(good)
    flipped[-1] ^= 0xFF  # payload byte: crc mismatch
    (tmp_path / "crc.ffkv").write_bytes(bytes(flipped))
    assert kvframe_fsck.main([str(tmp_path)]) == 1
    report = kvframe_fsck.fsck_paths([str(tmp_path)])
    assert not report["frames"][str(tmp_path / "torn.ffkv")]["ok"]
    assert not report["frames"][str(tmp_path / "crc.ffkv")]["ok"]


def test_kvframe_fsck_flags_interior_partial_page():
    from flexflow_tpu_torch.tools import kvframe_fsck

    pages = [[1, 2], [3, 4, 5, 6]]  # only the LAST page may be partial
    blocks = [{"kv": np.zeros((4, 2), np.float32)} for _ in pages]
    problems = kvframe_fsck.fsck_frame(pack_kv_blocks(pages, blocks, 4))
    assert any("partial" in p for p in problems)


def test_kvframe_fsck_missing_path_is_usage_error(tmp_path):
    from flexflow_tpu_torch.tools import kvframe_fsck

    assert kvframe_fsck.main([str(tmp_path / "nope")]) == 2
    # an existing but frame-less directory is a finding, not usage
    assert kvframe_fsck.main([str(tmp_path)]) == 1


# -- against the reference -------------------------------------------------

@pytest.mark.parametrize("field,bad", [
    ("serving_replicas", 0), ("serving_step_timeout", -1.0),
    ("serving_max_restarts", -1), ("request_retry_limit", -1),
    ("admission_deadline_s", -0.5), ("serving_chip_budget", -1),
    ("kv_transfer", "ftp"), ("spec_decode", "beam"), ("spec_k", 0),
])
def test_config_fields_refuse_as_the_reference(field, bad):
    """Each field the front reads has the reference's default and
    refuses a bad value with the reference's message."""
    from flexflow_tpu import config as jax_config
    from flexflow_tpu_torch import config as port_config

    assert (getattr(port_config.FFConfig(), field)
            == getattr(jax_config.FFConfig(), field))
    with pytest.raises(ValueError) as want:
        jax_config.FFConfig(**{field: bad})
    with pytest.raises(ValueError) as got:
        port_config.FFConfig(**{field: bad})
    assert str(got.value) == str(want.value)


def test_config_flags_parse_as_the_reference():
    from flexflow_tpu import config as jax_config
    from flexflow_tpu_torch import config as port_config

    argv = ["--serving-replicas", "3", "--serving-step-timeout", "2.5",
            "--serving-max-restarts", "5", "--request-retry-limit", "4",
            "--admission-deadline", "1.5", "--serving-chip-budget", "6",
            "--kv-transfer", "blob", "--spec-decode", "ngram",
            "--spec-k", "3", "--serving-handoff"]
    want = jax_config.FFConfig.from_args(argv)
    got = port_config.FFConfig.from_args(argv)
    for f in ("serving_replicas", "serving_step_timeout",
              "serving_max_restarts", "request_retry_limit",
              "admission_deadline_s", "serving_chip_budget", "kv_transfer",
              "spec_decode", "spec_k", "serving_handoff"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("kind", ["inproc", "blob"])
def test_cost_model_formulas_equal_the_reference_at_one_rate(kind):
    """Given the reference the card's hop rates (its ICI terms the
    in-process hop's two PCIe crossings, its DCN terms InfiniBand's),
    the port's decide and decide_handoff return the reference's
    records."""
    import types

    from flexflow_tpu.serving.disagg import \
        MigrationCostModel as JaxCostModel
    from flexflow_tpu_torch.sim import machine_model as mm

    machine = types.SimpleNamespace(
        ici_bw=mm.PCIE_GEN5_BW / 2, ici_lat=2 * mm.PCIE_LAT,
        dcn_bw=mm.IB_NDR_BW, dcn_lat=mm.IB_LAT)
    ref = JaxCostModel(cost_cap=0.8, fabric_kind=kind, machine=machine)
    port = MigrationCostModel(cost_cap=0.8, fabric_kind=kind)
    for written, block_bytes, chunk, step_s in [
            (40, 4096, 4, 5e-3), (7, 1 << 20, 0, 2e-3), (0, 0, 8, 0.0),
            (1000, 37748736, 8, 30e-3), (17, 10 << 30, 1, 1e-3)]:
        kw = dict(page_size=4, block_bytes=block_bytes, chunk=chunk,
                  step_s=step_s)
        assert (port.decide_handoff(written=written, **kw)
                == ref.decide_handoff(written=written, **kw))
        assert (port.decide(prompt_len=written, new_blocks=written // 4,
                            **kw)
                == ref.decide(prompt_len=written, new_blocks=written // 4,
                              **kw))


def test_cost_model_prices_the_card_s_links():
    """The in-process hop is two PCIe Gen5 crossings (device->host,
    host->device), the blob hop an InfiniBand NDR one."""
    from flexflow_tpu_torch.sim import machine_model as mm

    inproc = MigrationCostModel()
    assert inproc.hop_bw == mm.PCIE_GEN5_BW / 2
    assert inproc.hop_lat == 2 * mm.PCIE_LAT
    blob = MigrationCostModel(fabric_kind="blob")
    assert (blob.hop_bw, blob.hop_lat) == (mm.IB_NDR_BW, mm.IB_LAT)
    with pytest.raises(ValueError, match="cost cap"):
        MigrationCostModel(cost_cap=0)


def _fsck_frames(tmp_path):
    good = _frame()
    flipped = bytearray(good)
    flipped[-1] ^= 0xFF
    pages = [[1, 2], [3, 4, 5, 6]]
    partial = pack_kv_blocks(
        pages, [{"kv": np.zeros((4, 2), np.float32)} for _ in pages], 4)
    frames = {"good": {"a.ffkv": good},
              "torn": {"a.ffkv": good, "torn.ffkv": good[:-3]},
              "crc": {"crc.ffkv": bytes(flipped)},
              "partial": {"p.ffkv": partial},
              "magic": {"m.ffkv": b"NOPE" + good[4:]}}
    dirs = {}
    for name, files in frames.items():
        d = tmp_path / name
        d.mkdir()
        for fn, data in files.items():
            (d / fn).write_bytes(data)
        dirs[name] = str(d)
    return dirs


@pytest.mark.parametrize("case", ["good", "torn", "crc", "partial",
                                  "magic", "missing", "empty"])
@pytest.mark.parametrize("as_json", [False, True])
def test_kvframe_fsck_output_equals_the_reference_tool(tmp_path, capsys,
                                                       case, as_json):
    """The port's tool and tools/kvframe_fsck.py on the same frames:
    the same exit code (0 clean, 1 a bad frame, 2 usage) and the same
    stdout and stderr, text and --json."""
    from tools import kvframe_fsck as ref_tool

    from flexflow_tpu_torch.tools import kvframe_fsck as port_tool

    dirs = _fsck_frames(tmp_path)
    empty = tmp_path / "empty"
    empty.mkdir()
    dirs["empty"] = str(empty)
    dirs["missing"] = str(tmp_path / "nope")
    argv = [dirs[case]] + (["--json"] if as_json else [])
    out = []
    for tool in (ref_tool, port_tool):
        rc = tool.main(argv)
        o = capsys.readouterr()
        out.append((rc, o.out, o.err))
    assert out[0] == out[1]
    assert out[1][0] == {"good": 0, "missing": 2}.get(case, 1)
