"""The port's replicated serving front (flexflow_tpu_torch/serving/
front.py and replica.py), every case of tests/test_serving_front.py
mirrored on the port's own fake step model (no engine build): queue
handoff on replica death, supervised restarts under FaultPlan /
StepWatchdog / RetryPolicy, bounded requeues, shedding with
Retry-After, /v2/health's ok | degraded | down, the chip budget and
cache-affine dispatch.  Every replica of the port is one engine on one
card (tensor-parallel replicas are §1 item 8.3 of the roadmap), so the
chip-budget cases count one chip per replica where the reference's
count two.  Every wait is bounded; no assertion reads a count a live
thread may still change (the restart is awaited before close)."""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from flexflow_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from flexflow_tpu_torch.resilience.faults import (  # noqa: E402
    Fault, FaultKind, FaultPlan)
from flexflow_tpu_torch.serving import (  # noqa: E402
    ServiceUnavailable, ServingFront)
from flexflow_tpu_torch.serving.server import serve_http  # noqa: E402

V = 16
NO_SLEEP = lambda s: None  # noqa: E731


class FakeStepModel:
    """Deterministic stand-in for PagedKVDecodeModel: next token is
    (input + 1) % vocab as one-hot logits, so greedy expectations are
    closed-form — which makes requeue-after-death TOKEN-IDENTITY
    directly checkable.  Optional per-step delay simulates a hung
    device dispatch for the watchdog."""

    def __init__(self, batch_slots=2, max_seq=32, page_size=4,
                 delay_s=0.0):
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.max_blocks_per_seq = max_seq // page_size
        self.num_blocks = 1 + batch_slots * self.max_blocks_per_seq
        self.vocab = V
        self.delay_s = delay_s
        self.steps = 0

    def reset(self):
        pass

    def step(self, tokens, seq_lens, block_tables):
        self.steps += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        logits = np.zeros((self.batch_slots, V), np.float32)
        nxt = (np.asarray(tokens) + 1) % V
        logits[np.arange(self.batch_slots), nxt] = 1.0
        return logits


def expected(prompt, mnt):
    out = list(prompt)
    t = prompt[-1]
    for _ in range(mnt):
        t = (t + 1) % V
        out.append(t)
    return out


def factory(replica_id, survivors=None):
    return FakeStepModel()


def kill_on_steps(steps, kind=FaultKind.HUNG_STEP):
    return FaultPlan([Fault(step=s, kind=kind) for s in steps])


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- basic replicated serving -------------------------------------------

def test_front_serves_across_replicas():
    front = ServingFront(factory, num_replicas=2, sleep=NO_SLEEP)
    try:
        reqs = [([1, 2, 3], 4), ([5], 9), ([7, 8], 2), ([2, 4, 6, 8], 5),
                ([11], 3), ([3], 6)]
        hs = [front.generate_async(p, m) for p, m in reqs]
        for h, (p, m) in zip(hs, reqs):
            assert h.wait(30.0) == expected(p, m)
        assert front.requests_done == len(reqs)
        assert front.health()["status"] == "ok"
        st = front.stats()
        assert st["mode"] == "replicated"
        assert len(st["replicas"]) == 2
        # the dispatcher spread work: both replicas stepped
        assert all(r["batches_run"] > 0 for r in st["replicas"])
    finally:
        front.close()


def test_front_validates_at_admission():
    front = ServingFront(factory, num_replicas=1, sleep=NO_SLEEP)
    try:
        with pytest.raises(ValueError, match="prompt length"):
            front.generate_async([], 4)
        with pytest.raises(ValueError, match="max_new_tokens"):
            front.generate_async([1], 0)
    finally:
        front.close()


# -- replica death: requeue + token identity ----------------------------

def test_replica_death_requeues_inflight_token_identical():
    """Injected replica death mid-stream — in-flight requests
    are requeued and complete TOKEN-IDENTICALLY (greedy) on a
    surviving replica; queued requests are untouched; the dead replica
    restarts under supervision."""
    reg = MetricsRegistry()
    front = ServingFront(
        factory, num_replicas=2, registry=reg, sleep=NO_SLEEP,
        retry_backoff=0.0,
        fault_plans={0: kill_on_steps([2])},
    )
    try:
        # more requests than both replicas' slots: some queue at front
        reqs = [([1 + i, 2], 8) for i in range(6)]
        hs = [front.generate_async(p, m) for p, m in reqs]
        for h, (p, m) in zip(hs, reqs):
            assert h.wait(30.0) == expected(p, m)  # fault-free tokens
        assert front.requeued_requests >= 1
        assert reg.counter("serving/replica_deaths").value == 1
        assert front.replicas[0].deaths == 1
        assert _wait_for(lambda: front.replicas[0].state == "live")
        assert reg.counter("serving/replica_restarts").value == 1
        assert front.health()["status"] == "ok"
        # the front never returned a non-retriable error for an
        # admitted request
        assert front.requests_done == len(reqs)
    finally:
        front.close()


def test_device_loss_rebuilds_on_survivors():
    """A DeviceLossFault carries the surviving device count into the
    replica's rebuild factory (the degraded-mesh path)."""
    seen = []

    def recording_factory(replica_id, survivors=None):
        seen.append((replica_id, survivors))
        return FakeStepModel()

    plan = FaultPlan.single(1, FaultKind.DEVICE_LOSS, survivors=4)
    front = ServingFront(recording_factory, num_replicas=1,
                         sleep=NO_SLEEP, retry_backoff=0.0,
                         fault_plans={0: plan})
    try:
        assert front.generate([1, 2], 5, timeout=30.0) == \
            expected([1, 2], 5)
        assert _wait_for(lambda: front.replicas[0].restarts == 1)
        assert seen[0] == (0, None)
        assert seen[1] == (0, 4)  # rebuilt on the surviving count
    finally:
        front.close()


def test_hung_decode_step_routes_through_watchdog():
    """A REAL hang (step blocks past serving_step_timeout) raises
    HungStepTimeout via the StepWatchdog, kills the engine, and the
    supervisor restarts it — requests complete on the restarted
    replica instead of waiting forever."""
    built = []

    def hang_once_factory(replica_id, survivors=None):
        m = FakeStepModel(delay_s=5.0 if not built else 0.0)
        built.append(m)
        return m

    front = ServingFront(hang_once_factory, num_replicas=1,
                         step_timeout=0.3, sleep=NO_SLEEP,
                         retry_backoff=0.0)
    try:
        h = front.generate_async([1, 2], 4)
        assert h.wait(30.0) == expected([1, 2], 4)
        assert front.replicas[0].deaths == 1
        assert front.replicas[0].restarts == 1
        from flexflow_tpu_torch.resilience.watchdog import HungStepTimeout

        assert isinstance(front.replicas[0].last_error, HungStepTimeout)
        assert front.requeued_requests == 1
    finally:
        front.close()


# -- shedding and budgets -----------------------------------------------

def test_all_replicas_down_sheds_with_retry_after():
    reg = MetricsRegistry()
    front = ServingFront(
        factory, num_replicas=2, registry=reg, sleep=NO_SLEEP,
        retry_backoff=0.0, max_restarts=0, request_retry_limit=5,
        fault_plans={0: kill_on_steps(range(50)),
                     1: kill_on_steps(range(50))},
    )
    try:
        h = front.generate_async([1, 2], 4)  # drives both to death
        with pytest.raises(ServiceUnavailable):
            h.wait(30.0)
        assert _wait_for(
            lambda: front.health()["status"] == "down")
        assert all(r["state"] == "dead"
                   for r in front.health()["replicas"])
        with pytest.raises(ServiceUnavailable) as ei:
            front.generate_async([1], 2)
        assert ei.value.retry_after_s > 0
        assert front.shed_requests == 1
        assert reg.counter("serving/shed_requests").value == 1
    finally:
        front.close()


def test_restart_budget_exhaustion_marks_replica_dead():
    """One poisoned replica exhausts its budget and goes PERMANENTLY
    dead; the front keeps serving on the survivor and reports
    degraded."""
    front = ServingFront(
        factory, num_replicas=2, sleep=NO_SLEEP, retry_backoff=0.0,
        max_restarts=1, request_retry_limit=5,
        fault_plans={0: kill_on_steps(range(100))},
    )
    try:
        for i in range(6):
            assert front.generate([1 + i], 4, timeout=30.0) == \
                expected([1 + i], 4)
        assert _wait_for(lambda: front.replicas[0].state == "dead")
        health = front.health()
        assert health["status"] == "degraded"
        assert health["replicas"][0]["state"] == "dead"
        # still serving on the survivor
        assert front.generate([9], 3, timeout=30.0) == expected([9], 3)
    finally:
        front.close()


def test_request_retry_limit_exhaustion_is_retriable():
    """A request that keeps landing on dying replicas fails with a
    RETRIABLE ServiceUnavailable after request_retry_limit requeues —
    never a client error."""
    front = ServingFront(
        factory, num_replicas=1, sleep=NO_SLEEP, retry_backoff=0.0,
        max_restarts=100, request_retry_limit=2,
        fault_plans={0: kill_on_steps(range(200))},
    )
    try:
        h = front.generate_async([1, 2], 6)
        with pytest.raises(ServiceUnavailable, match="3 times"):
            h.wait(30.0)
        assert h.retries == 3  # initial + 2 requeues, all consumed
        assert front.requeued_requests == 2
    finally:
        front.close()


# -- shutdown -----------------------------------------------------------

def test_front_close_bounded_with_wedged_replica():
    """A replica wedged inside a decode step (no watchdog armed)
    cannot hang front shutdown: every close is bounded."""

    def wedged_factory(replica_id, survivors=None):
        return FakeStepModel(delay_s=30.0)

    front = ServingFront(wedged_factory, num_replicas=2,
                         sleep=NO_SLEEP, close_timeout_s=0.5)
    h = front.generate_async([1, 2], 4)
    time.sleep(0.2)  # let a step wedge
    t0 = time.monotonic()
    front.close()
    assert time.monotonic() - t0 < 10.0
    with pytest.raises(RuntimeError):
        h.wait(1.0)
    with pytest.raises(RuntimeError, match="closed"):
        front.generate_async([1], 1)


# -- metrics ------------------------------------------------------------

def test_front_metrics_and_summary(tmp_path):
    reg = MetricsRegistry()
    front = ServingFront(
        factory, num_replicas=2, registry=reg, sleep=NO_SLEEP,
        retry_backoff=0.0, fault_plans={0: kill_on_steps([2])},
    )
    try:
        hs = [front.generate_async([1 + i], 6) for i in range(4)]
        for h in hs:
            h.wait(30.0)
        # the killed replica's restart runs on its supervisor thread:
        # wait for it, so that close() cannot race it
        assert _wait_for(lambda: front.replicas[0].restarts == 1)
        front.stats()  # refreshes the replicas_live gauge
    finally:
        front.close()
    names = {m for m in reg._metrics}
    assert "serving/replica_deaths" in names
    assert "serving/replica_restarts" in names
    assert "serving/requeued_requests" in names
    assert "serving/replica/0/queue_depth" in names
    assert "serving/replica/1/queue_depth" in names
    assert "serving/replicas_live" in names
    path = tmp_path / "run_telemetry.jsonl"
    assert reg.write_jsonl(str(path)) > 0
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    from flexflow_tpu_torch.tools import telemetry_summary as summary

    text = summary.summarize(recs)
    assert "replica_deaths" in text and "requeued_requests" in text


# -- HTTP surface -------------------------------------------------------

def _post(port, payload, path="/v2/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read())


def test_http_front_health_stats_and_shed():
    front = ServingFront(
        factory, num_replicas=2, sleep=NO_SLEEP, retry_backoff=0.0,
        max_restarts=0, request_retry_limit=3,
        fault_plans={0: kill_on_steps(range(50)),
                     1: kill_on_steps(range(50))},
    )
    server = serve_http(generator=front, port=0, block=False)
    port = server.server_address[1]
    try:
        health = _get(port, "/v2/health")
        assert health["status"] == "ok"
        assert [r["state"] for r in health["replicas"]] == ["live"] * 2
        # the first request drives both replicas to permanent death
        # (every step is a kill; max_restarts=0): its retries exhaust
        # into a 503 retriable with a Retry-After
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, {"prompt": [1, 2], "max_new_tokens": 3})
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") is not None
        assert json.loads(ei.value.read())["retriable"]
        assert _wait_for(lambda: front.health()["status"] == "down")
        # down rides a 503 for status-code-only probes
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/v2/health")
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["status"] == "down"
        # shed new requests: 503 + Retry-After
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, {"prompt": [1], "max_new_tokens": 2})
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") is not None
        assert json.loads(ei.value.read())["retriable"]
        # stats carries the per-replica block
        stats = _get(port, "/v2/stats")
        reps = stats["continuous"]["replicas"]
        assert [r["state"] for r in reps] == ["dead", "dead"]
    finally:
        server.shutdown()
        front.close()


def test_http_front_serves_and_degrades():
    front = ServingFront(
        factory, num_replicas=2, sleep=NO_SLEEP, retry_backoff=0.0,
        max_restarts=0, request_retry_limit=3,
        fault_plans={0: kill_on_steps(range(50))},  # replica 0 dies
    )
    server = serve_http(generator=front, port=0, block=False)
    port = server.server_address[1]
    try:
        status, out = _post(port, {"prompts": [[1, 2], [5]],
                                   "max_new_tokens": 4})
        assert status == 200
        assert out["tokens"] == [expected([1, 2], 4), expected([5], 4)]
        assert _wait_for(lambda: front.replicas[0].state == "dead")
        # degraded still SERVES, so it rides a 200 (unlike the
        # single-engine degraded, which cannot serve at all)
        health = _get(port, "/v2/health")
        assert health["status"] == "degraded"
        status, out = _post(port, {"prompt": [3], "max_new_tokens": 2})
        assert status == 200 and out["tokens"] == [expected([3], 2)]
    finally:
        server.shutdown()
        front.close()


# -- chip budget + cache-affine dispatch ---------------------------------

def test_front_chip_budget_refuses_add_replica():
    """Fleet chips = replicas x 1 (one card per replica); an add_replica
    that would pass --serving-chip-budget is refused BEFORE the build
    and counted."""
    reg = MetricsRegistry()
    front = ServingFront(factory, num_replicas=1, chip_budget=2,
                         registry=reg, sleep=NO_SLEEP)
    try:
        assert front.chips_per_replica == 1
        front.add_replica()  # 2 chips: fits exactly
        with pytest.raises(RuntimeError, match="chip budget exhausted"):
            front.add_replica()
        assert reg.counter("serving/chip_budget_refused").value == 1
        st = front.stats()
        assert st["chips_per_replica"] == 1
        assert st["chip_budget"] == 2
        assert st["fleet_chips"] == 2
        assert len(st["replicas"]) == 2
    finally:
        front.close()


def test_front_chip_budget_validates_initial_fleet():
    with pytest.raises(ValueError, match="chip budget"):
        ServingFront(factory, num_replicas=3, chip_budget=2,
                     sleep=NO_SLEEP)


def test_front_without_budget_keeps_prior_behavior():
    front = ServingFront(factory, num_replicas=1, sleep=NO_SLEEP)
    try:
        for _ in range(3):
            front.add_replica()  # unbounded: no refusal
        assert len(front.replicas) == 4
        assert front.stats()["chip_budget"] == 0
    finally:
        front.close()


def test_dispatch_is_cache_affine():
    """The dispatcher routes a request to the replica whose prefix
    cache holds the longest prefix of its prompt — not least-loaded —
    and falls back to least-loaded for cold prompts."""
    reg = MetricsRegistry()
    front = ServingFront(factory, num_replicas=2, registry=reg,
                         sleep=NO_SLEEP)
    try:
        r0, r1 = front.replicas
        # pretend replica 1 (NOT first in rotation) holds the blocks
        r1.scheduler.cached_prefix_tokens = (
            lambda p: 4 if list(p)[:4] == [1, 2, 3, 4] else 0)
        r0.scheduler.cached_prefix_tokens = lambda p: 0
        h = front.generate_async([1, 2, 3, 4, 5], 3)
        assert h.wait(30.0) == expected([1, 2, 3, 4, 5], 3)
        assert r1.stats()["batches_run"] > 0
        assert r0.stats()["batches_run"] == 0
        assert reg.counter("serving/cache_affine_routed").value == 1
        # a cold prompt falls back to least-loaded (replica 0 first)
        h = front.generate_async([9, 9], 2)
        assert h.wait(30.0) == expected([9, 9], 2)
        assert r0.stats()["batches_run"] > 0
    finally:
        front.close()


def test_cache_affinity_follows_real_prefix_cache():
    """End to end on the real block pool: the first shared-prefix
    request warms ONE replica's prefix cache; every later request with
    the same prefix routes to that same replica (its prefill becomes a
    block-table metadata hit), leaving the other replica cold."""
    front = ServingFront(factory, num_replicas=2, sleep=NO_SLEEP)
    try:
        prefix = [1, 2, 3, 4]  # one full page (page_size=4)
        assert front.generate(prefix + [5], 3) == \
            expected(prefix + [5], 3)
        warm = [r for r in front.replicas
                if r.stats()["batches_run"] > 0]
        assert len(warm) == 1
        for tail in ([6], [7, 8], [5]):
            assert front.generate(prefix + tail, 3) == \
                expected(prefix + tail, 3)
        cold = [r for r in front.replicas if r is not warm[0]]
        assert cold[0].stats()["batches_run"] == 0
        assert warm[0].scheduler.cached_prefix_tokens(prefix + [5]) >= 4
    finally:
        front.close()


# -- no fallback hides the card ---------------------------------------------

class _KernelFailingModel(FakeStepModel):
    """The first step's paged-attention launch fails, as a kernel that
    did not build or launch would."""

    failed = []

    def step(self, tokens, seq_lens, block_tables):
        if not self.failed:
            from flexflow_tpu_torch.ops.kernels._build import \
                KernelLaunchError

            self.failed.append(True)
            raise KernelLaunchError("paged_attention kernel launch failed")
        return super().step(tokens, seq_lens, block_tables)


def test_a_kernel_launch_failure_kills_the_engine_and_is_counted():
    """KernelLaunchError is fatal to the engine: the replica dies and
    restarts through the death path (counted), its request is requeued
    and completes; nothing retries the step or falls back."""
    reg = MetricsRegistry()
    _KernelFailingModel.failed.clear()
    front = ServingFront(lambda rid, survivors=None: _KernelFailingModel(),
                         num_replicas=1, registry=reg, sleep=NO_SLEEP,
                         retry_backoff=0.0)
    try:
        assert front.generate([1, 2], 4, timeout=30.0) == expected([1, 2], 4)
        assert _wait_for(lambda: front.replicas[0].restarts == 1)
        assert front.replicas[0].deaths == 1
        assert reg.counter("serving/replica_deaths").value == 1
        assert front.replicas[0].stats()["step_failures"] == 0
    finally:
        front.close()


def test_an_engine_for_the_card_raises_on_a_host_without_one():
    """A replica's engine for a model on the card cannot be built on a
    host without CUDA: the build raises, and so does the front."""
    import types

    import torch

    from flexflow_tpu_torch.serving import PagedKVDecodeModel

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVDecodeModel(on_card)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingFront(lambda rid, survivors=None: PagedKVDecodeModel(on_card),
                     num_replicas=1, sleep=NO_SLEEP)
