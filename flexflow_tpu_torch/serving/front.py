"""ServingFront (flexflow_tpu/serving/front.py): one admission queue, N
supervised replicas.

A lone `ContinuousScheduler` takes the whole service down with it when
it dies.  The front makes availability a property of the fleet:

  * **one shared admission queue.**  Requests are validated and queued
    at the front; a dispatcher hands each to a live replica, the one
    whose prefix cache holds the longest prefix of its tokens (cache
    affinity), else the least loaded, capped at each replica's slot
    count, so a replica death strands only what it was running.
  * **supervised replicas** (serving/replica.py): each a
    `ContinuousScheduler` under the resilience primitives: the step
    watchdog, a seeded `FaultPlan`, a jittered-backoff `RetryPolicy`
    with a restart budget, rebuilds on the surviving device count.
  * **requeue with a bounded retry count.**  A request stranded by a
    replica death (or failed by a transient step fault) goes back to
    the HEAD of the queue with the resume record its scheduler stamped
    and runs on: a replay of prompt + generated gives the same tokens.
    One past `request_retry_limit` fails with a retriable 503, never a
    client error.
  * **mid-decode handoff** (serving/handoff.py, with `handoff=True`): a
    draining, terminating or rebalanced replica pauses its in-flight
    generations; the front streams their KV blocks to another replica
    through a `KVMigrator` (serving/kv_transfer.py), priced against a
    replay by `MigrationCostModel` (serving/disagg.py), and requeues
    the resume.  Every fault on the way degrades to replay.
  * **load shedding, not unbounded queueing.**  While no replica is
    live, or while the predicted TTFT passes `admission_deadline_s`,
    submissions are refused with `ServiceUnavailable` (HTTP 503 and a
    Retry-After from the measured drain rate, server.py).  When every
    replica is permanently dead, the queue fails retriably.

The batcher contract (generate / generate_async / latency_stats /
stats / close / worker_alive) plus `health()` for /v2/health's ok |
degraded | down.  Metrics (serving/replica_restarts, replica_deaths,
requeued_requests, shed_requests, handoff_*, per-replica queue-depth
gauges) ride the shared obs.metrics registry.  Request tracing and the
autoscaler are not ported yet (§1 item 8.4 of the roadmap):
`self.autoscaler` stays None.
"""
from __future__ import annotations

import itertools
import signal
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from ..logger import resilience_logger
from ..resilience.faults import FaultPlan
from ..resilience.retry import RetryPolicy
from .handoff import HandoffPaused
from .replica import ServingReplica


class ServiceUnavailable(RuntimeError):
    """The front cannot take (or finish) this request right now; the
    client should back off and retry.  server.py maps it to HTTP 503
    with a Retry-After header from `retry_after_s`."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class FrontRequest:
    """Front-level future for one admitted request.  Mirrors the
    scheduler handle surface the loadgen and server consume (wait /
    t_submit / t_first_token / t_done / n_generated), independent of
    which replica — or how many, after requeues — ran it."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "event",
                 "result", "error", "t_submit", "t_first_token",
                 "t_done", "n_generated", "retries",
                 "queue_depth_at_admit", "deadline_s",
                 "prefix_hit_tokens", "served_role", "migration",
                 "seed", "resume")

    def __init__(self, prompt, max_new_tokens, temperature,
                 deadline_s: Optional[float] = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.event = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[Exception] = None
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.n_generated = 0
        self.retries = 0  # requeues consumed (replica deaths/faults)
        self.queue_depth_at_admit = 0  # front backlog seen at admission
        self.deadline_s = deadline_s   # TTFT SLO for admission control
        self.prefix_hit_tokens = 0     # stamped from the replica handle
        self.served_role = None        # class of the replica that served
        self.migration = None  # the handoff's pricing record
        self.seed = None   # per-request sampling seed (front-minted)
        self.resume = None  # ResumeRecord after a pause/death mid-decode

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self.event.wait(timeout):
            raise TimeoutError("generation request timed out")
        if self.error is not None:
            raise self.error
        return self.result


class ServingFront:
    """N supervised ContinuousScheduler replicas behind one queue.

    `model_factory(replica_id, survivors=None)` builds one replica's
    decode model (see ServingReplica).  `fault_plans` optionally maps
    replica id -> FaultPlan for seeded fault injection; `step_timeout`
    arms each replica's decode-step watchdog; `max_restarts` /
    `retry_backoff` bound each replica's supervised restarts;
    `request_retry_limit` bounds per-request requeues.
    """

    def __init__(
        self,
        model_factory: Callable,
        num_replicas: int = 2,
        *,
        eos_id: int = -1,
        registry=None,
        seed: int = 0,
        step_timeout: float = 0.0,
        max_restarts: int = 3,
        retry_backoff: float = 0.1,
        request_retry_limit: int = 2,
        handoff: bool = False,
        chip_budget: int = 0,
        fault_plans: Optional[Dict[int, FaultPlan]] = None,
        roles: Optional[Sequence[str]] = None,
        check_invariants: bool = False,
        latency_window: int = 1024,
        close_timeout_s: float = 5.0,
        shed_retry_after_s: float = 1.0,
        admission_deadline_s: float = 0.0,
        rate_staleness_s: float = 30.0,
        kv_transfer=None,
        sleep: Callable[[float], None] = time.sleep,
        logger=resilience_logger,
    ):
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}")
        if request_retry_limit < 0:
            raise ValueError(
                f"request_retry_limit must be >= 0, "
                f"got {request_retry_limit}")
        # replica roles (the disaggregated fleet, §1 item 8.4 of the
        # roadmap): "prefill" replicas never serve client decodes (the
        # dispatcher skips them), "decode" and "mixed" replicas do.
        # A fleet with no decode-capable member could admit but never
        # serve, so it is refused at construction.
        if roles is None:
            roles = ["mixed"] * num_replicas
        roles = [str(r) for r in roles]
        if len(roles) != num_replicas:
            raise ValueError(
                f"roles must name every replica: got {len(roles)} "
                f"role(s) for {num_replicas} replica(s)")
        for r in roles:
            if r not in ("prefill", "decode", "mixed"):
                raise ValueError(
                    f"unknown replica role {r!r} (expected prefill, "
                    "decode, or mixed)")
        if all(r == "prefill" for r in roles):
            raise ValueError(
                "fleet needs at least one decode-capable replica "
                "(role decode or mixed)")
        self.registry = registry
        self.request_retry_limit = int(request_retry_limit)
        self.chip_budget = int(chip_budget)  # 0 = unbounded
        # mid-decode handoff (serving/handoff.py): with the flag on, a
        # DRAINING / terminating / rebalanced replica pauses in-flight
        # generations and the front resumes them elsewhere instead of
        # waiting them out or shedding them.  Off by default: the
        # classic drain semantics (run every slot to completion).
        self.handoff = bool(handoff)
        # per-request sampling seeds: minted at admission so a
        # temperature>0 generation replays deterministically on any
        # replica (each scheduler seeds a private RandomState from it)
        self._req_seed = itertools.count(int(seed) * 1_000_003 + 1)
        # the fabric live handoffs cross: a fabric object, or a
        # --kv-transfer spec (None: "inproc"), resolved here so that a
        # bad spec fails the build and not a pause
        if kv_transfer is None or isinstance(kv_transfer, str):
            from .kv_transfer import resolve_kv_transfer

            kv_transfer = resolve_kv_transfer(kv_transfer or "inproc")
        self._kv_fabric = kv_transfer
        self._handoff_mig = None  # lazy KVMigrator
        self._handoff_cm = None   # lazy MigrationCostModel
        self._handoff_inflight = 0  # pauses not yet requeued
        self.handoff_requested = 0
        self.handoff_ok = 0
        self.handoff_replays = 0
        self.handoff_migrate_decisions = 0
        self.handoff_replay_decisions = 0
        self.handoff_faults: Dict[str, int] = {}
        self._pending_replicas = 0  # add_replica compiles in flight
        self.shed_retry_after_s = float(shed_retry_after_s)
        self.admission_deadline_s = float(admission_deadline_s)
        self.rate_staleness_s = float(rate_staleness_s)
        self.log = logger
        self._cv = threading.Condition()
        self._admission: "deque[FrontRequest]" = deque()
        self._closed = False
        self._terminating = False
        self.requests_done = 0
        self.shed_requests = 0
        self.admission_shed = 0   # overload-control sheds (deadline)
        self.requeued_requests = 0
        self._latencies = deque(maxlen=latency_window)
        self._ttfts = deque(maxlen=latency_window)
        self._lat_lock = threading.Lock()
        # completion timestamps for the measured service rate (drain
        # rate): Retry-After and predicted-TTFT admission control both
        # read it instead of a constant.  _done_busy marks, per
        # completion, whether the admission queue was non-empty at
        # that moment — only those samples witness CAPACITY (an
        # uncontended completion merely tracks the arrival rate)
        self._done_times = deque(maxlen=256)
        self._done_busy = deque(maxlen=256)
        # per-CLASS completion windows (role -> timestamps) and
        # per-token samples: once roles split, a single fleet-wide
        # window would blend prefill-pass throughput into the decode
        # drain rate and mis-size Retry-After / admission control
        self._class_done: Dict[str, deque] = {}
        self._class_tok: Dict[str, deque] = {}
        # the autoscaler's place (not ported yet: §1 item 8.4)
        self.autoscaler = None
        # bounded retirement history: a long-lived front cycles replicas
        # indefinitely, so keep the last few for /v2/stats and fold the
        # rest into aggregate counters
        self.retired: List[ServingReplica] = []
        self.retired_keep = 16
        self._retired_dropped = 0
        self._retired_folded = {"batches_run": 0, "tokens_generated": 0}
        self._model_factory = model_factory
        plans = fault_plans or {}
        self._replica_kw = dict(
            eos_id=eos_id, registry=registry, seed=seed,
            step_timeout=step_timeout, max_restarts=max_restarts,
            retry_backoff=retry_backoff,
            check_invariants=check_invariants,
            close_timeout_s=close_timeout_s, sleep=sleep, logger=logger,
        )
        self.replicas: List[ServingReplica] = [
            self._build_replica(i, fault_plan=plans.get(i),
                                role=roles[i])
            for i in range(num_replicas)
        ]
        self._next_replica_id = num_replicas
        # every replica is one engine on one card (tensor-parallel
        # replicas are §1 item 8.3); the chip budget bounds
        # len(replicas) * chips_per_replica
        self.chips_per_replica = 1
        if self.chip_budget and (len(self.replicas)
                                 * self.chips_per_replica
                                 > self.chip_budget):
            for r in self.replicas:
                r.close(close_timeout_s)
            raise ValueError(
                f"chip budget {self.chip_budget} cannot hold "
                f"{len(self.replicas)} replica(s) x "
                f"{self.chips_per_replica} chip(s) each")
        self.max_seq = self.replicas[0].scheduler.model.max_seq
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="serving-front-dispatch",
        )
        self._dispatcher.start()

    def _build_replica(self, replica_id: int,
                       fault_plan=None,
                       role: str = "mixed") -> ServingReplica:
        kw = self._replica_kw
        r = ServingReplica(
            replica_id, self._model_factory,
            eos_id=kw["eos_id"], registry=kw["registry"],
            seed=kw["seed"],
            step_timeout=kw["step_timeout"],
            retry=RetryPolicy(max_restarts=kw["max_restarts"],
                              base_backoff=kw["retry_backoff"],
                              seed=kw["seed"] + replica_id),
            fault_plan=fault_plan,
            role=role,
            check_invariants=kw["check_invariants"],
            close_timeout_s=kw["close_timeout_s"],
            sleep=kw["sleep"],
            logger=kw["logger"],
        )
        r.on_state_change = self._on_replica_state
        return r

    @classmethod
    def from_trained(cls, ff_train, num_replicas: Optional[int] = None,
                     *, eos_id: int = -1, registry=None,
                     fault_plans: Optional[Dict[int, FaultPlan]] = None,
                     draft_ff=None, kv_store=None,
                     **kw) -> "ServingFront":
        """Replicated front over a trained GPT, reading the FFConfig
        serving fields (serving_replicas, serving_step_timeout,
        serving_max_restarts, request_retry_limit, serving_handoff,
        admission_deadline_s, serving_chip_budget, kv_transfer,
        spec_decode, spec_k and the pool geometry).  Each replica builds
        its own paged decode engine on the trained model's device, and
        so does every rebuild after a death.

        `draft_ff` is the smaller trained GPT that spec_decode "draft"
        drafts with; each replica builds its own draft engine from it,
        and a missing one is a ConfigError here, not a death loop.
        `kv_store` is the blob store a "blob" kv_transfer crosses (a
        LocalBlobStore under the strategy store's directory when None)."""
        from ..config import ConfigError, resolve_spec_decode
        from .kv_transfer import resolve_kv_transfer
        from .scheduler import PagedKVDecodeModel

        cfg = ff_train.config
        # the run's telemetry registry unless the caller wires its own
        tel = getattr(ff_train, "telemetry", None)
        if (registry is None and tel is not None
                and getattr(tel, "enabled", False)):
            registry = tel.metrics
        spec_decode = resolve_spec_decode(cfg.spec_decode, cfg.spec_k)
        spec_k = int(cfg.spec_k)
        if spec_decode == "draft" and draft_ff is None:
            raise ConfigError(
                "--spec-decode draft needs a draft model: pass "
                "ServingFront.from_trained(..., draft_ff=<smaller "
                "trained GPT>) or use --spec-decode ngram")

        def factory(replica_id, survivors=None):
            draft_model = None
            if spec_decode == "draft":
                draft_model = PagedKVDecodeModel(
                    draft_ff, batch_slots=cfg.serving_slots,
                    page_size=cfg.kv_page_size)
            return PagedKVDecodeModel(
                ff_train,
                batch_slots=cfg.serving_slots,
                page_size=cfg.kv_page_size,
                num_blocks=cfg.kv_pool_blocks or None,
                prefill_chunk=cfg.prefill_chunk,
                prefix_cache=cfg.prefix_cache,
                spec_decode=spec_decode,
                spec_k=spec_k,
                draft_model=draft_model,
            )

        kw.setdefault("step_timeout", cfg.serving_step_timeout)
        kw.setdefault("max_restarts", cfg.serving_max_restarts)
        kw.setdefault("request_retry_limit", cfg.request_retry_limit)
        kw.setdefault("handoff", cfg.serving_handoff)
        kw.setdefault("seed", cfg.seed)
        kw.setdefault("admission_deadline_s", cfg.admission_deadline_s)
        kw.setdefault("chip_budget", cfg.serving_chip_budget)
        if "kv_transfer" not in kw:
            kw["kv_transfer"] = resolve_kv_transfer(
                cfg.kv_transfer, store=kv_store,
                root=cfg.strategy_store or None)
        n = cfg.serving_replicas if num_replicas is None else num_replicas
        budget = int(kw.get("chip_budget") or 0)
        if budget and n > budget:
            raise ConfigError(
                f"--serving-chip-budget {budget} cannot hold the "
                f"initial fleet: {n} replica(s) x 1 chip = {n} chip(s)")
        return cls(
            factory, n,
            eos_id=eos_id, registry=registry, fault_plans=fault_plans,
            **kw,
        )

    # -- replica events --------------------------------------------------
    def _on_replica_state(self, replica: ServingReplica) -> None:
        with self._cv:
            self._cv.notify_all()

    def _live(self) -> List[ServingReplica]:
        return [r for r in self.replicas if r.alive]

    def _serving(self) -> List[ServingReplica]:
        """Decode-capable subset: the replicas client requests can be
        dispatched to.  Identical to the fleet while every role is
        mixed; prefill-class replicas only run migration passes."""
        return [r for r in self.replicas if r.role != "prefill"]

    def _serving_live(self) -> List[ServingReplica]:
        return [r for r in self._serving() if r.alive]

    def _all_permanently_dead(self) -> bool:
        # vacuous truth on an empty fleet would mislabel terminate()'s
        # residue (all replicas retired) as "restart budgets exhausted".
        # Only the decode-capable subset counts: a fleet whose decode
        # class is gone cannot finish a client request no matter how
        # healthy its prefill class is.
        serving = self._serving()
        return bool(serving) and all(
            r.state == "dead" for r in serving)

    # -- fleet lifecycle (scale-up, drain, SIGTERM grace) ----------------
    def add_replica(self, role: str = "mixed") -> ServingReplica:
        """Scale-up: build one more supervised replica and put it in the
        dispatcher's rotation.  With a chip budget set, a replica that
        would not fit (fleet chips + chips_per_replica > budget) is
        refused BEFORE it is built, and counted."""
        if self._closed or self._terminating:
            raise RuntimeError("ServingFront is closing")
        with self._cv:
            if self.chip_budget:
                in_use = (len(self.replicas) + self._pending_replicas
                          ) * self.chips_per_replica
                if in_use + self.chips_per_replica > self.chip_budget:
                    if self.registry is not None:
                        self.registry.counter(
                            "serving/chip_budget_refused").inc()
                    raise RuntimeError(
                        f"chip budget exhausted: {in_use} of "
                        f"{self.chip_budget} chip(s) in use and a new "
                        f"replica spans {self.chips_per_replica}")
            self._pending_replicas += 1
            rid = self._next_replica_id
            self._next_replica_id += 1
        if role not in ("prefill", "decode", "mixed"):
            with self._cv:
                self._pending_replicas -= 1
            raise ValueError(f"unknown replica role {role!r}")
        try:
            # compile OUTSIDE the lock
            replica = self._build_replica(rid, role=role)
        except Exception:
            with self._cv:
                self._pending_replicas -= 1
            raise
        with self._cv:
            self._pending_replicas -= 1
            # close()/terminate() may have swept the fleet while we
            # were compiling; appending now would leak a live engine
            # nobody ever closes
            if self._closed or self._terminating:
                aborted = True
            else:
                aborted = False
                self.replicas.append(replica)
                self._cv.notify_all()
        if aborted:
            replica.close()
            raise RuntimeError("ServingFront is closing")
        if self.registry is not None:
            self.registry.counter("serving/replicas_added").inc()
        self.log.info("serving front: replica %d added (fleet %d)",
                      rid, len(self.replicas))
        return replica

    def drain_replica(self, replica: ServingReplica) -> bool:
        """Scale-down: READY -> DRAINING.  The dispatcher stops routing
        to it immediately (state leaves \"live\"); in-flight slots run
        to completion token-identically; on retirement the replica
        leaves `replicas` for `retired` and its KV pool is freed.

        With handoff enabled and another live serving replica up, the
        drain is proactive instead of patient: every in-flight
        generation with tokens left pauses onto the handoff path and
        resumes elsewhere, so the drain time is bounded by the
        migration, not by the longest generation."""
        ok = replica.drain(on_retired=self._on_replica_retired)
        if ok and self.handoff and replica.role != "prefill":
            with self._cv:
                others = [r for r in self._serving_live()
                          if r is not replica]
            if others:
                replica.request_handoff(remaining_over=0,
                                        export_kv=True)
        return ok

    def _on_replica_retired(self, replica: ServingReplica) -> None:
        dropped = []
        with self._cv:
            if replica in self.replicas:
                self.replicas.remove(replica)
                self.retired.append(replica)
                while len(self.retired) > self.retired_keep:
                    old = self.retired.pop(0)
                    st = old.stats()
                    self._retired_dropped += 1
                    for k in self._retired_folded:
                        self._retired_folded[k] += int(st.get(k, 0))
                    dropped.append(old)
            self._cv.notify_all()
        for old in dropped:
            old.close(0.1)  # outside the lock: close joins a thread
        if self.registry is not None:
            # replica ids are monotonic — the per-id gauge would
            # otherwise accumulate one dead name per scale cycle
            self.registry.remove(
                f"serving/replica/{replica.replica_id}/queue_depth")
        self.log.info("serving front: replica %d retired (fleet %d)",
                      replica.replica_id, len(self.replicas))

    # -- measured service rate -------------------------------------------
    def _note_class_done(self, role: Optional[str], t: float,
                         per_token_s: Optional[float] = None) -> None:
        """Record one client completion (from _complete) in its replica
        class's window.  Caller holds no lock."""
        if not role:
            return
        with self._lat_lock:
            self._class_done.setdefault(
                role, deque(maxlen=256)).append(t)
            if per_token_s is not None:
                self._class_tok.setdefault(
                    role, deque(maxlen=256)).append(per_token_s)

    def service_rate(self, role: Optional[str] = None
                     ) -> Optional[float]:
        """Measured completions/s over the recent window; None until
        two completions have landed, and None again once the newest
        completion is older than `rate_staleness_s` — after an idle
        gap the old span measures ARRIVALS, not capacity, and a stale
        near-zero rate would shed traffic an idle fleet could trivially
        serve.  This is the drain rate Retry-After and predicted-TTFT
        admission control are computed from.  With `role` set, the
        window is that replica class's alone (disaggregated fleets:
        prefill passes must not blend into the decode drain rate)."""
        with self._lat_lock:
            ts = list(self._done_times if role is None
                      else self._class_done.get(role, ()))
        if len(ts) < 2:
            return None
        if time.monotonic() - ts[-1] > self.rate_staleness_s:
            return None
        span = ts[-1] - ts[0]
        if span <= 0:
            return None
        return (len(ts) - 1) / span

    def _capacity_rate(self) -> Optional[float]:
        """Completions/s over the TRAILING RUN of completions that all
        landed with a non-empty admission queue — i.e. while the fleet
        was saturated, so the span witnesses CAPACITY.  Anything less
        (a whole-window rate, even one gated on a few busy samples)
        is contaminated by calm stretches where completions pace
        arrivals, and shedding on an arrival rate would condemn the
        first burst after every quiet period.  None until the run has
        3 members; an uncontended completion resets it (the queue
        drained — no longer saturated, and with an empty queue the
        shed path is off anyway)."""
        with self._lat_lock:
            ts = list(self._done_times)
            flags = list(self._done_busy)
        run = 0
        for b in reversed(flags):
            if not b:
                break
            run += 1
        if run < 3:
            return None
        ts = ts[-run:]
        if time.monotonic() - ts[-1] > self.rate_staleness_s:
            return None
        span = ts[-1] - ts[0]
        if span <= 0:
            return None
        return (run - 1) / span

    def _prefix_discount(self, prompt, max_new: int) -> float:
        """The candidate request's own service cost relative to an
        uncached request of the same shape: cached prefix tokens cost
        ZERO prefill steps, so a request whose prompt is largely in a
        replica's prefix cache consumes (plen - hit + max_new) of the
        (plen + max_new) steps an uncached twin would.  The dispatcher
        is CACHE-AFFINE (_pick_replica routes a request to the replica
        holding its longest cached prefix), so the discount uses the
        BEST live replica's hit — that is the replica that will
        actually serve it.  1.0 when nothing is cached or no live
        replica exposes a probe."""
        best = None
        for r in self._serving():
            sched = r.scheduler
            if r.state != "live" or sched is None:
                continue
            probe = getattr(sched, "cached_prefix_tokens", None)
            if probe is None:
                return 1.0
            try:
                hit = probe(prompt)
            except Exception:  # noqa: BLE001 — a probe must never shed
                return 1.0
            total = len(prompt) + max_new
            cost = max(0, total - hit) / max(total, 1)
            best = cost if best is None else min(best, cost)
        return 1.0 if best is None else best

    def _predict_wait_s(self, depth: int) -> Optional[float]:
        """Predicted time for `depth` queued requests to clear at the
        measured service rate (None with no measurements yet)."""
        rate = self.service_rate()
        if rate is None or rate <= 0:
            return None
        return depth / rate

    def _retry_after(self, depth: Optional[int] = None) -> float:
        """Retry-After from the measured drain rate: how long until the
        current backlog clears.  Falls back to the constructor constant
        before any completion has been measured."""
        if depth is None:
            with self._cv:
                depth = len(self._admission) + sum(
                    r.outstanding for r in self.replicas)
        predicted = self._predict_wait_s(max(depth, 1))
        if predicted is None:
            return self.shed_retry_after_s
        return min(max(predicted, self.shed_retry_after_s), 120.0)

    # -- client API ------------------------------------------------------
    def generate_async(self, prompt, max_new_tokens: int = 16,
                       temperature: float = 0.0,
                       deadline_s: Optional[float] = None) -> FrontRequest:
        if self._closed:
            raise RuntimeError("ServingFront is closed")
        # validate at admission (the batcher convention: a bad request
        # fails alone, synchronously, as a client error)
        req = FrontRequest(prompt, max_new_tokens, temperature,
                           deadline_s=deadline_s)
        if not 1 <= len(req.prompt) < self.max_seq:
            raise ValueError(
                f"prompt length {len(req.prompt)} outside "
                f"[1, {self.max_seq})")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {deadline_s}")
        with self._cv:
            if self._terminating:
                # SIGTERM grace: the front is draining — redirect new
                # load with a Retry-After from the measured drain rate
                self.shed_requests += 1
                if self.registry is not None:
                    self.registry.counter("serving/shed_requests").inc()
                raise ServiceUnavailable(
                    "serving front is terminating",
                    retry_after_s=self._retry_after(
                        len(self._admission) + 1),
                )
            if not self._serving_live():
                # no decode-capable replica up: shed instead of
                # queueing against a service that may never come back
                self.shed_requests += 1
                if self.registry is not None:
                    self.registry.counter("serving/shed_requests").inc()
                raise ServiceUnavailable(
                    "all serving replicas are down",
                    retry_after_s=self.shed_retry_after_s,
                )
            depth = len(self._admission)
            backlog = depth + sum(r.outstanding for r in self.replicas)
            # overload admission control: a request whose PREDICTED
            # TTFT (backlog ahead of it / measured service rate)
            # already exceeds its deadline would only time out inside
            # the queue — shed it NOW so the front degrades to a
            # bounded-latency subset under sustained overload
            slo = (deadline_s if deadline_s is not None
                   else self.admission_deadline_s)
            # only predict when there is an actual FRONT backlog: with
            # an empty admission queue the request dispatches at once
            # and its TTFT is service time, not backlog/rate — the
            # measured rate is arrival-limited and would over-predict
            if slo and slo > 0 and depth > 0:
                # capacity-gated rate, NOT the general service rate:
                # Retry-After may hint from an arrival-paced window,
                # but shedding on one would be wrong
                rate = self._capacity_rate()
                # the request's own cost discounts its prefix-cache
                # hit: cached tokens cost zero prefill steps, so a
                # fully cached prompt predicts backlog-drain time only
                own = self._prefix_discount(req.prompt,
                                            req.max_new_tokens)
                predicted = (None if rate is None or rate <= 0
                             else (backlog + own) / rate)
                if predicted is not None and predicted > slo:
                    self.admission_shed += 1
                    if self.registry is not None:
                        self.registry.counter(
                            "serving/admission_shed").inc()
                    raise ServiceUnavailable(
                        f"predicted TTFT {predicted:.2f}s exceeds the "
                        f"{slo:.2f}s deadline (backlog {backlog} at "
                        "the measured service rate)",
                        retry_after_s=min(max(
                            predicted - slo, self.shed_retry_after_s),
                            120.0),
                    )
            req.queue_depth_at_admit = depth
            req.seed = next(self._req_seed)
            self._admission.append(req)
            self._cv.notify_all()
        return req

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 temperature: float = 0.0,
                 timeout: Optional[float] = 60.0) -> List[int]:
        return self.generate_async(
            prompt, max_new_tokens, temperature).wait(timeout)

    # -- dispatch --------------------------------------------------------
    def _pick_replica(self, req: Optional[FrontRequest] = None
                      ) -> Optional[ServingReplica]:
        """Cache-affine pick: among live replicas with dispatch
        headroom (the cap keeps the backlog at the FRONT, where a
        replica death can't strand it), prefer the replica whose
        prefix cache holds the LONGEST prefix of the request's prompt
        — each pool caches independently, so routing a shared-prefix
        request to the holder turns its prefill into a block-table
        metadata hit instead of a recompute on a cold pool.  Ties and
        cold prompts fall back to least-outstanding."""
        best, best_hit = None, -1
        for r in self._serving():  # prefill-class never serves clients
            sched = r.scheduler  # may concurrently flip to None on death
            if r.state != "live" or sched is None:
                continue
            if r.outstanding >= sched.model.batch_slots:
                continue
            hit = 0
            if req is not None:
                # a resumed generation's cached prefix is its whole
                # replay feed (prompt + generated), not the prompt:
                # affinity routes it to the replica that adopted its
                # migrated blocks
                toks = (req.resume.replay_tokens()
                        if req.resume is not None else req.prompt)
                probe = getattr(sched, "cached_prefix_tokens", None)
                if probe is not None:
                    try:
                        hit = int(probe(toks))
                    except Exception:  # noqa: BLE001 — a probe must
                        hit = 0        # never stall dispatch
            if (best is None or hit > best_hit
                    or (hit == best_hit
                        and r.outstanding < best.outstanding)):
                best, best_hit = r, hit
        if (best is not None and best_hit > 0
                and self.registry is not None):
            self.registry.counter("serving/cache_affine_routed").inc()
        return best

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                replica = None
                while not self._closed:
                    if self._admission:
                        if self._all_permanently_dead():
                            break
                        replica = self._pick_replica(self._admission[0])
                        if replica is not None:
                            break
                    self._cv.wait(0.2)
                if self._closed:
                    return
                req = self._admission.popleft()
                if replica is None:  # every replica permanently dead
                    self._fail(req, ServiceUnavailable(
                        "all serving replicas are permanently dead "
                        "(restart budgets exhausted)",
                        retry_after_s=self.shed_retry_after_s,
                    ))
                    continue
                replica.outstanding += 1
                self._observe_depth(replica)
            try:
                replica.submit(
                    req.prompt, req.max_new_tokens, req.temperature,
                    seed=req.seed, resume=req.resume,
                    on_done=lambda h, _req=req, _r=replica:
                        self._on_settle(_req, _r, h),
                )
            except ValueError as e:
                # pool geometry can never serve it: the request's
                # problem, fail alone
                with self._cv:
                    replica.outstanding -= 1
                    self._observe_depth(replica)
                self._fail(req, e)
            except Exception:
                # the replica died between pick and submit: back to the
                # queue head (dispatch never started — no retry spent).
                # Mid-terminate the residue sweep may already have run,
                # so requeueing would strand the request until close()
                # fails it NON-retriably — settle it 503 instead, as
                # the terminate contract promises.
                shed_req = None
                with self._cv:
                    replica.outstanding -= 1
                    self._observe_depth(replica)
                    if self._terminating or self._closed:
                        shed_req = req
                    else:
                        self._admission.appendleft(req)
                if shed_req is not None:
                    self._fail(shed_req, ServiceUnavailable(
                        "serving front terminated before this request "
                        "was dispatched",
                        retry_after_s=self._retry_after(),
                    ))

    def _observe_depth(self, replica: ServingReplica) -> None:
        if self.registry is not None:
            self.registry.gauge(
                f"serving/replica/{replica.replica_id}/queue_depth"
            ).set(replica.outstanding)

    # -- settlement ------------------------------------------------------
    def _fail(self, req: FrontRequest, err: Exception) -> None:
        req.error = err
        req.event.set()

    def _complete(self, req: FrontRequest, handle,
                  role: Optional[str] = None) -> None:
        req.result = handle.result
        req.n_generated = handle.n_generated
        # a resumed generation's first token landed on an EARLIER
        # replica (stamped at the pause/death settle): keep it — TTFT
        # measures the client's wait, not the last leg's
        if req.t_first_token is None:
            req.t_first_token = handle.t_first_token
        req.t_done = handle.t_done or time.monotonic()
        req.prefix_hit_tokens = getattr(handle, "prefix_hit_tokens", 0)
        req.served_role = role
        per_tok = None
        if (role and req.t_first_token is not None
                and req.n_generated > 1):
            per_tok = ((req.t_done - req.t_first_token)
                       / (req.n_generated - 1))
        self._note_class_done(role, req.t_done, per_tok)
        with self._lat_lock:
            self._latencies.append(req.t_done - req.t_submit)
            if req.t_first_token is not None:
                self._ttfts.append(req.t_first_token - req.t_submit)
            self._done_times.append(req.t_done)  # service-rate window
            # relaxed read of the deque (no _cv inside _lat_lock —
            # lock order is _cv -> _lat_lock): a heuristic flag
            self._done_busy.append(bool(self._admission))
            # settles arrive from every replica's worker thread; the
            # += below is not atomic, so it rides the same lock
            self.requests_done += 1
        req.event.set()

    def _on_settle(self, req: FrontRequest, replica: ServingReplica,
                   handle) -> None:
        """Completion hook, fired once per replica-side handle on
        whichever thread settled it (decode loop, drain, or the
        submit-raced close path)."""
        with self._cv:
            replica.outstanding -= 1
            self._observe_depth(replica)
            self._cv.notify_all()
        err = handle.error
        if err is None:
            self._complete(req, handle, role=replica.role)
            return
        if isinstance(err, HandoffPaused):
            # NOT a failure: the replica paused this generation for
            # handoff (drain / terminate / rebalance).  Checked before
            # every other branch — a pause mid-terminate must resume,
            # not shed, or the drain drops the very generation it
            # paused to save.
            self._on_handoff_paused(req, replica, handle, err)
            return
        if isinstance(err, ValueError):
            self._fail(req, err)  # unservable as posed, retry won't help
            return
        if self._terminating:
            # force-closed past the drain deadline: the contract is
            # 503 + Retry-After, never a silent drop or a requeue into
            # a dispatcher that is going away
            self._fail(req, ServiceUnavailable(
                "serving front is terminating",
                retry_after_s=self._retry_after(1),
            ))
            return
        if self._closed:
            self._fail(req, RuntimeError("ServingFront is closed"))
            return
        # replica death, hung step, or transient step fault: the
        # request was ADMITTED, so it never gets a non-retriable error.
        # If the dying scheduler managed to stamp a resume record
        # (tokens live on the host — a dead device cannot tear them),
        # the retry REPLAYS prompt+generated instead of regenerating
        # from scratch: same output, no decode work burned twice.
        rs = getattr(handle, "resume_out", None)
        if rs is not None:
            req.resume = rs
            if req.t_first_token is None:
                req.t_first_token = handle.t_first_token
            self.handoff_replays += 1
            if self.registry is not None:
                self.registry.counter("serving/handoff_replays").inc()
        req.retries += 1
        if req.retries > self.request_retry_limit:
            self._fail(req, ServiceUnavailable(
                f"request failed {req.retries} times across replicas "
                f"(last: {type(err).__name__}: {err})",
                retry_after_s=self.shed_retry_after_s,
            ))
            return
        self.requeued_requests += 1
        if self.registry is not None:
            self.registry.counter("serving/requeued_requests").inc()
        with self._cv:
            if self._closed:
                # close() may have drained the queue between the check
                # above and here; a late requeue would park the client
                # for its full timeout with no dispatcher left
                self._fail(req, RuntimeError("ServingFront is closed"))
                return
            self._admission.appendleft(req)  # keep its seniority
            self._cv.notify_all()

    # -- mid-decode handoff (serving/handoff.py) -------------------------
    def _handoff_migrator(self):
        """The migrator live handoffs stream through, built the first
        time a pause carries a KV payload, over the front's fabric."""
        with self._cv:
            if self._handoff_mig is None and not self._closed:
                from .kv_transfer import KVMigrator

                self._handoff_mig = KVMigrator(
                    self._kv_fabric, registry=self.registry,
                    logger=self.log)
            return self._handoff_mig

    def _handoff_cost_model(self):
        """Migrate-vs-replay pricing at the hop rate of the fabric the
        handoffs cross (serving/disagg.py)."""
        if self._handoff_cm is None:
            from .disagg import MigrationCostModel

            self._handoff_cm = MigrationCostModel(
                fabric_kind=self._kv_fabric.kind)
        return self._handoff_cm

    def _pick_handoff_dest(self, source: ServingReplica,
                           toks: Sequence[int]
                           ) -> Optional[ServingReplica]:
        """Live decode-capable destination for a handoff, excluding
        the source; prefer the replica already caching the longest
        prefix of the paused sequence (fewer blocks to ship), ties to
        least outstanding.  No slot-headroom gate: the migration only
        populates the prefix cache — the resumed request queues like
        any other."""
        best, best_hit = None, -1
        for r in self._serving():
            sched = r.scheduler
            if r is source or r.state != "live" or sched is None:
                continue
            hit = 0
            probe = getattr(sched, "cached_prefix_tokens", None)
            if probe is not None:
                try:
                    hit = int(probe(toks))
                except Exception:  # noqa: BLE001 — never stall a pause
                    hit = 0
            if (best is None or hit > best_hit
                    or (hit == best_hit
                        and r.outstanding < best.outstanding)):
                best, best_hit = r, hit
        return best

    def _on_handoff_paused(self, req: FrontRequest,
                           replica: ServingReplica, handle,
                           err: HandoffPaused) -> None:
        """A replica paused this generation for handoff.  Attach the
        resume record, optionally stream the exported KV blocks to a
        live destination, and requeue at the admission head — a pause
        consumes no retry (the request did nothing wrong).  Every
        fault on the live path degrades to replay: the resume record
        alone suffices (chunked-prefill replay of prompt+generated is
        token-identical by construction)."""
        rec = err.record
        req.resume = rec
        if req.t_first_token is None:
            req.t_first_token = handle.t_first_token
        with self._cv:
            self._handoff_inflight += 1
        self.handoff_requested += 1
        if self.registry is not None:
            self.registry.counter("serving/handoff_requested").inc()
        toks = rec.replay_tokens()[:rec.written]
        payload = bool(err.arrays) and bool(err.pages)
        dest = self._pick_handoff_dest(replica, toks) if payload else None
        dsched = dest.scheduler if dest is not None else None
        mig = self._handoff_migrator() if dsched is not None else None
        decision = None
        if (dsched is not None and mig is not None
                and getattr(dsched.model, "import_block", None)
                is not None):
            src = replica.scheduler
            step_ms = dsched.step_ms_ewma or (
                src.step_ms_ewma if src is not None else 0.0)
            decision = self._handoff_cost_model().decide_handoff(
                written=rec.written, page_size=err.page_size,
                block_bytes=int(getattr(dsched.model,
                                        "kv_block_bytes", 0)),
                chunk=int(getattr(dsched.model, "prefill_chunk", 0)),
                step_s=step_ms / 1e3)
            req.migration = decision
            if decision["decision"] != "handoff":
                dsched = None
        if dsched is None or mig is None:
            if decision is not None:
                self.handoff_replay_decisions += 1
                if self.registry is not None:
                    self.registry.counter(
                        "serving/handoff_replay_decisions").inc()
            self._settle_handoff(req, False, None)
            return
        self.handoff_migrate_decisions += 1
        if self.registry is not None:
            self.registry.counter(
                "serving/handoff_migrate_decisions").inc()
        mig.migrate_live(
            tokens=toks, pages=err.pages, blocks=err.arrays,
            page_size=err.page_size, target=dsched,
            on_done=lambda ok, detail: self._settle_handoff(
                req, ok, detail))

    def _settle_handoff(self, req: FrontRequest, ok: bool,
                        detail: Optional[Dict]) -> None:
        """Exactly-once tail of every pause: count the outcome and
        requeue at the admission head with the resume record attached.
        A live-handoff fault is NOT a request failure — the resume
        admission replays whatever was not adopted, so the output
        stays exact either way."""
        rec = req.resume
        if ok and detail is not None and rec is not None:
            # the verified partial tail page rides the resume record:
            # admission lands it in the resumed sequence's fresh
            # private block (a sub-page tail has no cache key)
            rec.kv_tail = detail.get("tail")
            self.handoff_ok += 1
            if self.registry is not None:
                self.registry.counter("serving/handoff_ok").inc()
        else:
            self.handoff_replays += 1
            if self.registry is not None:
                self.registry.counter("serving/handoff_replays").inc()
            kind = (detail or {}).get("fault")
            if kind:
                self.handoff_faults[kind] = (
                    self.handoff_faults.get(kind, 0) + 1)
                if self.registry is not None:
                    self.registry.counter(
                        f"serving/handoff_fault_{kind}").inc()
        with self._cv:
            self._handoff_inflight -= 1
            if self._closed:
                self._fail(req, RuntimeError("ServingFront is closed"))
                self._cv.notify_all()
                return
            self._admission.appendleft(req)  # keeps its seniority
            self._cv.notify_all()

    def rebalance_replica(self, replica: ServingReplica,
                          max_sequences: int = 1) -> bool:
        """Hot-replica rebalance: pause up to `max_sequences` of the
        longest-remaining generations on `replica` so they resume on
        a cooler member, by the path drain and terminate use (the
        reference's autoscaler calls it on a KV-occupancy trigger)."""
        if not self.handoff:
            return False
        with self._cv:
            others = [r for r in self._serving_live()
                      if r is not replica]
        if not others:
            return False
        ok = replica.request_handoff(
            remaining_over=0, max_sequences=int(max_sequences),
            export_kv=True)
        if ok and self.registry is not None:
            self.registry.counter("serving/handoff_rebalance").inc()
        return ok

    # -- stats / health --------------------------------------------------
    @property
    def worker_alive(self) -> bool:
        return self._dispatcher.is_alive() and not self._all_permanently_dead()

    @property
    def batches_run(self) -> int:
        with self._cv:
            fleet = list(self.replicas) + list(self.retired)
            folded = self._retired_folded["batches_run"]
        return folded + sum(r.stats()["batches_run"] for r in fleet)

    @property
    def tokens_generated(self) -> int:
        with self._cv:
            fleet = list(self.replicas) + list(self.retired)
            folded = self._retired_folded["tokens_generated"]
        return folded + sum(r.stats()["tokens_generated"] for r in fleet)

    def latency_stats(self) -> Dict[str, float]:
        from .batcher import latency_percentiles

        return latency_percentiles(self._latencies, self._lat_lock)

    def ttft_stats(self) -> Dict[str, float]:
        from .batcher import latency_percentiles

        return latency_percentiles(self._ttfts, self._lat_lock)

    @property
    def roles_active(self) -> bool:
        """True once any replica carries a non-mixed role (the fleet is
        disaggregated or transitioning)."""
        return any(r.role != "mixed" for r in self.replicas)

    def class_stats(self) -> Dict[str, Dict]:
        """Per-role fleet accounting: replica counts, outstanding,
        measured class service rate, merged TTFT percentiles from each
        member scheduler's window (the prefill class's TTFT is its
        internal pass time — there is no client TTFT for it), and
        per-token decode percentiles from front-side samples."""
        from .batcher import percentile_summary

        with self._cv:
            replicas = list(self.replicas)
        by_role: Dict[str, List[ServingReplica]] = {}
        for r in replicas:
            by_role.setdefault(r.role, []).append(r)
        with self._lat_lock:
            toks = {k: list(v) for k, v in self._class_tok.items()}
        out: Dict[str, Dict] = {}
        for role, members in sorted(by_role.items()):
            ttfts: List[float] = []
            for r in members:
                sched = r.scheduler
                if sched is None:
                    continue
                with sched._lat_lock:
                    ttfts.extend(sched._ttfts)
            rate = self.service_rate(role)
            out[role] = {
                "replicas": len(members),
                "live": sum(1 for r in members if r.alive),
                "outstanding": sum(r.outstanding for r in members),
                "chips": len(members) * self.chips_per_replica,
                "service_rate_rps": (round(rate, 3)
                                     if rate is not None else None),
                "ttft": percentile_summary(ttfts),
                "per_token": percentile_summary(toks.get(role, [])),
            }
        return out

    def health(self) -> Dict:
        """ok = every fleet member live or intentionally draining;
        degraded = a replica is restarting/dead but something still
        serves; down = nothing live (server.py rides this to HTTP
        200/200/503).  A DRAINING replica is an intentional,
        scale-down exit — it finishes its in-flight work but
        takes nothing new, and does NOT degrade the front."""
        with self._cv:
            replicas = list(self.replicas)
            retired = len(self.retired) + self._retired_dropped
        live = sum(1 for r in replicas if r.alive)
        serving_live = sum(1 for r in replicas
                           if r.alive and r.role != "prefill")
        draining = sum(1 for r in replicas if r.state == "draining")
        broken = sum(1 for r in replicas
                     if r.state in ("restarting", "dead"))
        # "down" means no replica can FINISH a client request — a
        # healthy prefill class cannot keep a decode-less fleet up
        if self._closed or serving_live == 0:
            status = "down"
        elif broken:
            status = "degraded"
        else:
            status = "ok"
        out = {
            "status": status,
            "replicas_live": live,
            "replicas_draining": draining,
            "replicas_retired": retired,
            "terminating": self._terminating,
            "replicas": [
                {"id": r.replica_id, "state": r.state,
                 "role": r.role,
                 "restarts": r.restarts, "deaths": r.deaths}
                for r in replicas
            ],
        }
        if any(r.role != "mixed" for r in replicas):
            out["roles"] = {
                role: {"replicas": sum(1 for r in replicas
                                       if r.role == role),
                       "live": sum(1 for r in replicas
                                   if r.role == role and r.alive)}
                for role in sorted({r.role for r in replicas})
            }
        return out

    def stats(self) -> Dict:
        with self._cv:
            queued = len(self._admission)
            replicas = [r.stats() for r in self.replicas]
            retired = [r.stats() for r in self.retired]
            retired_n = len(self.retired) + self._retired_dropped
            folded = dict(self._retired_folded)
        if self.registry is not None:
            self.registry.gauge("serving/replicas_live").set(
                len(self._live()))
        rate = self.service_rate()
        out = {
            "mode": "replicated",
            "chips_per_replica": self.chips_per_replica,
            "chip_budget": self.chip_budget,
            "fleet_chips": len(replicas) * self.chips_per_replica,
            "replicas_live": len(self._live()),
            "replicas_draining": sum(1 for r in replicas
                                     if r["state"] == "draining"),
            "replicas_retired": retired_n,
            "queue_depth": queued + sum(r["outstanding"]
                                        for r in replicas),
            "requests_done": self.requests_done,
            "requeued_requests": self.requeued_requests,
            "shed_requests": self.shed_requests,
            "admission_shed": self.admission_shed,
            "service_rate_rps": (round(rate, 3)
                                 if rate is not None else None),
            "tokens_generated": (folded["tokens_generated"]
                                 + sum(r["tokens_generated"]
                                       for r in replicas)
                                 + sum(r["tokens_generated"]
                                       for r in retired)),
            "steps": (folded["batches_run"]
                      + sum(r["batches_run"] for r in replicas)
                      + sum(r["batches_run"] for r in retired)),
            "ttft": self.ttft_stats(),
            "latency": self.latency_stats(),
            "replicas": replicas,
        }
        if self.roles_active:
            out["roles"] = self.class_stats()
        if self.handoff or self.handoff_requested:
            out["handoff"] = {
                "requested": self.handoff_requested,
                "ok": self.handoff_ok,
                "replays": self.handoff_replays,
                "migrate_decisions": self.handoff_migrate_decisions,
                "replay_decisions": self.handoff_replay_decisions,
                "faults": dict(self.handoff_faults),
            }
            mig = self._handoff_mig
            if mig is not None:
                out["handoff"]["kv_transfer"] = mig.stats()
        return out

    # -- shutdown --------------------------------------------------------
    def terminate(self, deadline_s: float = 30.0) -> Dict:
        """SIGTERM grace, the serving-side twin of the training
        supervisor's preemption grace (resilience/supervisor.py): stop
        admitting (new submissions shed with 503 + Retry-After from the
        measured drain rate), drain every replica under `deadline_s` —
        in-flight and already-queued requests run to completion — then
        shed the residue and close.  No admitted request is ever
        silently dropped: each one either completes or settles with a
        retriable ServiceUnavailable.

        Returns a report: completed/shed counts, drained replicas,
        whether the deadline was met, and the elapsed time."""
        t0 = time.monotonic()
        with self._cv:
            if self._closed or self._terminating:
                return {"already_terminating": True}
            self._terminating = True
            done_before = self.requests_done
            self._cv.notify_all()
        if self.registry is not None:
            self.registry.counter("serving/terminations").inc()
        self.log.info("serving front terminating: draining %d replicas "
                      "under %.1fs", len(self.replicas), deadline_s)
        deadline = t0 + deadline_s
        # phase 1: the dispatcher keeps handing QUEUED requests to the
        # still-live replicas — draining them now would strand the
        # backlog, so wait for the queue to empty (or the deadline)
        with self._cv:
            while (time.monotonic() < deadline and self._admission
                   and self._live()):
                self._cv.wait(min(
                    0.05, max(0.001, deadline - time.monotonic())))
            replicas = list(self.replicas)
        # phase 2: nothing left to dispatch (or out of time) — drain
        # every replica; in-flight slots run to completion.  With
        # handoff enabled the serving class retires in two waves:
        # every member but one survivor drains first, pausing the
        # generations it cannot FINISH before the deadline (remaining
        # tokens vs the measured step rate) onto the handoff path;
        # the survivor serves the resumed requests and drains last —
        # so a long generation is migrated, never shed at the bell.
        survivor = None
        if self.handoff:
            cands = [r for r in replicas
                     if r.alive and r.role != "prefill"]
            if len(cands) > 1:
                # the busiest member keeps its own work: it migrates
                # nothing, everyone else's unfinishables land on it
                survivor = max(cands, key=lambda r: r.outstanding)
        for r in replicas:
            if r is survivor:
                continue
            r.drain(on_retired=self._on_replica_retired)
            if survivor is not None and r.role != "prefill":
                self._terminate_handoff(r, deadline)
        if survivor is not None:
            with self._cv:
                while time.monotonic() < deadline:
                    others_open = any(
                        r.state in ("live", "draining", "restarting")
                        for r in self.replicas if r is not survivor)
                    if (not others_open and not self._admission
                            and self._handoff_inflight == 0):
                        break
                    self._cv.wait(min(0.05, max(
                        0.001, deadline - time.monotonic())))
            survivor.drain(on_retired=self._on_replica_retired)
        while time.monotonic() < deadline:
            with self._cv:
                # a replica mid-rebuild at the snapshot above refused
                # its drain() and comes back "live" after — catch it
                late_live = [r for r in self.replicas
                             if r.state == "live"]
            for r in late_live:  # outside the lock: drain fans into
                r.drain(on_retired=self._on_replica_retired)  # the sched
            with self._cv:
                settled = all(
                    r.state in ("retired", "dead", "closed")
                    for r in self.replicas)
                if not self._admission and settled:
                    break
                self._cv.wait(min(
                    0.05, max(0.001, deadline - time.monotonic())))
        with self._cv:
            residue = list(self._admission)
            self._admission.clear()
        # residue past the deadline: 503 + Retry-After from the
        # measured drain rate — the client knows when to come back
        shed = 0
        for req in residue:
            self._fail(req, ServiceUnavailable(
                "serving front terminated before this request was "
                "dispatched",
                retry_after_s=self._retry_after(len(residue)),
            ))
            shed += 1
        deadline_met = not residue and time.monotonic() <= deadline
        # bounded close sweeps up wedged DRAINING replicas; their
        # in-flight requests settle as 503s through _on_settle's
        # terminating branch
        self.close(timeout_s=max(0.1, deadline - time.monotonic()))
        report = {
            "duration_s": round(time.monotonic() - t0, 3),
            "deadline_s": deadline_s,
            "deadline_met": deadline_met,
            "completed_during_drain": self.requests_done - done_before,
            "shed": shed,
            "replicas_retired": len(self.retired) + self._retired_dropped,
        }
        self.log.info("serving front terminated: %s", report)
        return report

    def _terminate_handoff(self, replica: ServingReplica,
                           deadline: float) -> None:
        """Pause the sequences a draining replica cannot finish before
        the terminate deadline: a sequence whose remaining tokens
        exceed time-left / measured-step-EWMA would otherwise still be
        decoding when the residue sweep sheds it.  Finishable
        sequences keep decoding to completion (cheaper than any
        migration); the unfinishable ones take the handoff path and
        resume on the surviving replica."""
        sched = replica.scheduler
        step_ms = (getattr(sched, "step_ms_ewma", 0.0)
                   if sched is not None else 0.0) or 5.0
        time_left = max(0.0, deadline - time.monotonic())
        budget = max(1, int(time_left / (step_ms / 1e3)))
        replica.request_handoff(remaining_over=budget, export_kv=True)

    def install_grace_handlers(self, deadline_s: float = 30.0) -> Dict:
        """SIGTERM/SIGINT -> graceful terminate() on a daemon thread
        (the supervisor's preemption-grace pattern on the serving
        side).  Main-thread only; returns the displaced handlers so an
        embedding process can restore them."""
        if threading.current_thread() is not threading.main_thread():
            return {}
        installed = {}

        def _on_signal(signum, frame):
            self.log.info(
                "%s received: graceful serving drain under %.1fs",
                signal.Signals(signum).name, deadline_s)
            threading.Thread(
                target=self.terminate, args=(deadline_s,),
                daemon=True, name="serving-front-terminate",
            ).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                installed[sig] = signal.signal(sig, _on_signal)
            except (ValueError, OSError):  # exotic embeddings
                break
        return installed

    def close(self, timeout_s: Optional[float] = None):
        """Stop dispatching, close every replica, and fail whatever is
        still queued, promptly.  An explicit `timeout_s` is a TOTAL
        budget shared by the whole fleet (terminate()'s deadline
        contract — N wedged replicas must not each get the full
        bound); None lets each replica use its own close_timeout_s."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._dispatcher.join(timeout=2.0)
        with self._cv:
            # retired replicas released their threads at _retire();
            # sweeping them too makes close() the backstop either way
            replicas = list(self.replicas) + list(self.retired)
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        for r in replicas:
            r.close(None if deadline is None
                    else max(0.05, deadline - time.monotonic()))
        # the lazy handoff migrator: its close fails every pending
        # on_done, which settles the requests below
        mig = self._handoff_mig
        if mig is not None:
            self._handoff_mig = None
            mig.close()
        err = RuntimeError("ServingFront is closed")
        with self._cv:
            while self._admission:
                self._fail(self._admission.popleft(), err)
