"""Supervised serving replica (flexflow_tpu/serving/replica.py): one
ContinuousScheduler under the port's resilience primitives
(resilience/).

A replica sorts failures as the training supervisor does, adapted to a
decode engine that keeps no state worth restoring:

  * **transient step exception**: the scheduler's own handling stands:
    only the in-flight batch fails (the front requeues it, resuming from
    each row's resume record) and the replica keeps serving;
  * **hung decode step**: every dispatch runs under a
    `StepWatchdog(step_timeout)`, whose deadline covers the step's read
    of its logits from the card; a read that does not return raises
    `HungStepTimeout` instead of wedging the worker.  An injected
    HUNG_STEP on a card with the watchdog armed is a real stall: the
    engine's stream is held busy (`resilience.faults.stall_device`)
    ahead of the step, so the watchdog fires as on a wedged device while
    the other replicas, on streams of their own, go on; elsewhere it
    raises its twin `HungStepFault`.  The abandoned dispatch runs to its
    end once the stall ends; `hung_dispatches` counts them by kind;
  * **device loss**: `DeviceLossFault(survivors=k)` ends the engine and
    the factory rebuilds it on the surviving count;
  * **a kernel that does not launch** (`KernelLaunchError`: its library
    did not build, or the launch returned a CUDA error): the engine is
    dead, as on a lost device; nothing falls back to a plain version.

These are marked ``fatal_to_engine = True``, the scheduler's contract
for "drain everything and die", which fires the replica's `on_death`.
The replica's supervisor thread then rebuilds the engine under a
jittered-backoff `RetryPolicy` with a restart budget; a replica past
its budget is permanently ``dead`` and `/v2/health` says so.

Fault injection is the seeded `FaultPlan`: its step index counts the
replica's dispatches (decode, prefill, verify and copy-on-write, across
restarts), so a replica-kill run replays exactly.  Every replica is
built on the trained model's device (placing replicas across cards is
§1 item 8.3 of the roadmap).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, Optional

from ..logger import resilience_logger
from ..ops.kernels._build import KernelLaunchError
from ..resilience.faults import (DeviceLossFault, FaultKind, FaultPlan,
                                 HungStepFault)
from ..resilience.retry import RetryPolicy
from ..resilience.watchdog import HungStepTimeout, StepWatchdog
from .scheduler import ContinuousScheduler

#: failures that end the ENGINE, not just the in-flight batch: the
#: supervisor answers them with a restart
FATAL_DECODE_FAULTS = (DeviceLossFault, HungStepFault, HungStepTimeout,
                       KernelLaunchError)

#: per-replica scheduler counters folded into `stats()` across restarts
_CARRIED_COUNTERS = ("batches_run", "requests_done", "tokens_generated",
                     "step_failures", "prefill_steps", "spec_rounds")

#: an injected hung step holds the card this many watchdog deadlines, so
#: the watchdog fires well inside the stall
HANG_DEADLINES = 3


class SupervisedDecodeModel:
    """Decode-model wrapper adding the resilience instrumentation to
    every dispatch: seeded fault injection, then the watchdog-bounded
    call.  Proxies the geometry the scheduler reads (batch_slots,
    page_size, num_blocks, ...) and each optional surface as the
    wrapped model has it."""

    def __init__(self, model, watchdog: StepWatchdog,
                 fault_plan: FaultPlan, step_counter,
                 hung: Optional[Dict[str, int]] = None):
        self._model = model
        self._watchdog = watchdog
        self._fault_plan = fault_plan
        self._steps = step_counter  # replica-lifetime, restart-spanning
        # dispatches the watchdog abandoned, by kind (replica-lifetime)
        self.hung = hung if hung is not None else {}
        for name in ("batch_slots", "page_size", "num_blocks",
                     "max_blocks_per_seq", "max_seq", "vocab"):
            setattr(self, name, getattr(model, name))
        # prefix-cache / chunked-prefill surface (absent on bare test
        # fakes: the scheduler then runs without it)
        self.prefill_chunk = getattr(model, "prefill_chunk", 0)
        self.prefix_cache = getattr(model, "prefix_cache", True)
        # which read formulation runs and the per-block byte unit of the
        # scheduler's kernel-read counters
        self.paged_kernel = getattr(model, "paged_kernel", "plain")
        self.kv_block_bytes = getattr(model, "kv_block_bytes", 0)
        # speculative surface: mode, k and verify geometry proxied; the
        # draft engine goes through raw (its dispatches belong to the
        # proposer, which isolates their faults)
        self.spec_decode = getattr(model, "spec_decode", "off")
        self.spec_k = getattr(model, "spec_k", 0)
        self.verify_chunk = getattr(model, "verify_chunk", 0)
        self.draft_model = getattr(model, "draft_model", None)
        if getattr(model, "prefill_step", None) is None:
            self.prefill_chunk = 0
        self._has_verify = (self.spec_decode != "off" and getattr(
            model, "verify_step", None) is not None)
        if not self._has_verify:
            self.spec_decode = "off"
        self._has_copy = getattr(model, "copy_block", None) is not None
        self._has_export = (
            getattr(model, "export_block", None) is not None
            and getattr(model, "import_block", None) is not None)

    def reset(self):
        reset = getattr(self._model, "reset", None)
        if reset is not None:
            reset()

    def _dispatch(self, kind: str, fn):
        """One supervised dispatch: the fault plan's entry for this
        step, then `fn` under the watchdog; a fault that ends the engine
        is marked fatal_to_engine."""
        idx = next(self._steps)
        try:
            self._inject_hang(idx)
            self._fault_plan.check_step(idx)
            try:
                return self._watchdog.sync(fn, step=idx)
            except HungStepTimeout:
                self.hung[kind] = self.hung.get(kind, 0) + 1
                raise
        except FATAL_DECODE_FAULTS as e:
            e.fatal_to_engine = True
            raise

    def _inject_hang(self, idx: int) -> None:
        """A HUNG_STEP planned for this step, on a card with the watchdog
        armed: hold the engine's stream busy ahead of the step, so that
        the step's read of its logits outlives the watchdog's deadline
        as behind a wedged device (check_step raises HungStepFault for
        one on the host or with the watchdog off)."""
        stream = getattr(self._model, "stream", None)
        if stream is None or not self._watchdog.enabled:
            return
        if not any(not f.fired and f.step == idx
                   and f.kind == FaultKind.HUNG_STEP
                   for f in self._fault_plan.faults):
            return
        import torch

        with torch.cuda.stream(stream):
            self._fault_plan.hang_device(
                idx, stream.device,
                HANG_DEADLINES * self._watchdog.timeout_s)

    def step(self, tokens, seq_lens, block_tables):
        return self._dispatch(
            "step",
            lambda: self._model.step(tokens, seq_lens, block_tables))

    def prefill_step(self, tokens, positions, block_tables):
        # chunked prefill is a dispatch like any step: fault injection
        # and the watchdog see it under the same step index
        return self._dispatch(
            "prefill",
            lambda: self._model.prefill_step(tokens, positions,
                                             block_tables))

    @property
    def verify_step(self):
        # a capability probe (None without the surface); a hung or
        # lost-device verify is fatal, a transient one degrades the
        # engine to plain decode (the scheduler's rule)
        if not self._has_verify:
            return None

        def _verify(tokens, seq_lens, counts, block_tables):
            return self._dispatch(
                "verify",
                lambda: self._model.verify_step(tokens, seq_lens, counts,
                                                block_tables))

        return _verify

    @property
    def copy_block(self):
        # the copy-on-write is a device dispatch too: a wedged copy must
        # surface as HungStepTimeout, not park the worker
        if not self._has_copy:
            return None

        def _copy(src, dst):
            return self._dispatch(
                "copy", lambda: self._model.copy_block(src, dst))

        return _copy

    @property
    def export_block(self):
        # the migration surface: host <-> device copies on the worker
        # thread between steps, not watchdogged dispatches (a wedged
        # read surfaces at the next stepped dispatch)
        if not self._has_export:
            return None
        return self._model.export_block

    @property
    def import_block(self):
        if not self._has_export:
            return None
        return self._model.import_block


class ServingReplica:
    """One supervised engine slot of a ServingFront.

    `model_factory(replica_id, survivors=None)` builds the decode model
    (a PagedKVDecodeModel for a real GPT, anything with the same step
    contract in the tests); `survivors` is the device count a
    DeviceLossFault left standing.

    States: ``live`` (serving), ``restarting`` (death seen, rebuild
    pending), ``draining`` (no new dispatches, in-flight slots run to
    completion), ``retired`` (drain finished: engine and KV pool
    released, out of the fleet for good), ``dead`` (restart budget
    spent: permanent), ``closed``.  `on_state_change` (set by the
    front) fires on every transition, so the dispatcher never polls.
    """

    def __init__(
        self,
        replica_id: int,
        model_factory: Callable,
        *,
        eos_id: int = -1,
        registry=None,
        seed: int = 0,
        step_timeout: float = 0.0,
        retry: Optional[RetryPolicy] = None,
        fault_plan: Optional[FaultPlan] = None,
        close_timeout_s: float = 5.0,
        sleep: Callable[[float], None] = time.sleep,
        logger=resilience_logger,
        role: str = "mixed",
        check_invariants: bool = False,
    ):
        self.replica_id = int(replica_id)
        self.model_factory = model_factory
        # the replica's class in a fleet: the colocated fleet's replicas
        # are all "mixed"; "prefill" and "decode" are the disaggregated
        # fleet's (§1 item 8.4 of the roadmap)
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"replica role {role!r}: pick from "
                "['prefill', 'decode', 'mixed']")
        self.role = role
        self._check_invariants = bool(check_invariants)
        self.eos_id = int(eos_id)
        self.registry = registry
        self.seed = int(seed)
        self.retry = retry or RetryPolicy()
        self.fault_plan = fault_plan or FaultPlan()
        self.watchdog = StepWatchdog(step_timeout)
        self.close_timeout_s = float(close_timeout_s)
        self.sleep = sleep
        self.log = logger
        self.on_state_change: Optional[Callable] = None
        # dispatch bookkeeping owned by the front (under ITS lock)
        self.outstanding = 0
        self.state = "restarting"  # -> live after the first build
        self.restarts = 0       # successful rebuilds
        self.deaths = 0         # fatal engine exits seen
        self.last_death_t: Optional[float] = None
        self.last_live_t: Optional[float] = None
        self.last_recovery_s: Optional[float] = None
        self.last_error: Optional[Exception] = None
        self.scheduler: Optional[ContinuousScheduler] = None
        self._steps = itertools.count()  # dispatch index, all lives
        self.hung_dispatches: Dict[str, int] = {}  # by kind, all lives
        self._carried: Dict[str, int] = {k: 0 for k in _CARRIED_COUNTERS}
        self._survivors: Optional[int] = None
        self._death_evt = threading.Event()
        self._closed = False
        self._draining = False
        self._retire_guard = threading.Lock()
        self._retire_done = False
        self._on_retired: Optional[Callable] = None
        self.drain_started_t: Optional[float] = None
        self.retired_t: Optional[float] = None
        self._build()
        self._set_state("live")
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True,
            name=f"serving-replica-{replica_id}",
        )
        self._supervisor.start()

    # -- state ----------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self.state == "live" and self.scheduler is not None

    def _set_state(self, state: str) -> None:
        if self._closed and state != "closed":
            return  # a rebuild that raced close() must not resurrect us
        if self.state == "retired" and state not in ("closed",):
            return  # retirement is permanent
        self.state = state
        if state == "live":
            self.last_live_t = time.monotonic()
            if self.last_death_t is not None:
                self.last_recovery_s = self.last_live_t - self.last_death_t
        hook = self.on_state_change
        if hook is not None:
            try:
                hook(self)
            except Exception:  # noqa: BLE001 - never kill the supervisor
                pass

    def _count(self, name: str) -> None:
        if self.registry is not None:
            self.registry.counter(f"serving/{name}").inc()

    # -- engine lifecycle ------------------------------------------------
    def _build(self) -> None:
        model = self.model_factory(self.replica_id,
                                   survivors=self._survivors)
        wrapped = SupervisedDecodeModel(model, self.watchdog,
                                        self.fault_plan, self._steps,
                                        self.hung_dispatches)
        self.scheduler = ContinuousScheduler(
            wrapped,
            eos_id=self.eos_id,
            registry=self.registry,
            seed=self.seed + 7919 * self.replica_id,
            close_timeout_s=self.close_timeout_s,
            on_death=self._on_death,
            check_invariants=self._check_invariants,
        )

    def _on_death(self, exc: Exception) -> None:
        """Runs on the dying scheduler's worker: record why, flip the
        state so that the dispatcher stops routing here, and wake the
        supervisor thread for the rebuild."""
        self.last_error = exc
        self.last_death_t = time.monotonic()
        if isinstance(exc, DeviceLossFault):
            self._survivors = exc.survivors
        self.deaths += 1
        self._count("replica_deaths")
        self.log.info("serving replica %d died: %s", self.replica_id, exc)
        if not self._draining:
            # a draining replica was leaving anyway: it stays draining
            # and the supervisor retires it instead of rebuilding
            self._set_state("restarting")
        self._death_evt.set()

    def _fold_carried(self) -> None:
        sched = self.scheduler
        if sched is None:
            return
        for k in _CARRIED_COUNTERS:
            self._carried[k] += int(getattr(sched, k, 0))

    def _supervise(self) -> None:
        """Restart loop: each death costs one unit of the retry budget;
        past it the replica is permanently dead."""
        while True:
            self._death_evt.wait()
            self._death_evt.clear()
            if self._closed:
                return
            if self._draining:
                # death while leaving the fleet: the front already
                # requeued the stranded requests, so retire
                self._retire()
                return
            self._fold_carried()
            self.scheduler = None
            attempt = self.deaths
            if not self.retry.admits(attempt):
                self._set_state("dead")
                self.log.info(
                    "serving replica %d: restart budget (%d) exhausted — "
                    "permanently dead", self.replica_id,
                    self.retry.max_restarts)
                continue  # parked until close()
            self.sleep(self.retry.backoff(attempt))
            if self._closed:
                return
            try:
                self._build()
            except Exception as e:  # noqa: BLE001 - a failed rebuild is
                # another death: budget-capped, never an escaped crash
                self.last_error = e
                self.deaths += 1
                self._count("replica_deaths")
                self.log.info("serving replica %d rebuild failed: %s",
                              self.replica_id, e)
                self._death_evt.set()
                continue
            if self._closed:
                # close() raced the rebuild: the fresh engine must not
                # leak a worker or flip us back to live
                sched = self.scheduler
                self.scheduler = None
                if sched is not None:
                    sched.close(self.close_timeout_s)
                return
            self.restarts += 1
            self._count("replica_restarts")
            if self._survivors is not None:
                self.log.info(
                    "serving replica %d restarted on %d surviving devices "
                    "(restart %d)", self.replica_id, self._survivors,
                    self.restarts)
            else:
                self.log.info("serving replica %d restarted (restart %d)",
                              self.replica_id, self.restarts)
            self._set_state("live")

    # -- drain lifecycle -------------------------------------------------
    def drain(self, on_retired: Optional[Callable] = None) -> bool:
        """live -> draining: stop taking new work, let in-flight slots
        run to completion, then retire and release the engine and its KV
        pool.  Returns False when the replica is not live.
        `on_retired(replica)` fires once when the drain completes, also
        when a fault ends the draining engine."""
        sched = self.scheduler
        if self.state != "live" or sched is None or self._closed:
            return False
        self._draining = True
        self._on_retired = on_retired
        self.drain_started_t = time.monotonic()
        self._count("replica_drains")
        self.log.info("serving replica %d draining", self.replica_id)
        self._set_state("draining")  # the dispatcher stops routing here
        sched.drain(on_drained=self._retire)
        return True

    def _retire(self) -> None:
        """draining -> retired: release the engine (its KV pool goes with
        it) and notify the front.  A clean drain, a death while draining
        and a force_retire may all arrive, from different threads;
        exactly one runs the body."""
        with self._retire_guard:
            if self._retire_done or self.state == "retired":
                return
            self._retire_done = True
        self._fold_carried()
        self.scheduler = None  # drops the pool: KV blocks are freed
        self.retired_t = time.monotonic()
        if self.drain_started_t is not None and self.registry is not None:
            self.registry.histogram("serving/drain_ms").observe(
                (self.retired_t - self.drain_started_t) * 1e3)
        self._count("replica_retired")
        self.log.info("serving replica %d retired", self.replica_id)
        self._set_state("retired")
        hook = self._on_retired
        self._on_retired = None
        if hook is not None:
            try:
                hook(self)
            except Exception:  # noqa: BLE001 - never kill the thread
                pass           # retiring us
        # retirement ends the replica: release the parked supervisor too
        self._closed = True
        self._death_evt.set()

    def force_retire(self, timeout_s: Optional[float] = None) -> None:
        """Bounded end of a wedged drain: close the engine (in-flight
        requests fail and the front requeues them), then retire."""
        sched = self.scheduler
        if sched is not None:
            sched.close(timeout_s if timeout_s is not None
                        else self.close_timeout_s)
        self._retire()

    # -- front-facing ----------------------------------------------------
    def submit(self, prompt, max_new_tokens, temperature, on_done,
               seed=None, resume=None):
        sched = self.scheduler
        if self.state != "live" or sched is None:
            raise RuntimeError(
                f"serving replica {self.replica_id} is {self.state}")
        return sched.generate_async(prompt, max_new_tokens, temperature,
                                    on_done=on_done, seed=seed,
                                    resume=resume)

    def request_handoff(self, **kw) -> bool:
        """Ask the scheduler to pause in-flight generations for handoff
        (ContinuousScheduler.request_handoff).  Unlike submit this works
        while draining, its main caller.  False when there is no engine
        to ask."""
        sched = self.scheduler
        if sched is None or self.state in ("retired", "closed"):
            return False
        try:
            sched.request_handoff(**kw)
            return True
        except Exception:  # noqa: BLE001 - racing a death or a close
            return False

    def stats(self) -> Dict:
        sched = self.scheduler
        out = {
            "id": self.replica_id,
            "state": self.state,
            "role": self.role,
            "restarts": self.restarts,
            "deaths": self.deaths,
            "outstanding": self.outstanding,
            "last_recovery_s": self.last_recovery_s,
            "hung_dispatches": dict(self.hung_dispatches),
        }
        for k in _CARRIED_COUNTERS:
            out[k] = self._carried[k] + int(getattr(sched, k, 0) or 0)
        if sched is not None:
            sstats = sched.stats()
            out["queue_depth"] = sstats["queue_depth"]
            out["prefix_cache"] = sstats["prefix_cache"]
            out["paged_kernel"] = sstats["paged_kernel"]
        return out

    def close(self, timeout_s: Optional[float] = None) -> None:
        self._closed = True
        self._death_evt.set()  # unpark the supervisor so it exits
        bound = timeout_s if timeout_s is not None else self.close_timeout_s
        sched = self.scheduler
        if sched is not None:
            sched.close(bound)
        self._supervisor.join(timeout=2.0)
        # a rebuild may have landed between the close above and the
        # supervisor seeing _closed
        sched = self.scheduler
        self.scheduler = None
        if sched is not None:
            sched.close(bound)
        self._set_state("closed")
