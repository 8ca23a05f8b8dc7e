"""The training supervisor (flexflow_tpu/resilience/supervisor.py): a
failure happened, recover and keep training.

`TrainingSupervisor.run` trains a compiled FFModel step by step with:

  * periodic checkpoints every `checkpoint_every` steps, and an anchor at
    step 0 so that the first failure has a restore target, written
    synchronously or (checkpoint_async) by the background writer, and
    mirrored to the remote tier when FFConfig.remote_store names one
    (offload.py);
  * restore-and-retry under a jittered-backoff RetryPolicy with a hard
    restart budget on a transient failure (an injected step exception or
    preemption, or a non-finite loss under nan_policy "restore");
    nan_policy "skip_step" rolls the step back instead and moves past
    the batch, "raise" propagates;
  * the hung-step watchdog: the per-step loss read runs under
    `step_timeout`; a timeout (or an injected HungStepFault) is handled
    as a fault of the whole current group: re-search, recompile (a fresh
    step, captured again on a card) and restore;
  * on a device loss (DeviceLossFault(survivors=k)) on a group of ranks,
    ranks k and up leave `run` with a report that says so, and the k
    survivors form a new group (distributed.reform_group, through a file
    store named by the restart epoch they agree on, topology/
    rendezvous.py epoch_rendezvous, when a remote tier exists),
    re-search for k devices (through the strategy store,
    FFModel.search_strategy, or data parallel), recompile and restore
    the newest checkpoint resharded onto the new group;
  * on SIGTERM/SIGINT, the in-flight step finishes, the ranks agree on
    one step (distributed.preemption_barrier over the remote tier's
    store), and an emergency checkpoint is written, mirrored and drained
    before `run` returns a restorable report (`run(..., resume=True)`
    continues from it, from the remote tier when the directory is gone).

Where the reference loses virtual devices inside one process, a device
of the port is a rank: the port's compile wants a strategy that spans
exactly the group, so the survivors re-form the group itself.  On a
group, the grace signal is agreed on at every step boundary with one
small all-reduce (whether every rank has been signalled, and whether any
has waited barrier_timeout since its signal), so that the ranks, which
step together, stop at the same boundary; each posts the boundary at
which it saw its own signal to the blob-store barrier, which agrees on
the largest.

The loop is step-indexed and deterministic: batch i is rows [i*bs,
(i+1)*bs) of the data (modulo its batches), unshuffled, and the
generator is in every checkpoint, so a crashed and restored run reaches
the same state, bit for bit, as an uninterrupted run of as many steps.
Rollbacks and restores write into the live tensors (`copy_`), which a
captured step replays on.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import distributed
from ..checkpoint import CheckpointVerifyError
from ..executor import NonFiniteLossError, check_step_health
from ..logger import resilience_logger
from ..obs.metrics import emit_counters, registry_of
from ..obs.trace import tracer_of
from .faults import (CheckpointWriteFault, DeviceLossFault, FaultKind,
                     FaultPlan, HungStepFault, PreemptionFault, StepFault,
                     stall_device)
from .retry import RetryPolicy
from .watchdog import HungStepTimeout, StepWatchdog

# failures the supervisor treats as restore-and-retry transients
TRANSIENT_FAULTS = (StepFault, PreemptionFault)
# failures of the whole group that a recompile resets
HUNG_FAULTS = (HungStepFault, HungStepTimeout)
# signals taken as a preemption notice
GRACE_SIGNALS = (signal.SIGTERM, signal.SIGINT)
# on a card an injected hung step stalls the stream this many watchdog
# deadlines (FaultPlan.hang_device), so that the watchdog fires for real
HANG_DEADLINES = 2


class RestartBudgetExhausted(RuntimeError):
    """Failures outran RetryPolicy.max_restarts."""


@dataclasses.dataclass
class SupervisorReport:
    """What a supervised run did: the step it reached, the loss of each
    step it kept, and the counters (also logged through
    resilience_logger.counters and folded into the run's metrics).
    `preempted` names the signal when the run stopped on an emergency
    checkpoint (resume with `run(..., resume=True)`); `left_group` is set
    on a rank that a device loss took out of the group.  `recoveries`
    holds one record per recovery: its kind, the failed and the restored
    step, and its seconds (`reform_s` for the new group, `restore_s`,
    `total_s`); `agreed_step` is the preemption barrier's agreement."""

    final_step: int
    losses: List[float]
    counters: Dict[str, float]
    preempted: Optional[str] = None
    left_group: bool = False
    recoveries: List[Dict] = dataclasses.field(default_factory=list)
    agreed_step: Optional[int] = None


class _LeftGroup(Exception):
    """This rank is not among a device loss's survivors."""


class TrainingSupervisor:
    """A compiled FFModel's training loop with checkpoints, restore and
    retry, the preemption grace, the hung-step watchdog and the elastic
    re-formed group (see the module's note).

    The knobs default to the model's FFConfig (checkpoint_every,
    checkpoint_keep, checkpoint_async, step_timeout, preempt_grace,
    max_restarts, retry_backoff, nan_policy, remote_store,
    offload_every, remote_keep, barrier_timeout); the keyword arguments
    override them.  `sleep` is injectable (tests skip the backoffs);
    `search_fn(ff, n)` replaces the re-search; `offloader` or
    `blob_store` replace the remote tier FFConfig.remote_store names.
    `backend` "local" keeps the leaves in npz files, "dcp" in
    torch.distributed.checkpoint's (the reference's "orbax").  Every rank
    of a group runs its own supervisor over the same directory, with the
    same fault plan."""

    def __init__(self, ff, directory: str, *,
                 checkpoint_every: Optional[int] = None,
                 keep: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 nan_policy: Optional[str] = None,
                 search_fn: Optional[Callable] = None,
                 backend: str = "local",
                 async_save: Optional[bool] = None,
                 step_timeout: Optional[float] = None,
                 preempt_grace: Optional[bool] = None,
                 offloader=None, blob_store=None,
                 run_id: Optional[str] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 logger=resilience_logger):
        from ..config import NAN_POLICIES

        cfg = ff.config
        self.ff = ff
        self.checkpoint_every = (cfg.checkpoint_every if checkpoint_every
                                 is None else checkpoint_every)
        self.retry = retry or RetryPolicy(max_restarts=cfg.max_restarts,
                                          base_backoff=cfg.retry_backoff,
                                          seed=cfg.seed)
        self.fault_plan = fault_plan or FaultPlan()
        self.nan_policy = cfg.nan_policy if nan_policy is None else nan_policy
        if self.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy must be one of {NAN_POLICIES}, got "
                             f"{self.nan_policy!r}")
        self.search_fn = search_fn
        self.sleep = sleep
        self.log = logger
        self.async_save = (cfg.checkpoint_async if async_save is None
                           else bool(async_save))
        self.watchdog = StepWatchdog(cfg.step_timeout if step_timeout is None
                                     else step_timeout)
        self.preempt_grace = (cfg.preempt_grace if preempt_grace is None
                              else bool(preempt_grace))
        self._preempt: Optional[str] = None
        self.offloader = offloader
        if self.offloader is None:
            from .offload import offloader_from_config

            self.offloader = offloader_from_config(
                cfg, blob=blob_store, fault_plan=self.fault_plan,
                registry=registry_of(ff), sleep=sleep)
        # names the run's rendezvous in the blob store and its groups'
        # store files: every rank of one run must agree on it
        self._run_id_defaulted = run_id is None
        self.run_id = run_id or os.path.basename(
            os.path.abspath(directory)) or "run"
        self.barrier_timeout = float(cfg.barrier_timeout)
        keep = cfg.checkpoint_keep if keep is None else keep
        from ..checkpoint import CheckpointManager, LocalCheckpointManager

        managers = {"local": LocalCheckpointManager, "dcp": CheckpointManager}
        if backend not in managers:
            raise ValueError(f"unknown checkpoint backend {backend!r} "
                             f"(one of {sorted(managers)})")
        self.manager = managers[backend](directory, max_to_keep=keep,
                                         offloader=self.offloader)
        self.counters: Dict[str, float] = {
            "steps_run": 0,        # train_step calls, replays included
            "restarts": 0,         # restores after a failure
            "retries": 0,          # transient-failure retry attempts
            "lost_steps": 0,       # steps of progress replayed after restores
            "skipped_steps": 0,    # batches dropped under nan_policy=skip_step
            "checkpoints": 0,
            "checkpoint_failures": 0,
            "checkpoint_time_s": 0.0,
            "checkpoint_time_last_s": 0.0,
            "device_losses": 0,
            "hung_steps": 0,       # watchdog timeouts and injected hangs
            "emergency_saves": 0,  # preemption-grace checkpoints
            "re_searches": 0,
            "re_search_store_hits": 0,  # re-searches the store answered
        }
        self.recoveries: List[Dict] = []
        self._epoch = 0  # re-formed groups so far

    # -- deterministic batching -----------------------------------------
    def _x_map(self, x) -> Dict[str, np.ndarray]:
        input_ops = self.ff.layers.source_ops()
        if isinstance(x, dict):
            return dict(x)
        if isinstance(x, (list, tuple)):
            return {op.name: arr for op, arr in zip(input_ops, x)}
        return {input_ops[0].name: x}

    @staticmethod
    def _batch(x_map, y, step: int, batch_size: int, num_batches: int):
        i = step % num_batches
        sl = slice(i * batch_size, (i + 1) * batch_size)
        return {k: v[sl] for k, v in x_map.items()}, y[sl]

    # -- checkpoint / restore -------------------------------------------
    def _save_checkpoint(self, step: int, wait: Optional[bool] = None) -> None:
        self.fault_plan.check_checkpoint(step)
        if wait is None:
            wait = not self.async_save
        t0 = time.perf_counter()
        self.manager.save(self.ff, step, wait=wait)
        # async: the step boundary's stall (the copy to the host), not
        # the write, which overlaps the next steps
        dt = time.perf_counter() - t0
        self.counters["checkpoints"] += 1
        self.counters["checkpoint_time_s"] += dt
        self.counters["checkpoint_time_last_s"] = dt

    def _save_checkpoint_survivable(self, step: int,
                                    wait: Optional[bool] = None) -> None:
        """A failed periodic save (injected, or a full disk, or a
        verification miss) costs that save, never the run."""
        try:
            self._save_checkpoint(step, wait=wait)
        except (CheckpointWriteFault, CheckpointVerifyError, OSError) as e:
            self.counters["checkpoint_failures"] += 1
            self.log.info("checkpoint save failed at step %d: %s", step, e)

    def _drain_writer(self) -> None:
        """Wait for the queued async saves; their failures count here,
        where they surface."""
        for failed_step, err in self.manager.drain():
            self.counters["checkpoint_failures"] += 1
            self.log.info("async checkpoint save failed at step %d: %s",
                          failed_step, err)

    def _drain_offloader(self) -> None:
        """Wait for the queued mirrors.  Their failures are in the
        offloader's counters already; what comes back here is a crash of
        its thread."""
        if self.offloader is None:
            return
        for failed_step, err in self.offloader.drain():
            self.counters["checkpoint_failures"] += 1
            self.log.info("offload uploader crashed at step %d: %s",
                          failed_step, err)

    def _restore_latest(self, step: int, record: Dict) -> int:
        # a queued async save may be the newest state: let it land first
        self._drain_writer()
        t0 = time.perf_counter()
        with tracer_of(self.ff).span("restart", cat="resilience",
                                     failed_step=step):
            restored = int(self.manager.restore(self.ff))
        record["restore_s"] = time.perf_counter() - t0
        record["restored_step"] = restored
        self.counters["restarts"] += 1
        self.counters["lost_steps"] += max(0, step - restored)
        self.log.info("restored step %d after failure at step %d", restored,
                      step)
        return restored

    # -- recovery paths --------------------------------------------------
    def _retry_transient(self, err, step: int, restarts: int,
                         record: Dict) -> int:
        self.counters["retries"] += 1
        if not self.retry.admits(restarts):
            raise RestartBudgetExhausted(
                f"restart budget ({self.retry.max_restarts}) exhausted at "
                f"step {step}: {err}") from err
        self.sleep(self.retry.backoff(restarts))
        return self._restore_latest(step, record)

    def _search_strategy(self, num_devices: int):
        if self.search_fn is not None:
            return self.search_fn(self.ff, num_devices)
        cfg = self.ff.config
        if cfg.search_budget > 0 and not cfg.only_data_parallel:
            # the strategy store may hold this group size's plan already
            # (an earlier loss to as many survivors): cached_search
            # restores it, and publishes on a miss
            strategy = self.ff.search_strategy(num_devices)
            if (getattr(strategy, "search_stats", None) or {}).get(
                    "store_hit"):
                self.counters["re_search_store_hits"] += 1
            return strategy
        from ..strategy import data_parallel_strategy

        return data_parallel_strategy(num_devices)

    def _elastic_restart(self, num_devices: int, step: int, reason: str,
                         record: Dict) -> int:
        """Re-search for `num_devices` (the group's size), compile again
        (the old step dropped, the new one captured again on a card) and
        restore the newest checkpoint resharded onto it: the restore
        overwrites whatever compile drew, so nothing is carried."""
        with tracer_of(self.ff).span("re_search", cat="resilience",
                                     survivors=num_devices, reason=reason):
            strategy = self._search_strategy(num_devices)
        self.counters["re_searches"] += 1
        t0 = time.perf_counter()
        self.ff.recompile(strategy=strategy, carry=False)
        record["recompile_s"] = time.perf_counter() - t0
        return self._restore_latest(step, record)

    def _reform(self, survivors: int) -> bool:
        """The survivors of a device loss form a new group of
        `survivors` ranks (0 to survivors - 1 keep their ranks); whether
        this rank is among them.  Every rank of the old group calls: the
        queued saves land first, then the step is dropped and the group
        destroyed.  The new group meets through a file store in the
        checkpoint directory named by the restart epoch, which the
        survivors agree on through the remote tier when there is one."""
        from ..topology.rendezvous import epoch_rendezvous

        self._drain_writer()
        me = distributed.rank()
        self.ff._drop_step()
        epoch = self._epoch + 1
        if me < survivors and self.offloader is not None:
            epoch = epoch_rendezvous(
                self.offloader.remote.blob, self.run_id, epoch, slice_id=me,
                num_slices=survivors, round_id=epoch,
                timeout_s=self.barrier_timeout, sleep=self.sleep)
        self._epoch = epoch
        store = os.path.join(self.manager.directory,
                             f".group-{self.run_id}-epoch{epoch:04d}")
        return self.ff._join_devices(list(range(survivors)),
                                     f"file://{store}")

    def _recover_device_loss(self, fault: DeviceLossFault, step: int,
                             record: Dict) -> int:
        """The survivors re-form the group (a rank beyond them raises
        _LeftGroup), re-search, recompile and restore."""
        world = distributed.world_size()
        survivors = min(int(fault.survivors), world)
        if survivors < 1:
            raise RuntimeError(f"device loss left no survivors: {fault}")
        self.counters["device_losses"] += 1
        self.log.info("device loss at step %d: %d of %d ranks survive, "
                      "re-searching", step, survivors, world)
        if survivors < world:
            t0 = time.perf_counter()
            if not self._reform(survivors):
                raise _LeftGroup()
            record["reform_s"] = time.perf_counter() - t0
        return self._elastic_restart(survivors, step, "device_loss", record)

    def _recover_hung_step(self, err, step: int, restarts: int,
                           record: Dict) -> int:
        """A hung step is a fault of the whole group with every device
        still there: a recompile resets the step, then restore.  It
        counts against the restart budget, so a group that hangs on
        every attempt fails loudly."""
        self.counters["hung_steps"] += 1
        if not self.retry.admits(restarts):
            raise RestartBudgetExhausted(
                f"restart budget ({self.retry.max_restarts}) exhausted at "
                f"hung step {step}: {err}") from err
        self.log.info("hung step %d (%s): recompiling", step, err)
        return self._elastic_restart(distributed.world_size(), step,
                                     "hung_step", record)

    # -- preemption grace -------------------------------------------------
    def _on_grace_signal(self, signum, frame) -> None:
        # signal-handler context: set the flag, the work happens at the
        # next step boundary
        if self._preempt is None:
            self._preempt = signal.Signals(signum).name
            self._signalled_at = time.monotonic()
        self.log.info("%s received: emergency checkpoint at the next step "
                      "boundary", signal.Signals(signum).name)

    def _install_grace_handlers(self) -> Dict:
        """SIGTERM/SIGINT -> an emergency save at the next step boundary.
        Returns the handlers they replace (put back on exit); none off the
        main thread, where signal.signal would raise."""
        if not self.preempt_grace:
            return {}
        if threading.current_thread() is not threading.main_thread():
            return {}
        installed = {}
        for sig in GRACE_SIGNALS:
            try:
                installed[sig] = signal.signal(sig, self._on_grace_signal)
            except (ValueError, OSError):
                break
        return installed

    def _group_stops(self, last: bool = False) -> bool:
        """On a group, whether the ranks stop at this boundary: every one
        was signalled, or one was and has waited barrier_timeout, or
        (`last`, after the last step) any one was.  Every rank calls (one
        all-reduce); a rank that stops without a signal of its own takes
        the preemption as "peer"."""
        ex = self.ff.executor
        device = (ex.device if torch.distributed.get_backend() == "nccl"
                  else torch.device("cpu"))
        signalled = self._preempt is not None
        late = signalled and (time.monotonic() - self._signalled_at
                              >= self.barrier_timeout)
        flags = torch.tensor([0 if signalled else 1, 1 if late else 0,
                              1 if signalled else 0], dtype=torch.int32,
                             device=device)
        torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MAX)
        not_all, any_late, any_signalled = (int(v) for v in flags.tolist())
        stop = bool(any_signalled and (last or not not_all or any_late))
        if stop and self._preempt is None:
            self._preempt = "peer"
        return stop

    def _preempt_rendezvous(self, step: int) -> int:
        """One emergency step for every rank of the run: the blob-store
        barrier's largest posted step.  Without a remote tier (or when the
        barrier fails) this rank's own step stands."""
        if self.offloader is None:
            return step
        from ..distributed import preemption_barrier

        try:
            if self._run_id_defaulted and distributed.world_size() > 1:
                self.log.warning(
                    "preemption-barrier run_id defaulted to %r from the "
                    "checkpoint directory: pass TrainingSupervisor(run_id="
                    "...) with one value for every rank if their "
                    "directories differ", self.run_id)
            agreed = int(preemption_barrier(
                self.offloader.remote.blob, self.run_id, step,
                timeout_s=self.barrier_timeout, sleep=self.sleep))
        except Exception as e:  # noqa: BLE001 - never block the save
            self.log.info("preemption barrier failed (%s); saving without "
                          "agreement", e)
            return step
        if agreed != step:
            self.log.info("preemption barrier agreed on step %d (this rank "
                          "is at %d): running forward to it", agreed, step)
        return agreed

    def _emergency_stop(self, step: int) -> None:
        """One synchronous checkpoint at this step boundary, mirrored
        whatever the cadence, with the async writer drained first (the
        sync write must not race a queued one on the step directory)."""
        registry = registry_of(self.ff)
        with tracer_of(self.ff).span("emergency_checkpoint",
                                     cat="resilience", step=step,
                                     reason=self._preempt):
            self._drain_writer()
            self._save_checkpoint_survivable(step, wait=True)
        if self.offloader is not None:
            self.manager.offload_step(step)
        self.counters["emergency_saves"] += 1
        if registry is not None:
            registry.counter("resilience/ckpt_emergency_saves").inc()
        self.log.info("emergency checkpoint at step %d after %s; exiting "
                      "restorable", step, self._preempt)

    def _clear_run_state(self) -> None:
        """A run's start: an earlier incarnation's barrier and epoch posts
        and group store files must not meet this run's quorums."""
        if self.offloader is not None:
            from ..distributed import clear_preemption_barrier
            from ..topology.rendezvous import clear_rendezvous

            blob = self.offloader.remote.blob
            clear_preemption_barrier(blob, self.run_id)
            clear_rendezvous(blob, self.run_id)
        if distributed.rank() == 0:
            for path in glob.glob(os.path.join(
                    self.manager.directory, f".group-{self.run_id}-epoch*")):
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- the supervised loop ----------------------------------------------
    def run(self, x, y, num_steps: int, batch_size: Optional[int] = None,
            resume: bool = False) -> SupervisorReport:
        """Train `num_steps` supervised steps over (x, y).  resume=True
        restores the newest checkpoint of either tier (if any) and goes on
        from its step: the companion of the preemption grace's exit."""
        ff = self.ff
        if ff._step_fn is None:
            raise RuntimeError("call compile() first")
        batch_size = batch_size or ff.config.batch_size
        x_map = self._x_map(x)
        num_batches = len(y) // batch_size
        if num_batches < 1:
            raise ValueError(f"need at least one batch: {len(y)} samples < "
                             f"batch_size {batch_size}")
        # keyed by step, so that a restore truncates exactly (a skipped
        # step records nothing)
        loss_by_step: Dict[int, float] = {}
        step = 0
        restarts = 0
        preempt_target: Optional[int] = None
        noticed: Optional[int] = None
        left = False
        self._preempt = None
        self._signalled_at = None
        self._clear_run_state()
        if resume and self.manager.any_restorable():
            step = int(self.manager.restore(ff))
            self.log.info("resumed from checkpoint step %d", step)
        else:
            self._save_checkpoint_survivable(0)  # the first restore target
        real_hangs = ff.device.type == "cuda" and self.watchdog.enabled
        displaced = self._install_grace_handlers()
        try:
            while step < num_steps:
                if self._preempt is not None and noticed is None:
                    noticed = step  # the boundary this rank posts
                group = distributed.world_size() > 1 and self.preempt_grace
                if (self._preempt is not None and not group) or (
                        group and self._group_stops()):
                    # one rendezvous, then steps until this rank reaches
                    # the agreed step (laggards run forward)
                    if preempt_target is None:
                        preempt_target = self._preempt_rendezvous(
                            step if noticed is None else noticed)
                    if step >= preempt_target:
                        break
                t_fault = time.perf_counter()
                try:
                    # on a card a hung step is a real one: its stream
                    # stalls after the step's work, and the watchdog's
                    # deadline on the loss read fires
                    stall = (self.fault_plan.take(step, FaultKind.HUNG_STEP)
                             if real_hangs else None)
                    self.fault_plan.check_step(step)
                    inputs, labels = self._batch(x_map, y, step, batch_size,
                                                 num_batches)
                    inputs = self.fault_plan.corrupt_batch(step, inputs)
                    snap = (self._snapshot() if self.nan_policy == "skip_step"
                            else None)
                    m = ff.train_step(inputs, labels)
                    if stall is not None:
                        stall_device(ff.device, HANG_DEADLINES
                                     * self.watchdog.timeout_s)
                    self.counters["steps_run"] += 1
                    # the per-step device read, under the watchdog
                    loss_val = self.watchdog.sync(
                        lambda: float(m["loss"]), step=step)
                    try:
                        check_step_health({"loss": loss_val}, step=step,
                                          nan_policy=self.nan_policy)
                    except NonFiniteLossError:
                        if self.nan_policy != "skip_step":
                            raise  # "raise" propagates, "restore" below
                        # the whole step undone, then past the batch
                        self._rollback(snap)
                        self.counters["skipped_steps"] += 1
                        loss_val = None
                    if loss_val is not None:
                        loss_by_step[step] = loss_val
                    step += 1
                    if (self.checkpoint_every > 0
                            and step % self.checkpoint_every == 0):
                        self._save_checkpoint_survivable(step)
                    continue
                except DeviceLossFault as f:
                    record = {"kind": "device_loss", "step": step}
                    step = self._recover_device_loss(f, step, record)
                except HUNG_FAULTS as e:
                    record = {"kind": "hung_step", "step": step,
                              "error": type(e).__name__}
                    restarts += 1
                    step = self._recover_hung_step(e, step, restarts, record)
                except TRANSIENT_FAULTS + (NonFiniteLossError,) as e:
                    if (isinstance(e, NonFiniteLossError)
                            and self.nan_policy == "raise"):
                        raise
                    record = {"kind": type(e).__name__, "step": step}
                    restarts += 1
                    step = self._retry_transient(e, step, restarts, record)
                # replayed steps record their losses again
                loss_by_step = {s: v for s, v in loss_by_step.items()
                                if s < step}
                record["total_s"] = time.perf_counter() - t_fault
                self.recoveries.append(record)
            if (preempt_target is None and distributed.world_size() > 1
                    and self.preempt_grace):
                self._group_stops(last=True)
            if self._preempt is not None:
                # after the loop too: a signal during the last step still
                # gets its checkpoint
                if preempt_target is None:
                    # this rank finished every step, so the agreement
                    # cannot pass it; its peers wait for its post
                    preempt_target = self._preempt_rendezvous(step)
                self._emergency_stop(step)
        except _LeftGroup:
            left = True
            self.log.info("this rank left the group at step %d (device "
                          "loss)", step)
        finally:
            for sig, handler in displaced.items():
                signal.signal(sig, handler)
            # every exit waits for the queued saves and mirrors
            self._drain_writer()
            self._drain_offloader()
        tel = getattr(self.ff, "telemetry", None)
        emit_counters(self.log, "supervisor", self.counters,
                      registry=tel.metrics if tel is not None else None,
                      group="resilience")
        if tel is not None and tel.enabled:
            tel.flush()
        counters = dict(self.counters)
        if self.offloader is not None:
            counters.update(self.offloader.counters)
        return SupervisorReport(
            final_step=step,
            losses=[loss_by_step[s] for s in sorted(loss_by_step)],
            counters=counters,
            preempted=None if left else self._preempt,
            left_group=left, recoveries=list(self.recoveries),
            agreed_step=preempt_target)

    # -- nan handling -----------------------------------------------------
    def _snapshot(self):
        """Copies (on the model's device) of every leaf of the train state
        and the generator's state, for a skip_step rollback."""
        from ..checkpoint import _state_leaves

        with torch.no_grad():
            leaves = [(t, t.detach().clone())
                      for _, t, _, _ in _state_leaves(self.ff)]
        return leaves, self.ff._generator.get_state().clone()

    def _rollback(self, snap) -> None:
        """The snapshot written back into the live tensors (`copy_`: a
        captured step replays on them, so they keep their storage)."""
        leaves, rng = snap
        with torch.no_grad():
            for t, saved in leaves:
                t.copy_(saved)
        self.ff._generator.set_state(rng)
