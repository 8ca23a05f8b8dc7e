"""Continuous (iteration-level) batching on the paged KV pool: the Orca
OSDI'22 scheduling discipline (flexflow_tpu/serving/scheduler.py).

A persistent decode loop steps every in-flight sequence by one token
per iteration; at every step boundary it retires finished sequences
and admits queued prompts into the freed slots.  Sequences reserve
worst-case blocks at admission (a full pool QUEUES the request),
extend block by block and free on retirement.  The pool is also a
prefix cache: an admission maps the longest indexed block-aligned
prefix of its prompt onto shared physical blocks, copy-on-write
isolates a full-prompt hit's tail block, and a second [slots, C] step
prefills the uncached remainder C tokens per dispatch.

The device half, `PagedKVDecodeModel`, runs on the trained model's
device.  Which read formulation runs is not a choice here: on a CUDA
device every attention layer reads the pool through the hand-written
paged-attention kernel, on the CPU through its plain gather version,
and `stats()["paged_kernel"]["formulation"]` says which ran.

Speculative decoding (serving/speculative.py): with spec_decode "ngram"
or "draft" the model also holds the [slots, spec_k + 1] verify step,
and the loop asks a proposer for up to k drafts per greedy decode-phase
slot each round.  One verify dispatch then advances every live row; a
row accepts the longest prefix of its drafts that matches the target's
own greedy chain plus the first corrected token, and the pool rolls the
rejected positions back.  A round with no proposals takes the plain
decode step.  A transient verify fault degrades the engine to plain
decode (`stats()["speculative"]["degraded"]`, `verify_faults`); a fault
marked `fatal_to_engine` ends the worker and fails what is in flight.

Mid-decode handoff (serving/handoff.py): `request_handoff` pauses live
rows at the next step boundary and settles their handles with
HandoffPaused, carrying a ResumeRecord (prompt, generated tokens, the
sampling RNG's state) and, with `export_kv`, the row's written KV blocks
read by `PagedKVDecodeModel.export_block`.  A request submitted with
`resume=` replays prompt + generated as its feed (or hits the blocks a
migration adopted into this pool, its partial tail block written by
`import_block`) and goes on token for token.  `run_on_worker` queues
work (a migration's block writes, a pause) for the worker to run
between steps, the only thread that touches the pools; `drain` stops
taking requests and runs the accepted ones to completion; `on_death`
fires when a fault marked `fatal_to_engine` ends the worker, whose
drain stamps a resume record on every row that had generated tokens.

With a `registry` (obs.metrics.MetricsRegistry) the engine records the
reference's `serving/*` metrics: steps, TTFT, request and per-token
latency, the KV and prefix gauges and counters, the paged kernel's
reads, the speculative counters and `serving/handoff_*`.  Left out of
this slice: tensor-parallel replicas and request tracing.
"""
from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.kernels.paged_attention import blocks_read
from .kv_pool import KVPool

_LATENCY_WINDOW = 1024   # latency samples kept for the percentiles
_CLOSE_TIMEOUT_S = 60.0  # how long close() waits for the worker


class PagedKVDecodeModel:
    """Device half of the continuous engine: the paged decode twin of a
    trained GPT plus its step functions.

    step(tokens[b], seq_lens[b], block_tables[b, max_blocks]) runs one
    decode step for every slot at its OWN position and returns host
    logits [b, vocab].  prefill_chunk = C > 1 adds the [b, C]
    chunked-prefill step (a loop of C seq-1 forwards, so the K/V bytes
    match one-token prefill).  copy_block(src, dst) is the prefix
    cache's copy-on-write.  spec_decode "ngram" or "draft" adds the
    [b, spec_k + 1] verify_step, and "draft" keeps the draft engine
    (`draft_model`, a PagedKVDecodeModel over a smaller GPT) for the
    scheduler's proposer.  The KV pools are updated in place; only the
    scheduler's worker thread calls these methods.

    On a card every engine works on a CUDA stream of its own (`stream`),
    its state allocated there too: two replicas on one card do not wait
    on each other's work, a stalled engine stalls only itself, and an
    engine's memory is never handed to another stream while its work is
    pending.  Each call first orders the engine's stream after the
    caller's, so work the caller queued (a restore of the pools) lands
    before it; a caller that reads the pools after a call that returns
    nothing (prefill_step, copy_block, import_block, reset) synchronizes
    first."""

    def __init__(self, ff_train, batch_slots: int = 8,
                 page_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 0, prefix_cache: bool = True,
                 spec_decode: str = "off", spec_k: int = 4,
                 draft_model=None):
        from ..config import resolve_spec_decode

        self.spec_decode = resolve_spec_decode(spec_decode, spec_k)
        self.spec_k = int(spec_k)
        self.device = torch.device(ff_train.device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        with self._on_stream():
            self._build(ff_train, batch_slots, page_size, num_blocks,
                        prefill_chunk, prefix_cache, draft_model)

    def _build(self, ff_train, batch_slots, page_size, num_blocks,
               prefill_chunk, prefix_cache, draft_model):
        from ..config import ConfigError
        from ..decoding import (_gpt_dims, build_paged_copy_block,
                                build_paged_decode_step,
                                build_paged_prefill_step,
                                build_paged_verify_step, make_gpt_decoder)

        dims = _gpt_dims(ff_train)
        max_seq = dims["max_seq"]
        if page_size < 1 or max_seq % page_size:
            raise ValueError(
                f"page_size {page_size} must divide the model's "
                f"max positions {max_seq}")
        max_blocks = max_seq // page_size
        if num_blocks is None:
            # half of the dense footprint (+ scratch)
            num_blocks = 1 + max(max_blocks,
                                 (batch_slots * max_blocks + 1) // 2)
        self.ffd = make_gpt_decoder(ff_train, batch_size=batch_slots,
                                    kv_page_size=page_size,
                                    kv_num_blocks=num_blocks)
        # the device decides the read formulation
        self.paged_kernel = "cuda" if self.device.type == "cuda" else "plain"
        self.batch_slots = batch_slots
        self.page_size = page_size
        self.num_blocks = num_blocks
        self.max_blocks_per_seq = max_blocks
        self.max_seq = max_seq
        self.vocab = dims["vocab_size"]
        self.prefill_chunk = max(0, int(prefill_chunk))
        if self.prefill_chunk == 1:
            self.prefill_chunk = 0  # a 1-token chunk IS the decode step
        self.prefix_cache = bool(prefix_cache)
        self._step_fn = build_paged_decode_step(self.ffd)
        self._prefill_fn = (
            build_paged_prefill_step(self.ffd, self.prefill_chunk)
            if self.prefill_chunk else None)
        self._copy_fn = build_paged_copy_block(self.ffd)
        # the speculative verify step: ONE [slots, spec_k + 1] step scores
        # a pending token plus up to spec_k drafts per row; counts is
        # data, so adaptive-k rounds reuse it
        self.verify_chunk = (self.spec_k + 1 if self.spec_decode != "off"
                             else 0)
        self._verify_fn = (
            build_paged_verify_step(self.ffd, self.verify_chunk)
            if self.spec_decode != "off" else None)
        self.draft_model = draft_model
        if self.spec_decode == "draft":
            dm = draft_model
            if dm is None:
                raise ConfigError(
                    "--spec-decode draft needs a draft model — pass "
                    "draft_model= (or from_trained(..., draft_ff=)) "
                    "or use --spec-decode ngram")
            if int(getattr(dm, "vocab", -1)) != self.vocab:
                raise ConfigError(
                    f"draft model vocab {getattr(dm, 'vocab', None)} "
                    f"!= target vocab {self.vocab} — draft token ids "
                    f"are proposed verbatim, so the vocabularies must "
                    f"match")
            if int(getattr(dm, "max_seq", 0)) < max_seq:
                raise ConfigError(
                    f"draft model position table "
                    f"({getattr(dm, 'max_seq', 0)}) is shorter than "
                    f"the target's ({max_seq}) — the drafter must be "
                    f"able to reach every target position")
            if int(getattr(dm, "batch_slots", 0)) < batch_slots:
                raise ConfigError(
                    f"draft model has {getattr(dm, 'batch_slots', 0)} "
                    f"slots < the target's {batch_slots} — draft rows "
                    f"mirror engine slots 1:1")
        self._state = self.ffd._state
        # bytes of ONE physical block summed across every layer's k/v
        # pool: the unit of the kernel-read counters
        self.kv_block_bytes = sum(
            v[0].numel() * v.element_size()
            for entries in self._state.values()
            for k, v in entries.items() if k in ("k_cache", "v_cache"))

    @contextlib.contextmanager
    def _on_stream(self):
        """Run the block on the engine's stream, ordered after the
        caller's current stream (nothing to do on the CPU)."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield

    def _ints(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, np.int32), device=self.device)

    def reset(self):
        """Zero the decode state in place (fault recovery).  The
        scheduler invalidates the pool's prefix index right after."""
        with self._on_stream(), torch.no_grad():
            for entries in self._state.values():
                for v in entries.values():
                    v.zero_()

    def step(self, tokens: np.ndarray, seq_lens: np.ndarray,
             block_tables: np.ndarray) -> np.ndarray:
        with self._on_stream():
            logits, self._state = self._step_fn(
                self.ffd._weights, self._state, self._ints(tokens),
                self._ints(seq_lens), self._ints(block_tables))
            return logits.float().cpu().numpy()

    def prefill_step(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray) -> None:
        """Chunked prefill: scatter tokens[b, C] at positions[b]..+C-1
        into the pool.  No logits come back."""
        with self._on_stream():
            self._state = self._prefill_fn(
                self.ffd._weights, self._state, self._ints(tokens),
                self._ints(positions), self._ints(block_tables))

    def verify_step(self, tokens: np.ndarray, seq_lens: np.ndarray,
                    counts: np.ndarray,
                    block_tables: np.ndarray) -> np.ndarray:
        """Speculative verify: feed tokens[b, :counts[b]] at
        seq_lens[b].. and return host logits [b, verify_chunk, vocab];
        row i's logits[j] equal, bit for bit, what the decode step gives
        feeding tokens[i, j] at seq_lens[i] + j.  Built only when
        spec_decode != "off"."""
        with self._on_stream():
            logits, self._state = self._verify_fn(
                self.ffd._weights, self._state, self._ints(tokens),
                self._ints(seq_lens), self._ints(counts),
                self._ints(block_tables))
            return logits.float().cpu().numpy()

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: clone physical block src -> dst in every
        layer's k/v pool, ordered with the steps on the engine's
        stream."""
        with self._on_stream():
            self._state = self._copy_fn(self._state, int(src), int(dst))

    def _kv_pages(self):
        """(key, pool) of every layer's k/v pool, keyed
        "<op>/<k_cache|v_cache>" as the reference's."""
        return [(f"{name}/{k}", entries[k])
                for name, entries in self._state.items()
                for k in ("k_cache", "v_cache") if k in entries]

    def export_block(self, block: int) -> Dict[str, np.ndarray]:
        """Read ONE physical block of every layer's k/v pool to host
        numpy (the migration export path, serving/kv_transfer.py), keyed
        "<op>/<k_cache|v_cache>", so that an import lands each page in
        the matching layer.  The pages are gathered into one buffer on
        the card and read in ONE copy (a copy per page would wait on the
        host once per page); the arrays are views of that fresh host
        buffer, and a bfloat16 pool's pages travel widened to float32,
        which is exact.  Worker thread only, between steps."""
        pools = self._kv_pages()
        with self._on_stream():
            flat = torch.cat([p[block].reshape(-1) for _, p in pools])
            if flat.dtype == torch.bfloat16:
                flat = flat.float()
            host = flat.cpu().numpy()
        out: Dict[str, np.ndarray] = {}
        off = 0
        for key, pool in pools:
            shape = tuple(pool.shape[1:])
            n = int(np.prod(shape))
            out[key] = host[off:off + n].reshape(shape)
            off += n
        return out

    def import_block(self, block: int,
                     arrays: Dict[str, np.ndarray]) -> None:
        """Write one migrated block into every layer's pool IN PLACE
        (`pool[block].copy_`): the pools the steps read keep their
        storage and addresses, so a step captured over them stays
        valid.  The pages cross to the card in ONE copy and are
        scattered there.  Worker thread only, between steps."""
        pools = self._kv_pages()
        host = np.concatenate([
            np.asarray(arrays[key], np.float32).reshape(-1)
            for key, _ in pools])
        with self._on_stream(), torch.no_grad():
            flat = torch.from_numpy(host).to(self.device)
            off = 0
            for _, pool in pools:
                page = pool[block]
                n = page.numel()
                page.copy_(flat[off:off + n].view(page.shape))
                off += n


class _PendingSeq:
    """Future-style handle for one request, with the SLO timestamps:
    submit, first generated token (TTFT), done.

    `on_done` (set at submission, never after) fires exactly once when
    the request settles (success, fault, pause or drain) on whichever
    thread settled it; the replicated front (serving/front.py) routes
    completions and requeues by it."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "seed",
                 "event", "result", "error", "t_submit", "t_first_token",
                 "t_done", "n_generated", "prefix_hit_tokens",
                 "spec_proposed", "spec_accepted", "on_done", "resume",
                 "resume_out", "_settle_lock", "_settled")

    def __init__(self, prompt, max_new_tokens, temperature, seed,
                 on_done=None, resume=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        # resume: a handoff.ResumeRecord continuing a mid-decode
        # generation.  resume_out: stamped when the scheduler settles
        # this handle unfinished with recoverable state (death, a failed
        # step), so that the front's requeue resumes instead of
        # generating again from the prompt.
        self.resume = resume
        self.resume_out = None
        self.event = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[Exception] = None
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.n_generated = 0
        self.prefix_hit_tokens = 0  # prompt tokens served from cache
        self.spec_proposed = 0   # draft tokens verified for this request
        self.spec_accepted = 0   # ... of which the target agreed with
        self.on_done = on_done
        self._settle_lock = threading.Lock()
        self._settled = False

    def _settle(self) -> None:
        """Wake the waiter and fire the completion hook exactly once,
        even when close() races the worker's own drain."""
        with self._settle_lock:
            if self._settled:
                return
            self._settled = True
        self.event.set()
        if self.on_done is not None:
            try:
                self.on_done(self)
            except Exception:  # noqa: BLE001 - a hook never kills the
                pass           # decode loop or a drain

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self.event.wait(timeout):
            raise TimeoutError("generation request timed out")
        if self.error is not None:
            raise self.error
        return self.result


class _Live:
    """Slot-resident decoding state for one admitted sequence.  `start`
    > 0 means a prefix-cache hit: positions [0, start) are already in
    shared KV blocks and never prefill.

    `feed` is the token stream the positions consume before sampling
    begins: the prompt or, for a resumed generation, the prompt and
    every token generated before the pause (fed as prompt, so the KV
    state is built again bit for bit).  `generated` then starts with
    those tokens, so that the completion and the budget count them as
    the uninterrupted run does."""

    __slots__ = ("req", "seq_id", "pos", "next_token", "generated",
                 "max_new", "rng", "feed")

    def __init__(self, req: _PendingSeq, seq_id: int, max_new: int,
                 start: int = 0, feed=None, generated=None,
                 rng_state=None):
        self.req = req
        self.seq_id = seq_id
        self.feed = req.prompt if feed is None else list(feed)
        self.pos = start                      # tokens already in the cache
        self.next_token = self.feed[start]    # token fed at position pos
        self.generated: List[int] = list(generated or [])
        self.max_new = max_new                # clamped to the position table
        self.rng = (np.random.RandomState(req.seed)
                    if req.temperature > 0.0 else None)
        if self.rng is not None and rng_state is not None:
            # a resume goes on with the sampled stream where the pause
            # left it: the replayed tokens draw nothing
            self.rng.set_state(rng_state)


class ContinuousScheduler:
    """Persistent decode loop with iteration-level admission/retirement.
    `batches_run` counts decode steps and verify rounds (the unit of
    batching is the dispatch); generate / generate_async /
    latency_stats / stats / close are the client API serve_http drives.
    `model` may be any object with PagedKVDecodeModel's step contract
    (the tests' fakes): a model without `verify_step` runs with
    speculation off, one without `copy_block` never shares a tail block
    it would have to copy, one without `export_block` pauses with a
    replay-only resume record."""

    def __init__(self, model, pool: Optional[KVPool] = None,
                 eos_id: int = -1, registry=None, seed: int = 0,
                 close_timeout_s: float = _CLOSE_TIMEOUT_S,
                 on_death=None, check_invariants: bool = False):
        self.model = model
        self.pool = pool or KVPool(
            model.num_blocks, model.page_size, model.max_blocks_per_seq,
            prefix_cache=bool(getattr(model, "prefix_cache", True)))
        self._chunk = int(getattr(model, "prefill_chunk", 0) or 0)
        if self._chunk and getattr(model, "prefill_step", None) is None:
            self._chunk = 0
        self._can_cow = getattr(model, "copy_block", None) is not None
        # kernel-read counters: physical blocks the paged-attention
        # kernel read vs what the dense gather formulation would have
        # materialized for the same dispatches (counted when the kernel
        # runs, i.e. on a CUDA device)
        self._paged_kernel = str(getattr(model, "paged_kernel", "plain"))
        self._kv_block_bytes = int(getattr(model, "kv_block_bytes", 0))
        self.kernel_blocks_read = 0
        self.kernel_dense_blocks = 0
        self._check_invariants = bool(check_invariants)
        self._evictions_seen = 0  # delta base for the evictions counter
        self.prefill_steps = 0
        # speculative decoding: the model carries the mode, the verify
        # step and (for "draft") the draft engine; the scheduler owns
        # the proposer, the adaptive-k controller and accept/rollback
        spec = str(getattr(model, "spec_decode", "off") or "off")
        self._spec_k = int(getattr(model, "spec_k", 0) or 0)
        self._proposer = None
        if (spec != "off" and self._spec_k >= 1
                and getattr(model, "verify_step", None) is not None):
            from .speculative import AdaptiveK, build_proposer

            self._proposer = build_proposer(
                spec, getattr(model, "draft_model", None))
            self._adaptive = AdaptiveK(self._spec_k)
        self._spec = spec if self._proposer is not None else "off"
        self._spec_broken = False  # verify/proposer fault: plain decode
        self._spec_t0: Optional[float] = None
        self.spec_rounds = 0           # verify dispatches run
        self.spec_fallback_rounds = 0  # spec on, but no proposals
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_verify_faults = 0
        self.eos_id = int(eos_id)
        self.registry = registry
        self._queue: "queue.Queue[_PendingSeq]" = queue.Queue()
        self._waiting: deque = deque()  # worker-local FIFO admit order
        # work other threads marshal onto the worker (a migration's block
        # writes, a pause): only the worker touches the pools, between
        # steps
        self._service: "queue.Queue" = queue.Queue()
        # per-dispatch wall time (EWMA over decode, prefill and verify
        # dispatches): the unit the front prices a handoff and a
        # terminate deadline in
        self.step_ms_ewma = 0.0
        self._stop = threading.Event()
        self._latencies = deque(maxlen=_LATENCY_WINDOW)
        self._ttfts = deque(maxlen=_LATENCY_WINDOW)
        self._lat_lock = threading.Lock()
        self._slots: List[Optional[_Live]] = [None] * model.batch_slots
        # persistent step buffers: block-table rows change only on
        # admit/retire and at page boundaries
        self._tokens = np.zeros(model.batch_slots, np.int32)
        self._slens = np.zeros(model.batch_slots, np.int32)
        self._btab = np.zeros(
            (model.batch_slots, self.pool.max_blocks_per_seq), np.int32)
        self._next_seq_id = 0
        self._seed = itertools.count(int(seed) + 1)
        self._close_timeout_s = float(close_timeout_s)
        # fired with the exception when a fault ends the worker (not on
        # a clean close): the replica supervisor's death signal
        self._on_death = on_death
        # drain(): refuse new submissions, run the accepted ones to
        # completion, then exit cleanly and fire _on_drained once
        self._draining = False
        self._on_drained = None
        self.batches_run = 0       # decode steps executed
        self.requests_done = 0
        self.tokens_generated = 0
        self.step_failures = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    @classmethod
    def from_trained(cls, ff_train, batch_slots: int = 8,
                     page_size: int = 16,
                     num_blocks: Optional[int] = None, eos_id: int = -1,
                     registry=None, seed: int = 0, prefill_chunk: int = 0,
                     prefix_cache: bool = True,
                     check_invariants: bool = False,
                     spec_decode: str = "off", spec_k: int = 4,
                     draft_ff=None,
                     draft_num_blocks: Optional[int] = None,
                     ) -> "ContinuousScheduler":
        # the draft twin (spec_decode "draft") is its own paged engine
        # over the smaller trained GPT, on its device: the target's slot
        # count and page size (draft rows mirror engine slots 1:1), no
        # chunked prefill (catch-up is its prefill)
        draft_model = None
        if spec_decode == "draft" and draft_ff is not None:
            draft_model = PagedKVDecodeModel(
                draft_ff, batch_slots=batch_slots, page_size=page_size,
                num_blocks=draft_num_blocks)
        model = PagedKVDecodeModel(ff_train, batch_slots=batch_slots,
                                   page_size=page_size,
                                   num_blocks=num_blocks,
                                   prefill_chunk=prefill_chunk,
                                   prefix_cache=prefix_cache,
                                   spec_decode=spec_decode, spec_k=spec_k,
                                   draft_model=draft_model)
        return cls(model, eos_id=eos_id, registry=registry, seed=seed,
                   check_invariants=check_invariants)

    # -- client API -----------------------------------------------------
    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 temperature: float = 0.0,
                 timeout: Optional[float] = 60.0) -> List[int]:
        return self.generate_async(
            prompt, max_new_tokens, temperature).wait(timeout)

    def generate_async(self, prompt, max_new_tokens: int = 16,
                       temperature: float = 0.0, on_done=None,
                       seed=None, resume=None) -> _PendingSeq:
        """Queue one request.  `on_done(handle)` rides the handle from
        its birth, so a completion never races the caller attaching it;
        `seed` pins the sampling RNG (the front mints one per request,
        so a resubmission samples alike on any replica; None takes the
        engine's counter); `resume` (handoff.ResumeRecord) continues a
        paused or recovered generation, its generated tokens fed again
        as prompt."""
        if self._stop.is_set():
            raise RuntimeError("ContinuousScheduler is closed")
        if self._draining:
            # everything accepted before drain() runs to completion;
            # nothing new boards a leaving engine
            raise RuntimeError("ContinuousScheduler is draining")
        p = _PendingSeq(prompt, max_new_tokens, temperature,
                        next(self._seed) if seed is None else int(seed),
                        on_done=on_done, resume=resume)
        if not 1 <= len(p.prompt) < self.model.max_seq:
            raise ValueError(
                f"prompt length {len(p.prompt)} outside [1, "
                f"{self.model.max_seq})")
        if p.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if resume is not None and not 1 <= len(
                resume.replay_tokens()) < self.model.max_seq:
            raise ValueError(
                f"resume replay length {len(resume.replay_tokens())} "
                f"outside [1, {self.model.max_seq})")
        self._queue.put(p)
        if self._stop.is_set():  # close() raced the put
            p.error = RuntimeError("ContinuousScheduler is closed")
            p._settle()
        return p

    def run_on_worker(self, fn, on_dropped=None) -> None:
        """Queue `fn` for the worker to run between steps (it alone
        touches the model's pools: a migration's block writes land
        here).  `fn` handles its own errors; one it lets escape is
        treated as a step fault (`fatal_to_engine` ends the worker,
        anything else goes to `on_dropped`).  If the engine closes,
        drains or dies before `fn` runs, `on_dropped` fires with the
        terminal error instead, so no caller waits on work that will
        not run."""
        if self._stop.is_set():
            raise RuntimeError("ContinuousScheduler is closed")
        self._service.put((fn, on_dropped))
        if self._stop.is_set():  # close() raced the put
            self._drop_services(RuntimeError(
                "ContinuousScheduler is closed"))

    def _drop_services(self, err: Exception) -> None:
        while True:
            try:
                fn, on_dropped = self._service.get_nowait()
            except queue.Empty:
                return
            if on_dropped is not None:
                try:
                    on_dropped(err)
                except Exception:  # noqa: BLE001 - a drain is never
                    pass           # masked by a hook

    def _run_services(self) -> None:
        while True:
            try:
                fn, on_dropped = self._service.get_nowait()
            except queue.Empty:
                return
            try:
                fn()
            except Exception as e:
                if getattr(e, "fatal_to_engine", False):
                    raise
                if on_dropped is not None:
                    try:
                        on_dropped(e)
                    except Exception:  # noqa: BLE001
                        pass

    @property
    def worker_alive(self) -> bool:
        return self._worker.is_alive()

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, on_drained=None) -> None:
        """Stop ACCEPTING and run everything already accepted to
        completion (decode goes on undisturbed, so completions equal an
        engine's that was never drained).  When the last live sequence
        retires and nothing is queued, the worker exits cleanly and
        fires `on_drained` once; the engine then refuses submissions as
        a closed one does.  close() bounds a wedged drain."""
        if self._stop.is_set() or self._draining:
            return
        self._on_drained = on_drained
        self._draining = True

    def request_handoff(self, *, remaining_over: int = 0,
                        max_sequences: int = 0, export_kv: bool = True,
                        on_paused=None) -> None:
        """Pause live generations at the next step boundary and settle
        their handles with handoff.HandoffPaused.  Eligible rows have
        MORE than `remaining_over` tokens still to generate (a draining
        replica passes 0; a terminating front the count that still fits
        its deadline); `max_sequences` > 0 caps how many pause, the
        largest remaining budget first.  With `export_kv` each paused
        row's written KV blocks, the partial tail included, ride the
        settle for the front to stream to another replica; the resume
        record rides regardless, so every later fault degrades to
        replay.  `on_paused(count)` fires on the worker after the sweep
        (0 if the engine ended first).  Works on a draining engine:
        services still run between its last steps."""
        def service():
            rows = [(live.max_new - len(live.generated), i, live)
                    for i, live in enumerate(self._slots)
                    if live is not None]
            rows = [r for r in rows if r[0] > int(remaining_over)]
            rows.sort(key=lambda r: (-r[0], r[1]))
            if max_sequences and int(max_sequences) > 0:
                rows = rows[:int(max_sequences)]
            for _, i, live in rows:
                self._pause_slot(i, live, export_kv)
            if on_paused is not None:
                on_paused(len(rows))

        self.run_on_worker(
            service,
            on_dropped=((lambda e: on_paused(0))
                        if on_paused is not None else None))

    def cached_prefix_tokens(self, prompt) -> int:
        """Read-only probe: prompt tokens the prefix cache would serve
        now.  The front routes by it and discounts them at admission."""
        return self.pool.cached_prefix_tokens([int(t) for t in prompt])

    def latency_stats(self) -> Dict[str, float]:
        from .batcher import latency_percentiles

        return latency_percentiles(self._latencies, self._lat_lock)

    def ttft_stats(self) -> Dict[str, float]:
        from .batcher import latency_percentiles

        return latency_percentiles(self._ttfts, self._lat_lock)

    def stats(self) -> Dict:
        live = [s for s in self._slots if s is not None]
        return {
            "mode": "continuous",
            "draining": self._draining,
            "steps": self.batches_run,
            "prefill_steps": self.prefill_steps,
            "prefill_chunk": self._chunk,
            "requests_done": self.requests_done,
            "tokens_generated": self.tokens_generated,
            "step_failures": self.step_failures,
            "step_ms_ewma": round(self.step_ms_ewma, 4),
            "queue_depth": self._queue.qsize() + len(self._waiting),
            "live_sequences": len(live),
            "kv_pool": {
                "page_size": self.pool.page_size,
                "usable_blocks": self.pool.usable_blocks,
                "used_blocks": self.pool.used_blocks,
                "reserved_blocks": self.pool.reserved_blocks,
                "peak_used_blocks": self.pool.peak_used,
                "occupancy": round(self.pool.occupancy(), 4),
                "fragmentation": round(self.pool.fragmentation(), 4),
            },
            "prefix_cache": self.pool.prefix_stats(),
            "speculative": {
                "mode": self._spec,
                "k_max": self._spec_k if self._spec != "off" else 0,
                "k_current": (self._adaptive.k
                              if self._proposer is not None else 0),
                "rounds": self.spec_rounds,
                "fallback_rounds": self.spec_fallback_rounds,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": round(
                    self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else 0.0,
                "accepted_per_round": round(
                    self.spec_accepted / self.spec_rounds, 4)
                if self.spec_rounds else 0.0,
                "verify_faults": self.spec_verify_faults,
                "degraded": self._spec_broken,
                "proposer": (self._proposer.stats()
                             if self._proposer is not None else {}),
            },
            "paged_kernel": {
                "formulation": self._paged_kernel,
                "blocks_read": self.kernel_blocks_read,
                "dense_blocks_equiv": self.kernel_dense_blocks,
                "bytes_read":
                    self.kernel_blocks_read * self._kv_block_bytes,
                "dense_bytes_avoided":
                    max(0, self.kernel_dense_blocks
                        - self.kernel_blocks_read) * self._kv_block_bytes,
            },
            "ttft": self.ttft_stats(),
            "latency": self.latency_stats(),
        }

    def close(self, timeout_s: Optional[float] = None):
        """Stop the loop: in-flight sequences fail with a closed error
        (their blocks are freed), queued requests fail without waiting
        out their timeout.  The wait for the worker is bounded, and the
        drain runs even if the worker outlived it."""
        self._stop.set()
        if timeout_s is None:
            timeout_s = self._close_timeout_s
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and self._worker.is_alive():
            self._worker.join(timeout=min(0.2, max(0.0, timeout_s)))
        err = RuntimeError("ContinuousScheduler closed")
        self._drain(err)
        while True:  # late enqueues that raced the stop flag
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.error = err
            p._settle()

    # -- worker ---------------------------------------------------------
    def _free_slot_buffers(self, slot: int):
        """Point a vacated slot's step buffers back at scratch."""
        self._btab[slot] = 0
        self._tokens[slot] = 0
        self._slens[slot] = 0

    def _resume_record_of(self, live: _Live):
        """Host-side resume record of a live row, built on the failure
        paths too: the tokens live on the host, so a dead device cannot
        tear them, and the front's requeue replays prompt + generated
        instead of generating again from the prompt."""
        from .handoff import ResumeRecord

        try:
            return ResumeRecord(
                live.req.prompt, live.generated, live.pos,
                live.req.seed, live.req.temperature,
                rng_state=(live.rng.get_state()
                           if live.rng is not None else None),
                page_size=self.pool.page_size)
        except Exception:  # noqa: BLE001 - recovery metadata never
            return None    # masks the original failure

    def _pause_slot(self, slot: int, live: _Live,
                    export_kv: bool = True) -> None:
        """Worker-side pause: snapshot the row (and, with export_kv, its
        written KV blocks, the partial tail included), retire it and
        settle its handle with HandoffPaused.  It runs between steps
        only, so the exported bytes are a consistent prefix of the
        generation."""
        from .handoff import HandoffPaused

        req = live.req
        written = (req.prompt + live.generated)[:live.pos]
        rec = self._resume_record_of(live)
        pages = arrays = None
        exporter = getattr(self.model, "export_block", None)
        if export_kv and exporter is not None:
            try:
                blocks, pages = self.pool.export_live(live.seq_id, written)
                arrays = [exporter(b) for b in blocks]
            except Exception as e:
                if getattr(e, "fatal_to_engine", False):
                    raise
                pages = arrays = None  # a replay-only resume
        if self._proposer is not None:
            self._proposer.release(slot)
        # the written prefix keys the retired blocks into the prefix
        # cache: a re-admission on THIS engine is a hit too
        self.pool.retire(live.seq_id, tokens=written)
        self._slots[slot] = None
        self._free_slot_buffers(slot)
        if self.registry is not None:
            self.registry.counter("serving/handoff_paused").inc()
        req.error = HandoffPaused(rec, pages=pages, arrays=arrays,
                                  page_size=self.pool.page_size)
        req._settle()

    def _drain(self, err: Exception):
        """Fail every queued/waiting/live request (close or fault).  It
        runs on the worker's way out of _loop and from close(), which
        overlap only when close() gave up on a wedged worker."""
        for i, s in enumerate(self._slots):
            if s is not None:
                try:
                    self.pool.retire(s.seq_id)
                except KeyError:
                    pass  # the racing drain already freed it
                if s.generated:
                    # death recovery: the front's requeue resumes from
                    # this instead of generating again from the prompt
                    s.req.resume_out = self._resume_record_of(s)
                s.req.error = err
                s.req._settle()
                self._free_slot_buffers(i)
        self._slots = [None] * self.model.batch_slots
        while self._waiting:
            p = self._waiting.popleft()
            p.error = err
            p._settle()
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.error = err
            p._settle()
        self._drop_services(err)

    def _admit(self):
        """Pull arrivals, then admit FIFO into free slots while the pool
        can GUARANTEE completion (a head-of-line request that does not
        fit blocks later ones).  Admission maps the longest indexed
        block-aligned prefix of the prompt onto shared blocks; a
        FULL-prompt hit still re-runs the last prompt token for its
        logits, so the pool copy-on-writes its tail block first.  A
        resumed request feeds prompt + generated through the same
        machinery (cache hit, chunked prefill, budget clamp), so it goes
        on as the uninterrupted generation would."""
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break
        free = [i for i, s in enumerate(self._slots) if s is None]
        while free and self._waiting:
            req = self._waiting[0]
            plen = len(req.prompt)
            rs = req.resume
            feed = req.prompt if rs is None else rs.replay_tokens()
            flen = len(feed)
            max_new = min(req.max_new_tokens, self.model.max_seq - plen)
            if rs is not None and len(rs.generated) >= max_new:
                # the pause raced the budget's edge: nothing is left to
                # decode, so settle the finished completion here
                self._waiting.popleft()
                req.result = req.prompt + list(rs.generated)
                req.n_generated = len(rs.generated)
                req.t_done = time.monotonic()
                req._settle()
                continue
            sid = self._next_seq_id
            try:
                admitted = self.pool.try_admit(
                    sid, plen + max_new, prompt=feed,
                    cow_ok=self._can_cow)
            except ValueError as e:
                # can never fit the table width: fail it alone
                self._waiting.popleft()
                req.error = e
                req._settle()
                continue
            if not admitted:
                if self.pool.reserved_blocks == 0:
                    self._waiting.popleft()
                    req.error = ValueError(
                        f"request needs "
                        f"{self.pool.blocks_for(plen + max_new)} KV blocks "
                        f"but the pool only has {self.pool.usable_blocks}")
                    req._settle()
                    continue
                if self.registry is not None:
                    self.registry.counter(
                        "serving/admissions_deferred").inc()
                break
            self._waiting.popleft()
            self._next_seq_id += 1
            hit = self.pool.admit_hit_tokens(sid)
            if rs is not None:
                # a live handoff may have shipped the partial tail
                # block: land it when the hit covers every full page,
                # so that the tail never replays either
                hit = self._import_resume_tail(sid, rs, hit)
            start = min(hit, flen - 1)
            req.prefix_hit_tokens = hit
            if hit and self.registry is not None:
                self.registry.counter("serving/prefix_hits").inc()
                self.registry.counter(
                    "serving/prefix_hit_tokens").inc(hit)
            cow = self.pool.ensure_writable(sid, start)
            if cow is not None:
                try:
                    self.model.copy_block(*cow)
                except Exception as e:
                    # fail the admitting request alone; a fatal fault
                    # ends the engine through _loop
                    self.pool.retire(sid)
                    req.error = e
                    req._settle()
                    if getattr(e, "fatal_to_engine", False):
                        raise
                    continue
                if self.registry is not None:
                    self.registry.counter("serving/kv_cow_copies").inc()
            live = _Live(
                req, sid, max_new, start=start,
                feed=feed if rs is not None else None,
                generated=rs.generated if rs is not None else None,
                rng_state=rs.rng_state if rs is not None else None)
            if rs is not None and self.registry is not None:
                self.registry.counter("serving/handoff_resumed").inc()
            slot = free.pop(0)
            self._slots[slot] = live
            # first private block (or a no-op after a full hit)
            self.pool.extend(sid, start + 1, written=start)
            self._btab[slot] = self.pool.table_row(sid)
            self._tokens[slot] = live.next_token
            self._slens[slot] = start

    def _import_resume_tail(self, sid: int, rs, hit: int) -> int:
        """Land a resumed sequence's migrated partial tail block: only
        when the adopted full pages cover the hit exactly (the tail
        chains through them) and the written watermark ends inside a
        page.  Returns the new hit; on any failure the table rolls back
        to the page-aligned hit and the tail replays through prefill."""
        page = self.pool.page_size
        tail_len = rs.written % page
        if (rs.kv_tail is None or not tail_len
                or rs.page_size != page
                or hit != (rs.written // page) * page
                or getattr(self.model, "import_block", None) is None):
            return hit
        try:
            self.pool.extend(sid, rs.written, written=rs.written)
            blk = self.pool.table_of(sid)[-1]
            self.model.import_block(blk, rs.kv_tail)
            if self.registry is not None:
                self.registry.counter(
                    "serving/handoff_tail_imports").inc()
            return rs.written
        except Exception as e:
            if getattr(e, "fatal_to_engine", False):
                raise
            try:
                self.pool.rollback(sid, (rs.written // page) * page)
            except Exception:  # noqa: BLE001 - fall back to replay
                pass
            return hit

    def _loop(self):
        """Thread body: run the decode loop, then drain no matter how it
        exited, so a crash fails pending requests at once (and leaves
        worker_alive False for the /v2/health degraded check).  A fatal
        exit fires on_death first, so a front's requeues already see
        this engine as down; a finished drain fires on_drained last."""
        err: Exception = RuntimeError("ContinuousScheduler closed")
        fatal: Optional[Exception] = None
        try:
            self._decode_loop()
        except Exception as e:  # a fault, a scheduler bug, a pool breach
            err = fatal = e
        drained = (fatal is None and self._draining
                   and not self._stop.is_set())
        if drained:
            # refuse late submissions; notify after the drain below has
            # settled any that slipped into the queue
            self._stop.set()
        if fatal is not None:
            self._stop.set()
            if self._on_death is not None:
                try:
                    self._on_death(fatal)
                except Exception:  # noqa: BLE001 - the worker is
                    pass           # exiting; never mask the drain
        self._drain(err)
        if drained and self._on_drained is not None:
            try:
                self._on_drained()
            except Exception:  # noqa: BLE001
                pass

    def _fail_inflight(self, e: Exception):
        """Step fault: fail in-flight only; queued requests survive on
        the same engine."""
        self.step_failures += 1
        if self.registry is not None:
            self.registry.counter("serving/step_failures").inc()
        for i, live in enumerate(self._slots):
            if live is None:
                continue
            self.pool.retire(live.seq_id)
            if live.generated:
                # the tokens survive on the host: a front's retry
                # replays them
                live.req.resume_out = self._resume_record_of(live)
            live.req.error = e
            live.req._settle()
            self._slots[i] = None
            self._free_slot_buffers(i)
        # a step that died mid-execution may have left the pools half
        # written: zero them, and drop the prefix index whose bytes
        # were zeroed with them
        reset = getattr(self.model, "reset", None)
        if reset is not None:
            reset()
            self.pool.invalidate_prefix_cache()
        # the drafter's state describes sequences that no longer exist:
        # speculation resumes from scratch with the fresh engine
        if self._proposer is not None:
            self._proposer.reset()

    def _note_step_time(self, dt_s: float) -> None:
        ms = dt_s * 1e3
        self.step_ms_ewma = (ms if self.step_ms_ewma == 0.0
                             else 0.9 * self.step_ms_ewma + 0.1 * ms)

    def _note_kernel_reads(self, blocks: int, dense_blocks: int):
        self.kernel_blocks_read += blocks
        self.kernel_dense_blocks += dense_blocks
        if self.registry is None:
            return
        reg = self.registry
        reg.counter("serving/paged_kernel_blocks_read").inc(blocks)
        if self._kv_block_bytes:
            reg.counter("serving/paged_kernel_bytes_read").inc(
                blocks * self._kv_block_bytes)
            reg.counter("serving/paged_dense_bytes_avoided").inc(
                max(0, dense_blocks - blocks) * self._kv_block_bytes)

    def _prefill_chunk_step(self, pre) -> bool:
        """One [slots, C] chunked-prefill dispatch advancing every
        mid-prefill row by up to C prompt tokens (never past plen-1:
        the last prompt token runs through the decode step, whose
        logits seed sampling).  Decode-phase rows ride along pointed at
        scratch, and a row's trailing pad tokens write only past its own
        frontier, overwritten before any query attends them.  Returns
        False after a fault (already handled)."""
        C = self._chunk
        tok = np.zeros((self.model.batch_slots, C), np.int32)
        slen = np.zeros(self.model.batch_slots, np.int32)
        btab = np.zeros_like(self._btab)
        plan = []
        for i, live in pre:
            upto = min(live.pos + C, len(live.feed) - 1)
            self.pool.extend(live.seq_id, upto, written=live.pos)
            self._btab[i] = self.pool.table_row(live.seq_id)
            tok[i, :upto - live.pos] = live.feed[live.pos:upto]
            slen[i] = live.pos
            btab[i] = self._btab[i]
            plan.append((i, live, upto))
        t0 = time.monotonic()
        try:
            self.model.prefill_step(tok, slen, btab)
        except Exception as e:
            if getattr(e, "fatal_to_engine", False):
                raise
            self._fail_inflight(e)
            return False
        self._note_step_time(time.monotonic() - t0)
        self.prefill_steps += 1
        if self._paged_kernel == "cuda":
            # the prefill step is C seq-1 forwards: account each as one
            # seq-1 kernel launch over the plan rows
            tw = self.pool.max_blocks_per_seq
            slens = np.array([live.pos for _, live, _ in plan])
            mask = np.ones(len(plan), bool)
            blocks = sum(
                blocks_read(slens + j, mask, 1, self.pool.page_size, tw)
                for j in range(C))
            self._note_kernel_reads(blocks,
                                    self.model.batch_slots * tw * C)
        for i, live, upto in plan:
            live.pos = upto
            # freshly written prompt blocks join the prefix index now
            self.pool.note_written(live.seq_id, upto)
            live.next_token = live.feed[live.pos]
            self._tokens[i] = live.next_token
            self._slens[i] = live.pos
        if self._check_invariants:
            self.pool.check_invariants()
        return True

    def _spec_proposals(self):
        """Ask the proposer for this round's drafts.  Eligible rows are
        GREEDY decode-phase slots with >= 2 tokens of budget left;
        mid-prefill and sampled rows ride the verify round with count
        1.  A row's draft length is capped by the adaptive k and its
        remaining budget, so fed positions never pass prompt + max_new
        (<= max_seq by admission)."""
        k = min(self._adaptive.k, self._spec_k)
        contexts: Dict[int, List[int]] = {}
        limits: Dict[int, int] = {}
        caps: Dict[int, int] = {}
        for i, live in enumerate(self._slots):
            if live is None or live.req.temperature > 0.0:
                continue
            plen = len(live.req.prompt)
            if live.pos < len(live.feed) - 1:
                continue  # still prefilling (or replaying a resume)
            rem = live.max_new - len(live.generated)
            if rem < 2:
                continue
            contexts[i] = live.req.prompt + live.generated
            limits[i] = min(plen + live.max_new + self._spec_k,
                            self.model.max_seq)
            caps[i] = min(k, rem - 1)
        if not contexts:
            return None
        try:
            props = self._proposer.propose(contexts, k, limits)
        except Exception:  # noqa: BLE001 - a proposer bug degrades to
            self._spec_broken = True   # plain decode, never kills the
            return None                # engine
        out = {}
        for i, d in (props or {}).items():
            if i in caps and d:
                d = [int(t) for t in d[:caps[i]]]
                if d:
                    out[i] = d
        return out or None

    def _spec_round(self, props) -> bool:
        """ONE verify dispatch advancing EVERY live row: row i feeds its
        pending next_token and then its drafts (counts[i] in all; 1 for
        rows without proposals) and gets the logits of each fed
        position.  A greedy row accepts the longest prefix of drafts
        that matches the model's own argmax chain plus the first
        corrected token; the pool rolls back past the accept point
        (un-registering prefix-index entries over rejected positions
        and copy-on-writing a kept shared tail).

        Returns True when the round ran; False after a transient verify
        fault, after which speculation stays off for this engine and
        the rows go on through the plain decode step.  A fault marked
        `fatal_to_engine` propagates."""
        C = self.model.verify_chunk
        bs = self.model.batch_slots
        tok = np.zeros((bs, C), np.int32)
        counts = np.zeros(bs, np.int32)
        for i, live in enumerate(self._slots):
            if live is None:
                continue
            tok[i, 0] = live.next_token
            counts[i] = 1
            d = props.get(i)
            if d:
                m = 1 + len(d)
                tok[i, 1:m] = d
                counts[i] = m
                # the drafts' blocks must exist BEFORE dispatch; the
                # admission reservation covers them
                self.pool.extend(live.seq_id, live.pos + m,
                                 written=live.pos)
                self._btab[i] = self.pool.table_row(live.seq_id)
        t0 = time.monotonic()
        try:
            logits = self.model.verify_step(
                tok, self._slens, counts, self._btab)
        except Exception as e:
            if getattr(e, "fatal_to_engine", False):
                raise
            # transient verify fault: DEGRADE, don't fail in-flight; a
            # state the fault consumed surfaces on the next plain step
            # and takes the _fail_inflight recovery
            self.spec_verify_faults += 1
            self._spec_broken = True
            if self._proposer is not None:
                self._proposer.reset()
            if self.registry is not None:
                self.registry.counter("serving/spec_verify_faults").inc()
            return False
        self._note_step_time(time.monotonic() - t0)
        self.batches_run += 1
        self.spec_rounds += 1
        if self._spec_t0 is None:
            self._spec_t0 = time.monotonic()
        if self._paged_kernel == "cuda":
            # C seq-1 forwards: each step j one kernel launch over the
            # rows still feeding
            tw = self.pool.max_blocks_per_seq
            blocks = 0
            for j in range(C):
                mask = counts > j
                if not mask.any():
                    break
                blocks += blocks_read(self._slens + j, mask, 1,
                                      self.pool.page_size, tw)
            self._note_kernel_reads(blocks, bs * tw * C)
        now = time.monotonic()
        for i, live in enumerate(self._slots):
            if live is None:
                continue
            m = int(counts[i])
            if live.pos < len(live.feed) - 1:
                # a mid-prefill row rode with its prompt token (m == 1),
                # as on the plain decode path
                live.pos += 1
                self.pool.note_written(live.seq_id, live.pos)
                live.next_token = live.feed[live.pos]
                self._tokens[i] = live.next_token
                self._slens[i] = live.pos
                continue
            # decode phase: walk the model's own token chain across the
            # fed positions; position j's output is valid iff every fed
            # token before it matched the chain
            out: List[int] = []
            for j in range(m):
                t = int(self._sample(logits[i, j], live))
                out.append(t)
                if self.eos_id >= 0 and t == self.eos_id:
                    break
                if j + 1 >= m or t != int(tok[i, j + 1]):
                    break
            emitted = len(out)
            proposed, accepted = m - 1, emitted - 1
            # watermark first (the dispatch wrote all m positions), then
            # roll the rejected positions back out
            self.pool.note_written(live.seq_id, live.pos + m)
            new_pos = live.pos + emitted
            if m > emitted:
                cow = self.pool.rollback(live.seq_id, new_pos)
                # the table shrank (and its kept tail block may have
                # been swapped by the COW): refresh the row BEFORE the
                # next dispatch can write through a stale block id
                self._btab[i] = self.pool.table_row(live.seq_id)
                if cow is not None:
                    try:
                        self.model.copy_block(*cow)
                    except Exception as e:
                        if getattr(e, "fatal_to_engine", False):
                            raise
                        # this row's KV is unsynced: fail it alone
                        self.pool.retire(live.seq_id)
                        if self._proposer is not None:
                            self._proposer.release(i)
                        live.req.error = e
                        live.req._settle()
                        self._slots[i] = None
                        self._free_slot_buffers(i)
                        continue
            live.pos = new_pos
            if proposed:
                self.spec_proposed += proposed
                self.spec_accepted += accepted
                live.req.spec_proposed += proposed
                live.req.spec_accepted += accepted
                self._adaptive.update(proposed, accepted)
                if self.registry is not None:
                    reg = self.registry
                    reg.counter("serving/spec_proposed").inc(proposed)
                    reg.counter("serving/spec_accepted").inc(accepted)
                    reg.histogram(
                        "serving/spec_accepted_per_round").observe(
                        accepted)
            if not live.generated:
                self._first_token(live, now)
            live.generated.extend(out)
            self.tokens_generated += emitted
            done = (len(live.generated) >= live.max_new
                    or (self.eos_id >= 0 and out[-1] == self.eos_id))
            if done:
                self._finish(i, live)
            else:
                live.next_token = out[-1]
                self._tokens[i] = out[-1]
                self._slens[i] = live.pos
        if self.registry is not None:
            self.registry.counter("serving/spec_rounds").inc()
        return True

    def _first_token(self, live: _Live, now: float) -> None:
        live.req.t_first_token = now
        with self._lat_lock:
            self._ttfts.append(now - live.req.t_submit)
        if self.registry is not None:
            self.registry.histogram("serving/ttft_ms").observe(
                (now - live.req.t_submit) * 1e3)

    def _decode_loop(self):
        page = self.pool.page_size
        while not self._stop.is_set():
            self._run_services()
            self._admit()
            if all(s is None for s in self._slots):
                if (self._draining and not self._waiting
                        and self._queue.empty()):
                    # drain complete: nothing live, nothing queued (a
                    # submit that raced the cutoff sits in _queue and
                    # was admitted above)
                    return
                # idle: park on the arrival queue instead of spinning
                try:
                    self._waiting.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    pass
                continue
            if self._chunk:
                # chunked prefill first: mid-prefill rows jump up to C
                # positions, then everyone takes the decode step below
                pre = [(i, live) for i, live in enumerate(self._slots)
                       if live is not None
                       and live.pos < len(live.feed) - 1]
                if pre and not self._prefill_chunk_step(pre):
                    continue
            for i, live in enumerate(self._slots):
                if live is None:
                    continue
                # crossing a page boundary: allocate the next block
                # (admission reserved it, so this cannot fail)
                if live.pos and live.pos % page == 0:
                    self.pool.extend(live.seq_id, live.pos + 1)
                    self._btab[i] = self.pool.table_row(live.seq_id)
            if self._spec != "off" and not self._spec_broken:
                props = self._spec_proposals()
                if props:
                    # speculative round: every live row rides ONE verify
                    # dispatch (drafted rows multi-token, the rest
                    # count 1)
                    if self._spec_round(props):
                        self._observe_step()
                    continue
                # no proposals anywhere: the plain decode step below
                self.spec_fallback_rounds += 1
            t0 = time.monotonic()
            try:
                logits = self.model.step(
                    self._tokens, self._slens, self._btab)
            except Exception as e:
                if getattr(e, "fatal_to_engine", False):
                    raise  # the engine is gone: _loop drains it
                self._fail_inflight(e)
                continue
            self._note_step_time(time.monotonic() - t0)
            self.batches_run += 1
            if self._paged_kernel == "cuda":
                self._note_kernel_reads(
                    blocks_read(
                        self._slens,
                        np.array([s is not None for s in self._slots]),
                        1, page, self.pool.max_blocks_per_seq),
                    self.model.batch_slots * self.pool.max_blocks_per_seq)
            now = time.monotonic()
            for i, live in enumerate(self._slots):
                if live is None:
                    continue
                live.pos += 1
                # keep the pool's written-token watermark current
                self.pool.note_written(live.seq_id, live.pos)
                if live.pos < len(live.feed):
                    # prefill: the next token is given, logits ignored
                    live.next_token = live.feed[live.pos]
                    self._tokens[i] = live.next_token
                    self._slens[i] = live.pos
                    continue
                tok = int(self._sample(logits[i], live))
                if not live.generated:
                    self._first_token(live, now)
                live.generated.append(tok)
                self.tokens_generated += 1
                done = (len(live.generated) >= live.max_new
                        or (self.eos_id >= 0 and tok == self.eos_id))
                if done:
                    self._finish(i, live)
                else:
                    live.next_token = tok
                    self._tokens[i] = tok
                    self._slens[i] = live.pos
            self._observe_step()

    def _sample(self, row_logits: np.ndarray, live: _Live) -> int:
        if live.req.temperature <= 0.0:  # greedy hot path: one argmax
            return int(row_logits.argmax())
        from ..models.transformer import sample_next

        return sample_next(row_logits[None], live.req.temperature,
                           live.rng)[0]

    def _finish(self, slot: int, live: _Live):
        if self._proposer is not None:
            self._proposer.release(slot)
        # the written token prefix (everything fed; excludes the final
        # sampled token, whose k/v never landed) keys the retired blocks
        # into the prefix cache
        self.pool.retire(
            live.seq_id,
            tokens=(live.req.prompt + live.generated)[:live.pos])
        self._slots[slot] = None
        self._free_slot_buffers(slot)
        req = live.req
        req.n_generated = len(live.generated)
        req.result = req.prompt + live.generated
        req.t_done = time.monotonic()
        with self._lat_lock:
            self._latencies.append(req.t_done - req.t_submit)
        self.requests_done += 1
        if self.registry is not None:
            reg = self.registry
            reg.counter("serving/requests_done").inc()
            reg.histogram("serving/request_latency_ms").observe(
                (req.t_done - req.t_submit) * 1e3)
            if req.n_generated > 1 and req.t_first_token is not None:
                reg.histogram("serving/per_token_ms").observe(
                    (req.t_done - req.t_first_token) * 1e3
                    / (req.n_generated - 1))
        req._settle()

    def _observe_step(self):
        if self._check_invariants:
            self.pool.check_invariants()
        if self.registry is None:
            return
        reg = self.registry
        live = [s for s in self._slots if s is not None]
        reg.counter("serving/steps").inc()
        reg.gauge("serving/queue_depth").set(
            self._queue.qsize() + len(self._waiting))
        reg.gauge("serving/live_sequences").set(len(live))
        reg.gauge("serving/kv_used_blocks").set(self.pool.used_blocks)
        reg.gauge("serving/kv_shared_blocks").set(self.pool.shared_blocks)
        reg.gauge("serving/kv_cached_blocks").set(self.pool.cached_blocks)
        ev = self.pool.prefix_evictions
        if ev > self._evictions_seen:
            reg.counter("serving/prefix_evictions").inc(
                ev - self._evictions_seen)
            self._evictions_seen = ev
        reg.histogram("serving/kv_occupancy").observe(self.pool.occupancy())
        reg.histogram("serving/kv_fragmentation").observe(
            self.pool.fragmentation())
        if self.spec_rounds and self._spec_t0 is not None:
            dt = time.monotonic() - self._spec_t0
            if dt > 0:
                reg.gauge("serving/spec_rounds_per_s").set(
                    round(self.spec_rounds / dt, 4))
