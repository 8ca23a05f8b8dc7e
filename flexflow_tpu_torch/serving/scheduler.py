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
and `stats()["paged_kernel"]["formulation"]` says which ran.  Left out
of this slice: speculative decoding, mid-decode handoff, drain and
request tracing.
"""
from __future__ import annotations

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
    cache's copy-on-write.  The KV pools are updated in place; only the
    scheduler's worker thread calls these methods."""

    def __init__(self, ff_train, batch_slots: int = 8,
                 page_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 0, prefix_cache: bool = True):
        from ..decoding import (_gpt_dims, build_paged_copy_block,
                                build_paged_decode_step,
                                build_paged_prefill_step, make_gpt_decoder)

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
        self.device = self.ffd.device
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
        self._state = self.ffd._state
        # bytes of ONE physical block summed across every layer's k/v
        # pool: the unit of the kernel-read counters
        self.kv_block_bytes = sum(
            v[0].numel() * v.element_size()
            for entries in self._state.values()
            for k, v in entries.items() if k in ("k_cache", "v_cache"))

    def _ints(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, np.int32), device=self.device)

    def reset(self):
        """Zero the decode state in place (fault recovery).  The
        scheduler invalidates the pool's prefix index right after."""
        with torch.no_grad():
            for entries in self._state.values():
                for v in entries.values():
                    v.zero_()

    def step(self, tokens: np.ndarray, seq_lens: np.ndarray,
             block_tables: np.ndarray) -> np.ndarray:
        logits, self._state = self._step_fn(
            self.ffd._weights, self._state, self._ints(tokens),
            self._ints(seq_lens), self._ints(block_tables))
        return logits.float().cpu().numpy()

    def prefill_step(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray) -> None:
        """Chunked prefill: scatter tokens[b, C] at positions[b]..+C-1
        into the pool.  No logits come back."""
        self._state = self._prefill_fn(
            self.ffd._weights, self._state, self._ints(tokens),
            self._ints(positions), self._ints(block_tables))

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: clone physical block src -> dst in every
        layer's k/v pool, ordered with the steps on the device's
        stream."""
        self._state = self._copy_fn(self._state, int(src), int(dst))


class _PendingSeq:
    """Future-style handle for one request, with the SLO timestamps:
    submit, first generated token (TTFT), done."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "seed",
                 "event", "result", "error", "t_submit", "t_first_token",
                 "t_done", "n_generated", "prefix_hit_tokens",
                 "_settle_lock", "_settled")

    def __init__(self, prompt, max_new_tokens, temperature, seed):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.event = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[Exception] = None
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.n_generated = 0
        self.prefix_hit_tokens = 0  # prompt tokens served from cache
        self._settle_lock = threading.Lock()
        self._settled = False

    def _settle(self) -> None:
        """Wake the waiter exactly once, even when close() races the
        worker's own drain."""
        with self._settle_lock:
            if self._settled:
                return
            self._settled = True
        self.event.set()

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self.event.wait(timeout):
            raise TimeoutError("generation request timed out")
        if self.error is not None:
            raise self.error
        return self.result


class _Live:
    """Slot-resident decoding state for one admitted sequence.  `start`
    > 0 means a prefix-cache hit: positions [0, start) are already in
    shared KV blocks and never prefill."""

    __slots__ = ("req", "seq_id", "pos", "next_token", "generated",
                 "max_new", "rng")

    def __init__(self, req: _PendingSeq, seq_id: int, max_new: int,
                 start: int = 0):
        self.req = req
        self.seq_id = seq_id
        self.pos = start                      # tokens already in the cache
        self.next_token = req.prompt[start]   # token fed at position pos
        self.generated: List[int] = []
        self.max_new = max_new                # clamped to the position table
        self.rng = (np.random.RandomState(req.seed)
                    if req.temperature > 0.0 else None)


class ContinuousScheduler:
    """Persistent decode loop with iteration-level admission/retirement.
    `batches_run` counts decode steps (the unit of batching is the
    step); generate / generate_async / latency_stats / stats / close
    are the client API serve_http drives."""

    def __init__(self, model: PagedKVDecodeModel,
                 pool: Optional[KVPool] = None, eos_id: int = -1,
                 seed: int = 0, check_invariants: bool = False):
        self.model = model
        self.pool = pool or KVPool(
            model.num_blocks, model.page_size, model.max_blocks_per_seq,
            prefix_cache=model.prefix_cache)
        self._chunk = model.prefill_chunk
        # kernel-read counters: physical blocks the paged-attention
        # kernel read vs what the dense gather formulation would have
        # materialized for the same dispatches (counted when the kernel
        # runs, i.e. on a CUDA device)
        self._paged_kernel = model.paged_kernel
        self._kv_block_bytes = model.kv_block_bytes
        self.kernel_blocks_read = 0
        self.kernel_dense_blocks = 0
        self._check_invariants = bool(check_invariants)
        self.prefill_steps = 0
        self.eos_id = int(eos_id)
        self._queue: "queue.Queue[_PendingSeq]" = queue.Queue()
        self._waiting: deque = deque()  # worker-local FIFO admit order
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
                     seed: int = 0, prefill_chunk: int = 0,
                     prefix_cache: bool = True,
                     check_invariants: bool = False,
                     ) -> "ContinuousScheduler":
        model = PagedKVDecodeModel(ff_train, batch_slots=batch_slots,
                                   page_size=page_size,
                                   num_blocks=num_blocks,
                                   prefill_chunk=prefill_chunk,
                                   prefix_cache=prefix_cache)
        return cls(model, eos_id=eos_id, seed=seed,
                   check_invariants=check_invariants)

    # -- client API -----------------------------------------------------
    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 temperature: float = 0.0,
                 timeout: Optional[float] = 60.0) -> List[int]:
        return self.generate_async(
            prompt, max_new_tokens, temperature).wait(timeout)

    def generate_async(self, prompt, max_new_tokens: int = 16,
                       temperature: float = 0.0,
                       seed=None) -> _PendingSeq:
        if self._stop.is_set():
            raise RuntimeError("ContinuousScheduler is closed")
        p = _PendingSeq(prompt, max_new_tokens, temperature,
                        next(self._seed) if seed is None else int(seed))
        if not 1 <= len(p.prompt) < self.model.max_seq:
            raise ValueError(
                f"prompt length {len(p.prompt)} outside [1, "
                f"{self.model.max_seq})")
        if p.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._queue.put(p)
        if self._stop.is_set():  # close() raced the put
            p.error = RuntimeError("ContinuousScheduler is closed")
            p._settle()
        return p

    @property
    def worker_alive(self) -> bool:
        return self._worker.is_alive()

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
            timeout_s = _CLOSE_TIMEOUT_S
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

    def _drain(self, err: Exception):
        """Fail every queued/waiting/live request (close or fault)."""
        for i, s in enumerate(self._slots):
            if s is not None:
                try:
                    self.pool.retire(s.seq_id)
                except KeyError:
                    pass  # the racing drain already freed it
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

    def _admit(self):
        """Pull arrivals, then admit FIFO into free slots while the pool
        can GUARANTEE completion (a head-of-line request that does not
        fit blocks later ones).  Admission maps the longest indexed
        block-aligned prefix of the prompt onto shared blocks; a
        FULL-prompt hit still re-runs the last prompt token for its
        logits, so the pool copy-on-writes its tail block first."""
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break
        free = [i for i, s in enumerate(self._slots) if s is None]
        while free and self._waiting:
            req = self._waiting[0]
            plen = len(req.prompt)
            max_new = min(req.max_new_tokens, self.model.max_seq - plen)
            sid = self._next_seq_id
            try:
                admitted = self.pool.try_admit(
                    sid, plen + max_new, prompt=req.prompt)
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
                break
            self._waiting.popleft()
            self._next_seq_id += 1
            hit = self.pool.admit_hit_tokens(sid)
            start = min(hit, plen - 1)
            req.prefix_hit_tokens = hit
            cow = self.pool.ensure_writable(sid, start)
            if cow is not None:
                try:
                    self.model.copy_block(*cow)
                except Exception as e:
                    # fail the admitting request alone
                    self.pool.retire(sid)
                    req.error = e
                    req._settle()
                    continue
            live = _Live(req, sid, max_new, start=start)
            slot = free.pop(0)
            self._slots[slot] = live
            # first private block (or a no-op after a full hit)
            self.pool.extend(sid, start + 1, written=start)
            self._btab[slot] = self.pool.table_row(sid)
            self._tokens[slot] = live.next_token
            self._slens[slot] = start

    def _loop(self):
        """Thread body: run the decode loop, then drain no matter how it
        exited, so a crash fails pending requests at once (and leaves
        worker_alive False for the /v2/health degraded check)."""
        err: Exception = RuntimeError("ContinuousScheduler closed")
        try:
            self._decode_loop()
        except Exception as e:  # scheduler bug / pool invariant breach
            err = e
            self._stop.set()
        self._drain(err)

    def _fail_inflight(self, e: Exception):
        """Step fault: fail in-flight only; queued requests survive on
        the same engine."""
        self.step_failures += 1
        for i, live in enumerate(self._slots):
            if live is None:
                continue
            self.pool.retire(live.seq_id)
            live.req.error = e
            live.req._settle()
            self._slots[i] = None
            self._free_slot_buffers(i)
        # a step that died mid-execution may have left the pools half
        # written: zero them, and drop the prefix index whose bytes
        # were zeroed with them
        self.model.reset()
        self.pool.invalidate_prefix_cache()

    def _note_step_time(self, dt_s: float) -> None:
        ms = dt_s * 1e3
        self.step_ms_ewma = (ms if self.step_ms_ewma == 0.0
                             else 0.9 * self.step_ms_ewma + 0.1 * ms)

    def _note_kernel_reads(self, blocks: int, dense_blocks: int):
        self.kernel_blocks_read += blocks
        self.kernel_dense_blocks += dense_blocks

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
            plen = len(live.req.prompt)
            upto = min(live.pos + C, plen - 1)
            self.pool.extend(live.seq_id, upto, written=live.pos)
            self._btab[i] = self.pool.table_row(live.seq_id)
            tok[i, :upto - live.pos] = live.req.prompt[live.pos:upto]
            slen[i] = live.pos
            btab[i] = self._btab[i]
            plan.append((i, live, upto))
        t0 = time.monotonic()
        try:
            self.model.prefill_step(tok, slen, btab)
        except Exception as e:
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
            live.next_token = live.req.prompt[live.pos]
            self._tokens[i] = live.next_token
            self._slens[i] = live.pos
        if self._check_invariants:
            self.pool.check_invariants()
        return True

    def _decode_loop(self):
        page = self.pool.page_size
        while not self._stop.is_set():
            self._admit()
            if all(s is None for s in self._slots):
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
                       and live.pos < len(live.req.prompt) - 1]
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
            t0 = time.monotonic()
            try:
                logits = self.model.step(
                    self._tokens, self._slens, self._btab)
            except Exception as e:
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
                if live.pos < len(live.req.prompt):
                    # prefill: the next token is given, logits ignored
                    live.next_token = live.req.prompt[live.pos]
                    self._tokens[i] = live.next_token
                    self._slens[i] = live.pos
                    continue
                tok = int(self._sample(logits[i], live))
                if not live.generated:
                    live.req.t_first_token = now
                    with self._lat_lock:
                        self._ttfts.append(now - live.req.t_submit)
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
            if self._check_invariants:
                self.pool.check_invariants()

    def _sample(self, row_logits: np.ndarray, live: _Live) -> int:
        if live.req.temperature <= 0.0:  # greedy hot path: one argmax
            return int(row_logits.argmax())
        from ..models.transformer import sample_next

        return sample_next(row_logits[None], live.req.temperature,
                           live.rng)[0]

    def _finish(self, slot: int, live: _Live):
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
        req._settle()
