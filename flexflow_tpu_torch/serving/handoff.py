"""Resumable decode handoff (flexflow_tpu/serving/handoff.py): an
in-flight generation as an object that can move.

The scheduler can pause a generation at a step boundary and settle its
handle with :class:`HandoffPaused`, which carries what the generation
needs to go on elsewhere:

* a host-side :class:`ResumeRecord` (prompt and generated tokens, the
  KV write position, the request's sampling seed and the exact host RNG
  state), enough on its own to resume by chunked-prefill REPLAY of
  prompt + generated, and
* optionally the sequence's exported KV blocks (prompt and generated,
  the partial tail page included) for a live handoff that streams them
  as FFKV frames (serving/kv_transfer.py), so that the destination
  adopts them instead of recomputing.

Replay is exact by construction: the generated tokens are fed again as
prompt (the KV bytes are a function of the token prefix and the
weights), and a sampled row restores the captured
``numpy.random.RandomState`` state before its next draw, so the
continuation equals the uninterrupted run token for token.  Every
handoff fault degrades to replay; the front counts each kind under
``serving/handoff_fault_{kind}``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

#: fault kinds a live handoff can degrade on: each has its own
#: serving/handoff_fault_{kind} counter and falls back to replay
HANDOFF_FAULTS = ("torn", "header", "fabric", "capacity", "dest_death")


class ResumeRecord:
    """Host-side snapshot of an in-flight generation, taken at a step
    boundary (pause) or at replica death (the tokens live on the host,
    so a dead device cannot tear them)."""

    __slots__ = ("prompt", "generated", "written", "seed",
                 "temperature", "rng_state", "kv_tail", "page_size")

    def __init__(self, prompt: Sequence[int], generated: Sequence[int],
                 written: int, seed: int, temperature: float,
                 rng_state: Any = None, kv_tail: Optional[Dict] = None,
                 page_size: int = 0):
        self.prompt = list(prompt)
        self.generated = list(generated)
        # KV tokens written at capture: always < len(prompt) +
        # len(generated), since the newest token is the next step's feed
        self.written = int(written)
        self.seed = int(seed)
        self.temperature = float(temperature)
        # numpy RandomState.get_state() (None when greedy), restored
        # before the first draw after the resume: a replay draws nothing
        # for the re-fed tokens
        self.rng_state = rng_state
        # the partial tail block's arrays when a live handoff verified
        # them on the wire (full pages adopt through the prefix cache;
        # a sub-page tail has no cache key, so it lands in the resumed
        # sequence's own private block)
        self.kv_tail = kv_tail
        self.page_size = int(page_size)

    def replay_tokens(self) -> List[int]:
        """The feed of the resume admission: the prompt and every token
        generated before the pause, fed again as prompt."""
        return self.prompt + self.generated

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"ResumeRecord(plen={len(self.prompt)}, "
                f"gen={len(self.generated)}, written={self.written}, "
                f"tail={'yes' if self.kv_tail is not None else 'no'})")


class HandoffPaused(Exception):
    """Settled into a scheduler handle when its generation is paused for
    handoff.  Not a failure: the front streams the exported blocks to a
    destination replica (optionally) and requeues the request with the
    resume record attached, spending no retry."""

    def __init__(self, record: ResumeRecord,
                 pages: Optional[List[List[int]]] = None,
                 arrays: Optional[List[Dict]] = None,
                 page_size: int = 0):
        super().__init__(
            f"generation paused for handoff ({len(record.generated)} "
            f"tokens generated, {record.written} KV tokens written)")
        self.record = record
        #: token pages (the last may be partial) and the host arrays of
        #: each block; None when the pause exported nothing (a
        #: replay-only resume)
        self.pages = pages
        self.arrays = arrays
        self.page_size = int(page_size)


def classify_handoff_fault(reason: Optional[str],
                           exc: Optional[BaseException] = None) -> str:
    """Map a migrator failure reason (KVMigrator's on_done detail) onto
    the fault kinds of HANDOFF_FAULTS."""
    reason = reason or ""
    if reason == "torn" or "no block verified" in reason:
        return "torn"
    if reason == "header":
        return "header"
    if reason == "capacity":
        return "capacity"
    if reason in ("device write", "target gone", "target closed",
                  "migrator closed"):
        return "dest_death"
    if reason == "transfer":
        # a mangled frame raises KVTransferError (header or crc damage);
        # anything else is the fabric itself failing
        from .kv_transfer import KVTransferError

        if isinstance(exc, KVTransferError):
            return "header"
        return "fabric"
    return "fabric"
