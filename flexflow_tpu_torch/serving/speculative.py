"""Speculative decoding proposers for the continuous engine
(flexflow_tpu/serving/speculative.py).

Decode throughput is bounded by one dispatch per generated token per
slot.  Speculation (Leviathan et al., arXiv:2211.17192) breaks that
bound at temperature 0 without changing a single output token: a cheap
PROPOSER guesses up to k continuation tokens per eligible slot, the
target model scores all of them in ONE verify dispatch
(decoding.build_paged_verify_step: a loop of the seq-1 decode forward,
so the per-position logits are bit-identical to stepping one token at
a time), and the scheduler accepts the longest prefix whose tokens
match the target's own greedy choices plus the first corrected token.
Rejected positions roll back out of the KV pool (KVPool.rollback:
un-registers any prefix-index entries covering them and copy-on-writes
a kept shared tail).

Two proposers:

* `NGramProposer`: prompt-lookup decoding.  The longest suffix n-gram
  of the request's own prompt+generated tokens is matched against its
  most recent earlier occurrence and the tokens that followed it are
  proposed.  Host-only, no device cost.

* `DraftModelProposer`: a smaller GPT from the same builder running
  through its OWN paged decode engine (an independent
  PagedKVDecodeModel + KVPool; on a CUDA device every draft step reads
  its pool through the paged-attention kernel).  The draft engine
  catches up to each slot's accepted context (re-feeding divergent
  tails after a rejection, via its own pool rollback) and then
  free-runs k greedy steps.  Any draft fault permanently degrades to
  "no proposals": the engine falls back to plain decode, never dies on
  the drafter's account, and the fault shows in `stats()`
  (`draft_faults`, `dead`).

`AdaptiveK` shrinks the per-round draft length toward 1 when measured
acceptance is poor and grows it back toward spec_k when drafts are
landing.

The proposer contract (`propose(contexts, k, limits)`) is BATCHED: one
call per decode round with every eligible slot's context, so a draft
model services all slots with shared batched dispatches.  This module
is host code: the same classes as the reference's, on the port's own
KVPool.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .kv_pool import KVPool

__all__ = ["Proposer", "NGramProposer", "DraftModelProposer",
           "AdaptiveK", "build_proposer"]


class Proposer:
    """Interface a speculative proposer implements.  All methods are
    called from the scheduler's worker thread only."""

    def propose(self, contexts: Dict[int, List[int]], k: int,
                limits: Optional[Dict[int, int]] = None,
                ) -> Dict[int, List[int]]:
        """One decode round's drafts.  `contexts[slot]` is the slot's
        full accepted token sequence (prompt + generated so far);
        `limits[slot]` bounds the total tokens the slot's sequence may
        ever reach (prompt + max_new + k, clamped to the position
        table).  Returns up to k draft tokens per slot; slots may be
        omitted (no proposal this round — they ride the round as plain
        one-token decode)."""
        raise NotImplementedError

    def release(self, slot: int) -> None:
        """The slot's request finished/failed — drop any per-slot
        drafter state."""

    def reset(self) -> None:
        """The engine reset (transient fault recovery): drop ALL
        drafter state.  Called before the engine resumes decoding."""

    def stats(self) -> Dict:
        return {}


class NGramProposer(Proposer):
    """Prompt-lookup decoding: propose the continuation of the MOST
    RECENT earlier occurrence of the context's longest suffix n-gram,
    preferring longer n-grams (max_ngram down to min_ngram).  Stateless
    across rounds — the context IS the state."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_window: int = 4096):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        # lookback bound so one pathological context cannot make a
        # round's host time quadratic in the position table
        self.max_window = int(max_window)

    def _lookup(self, ctx: Sequence[int], k: int) -> List[int]:
        n_ctx = len(ctx)
        lo = max(0, n_ctx - self.max_window)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if n_ctx <= n:
                continue
            pat = list(ctx[n_ctx - n:])
            # scan right-to-left: the most recent match's continuation
            # is the likeliest to still be the live pattern
            for s in range(n_ctx - n - 1, lo - 1, -1):
                if list(ctx[s:s + n]) == pat:
                    cont = ctx[s + n:s + n + k]
                    if cont:
                        return [int(t) for t in cont]
                    break  # suffix match with no continuation room
        return []

    def propose(self, contexts, k, limits=None):
        out: Dict[int, List[int]] = {}
        for slot, ctx in contexts.items():
            d = self._lookup(ctx, k)
            if d:
                out[slot] = d
        return out


class _DraftSeq:
    """Per-slot draft-engine bookkeeping: the draft pool sequence, the
    tokens actually FED into it (KV positions 0..len(hist)-1), the
    greedy drafts minted beyond the accepted context, and the slot's
    lifetime token cap."""

    __slots__ = ("seq", "hist", "cap")

    def __init__(self, seq: int, cap: int):
        self.seq = seq
        self.hist: List[int] = []
        self.cap = int(cap)


class DraftModelProposer(Proposer):
    """Drafts with a smaller GPT through its own paged decode engine.

    `draft_model` is a PagedKVDecodeModel (or anything with its step
    contract) built from the SAME builder family as the target: its
    vocab must match (draft argmax ids are proposed verbatim), its
    position table must cover the target's, and it must have at least
    as many batch slots (draft rows mirror engine slots 1:1).

    Round shape: `propose` first RECONCILES each slot — the draft
    pool rolls back to the longest prefix its fed history shares with
    the slot's accepted context (a rejected draft tail, or a plain
    round's correction, simply re-feeds from the divergence point) —
    then catches up and free-runs greedy draft steps, all slots
    batched per dispatch.  Catch-up is bounded per round
    (`dispatch_budget`): a slot with a long un-fed prompt yields no
    proposals for a round or two instead of stalling every other
    slot's verify cadence.

    Fault posture: the draft engine is UNSUPERVISED — any exception
    from a draft dispatch marks the proposer dead (empty proposals
    forever) and the serving engine continues as a plain decoder.
    reset() revives it from zeroed pools."""

    def __init__(self, draft_model, dispatch_budget: int = 32):
        self.model = draft_model
        self.pool = KVPool(draft_model.num_blocks,
                           draft_model.page_size,
                           draft_model.max_blocks_per_seq,
                           prefix_cache=False)
        self.dispatch_budget = max(4, int(dispatch_budget))
        self._st: Dict[int, _DraftSeq] = {}
        self._next_seq = 0
        self._dead = False
        self.draft_steps = 0      # draft-engine dispatches, lifetime
        self.draft_faults = 0

    # -- slot lifecycle -------------------------------------------------
    def _ensure(self, slot: int, ctx: Sequence[int],
                limit: Optional[int]) -> Optional[_DraftSeq]:
        st = self._st.get(slot)
        if st is not None:
            return st
        cap = min(int(limit) if limit else self.model.max_seq,
                  self.model.max_seq)
        if cap <= len(ctx):
            return None  # no room to even re-feed the last token
        seq = self._next_seq
        if not self.pool.try_admit(seq, cap, prompt=None):
            return None  # draft pool full: retry after a release
        self._next_seq += 1
        st = _DraftSeq(seq, cap)
        self._st[slot] = st
        return st

    def release(self, slot: int) -> None:
        st = self._st.pop(slot, None)
        if st is not None:
            try:
                self.pool.retire(st.seq)
            except KeyError:
                pass

    def reset(self) -> None:
        for slot in list(self._st):
            self.release(slot)
        try:
            reset = getattr(self.model, "reset", None)
            if reset is not None:
                reset()
        except Exception:  # noqa: BLE001 — reviving is best-effort
            return
        self._dead = False

    def _reconcile(self, st: _DraftSeq, ctx: Sequence[int]) -> None:
        """Roll the draft sequence back to the longest prefix of `ctx`
        it has actually fed — capped at len(ctx)-1 so the context's
        final token is always (re-)fed this round, because ITS logits
        seed the first draft.  Re-fed positions rewrite byte-identical
        KV (same program, same inputs), so no copy is ever needed."""
        lcp = 0
        for a, b in zip(st.hist, ctx):
            if a != int(b):
                break
            lcp += 1
        target = min(lcp, len(ctx) - 1)
        if len(st.hist) > target:
            self.pool.rollback(st.seq, target)
            del st.hist[target:]

    # -- the round ------------------------------------------------------
    def propose(self, contexts, k, limits=None):
        if self._dead or k < 1 or not contexts:
            return {}
        limits = limits or {}
        bs = self.model.batch_slots
        active: Dict[int, List[int]] = {}
        for slot, ctx in contexts.items():
            if slot >= bs:
                continue  # geometry mismatch guard (validated upstream)
            st = self._ensure(slot, ctx, limits.get(slot))
            if st is None:
                continue
            self._reconcile(st, [int(t) for t in ctx])
            active[slot] = [int(t) for t in ctx]
        drafts: Dict[int, List[int]] = {slot: [] for slot in active}
        tw = self.pool.max_blocks_per_seq
        try:
            for _ in range(self.dispatch_budget):
                tok = np.zeros(bs, np.int32)
                slen = np.zeros(bs, np.int32)
                btab = np.zeros((bs, tw), np.int32)
                feeding = []
                for slot, ctx in active.items():
                    st = self._st[slot]
                    fed = len(st.hist)
                    if fed < len(ctx):
                        nxt = ctx[fed]          # catch-up
                    elif (len(drafts[slot]) < k and drafts[slot]
                          and fed < min(st.cap, self.model.max_seq)):
                        nxt = drafts[slot][-1]  # free-run its own draft
                    else:
                        continue                # slot done this round
                    self.pool.extend(st.seq, fed + 1, written=fed)
                    btab[slot] = self.pool.table_row(st.seq)
                    tok[slot] = nxt
                    slen[slot] = fed
                    feeding.append((slot, nxt))
                if not feeding:
                    break
                logits = self.model.step(tok, slen, btab)
                self.draft_steps += 1
                for slot, nxt in feeding:
                    st = self._st[slot]
                    st.hist.append(nxt)
                    self.pool.note_written(st.seq, len(st.hist))
                    if len(st.hist) >= len(active[slot]):
                        # this dispatch scored the context's last token
                        # (first draft) or a fed draft (the next one)
                        drafts[slot].append(int(logits[slot].argmax()))
        except Exception:  # noqa: BLE001 — draft faults NEVER kill the
            # serving engine: degrade to plain decode permanently
            # (reset() revives after an engine-level recovery)
            self._dead = True
            self.draft_faults += 1
            return {}
        return {slot: d[:k] for slot, d in drafts.items() if d}

    def stats(self) -> Dict:
        return {
            "draft_steps": self.draft_steps,
            "draft_faults": self.draft_faults,
            "dead": self._dead,
            "live_draft_seqs": len(self._st),
        }


class AdaptiveK:
    """Acceptance-rate-adaptive draft length: an EWMA of per-round
    acceptance (accepted drafts / proposed drafts) shrinks k toward 1
    below `lo` and grows it back toward k_max above `hi`.  A workload
    the proposer cannot predict therefore costs at most ONE wasted
    verify position per round — speculation is never materially worse
    than plain decode."""

    def __init__(self, k_max: int, ewma: float = 0.4,
                 lo: float = 0.2, hi: float = 0.6):
        self.k_max = max(1, int(k_max))
        self.k = self.k_max
        self.rate = 1.0  # optimistic start: first rounds draft fully
        self._ewma = float(ewma)
        self._lo = float(lo)
        self._hi = float(hi)

    def update(self, proposed: int, accepted: int) -> None:
        if proposed <= 0:
            return
        r = accepted / proposed
        self.rate = (1.0 - self._ewma) * self.rate + self._ewma * r
        if self.rate < self._lo and self.k > 1:
            self.k -= 1
        elif self.rate > self._hi and self.k < self.k_max:
            self.k += 1


def build_proposer(spec_decode: str, draft_model=None) -> Proposer:
    """Proposer for a validated spec_decode mode (the scheduler's
    build hook).  "draft" requires the draft engine to exist — missing
    it is a build-time ConfigError, not a silent fallback."""
    from ..config import ConfigError

    if spec_decode == "ngram":
        return NGramProposer()
    if spec_decode == "draft":
        if draft_model is None:
            raise ConfigError(
                "--spec-decode draft needs a draft model: build the "
                "engine with a draft twin (ContinuousScheduler."
                "from_trained(..., draft_ff=<smaller GPT>) or "
                "PagedKVDecodeModel(draft_model=...)) or use "
                "--spec-decode ngram")
        return DraftModelProposer(draft_model)
    raise ConfigError(
        f"no proposer for spec_decode mode {spec_decode!r}")
