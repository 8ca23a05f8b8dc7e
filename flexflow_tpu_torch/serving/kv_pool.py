"""Paged KV-cache pool accounting (the vLLM PagedAttention design,
SOSP'23, on the host side), with a PREFIX CACHE and copy-on-write
block sharing (the RadixAttention idea, SGLang arXiv:2312.07104).

The port's own copy of flexflow_tpu/serving/kv_pool.py: host numpy,
the same accounting step for step, so both packages give identical
tables over the same request sequence, the KV export / adopt half
(cross-replica migration and mid-decode handoff) included.

The device holds per-layer block pools ([num_blocks, page, heads, d]
state tensors built by `make_gpt_decoder(kv_page_size=...)`); this
module is the single source of truth for WHICH physical block belongs
to WHICH sequence.  All layers allocate in lockstep (every layer's
cache has the same sequence structure), so one free list and one block
table per scheduler slot cover the whole model.

Accounting protocol (no mid-flight OOM by construction):

* **Admission reserves, extension allocates.**  `try_admit` checks the
  sequence's WORST-CASE block need (ceil((plen + max_new) / page))
  against unreserved capacity and either books it or refuses — a full
  pool queues requests, it never crashes mid-decode.  Physical blocks
  are then popped lazily by `extend` as the sequence actually grows
  (allocate-on-extend), so a short reply never pins its worst case and
  `used_blocks` tracks real occupancy.
* **Retire frees — into the prefix cache.**  `retire` drops every
  block's refcount the moment a sequence finishes.  Blocks whose
  content is indexed under a token-prefix key stay CACHED (refcount 0,
  LRU-evictable) instead of returning to the free list; everything
  else frees immediately.  Capacity pressure reclaims cached blocks
  on demand, so caching never refuses an admission the free list
  alone could have served.
* **Prefix sharing.**  The pool keys every FULL (block-aligned) token
  prefix it has seen — registered live as prompt blocks fill, and at
  retirement for the generated suffix — to the physical block holding
  that prefix's last page.  Keys are ROLLING HASHES extended one page
  per block boundary (O(plen) admission-key builds, not the exact-key
  O(plen^2/page)); every hit is verified exactly through the entry's
  parent chain + per-page bytes before any block is shared, so the
  collision-free story is unchanged (see _PrefixEntry).
  `try_admit(prompt=...)` matches the
  longest indexed prefix of the new prompt and maps the request's
  table directly onto the shared physical blocks (refcount++), so
  those tokens skip prefill entirely.  Shared blocks are IMMUTABLE by
  construction: the scatter-at-own-position write path only ever
  targets positions past the shared region, except for a full-prompt
  hit, where the write at plen-1 re-lands in the last shared block —
  `ensure_writable` copy-on-writes that block (fresh private copy,
  refcount--) before the scheduler feeds the token, so no block with
  refcount > 1 (or an index entry) is ever written.
* **Block 0 is scratch.**  Idle scheduler slots point their table at
  block 0; their per-step garbage writes land there and are never
  attendable (masked by seq_len 0), so scratch never needs zeroing.

The pool tracks per-sequence token counts itself (`extend` sees every
growth), so `occupancy()`/`fragmentation()` cannot drift from the
tables under sharing — callers no longer pass scheduler-side counts.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

SCRATCH_BLOCK = 0

# rolling prefix hash (index keys): 61-bit Mersenne-prime modulus
# polynomial hash, extended one PAGE at a time so building every
# block-boundary key of a plen-token prompt costs O(plen) total
# instead of the exact-bytes key's O(plen^2/page).  Collisions cannot
# corrupt matches: every index hit is verified exactly (see
# _PrefixEntry) before any block is shared.
_HASH_MOD = (1 << 61) - 1
_HASH_BASE = 1_000_003
_HASH_EMPTY = 0


def _hash_block(h: int, tokens: Sequence[int]) -> int:
    """Extend the rolling prefix hash `h` over one page of tokens —
    O(page) per block boundary (the unit the linear-admission test
    counts)."""
    for t in tokens:
        h = (h * _HASH_BASE + int(t) + 1) % _HASH_MOD
    return h


def _page_bytes(tokens: Sequence[int]) -> bytes:
    """Exact int32 bytes of ONE page — the per-boundary verification
    payload (compact: entries store one page each, not the whole
    prefix)."""
    return np.asarray(tokens, np.int32).tobytes()


class _PrefixEntry:
    """One indexed block boundary: the physical block holding the
    prefix's last page, keyed by the rolling hash of the FULL prefix.

    The collision-free story of the old exact-bytes keys is preserved
    by construction, not by hash width: entries chain through `parent`
    (the entry for the one-page-shorter prefix, fixed at registration),
    and a match walk accepts boundary j only when (a) the hash hits,
    (b) the entry's parent IS the entry object verified at j-1, and
    (c) the entry's last-page bytes equal the prompt's page j exactly.
    By induction the accepted chain's content equals the prompt's
    prefix byte for byte — each comparison is O(page), so a full match
    of a plen-token prompt verifies in O(plen)."""

    __slots__ = ("key", "block", "parent", "page_bytes")

    def __init__(self, key: int, block: int,
                 parent: Optional["_PrefixEntry"],
                 page_bytes: bytes):
        self.key = key
        self.block = block
        self.parent = parent
        self.page_bytes = page_bytes


class PoolExhausted(Exception):
    """Internal invariant breach: extend() needed a block the
    admission reservation did not cover.  Seeing this means the
    accounting is wrong — callers must never trigger it."""


class KVPool:
    """Host-side block accounting for the paged decode twin.

    num_blocks counts the PHYSICAL pool including the scratch block;
    usable capacity is num_blocks - 1.  max_blocks_per_seq is the
    table width (decode_max_seq // page for the bit-identical gather).
    prefix_cache=False turns sharing off (no index, no refcount
    sharing, retire frees immediately).
    """

    def __init__(self, num_blocks: int, page_size: int,
                 max_blocks_per_seq: int, prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks {num_blocks} < 2 (scratch + at least one "
                "usable block)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_blocks_per_seq < 1:
            raise ValueError(
                f"max_blocks_per_seq must be >= 1, got "
                f"{max_blocks_per_seq}")
        self.num_blocks = int(num_blocks)
        self.page_size = int(page_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.prefix_cache = bool(prefix_cache)
        # LIFO free list: recently-freed blocks are re-used first (their
        # pool rows are the likeliest to still be in cache)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}   # seq id -> block ids
        self._reserved: Dict[int, int] = {}       # seq id -> max PRIVATE
        self._ref: Dict[int, int] = {}            # block -> live tables
        # prefix index: rolling hash of a FULL block-aligned token
        # prefix -> its _PrefixEntry (block + exact per-page
        # verification chain); _block_key maps block -> hash for
        # eviction.  _chain tracks each live sequence's verified entry
        # chain so registration extends it in O(page) per boundary.
        self._index: Dict[int, _PrefixEntry] = {}
        self._block_key: Dict[int, int] = {}
        self._chain: Dict[int, List[_PrefixEntry]] = {}
        # refcount-0 indexed blocks, LRU order (oldest first)
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # per-seq sharing bookkeeping
        self._shared_of: Dict[int, Set[int]] = {}  # shared-mapped blocks
        self._shared_pin: Dict[int, int] = {}      # block -> sharing seqs
        self._hit_tokens: Dict[int, int] = {}      # matched at admission
        self._prompt: Dict[int, List[int]] = {}    # for live indexing
        self._indexed_upto: Dict[int, int] = {}    # blocks registered
        self._tokens_of: Dict[int, int] = {}       # current token count
        self.peak_used = 0
        self.peak_shared = 0
        self.prefix_hits = 0          # admissions with a non-empty match
        self.prefix_hit_tokens = 0    # total tokens served from cache
        self.prefix_evictions = 0     # cached blocks reclaimed (LRU)
        self.prefix_invalidations = 0  # blocks dropped by a state reset
        self.cow_copies = 0           # tail blocks copy-on-written
        self.prefix_imports = 0           # adopt_prefix calls that landed
        self.prefix_imported_blocks = 0   # blocks adopted from migrations
        # the scheduler worker mutates the pool while /v2/stats reads
        # it from HTTP threads — iteration over _tables must not race
        # a retire()'s pop
        self._lock = threading.Lock()

    # -- capacity ---------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def used_blocks(self) -> int:
        """Physical blocks referenced by >= 1 live table — shared
        blocks counted ONCE.  Cached (refcount-0) blocks are
        reclaimable, so they are neither used nor free."""
        return self.usable_blocks - len(self._free) - len(self._cached)

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def shared_blocks(self) -> int:
        """Distinct physical blocks currently shared-mapped by at
        least one live sequence."""
        return len(self._shared_pin)

    @property
    def reserved_blocks(self) -> int:
        with self._lock:  # /v2/stats reads while the worker admits
            return sum(self._reserved.values())

    def blocks_for(self, tokens: int) -> int:
        """ceil(tokens / page): blocks a sequence of that length needs."""
        return max(1, -(-int(tokens) // self.page_size))

    # -- prefix index (internal; callers hold self._lock) ----------------
    def _match_prefix(self, prompt: Sequence[int]
                      ) -> Tuple[List[int], List["_PrefixEntry"]]:
        """Longest indexed block-aligned prefix of `prompt`, as the
        physical block chain plus the verified entries (walks
        progressively: every sub-prefix of a registered chain was
        registered with it).  O(plen) total: one _hash_block extension
        and one page-bytes compare per boundary — see _PrefixEntry for
        why this is exactly as collision-free as the byte keys."""
        page = self.page_size
        blocks: List[int] = []
        entries: List[_PrefixEntry] = []
        h = _HASH_EMPTY
        parent: Optional[_PrefixEntry] = None
        for j in range(1, len(prompt) // page + 1):
            seg = prompt[(j - 1) * page:j * page]
            h = _hash_block(h, seg)
            e = self._index.get(h)
            if e is None or e.parent is not parent \
                    or e.page_bytes != _page_bytes(seg):
                break
            blocks.append(e.block)
            entries.append(e)
            parent = e
        return blocks, entries

    def _register(self, seq_id: int, tokens: Sequence[int]) -> None:
        """Index every not-yet-registered FULL block of seq_id whose
        page is covered by `tokens` (the sequence's written prefix),
        extending the sequence's verified entry chain one page-hash at
        a time.  First key wins — when the prefix is already indexed
        (same bytes, verified), the existing entry is adopted into the
        chain and this sequence's duplicate block stays
        private-unindexed, freeing normally at retirement.  A FOREIGN
        hash hit (a different prefix colliding, or a chain broken by a
        mid-chain eviction + re-registration) stops indexing this
        sequence for good rather than ever sharing unverified bytes."""
        if not self.prefix_cache:
            return
        page = self.page_size
        table = self._tables[seq_id]
        chain = self._chain.setdefault(seq_id, [])
        b = self._indexed_upto.get(seq_id, 0)
        if b != len(chain):
            return  # invalidation sentinel / previously stopped chain
        while (b + 1) * page <= len(tokens) and b < len(table):
            seg = tokens[b * page:(b + 1) * page]
            h = _hash_block(chain[-1].key if chain else _HASH_EMPTY, seg)
            parent = chain[-1] if chain else None
            e = self._index.get(h)
            if e is not None:
                if e.parent is parent and e.page_bytes == _page_bytes(seg):
                    chain.append(e)
                    b += 1
                    continue
                b = self.max_blocks_per_seq + 1  # foreign: stop for good
                break
            blk = table[b]
            if blk in self._block_key:
                b = self.max_blocks_per_seq + 1
                break
            e = _PrefixEntry(h, blk, parent, _page_bytes(seg))
            self._index[h] = e
            self._block_key[blk] = h
            chain.append(e)
            b += 1
        self._indexed_upto[seq_id] = b

    def _evict_lru(self) -> None:
        blk, _ = self._cached.popitem(last=False)
        key = self._block_key.pop(blk)
        del self._index[key]
        self._free.append(blk)
        self.prefix_evictions += 1
        # longer-prefix entries chained through the evicted one are now
        # unreachable (the match walk stops at the missing parent);
        # their blocks remain LRU-evictable like any cached block

    def _pop_free(self) -> int:
        """A free physical block, reclaiming the LRU cached block under
        capacity pressure (the reservation discipline guarantees one of
        the two sources is non-empty)."""
        if not self._free:
            if not self._cached:
                raise PoolExhausted(
                    "no free or cached block available — the admission "
                    "accounting is wrong")
            self._evict_lru()
        return self._free.pop()

    def invalidate_prefix_cache(self) -> None:
        """Drop every index entry and free all cached blocks — called
        after a device-state reset (a failed step zeroes the pools, so
        cached bytes are garbage).  Live blocks keep their tables; any
        live index entries are dropped too (their content is suspect)."""
        with self._lock:
            for blk in list(self._cached):
                self._free.append(blk)
                # NOT prefix_evictions: that counter means capacity
                # pressure (operators size the pool from it) — a
                # fault-driven invalidation is its own signal
                self.prefix_invalidations += 1
            self._cached.clear()
            self._index.clear()
            self._block_key.clear()
            self._chain.clear()  # every entry object is dead now
            for sid in self._indexed_upto:
                # sentinel past any possible table: live survivors (if
                # any) never re-register their suspect content; new
                # sequences re-populate the index
                self._indexed_upto[sid] = self.max_blocks_per_seq + 1

    # -- lifecycle --------------------------------------------------------
    def try_admit(self, seq_id: int, max_tokens: int,
                  prompt: Optional[Sequence[int]] = None,
                  cow_ok: bool = True) -> bool:
        """Reserve worst-case capacity for a new sequence.  False means
        the pool cannot guarantee the sequence will finish — the caller
        keeps it queued and retries after the next retirement.

        With `prompt` given and the prefix cache on, the longest
        indexed block-aligned prefix is mapped straight into the new
        table (refcount++ per block) and `admit_hit_tokens` reports how
        many tokens skip prefill.  A FULL-prompt hit keeps its last
        shared block only when `cow_ok` (the engine can copy-on-write a
        device block); otherwise the match drops one block so the tail
        is re-prefilled privately."""
        if seq_id in self._reserved:
            raise ValueError(f"sequence {seq_id} already admitted")
        need = self.blocks_for(max_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence {seq_id} needs {need} blocks > table width "
                f"{self.max_blocks_per_seq} (prompt + max_new_tokens "
                f"exceed decode_max_seq)")
        with self._lock:  # raw sum: the lock is not reentrant
            matched: List[int] = []
            entries: List[_PrefixEntry] = []
            full_hit = False
            if self.prefix_cache and prompt is not None:
                matched, entries = self._match_prefix(prompt)
                full_hit = bool(matched) and \
                    len(matched) * self.page_size == len(prompt)
                if full_hit and not cow_ok:
                    matched.pop()  # tail re-prefilled privately instead
                    entries.pop()
                    full_hit = False
            # private worst case: blocks drawn from the free pool —
            # everything past the shared prefix, plus the COW copy of
            # the tail block on a full-prompt hit
            need_priv = need - len(matched) + (1 if full_hit else 0)
            # shared blocks are pinned (unevictable while mapped), so
            # they consume capacity alongside the reservations.  A
            # block both live-private elsewhere and shared here double
            # counts — conservative, never an undercount.
            pinned = set(self._shared_pin) | set(matched)
            if sum(self._reserved.values()) + need_priv + len(pinned) \
                    > self.usable_blocks:
                return False
            self._reserved[seq_id] = need_priv
            self._tables[seq_id] = list(matched)
            self._shared_of[seq_id] = set(matched)
            for blk in matched:
                self._cached.pop(blk, None)  # revive from the cache
                self._ref[blk] = self._ref.get(blk, 0) + 1
                self._shared_pin[blk] = self._shared_pin.get(blk, 0) + 1
            hit = len(matched) * self.page_size
            self._hit_tokens[seq_id] = hit
            self._prompt[seq_id] = (list(int(t) for t in prompt)
                                    if prompt is not None else [])
            self._indexed_upto[seq_id] = len(matched)
            self._chain[seq_id] = list(entries)
            self._tokens_of[seq_id] = hit
            if matched:
                self.prefix_hits += 1
                self.prefix_hit_tokens += hit
            if self.shared_blocks > self.peak_shared:
                self.peak_shared = self.shared_blocks
        return True

    def admit_hit_tokens(self, seq_id: int) -> int:
        """Tokens of seq_id's prompt served from the prefix cache at
        admission (block-aligned; the scheduler skips their prefill)."""
        with self._lock:
            return self._hit_tokens.get(seq_id, 0)

    def cached_prefix_tokens(self, prompt: Sequence[int]) -> int:
        """Read-only probe: tokens of `prompt` the cache would serve if
        admitted now (admission control discounts them — cached tokens
        cost zero prefill steps).  Does not touch LRU order."""
        if not self.prefix_cache:
            return 0
        with self._lock:
            return len(self._match_prefix(prompt)[0]) * self.page_size

    def ensure_writable(self, seq_id: int, pos: int
                        ) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard for the scatter at position `pos`: if
        the target block is shared (refcount > 1) or its content is
        index-pinned, swap a fresh private copy into the table and
        return (src, dst) so the engine copies the device bytes.
        Returns None when the write is already safe.  Only a
        full-prompt hit can reach a shared tail block, but the guard is
        total: NO write path ever touches a block another table or the
        index still vouches for."""
        with self._lock:
            table = self._tables[seq_id]
            bi = pos // self.page_size
            if bi >= len(table):
                return None  # block not allocated yet: fresh by nature
            blk = table[bi]
            if self._ref.get(blk, 0) <= 1 and blk not in self._block_key:
                return None
            dst = self._pop_free()
            table[bi] = dst
            self._ref[dst] = 1
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                del self._ref[blk]
                if blk in self._block_key:
                    self._cached[blk] = None  # back to the LRU cache
                else:
                    self._free.append(blk)
            shared = self._shared_of[seq_id]
            if blk in shared:
                shared.discard(blk)
                n = self._shared_pin[blk] - 1
                if n:
                    self._shared_pin[blk] = n
                else:
                    del self._shared_pin[blk]
            self.cow_copies += 1
            if self.used_blocks > self.peak_used:
                self.peak_used = self.used_blocks
            return blk, dst

    def extend(self, seq_id: int, tokens: int,
               written: Optional[int] = None) -> List[int]:
        """Grow seq_id's table to cover `tokens` total tokens; returns
        the block ids allocated by THIS call (allocate-on-extend).
        `written` is how many tokens are already in the cache (defaults
        to tokens - 1, the one-token decode step's invariant; chunked
        prefill passes its own) — every full PROMPT block it covers is
        registered in the prefix index."""
        with self._lock:
            table = self._tables[seq_id]
            need = self.blocks_for(tokens)
            shared = len(self._shared_of[seq_id])
            if need - shared > self._reserved[seq_id]:
                raise PoolExhausted(
                    f"sequence {seq_id} grew to {need - shared} private "
                    f"blocks past its reservation of "
                    f"{self._reserved[seq_id]}")
            grown = []
            while len(table) < need:
                blk = self._pop_free()
                self._ref[blk] = 1
                table.append(blk)
                grown.append(blk)
            done = (int(tokens) - 1) if written is None else int(written)
            self._tokens_of[seq_id] = max(
                self._tokens_of.get(seq_id, 0), done)
            prompt = self._prompt.get(seq_id) or []
            if prompt and done > 0:
                self._register(seq_id, prompt[:min(done, len(prompt))])
            if self.used_blocks > self.peak_used:
                self.peak_used = self.used_blocks
            return grown

    def note_written(self, seq_id: int, tokens: int) -> None:
        """Advance seq_id's written-token watermark — the scheduler
        calls this after every step that lands tokens (per-row decode
        advance and the chunked-prefill path), so freshly filled
        prompt blocks join the prefix index immediately and
        fragmentation stays truthful between block boundaries.  Hot
        path: the registration sweep only runs when a NEW full prompt
        block is actually covered."""
        with self._lock:
            if seq_id not in self._tables:
                return
            n = int(tokens)
            if n > self._tokens_of.get(seq_id, 0):
                self._tokens_of[seq_id] = n
            prompt = self._prompt.get(seq_id) or []
            if prompt:
                covered = min(n, len(prompt)) // self.page_size
                if self._indexed_upto.get(seq_id, 0) < covered:
                    self._register(seq_id, prompt[:min(n, len(prompt))])

    def retire(self, seq_id: int,
               tokens: Optional[Sequence[int]] = None) -> None:
        """Drop the sequence: refcount-- on every block.  Blocks whose
        content is indexed stay CACHED (refcount 0, LRU-evictable);
        the rest free immediately.  `tokens` — the sequence's full
        written token list (prompt + generated prefix) — lets the
        generated suffix's full blocks join the prefix index too (k/v
        bytes are a pure function of the token prefix, so a future
        prompt extending this completion hits them)."""
        with self._lock:
            if self.prefix_cache and tokens is not None \
                    and seq_id in self._tables:
                self._register(seq_id, list(int(t) for t in tokens))
            table = self._tables.pop(seq_id)
            for blk in self._shared_of.pop(seq_id, ()):
                n = self._shared_pin.get(blk, 0) - 1
                if n > 0:
                    self._shared_pin[blk] = n
                else:
                    self._shared_pin.pop(blk, None)
            for blk in table:
                self._ref[blk] -= 1
                if self._ref[blk] == 0:
                    del self._ref[blk]
                    if blk in self._block_key:
                        # most-recently-retired = most-recently-used
                        self._cached[blk] = None
                        self._cached.move_to_end(blk)
                    else:
                        self._free.append(blk)
            del self._reserved[seq_id]
            self._hit_tokens.pop(seq_id, None)
            self._prompt.pop(seq_id, None)
            self._indexed_upto.pop(seq_id, None)
            self._chain.pop(seq_id, None)
            self._tokens_of.pop(seq_id, None)

    def rollback(self, seq_id: int, tokens: int
                 ) -> Optional[Tuple[int, int]]:
        """Truncate a LIVE sequence's written positions to a watermark
        of `tokens` — the speculative-decoding reject path and the KV
        import-fallback unwind.  Blocks past the watermark leave the
        table (refcount--, freed or re-cached like retirement); index
        entries this sequence registered for boundaries the watermark
        no longer covers are unregistered, so a future prompt can never
        match content that is about to be overwritten.  The kept
        partial tail block is made writable: if another table or a
        surviving index entry still vouches for it, it is copy-on-
        written and the (src, dst) device copy is returned for the
        engine to perform; otherwise None.  The admission reservation
        is untouched (worst case was booked up front), so the sequence
        can re-extend to its original ceiling."""
        with self._lock:
            if seq_id not in self._tables:
                raise ValueError(f"sequence {seq_id} not admitted")
            tokens = int(tokens)
            shared_tok = len(self._shared_of[seq_id]) * self.page_size
            if tokens < shared_tok:
                raise ValueError(
                    f"rollback to {tokens} would cut into the shared-"
                    f"mapped prefix ({shared_tok} tokens) of sequence "
                    f"{seq_id}")
            if tokens > self._tokens_of.get(seq_id, 0):
                raise ValueError(
                    f"rollback watermark {tokens} is past sequence "
                    f"{seq_id}'s written count "
                    f"{self._tokens_of.get(seq_id, 0)}")
            page = self.page_size
            table = self._tables[seq_id]
            keep = -(-tokens // page)  # ceil; 0 tokens keeps no blocks
            new_indexed = tokens // page
            # unregister OUR chain entries past the new watermark (an
            # adopted entry — another sequence's block — stays: its
            # content is still globally valid)
            chain = self._chain.get(seq_id, [])
            own = set(table) - self._shared_of[seq_id]
            for e in chain[new_indexed:]:
                if e.block in own and self._index.get(e.key) is e:
                    del self._index[e.key]
                    self._block_key.pop(e.block, None)
                    self.prefix_invalidations += 1
            del chain[new_indexed:]
            if self._indexed_upto.get(seq_id, 0) <= \
                    self.max_blocks_per_seq:
                self._indexed_upto[seq_id] = new_indexed
            # drop the uncovered blocks (shared region is below the
            # watermark by the guard above, so these are all private)
            for blk in reversed(table[keep:]):
                self._ref[blk] -= 1
                if self._ref[blk] == 0:
                    del self._ref[blk]
                    if blk in self._block_key:
                        self._cached[blk] = None
                        self._cached.move_to_end(blk)
                    else:
                        self._free.append(blk)
            del table[keep:]
            self._tokens_of[seq_id] = tokens
            # the kept partial tail block will be rewritten at
            # positions >= tokens — copy-on-write it if anything else
            # still vouches for its content
            copy = None
            if tokens % page and keep <= len(table) and keep >= 1:
                blk = table[keep - 1]
                if self._ref.get(blk, 0) > 1 or blk in self._block_key:
                    dst = self._pop_free()
                    table[keep - 1] = dst
                    self._ref[dst] = 1
                    self._ref[blk] -= 1
                    if self._ref[blk] == 0:
                        del self._ref[blk]
                        if blk in self._block_key:
                            self._cached[blk] = None
                        else:
                            self._free.append(blk)
                    shared = self._shared_of[seq_id]
                    if blk in shared:
                        shared.discard(blk)
                        n = self._shared_pin[blk] - 1
                        if n:
                            self._shared_pin[blk] = n
                        else:
                            del self._shared_pin[blk]
                    self.cow_copies += 1
                    copy = (blk, dst)
            if self.used_blocks > self.peak_used:
                self.peak_used = self.used_blocks
            return copy

    def live_sequences(self) -> List[int]:
        with self._lock:
            return list(self._tables)

    # -- KV block export / import (cross-replica migration) ---------------
    def export_prefix(self, prompt: Sequence[int]
                      ) -> Tuple[List[int], List[List[int]]]:
        """(blocks, pages) for the longest indexed block-aligned prefix
        of `prompt`: the physical block ids whose device bytes a
        migration should stream, plus the token page each one holds.
        Verified through the entry chain exactly like admission — a
        hash collision can never export foreign bytes.  Caller must be
        on the scheduler worker thread (the only mutator), so the ids
        stay valid until the device read completes."""
        if not self.prefix_cache:
            return [], []
        page = self.page_size
        with self._lock:
            blocks, _ = self._match_prefix(prompt)
            pages = [list(int(t) for t in prompt[j * page:(j + 1) * page])
                     for j in range(len(blocks))]
            return blocks, pages

    def export_live(self, seq_id: int, tokens: Sequence[int]
                    ) -> Tuple[List[int], List[List[int]]]:
        """(blocks, pages) for a LIVE sequence's written KV state —
        prompt *and* generated blocks, including the partial tail page
        (a mid-decode handoff ships the whole generation, not just the
        indexed prefix).  `tokens` is the written token prefix the
        caller is snapshotting; it must not exceed the sequence's
        written watermark (exporting unwritten device bytes would
        stream garbage).  The last page may be sub-page; the adopter
        lands full pages through adopt_prefix and the tail directly
        into the resumed sequence's private block.  Caller must be on
        the scheduler worker thread (the only mutator), so the ids
        stay valid until the device read completes."""
        page = self.page_size
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                raise KeyError(f"sequence {seq_id} is not live")
            n = len(tokens)
            written = self._tokens_of.get(seq_id, 0)
            if n > written:
                raise ValueError(
                    f"cannot export {n} tokens of sequence {seq_id}: "
                    f"only {written} are written")
            nb = -(-n // page)  # ceil: the tail page may be partial
            blocks = list(table[:nb])
            pages = [list(int(t) for t in tokens[j * page:(j + 1) * page])
                     for j in range(nb)]
            return blocks, pages

    def adopt_prefix(self, prompt: Sequence[int], n_blocks: int
                     ) -> List[Tuple[int, int]]:
        """Admit a migrated prefix into THIS pool as shared cached
        blocks: walk the first `n_blocks` block-aligned pages of
        `prompt`, reusing any boundary already indexed (identical
        bytes — the device content is a pure function of the token
        prefix) and allocating a fresh refcount-0 cached block for each
        missing one.  Returns the (boundary, block) pairs whose device
        bytes the caller must write BEFORE the next admission runs —
        both happen on the scheduler worker thread, so no request can
        map a block whose bytes have not landed.  Stops early (partial
        adoption is still a prefix, so still valid) on a foreign hash
        hit or when the pool has no reclaimable block left."""
        if not self.prefix_cache:
            return []
        page = self.page_size
        pairs: List[Tuple[int, int]] = []
        with self._lock:
            h = _HASH_EMPTY
            parent: Optional[_PrefixEntry] = None
            chain_blocks: set = set()  # this adoption's own blocks
            for j in range(min(int(n_blocks), len(prompt) // page)):
                seg = prompt[j * page:(j + 1) * page]
                h = _hash_block(h, seg)
                e = self._index.get(h)
                if e is not None:
                    if e.parent is not parent \
                            or e.page_bytes != _page_bytes(seg):
                        break  # foreign collision: never share unverified
                    if e.block in self._cached:
                        self._cached.move_to_end(e.block)  # keep chain hot
                    chain_blocks.add(e.block)
                    parent = e
                    continue
                if not self._free and all(
                        b in chain_blocks for b in self._cached):
                    # the only evictable blocks are this chain's own
                    # (LRU would cannibalize a boundary we just
                    # adopted): partial adoption, still a valid prefix
                    break
                blk = self._pop_free()
                chain_blocks.add(blk)
                e = _PrefixEntry(h, blk, parent, _page_bytes(seg))
                self._index[h] = e
                self._block_key[blk] = h
                self._cached[blk] = None
                self._cached.move_to_end(blk)
                pairs.append((j, blk))
                parent = e
            self.prefix_imported_blocks += len(pairs)
            if pairs:
                self.prefix_imports += 1
        return pairs

    def drop_adopted(self, blocks: Sequence[int]) -> None:
        """Unwind adopt_prefix after a failed device write: unregister
        the entries and free the blocks, so no admission can ever map a
        block whose bytes never landed."""
        with self._lock:
            for blk in blocks:
                if blk in self._cached:
                    del self._cached[blk]
                    key = self._block_key.pop(blk, None)
                    if key is not None:
                        self._index.pop(key, None)
                    self._free.append(blk)

    def table_of(self, seq_id: int) -> List[int]:
        with self._lock:
            return list(self._tables[seq_id])

    def table_row(self, seq_id: Optional[int]) -> np.ndarray:
        """[max_blocks_per_seq] int32 row for the device block table;
        unallocated (and idle-slot) entries point at scratch."""
        row = np.full(self.max_blocks_per_seq, SCRATCH_BLOCK, np.int32)
        if seq_id is not None:
            with self._lock:
                table = list(self._tables[seq_id])
            row[:len(table)] = table
        return row

    # -- telemetry --------------------------------------------------------
    def occupancy(self) -> float:
        """Fraction of usable blocks held by live sequences (shared
        blocks counted once; cached blocks are reclaimable and do not
        count)."""
        return self.used_blocks / self.usable_blocks

    def fragmentation(self) -> float:
        """Internal fragmentation: fraction of live-allocated slots not
        holding a written token.  Computed from the pool's OWN
        per-sequence token counts (tracked by extend), so it cannot
        drift from the tables — shared full blocks never waste; only
        each sequence's private tail can."""
        with self._lock:
            alloc = self.used_blocks * self.page_size
            if not alloc:
                return 0.0
            waste = 0
            for sid, table in self._tables.items():
                shared = len(self._shared_of.get(sid, ()))
                priv_alloc = (len(table) - shared) * self.page_size
                priv_tokens = max(
                    0, self._tokens_of.get(sid, 0)
                    - shared * self.page_size)
                waste += max(0, priv_alloc - min(priv_tokens, priv_alloc))
        return waste / alloc

    def prefix_stats(self) -> Dict[str, int]:
        """Prefix-cache telemetry block for /v2/stats and the bench."""
        with self._lock:
            return {
                "hits": self.prefix_hits,
                "hit_tokens": self.prefix_hit_tokens,
                "shared_blocks": len(self._shared_pin),
                "cached_blocks": len(self._cached),
                "evictions": self.prefix_evictions,
                "invalidations": self.prefix_invalidations,
                "cow_copies": self.cow_copies,
                "imports": self.prefix_imports,
                "imported_blocks": self.prefix_imported_blocks,
                "peak_shared_blocks": self.peak_shared,
            }

    def check_invariants(self) -> None:
        """Every block is exactly one of: scratch, free, cached
        (refcount 0 + indexed), or live — and every physical block's
        refcount equals the number of live tables referencing it, with
        cached blocks disjoint from free blocks.  Raises AssertionError
        on leaks, double-frees, or refcount drift (tested property)."""
        with self._lock:
            refcount: Dict[int, int] = {}
            for table in self._tables.values():
                seen = set()
                for blk in table:
                    assert blk not in seen, "block twice in one table"
                    seen.add(blk)
                    refcount[blk] = refcount.get(blk, 0) + 1
            assert SCRATCH_BLOCK not in refcount, "scratch block allocated"
            assert refcount == self._ref, (
                f"refcount drift: tables say {refcount}, "
                f"pool says {self._ref}")
            free = set(self._free)
            cached = set(self._cached)
            assert len(free) == len(self._free), "double-freed block"
            assert not (free & set(refcount)), \
                "block both free and allocated"
            assert not (cached & free), "cached block also free"
            assert not (cached & set(refcount)), \
                "cached block has live references"
            assert free | cached | set(refcount) | {SCRATCH_BLOCK} == \
                set(range(self.num_blocks)), "block leaked"
            assert self.used_blocks == len(refcount)
            for blk in cached:
                assert blk in self._block_key, "cached block unindexed"
                # a cached block, adopted ones (adopt_prefix) included,
                # is reachable through its own index entry: an unwound
                # adoption (drop_adopted) leaves neither half behind
                entry = self._index.get(self._block_key[blk])
                assert entry is not None and entry.block == blk, \
                    "cached block not reachable through the index"
            for key, entry in self._index.items():
                assert entry.key == key, "entry keyed under wrong hash"
                assert self._block_key.get(entry.block) == key, \
                    "index/block_key mismatch"
                assert entry.block not in free, \
                    "indexed block on the free list"
                assert len(entry.page_bytes) == 4 * self.page_size, \
                    "entry verification payload is not one page"
            for sid, table in self._tables.items():
                shared = self._shared_of.get(sid, set())
                assert shared <= set(table), "shared block not in table"
                assert len(table) - len(shared) <= self._reserved[sid], \
                    "over-reservation"
            pin: Dict[int, int] = {}
            for shared in self._shared_of.values():
                for blk in shared:
                    pin[blk] = pin.get(blk, 0) + 1
            assert pin == self._shared_pin, "shared-pin drift"
