"""StrategyStore (flexflow_tpu/store/store.py): content-addressed
persistence for searched strategies.

Layout (one directory per key digest, under <root>/strategies/), the
reference's byte for byte in its file and field names, so that either
package's `entries()` lists the other's:

    <root>/strategies/<digest>/manifest.json   # key fields + provenance
    <root>/strategies/<digest>/strategy.json   # Strategy.to_json body
    <root>/kernel_cache/                       # built CUDA libraries

Writes are verify-then-publish: serialize into a process-unique tmp
dir, fsync, re-read and re-parse against the manifest digest, then one
atomic os.replace into the final name, so that a kill mid-write leaves
an ignorable tmp dir, never a torn entry.  Reads tolerate corruption:
an unreadable or digest-mismatched entry is a miss, and is quarantined
so that the follow-up search's publish repairs it.

The store is safe to share between processes on one filesystem: a
concurrent double publish of one key resolves to first-write-wins,
except that a publish carrying a strictly better `searched_cost`
replaces the incumbent (the best-cost upgrade).  Counters (store/hits,
store/misses, store/publishes, store/lookup_ms, ...) go to an optional
metrics registry with `counter(name).inc(n)` and
`histogram(name).observe(v)`; the port has none yet (obs/, ROADMAP §1
item 7), so compile passes None.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..checkpoint import _fsync_dir, _write_json_fsync
from ..logger import store_logger
from ..strategy import Strategy
from .blobstore import (
    BlobNotFound,
    BlobStore,
    BlobStoreError,
    rmtree_blob_prefix,
)
from .key import StoreKey, strategy_sha256

MANIFEST_VERSION = 1

#: gc() only sweeps .tmp-* staging dirs older than this — a young tmp
#: may be a LIVE concurrent publisher mid-write on the shared root
STALE_TMP_AGE_S = 3600.0


class StoreVerifyError(RuntimeError):
    """A publish failed its write-time re-read verification."""


def _json_safe(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {str(k): _json_safe(v) for k, v in obj.items()}
        return str(obj)


class RemoteStrategyMirror:
    """Fleet mirror of the strategy store on a BlobStore.

    Remote layout mirrors the local one: `strategies/<digest>/
    {manifest.json,strategy.json}`.  Reads verify the same invariants
    the local store does (manifest version, key digest, strategy
    sha256) and treat anything torn as a miss — a sha-mismatched pair
    is quarantined so the next publish repairs it.  Writes put
    strategy.json first, manifest.json last, and honor the best-cost
    upgrade policy against the REMOTE incumbent (strictly lower
    searched_cost replaces; everything else is first-write-wins).  The
    pair-write is lock-free like the local store: a concurrent push of
    the same key can tear the pair, which the next fetch detects and
    the next push repairs."""

    def __init__(self, blob: BlobStore, prefix: str = "strategies/"):
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        self.blob = blob
        self.prefix = prefix

    def _entry_prefix(self, digest: str) -> str:
        return f"{self.prefix}{digest}/"

    def fetch(self, digest: str):
        """(manifest dict, strategy.json text) for a verified remote
        entry, or None — unreadable/foreign-schema entries miss without
        deletion, genuinely torn pairs are quarantined."""
        prefix = self._entry_prefix(digest)
        try:
            manifest = json.loads(self.blob.get(prefix + "manifest.json"))
        except BlobNotFound:
            return None
        except (BlobStoreError, ValueError) as e:
            store_logger.info(
                "remote store entry %s unreadable (%s: %s): treating as "
                "a miss", digest[:16], type(e).__name__, e,
            )
            return None
        if manifest.get("manifest_version") != MANIFEST_VERSION:
            return None  # a newer reader's entry: never delete on a maybe
        try:
            text = self.blob.get(prefix + "strategy.json").decode("utf-8")
        except BlobNotFound:
            # writes land strategy.json BEFORE manifest.json, so a
            # manifest without its strategy is never mid-publish — it's
            # a quarantine that raced a concurrent push.  Left in place,
            # push()'s first-write-wins would honor the orphan manifest
            # forever; delete it so the next publish repairs the entry.
            store_logger.info(
                "remote store entry %s has a manifest but no strategy: "
                "quarantined, treating as a miss", digest[:16],
            )
            try:
                rmtree_blob_prefix(self.blob, prefix)
            except BlobStoreError:
                pass
            return None
        except (BlobStoreError, UnicodeDecodeError) as e:
            store_logger.info(
                "remote store entry %s unreadable (%s: %s): treating as "
                "a miss", digest[:16], type(e).__name__, e,
            )
            return None
        if (manifest.get("key_digest") != digest
                or strategy_sha256(text) != manifest.get("strategy_sha256")):
            store_logger.info(
                "remote store entry %s torn/mismatched: quarantined, "
                "treating as a miss", digest[:16],
            )
            try:
                rmtree_blob_prefix(self.blob, prefix)
            except BlobStoreError:
                pass
            return None
        return manifest, text

    def push(self, digest: str, manifest: Dict, text: str) -> bool:
        """Publish-through one locally-verified entry; returns True when
        the remote entry was (re)written.  First-write-wins against the
        remote incumbent, except a strictly better searched_cost."""
        prefix = self._entry_prefix(digest)
        existing = None
        try:
            existing = json.loads(self.blob.get(prefix + "manifest.json"))
        except BlobNotFound:
            pass
        except (BlobStoreError, ValueError):
            existing = None  # unreadable incumbent: repair it
        if existing is not None:
            new_cost = manifest.get("searched_cost")
            old_cost = existing.get("searched_cost")
            if not (new_cost is not None and old_cost is not None
                    and float(new_cost) < float(old_cost)):
                return False
        self.blob.put(prefix + "strategy.json", text.encode("utf-8"))
        self.blob.put(prefix + "manifest.json",
                      json.dumps(manifest).encode("utf-8"))
        return True


class StrategyStore:
    """Durable strategy artifacts keyed by StoreKey digests.

    `remote` (a RemoteStrategyMirror) adds the fleet tier: lookups
    consult local -> remote (a remote hit is verified, then
    materialized as a normal local entry so the NEXT lookup is local),
    and successful publishes mirror through, so a brand-new host warms
    from the fleet store before its first compile."""

    def __init__(self, root: str, registry=None, remote=None):
        self.root = os.path.abspath(root)
        self.registry = registry
        self.remote = remote
        os.makedirs(self.strategies_dir, exist_ok=True)

    @property
    def strategies_dir(self) -> str:
        return os.path.join(self.root, "strategies")

    @property
    def compilation_cache_dir(self) -> str:
        """Where --compilation-cache auto puts the built kernel
        libraries (ops/kernels/_build.py)."""
        return os.path.join(self.root, "kernel_cache")

    def _entry_dir(self, digest: str) -> str:
        return os.path.join(self.strategies_dir, digest)

    # -- metrics --------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        if self.registry is not None:
            self.registry.counter(f"store/{name}").inc(n)

    def _observe_ms(self, name: str, dt_s: float) -> None:
        if self.registry is not None:
            self.registry.histogram(f"store/{name}").observe(dt_s * 1e3)

    # -- lookup ---------------------------------------------------------
    def lookup(self, key: StoreKey) -> Optional[Strategy]:
        """Strategy for `key`, or None — consulting local THEN the
        fleet mirror.  A hit carries the manifest's provenance as
        strategy.search_stats with store_hit=True (remote hits add
        store_remote_hit=True); a verified remote hit is materialized
        as a local entry so later lookups never leave the host.
        Corrupt local entries are quarantined (removed) so the
        caller's post-search publish can repair them."""
        strategy = self._lookup_local(key)
        if strategy is not None or self.remote is None:
            return strategy
        return self._lookup_remote(key)

    def _lookup_remote(self, key: StoreKey) -> Optional[Strategy]:
        digest = key.digest
        try:
            fetched = self.remote.fetch(digest)
        except Exception as e:  # noqa: BLE001 — mirror failures never crash
            self._count("remote_errors")
            store_logger.info(
                "fleet mirror lookup failed for %s (%s: %s)",
                digest[:16], type(e).__name__, e,
            )
            return None
        if fetched is None:
            return None
        manifest, text = fetched
        try:
            strategy = Strategy.from_json(text)
        except Exception as e:  # noqa: BLE001 — verified sha, odd schema
            self._count("remote_errors")
            store_logger.info(
                "fleet mirror entry %s unparseable (%s)", digest[:16], e,
            )
            return None
        self._count("remote_hits")
        store_logger.info(
            "fleet mirror hit %s: strategy materialized locally",
            digest[:16],
        )
        # materialize through the normal verify-then-publish write so
        # the next lookup is local; mirror=False — it came FROM remote
        self.publish(
            key, strategy,
            searched_cost=manifest.get("searched_cost"),
            search_stats=manifest.get("search_stats"),
            created_at=manifest.get("created_at"),
            overwrite=True, mirror=False,
        )
        stats = dict(manifest.get("search_stats") or {})
        stats["store_hit"] = True
        stats["store_remote_hit"] = True
        stats["store_key"] = digest
        strategy.search_stats = stats
        if manifest.get("searched_cost") is not None:
            strategy.search_cost = manifest["searched_cost"]
        return strategy

    def _lookup_local(self, key: StoreKey) -> Optional[Strategy]:
        t0 = time.perf_counter()
        digest = key.digest
        d = self._entry_dir(digest)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            if manifest.get("manifest_version") != MANIFEST_VERSION:
                # a newer (or foreign) schema: valid for ITS readers —
                # miss without quarantining, never delete on a maybe
                store_logger.info(
                    "store entry %s has manifest_version %r (this "
                    "reader speaks %d): treating as a miss",
                    digest[:16], manifest.get("manifest_version"),
                    MANIFEST_VERSION,
                )
                self._count("misses")
                self._observe_ms("lookup_ms", time.perf_counter() - t0)
                return None
            if manifest.get("key_digest") != digest:
                raise StoreVerifyError(
                    f"manifest key_digest {manifest.get('key_digest')!r} "
                    f"!= directory digest {digest!r}"
                )
            with open(os.path.join(d, "strategy.json")) as f:
                text = f.read()
            if strategy_sha256(text) != manifest.get("strategy_sha256"):
                raise StoreVerifyError("strategy.json digest mismatch")
            strategy = Strategy.from_json(text)
        except FileNotFoundError:
            if not os.path.isdir(d):  # clean miss: no entry at all
                self._count("misses")
                self._observe_ms("lookup_ms", time.perf_counter() - t0)
                return None
            # entry dir exists but a file is gone: a half-entry would
            # block the publish (first-write-wins) forever — quarantine
            # it like any other corruption so the re-search repairs it
            store_logger.info(
                "store entry %s is missing files: quarantined, "
                "treating as a miss", digest[:16],
            )
            shutil.rmtree(d, ignore_errors=True)
            self._count("misses")
            self._count("corrupt_entries")
            self._observe_ms("lookup_ms", time.perf_counter() - t0)
            return None
        except OSError as e:
            # transient I/O (NFS ESTALE, EIO, a permissions blip): the
            # entry may be perfectly valid for every other reader —
            # miss WITHOUT quarantining, never delete on a maybe
            store_logger.info(
                "store entry %s unreadable (%s: %s): treating as a "
                "miss", digest[:16], type(e).__name__, e,
            )
            self._count("misses")
            self._observe_ms("lookup_ms", time.perf_counter() - t0)
            return None
        except Exception as e:
            # genuine corruption (torn write survivor, bit rot, digest
            # mismatch, a foreign/older schema): quarantine so the
            # follow-up search's publish repairs the key — never the
            # caller's problem either way
            store_logger.info(
                "corrupt store entry %s (%s: %s): quarantined, "
                "treating as a miss", digest[:16], type(e).__name__, e,
            )
            shutil.rmtree(d, ignore_errors=True)
            self._count("misses")
            self._count("corrupt_entries")
            self._observe_ms("lookup_ms", time.perf_counter() - t0)
            return None
        stats = dict(manifest.get("search_stats") or {})
        stats["store_hit"] = True
        stats["store_key"] = digest
        strategy.search_stats = stats
        if manifest.get("searched_cost") is not None:
            strategy.search_cost = manifest["searched_cost"]
        self._count("hits")
        self._observe_ms("lookup_ms", time.perf_counter() - t0)
        return strategy

    # -- publish --------------------------------------------------------
    def publish(
        self,
        key: StoreKey,
        strategy: Strategy,
        *,
        searched_cost: Optional[float] = None,
        search_stats: Optional[Dict] = None,
        created_at: Optional[float] = None,
        overwrite: bool = False,
        mirror: bool = True,
    ) -> bool:
        """Write-verify-rename one entry; returns True when the entry
        was (re)written, False when an existing entry was kept
        (first-write-wins) or the write failed survivably.  created_at
        is caller-supplied provenance (seconds since epoch).  A
        successful write publishes THROUGH to the fleet mirror when one
        is configured (mirror=False marks entries that came from it).

        Best-cost upgrade policy: a publish carrying a STRICTLY better
        (lower) `searched_cost` than the existing entry's replaces it —
        so a longer-budget search, or a serving replica's degraded-mesh
        re-search that beat the fleet entry, improves the shared store
        instead of being dropped on first-write-wins.  Equal or worse
        costs (and cost-less publishes) still lose to the incumbent."""
        digest = key.digest
        final = self._entry_dir(digest)
        upgrading = False
        if os.path.isdir(final) and not overwrite:
            if not self._upgrades_cost(final, searched_cost):
                return False
            overwrite = upgrading = True
            store_logger.info(
                "store entry %s: replacing with strictly better "
                "searched_cost %.6g", digest[:16], searched_cost,
            )
        text = strategy.to_json()
        manifest = {
            "manifest_version": MANIFEST_VERSION,
            "key_digest": digest,
            "key": key.manifest_fields(),
            "strategy_sha256": strategy_sha256(text),
            "searched_cost": (
                None if searched_cost is None else float(searched_cost)
            ),
            "search_stats": _json_safe(search_stats or {}),
            "created_at": (
                time.time() if created_at is None else float(created_at)
            ),
        }
        tmp = os.path.join(
            self.strategies_dir,
            f".tmp-{digest[:16]}-{os.getpid()}-{threading.get_ident()}",
        )
        try:
            os.makedirs(tmp)
            with open(os.path.join(tmp, "strategy.json"), "w") as f:
                f.write(text)
                f.flush()
                os.fsync(f.fileno())
            _write_json_fsync(os.path.join(tmp, "manifest.json"), manifest)
            self._verify_dir(tmp, digest)
            if (upgrading and os.path.isdir(final)
                    and not self._upgrades_cost(final, searched_cost)):
                # the incumbent changed while we serialized (a
                # concurrent publisher landed something at least as
                # good): dropping our copy keeps the best entry.  The
                # remaining replace-after-check window is microseconds
                # — an accepted cost of the lock-free shared store.
                shutil.rmtree(tmp, ignore_errors=True)
                return False
            if os.path.isdir(final):  # overwrite=True repair path
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_dir(self.strategies_dir)
        except FileExistsError:
            # a concurrent publisher beat us into the tmp or final name:
            # their verified entry serves the key; ours is redundant
            shutil.rmtree(tmp, ignore_errors=True)
            return False
        except (OSError, StoreVerifyError) as e:
            shutil.rmtree(tmp, ignore_errors=True)
            if isinstance(e, OSError) and os.path.isdir(final):
                # on Linux the concurrent-publish race surfaces as
                # ENOTEMPTY from os.replace, not FileExistsError: the
                # other writer's verified entry now serves the key —
                # benign first-write-wins, not a store failure
                return False
            self._count("publish_failures")
            store_logger.info(
                "store publish failed for %s (%s: %s); search result "
                "still used, entry not persisted",
                digest[:16], type(e).__name__, e,
            )
            return False
        self._count("publishes")
        if upgrading:  # counted only once the replacement actually landed
            self._count("best_cost_upgrades")
        if mirror and self.remote is not None:
            try:
                if self.remote.push(digest, manifest, text):
                    self._count("remote_publishes")
            except Exception as e:  # noqa: BLE001 — the mirror is an
                # accelerator for OTHER hosts; its failure never
                # un-publishes the verified local entry
                self._count("remote_errors")
                store_logger.info(
                    "fleet mirror publish failed for %s (%s: %s); local "
                    "entry intact", digest[:16], type(e).__name__, e,
                )
        return True

    def _upgrades_cost(self, entry_dir: str,
                       searched_cost: Optional[float]) -> bool:
        """True when `searched_cost` strictly beats the published
        entry's.  Unreadable/partial incumbents do NOT upgrade-replace
        here — lookup() owns quarantine policy (a transient I/O blip
        must not let a publish clobber a healthy entry)."""
        if searched_cost is None:
            return False
        try:
            with open(os.path.join(entry_dir, "manifest.json")) as f:
                existing = json.load(f).get("searched_cost")
        except (OSError, ValueError):
            return False
        return existing is not None and float(searched_cost) < float(existing)

    @staticmethod
    def _verify_dir(path: str, digest: str) -> None:
        """Re-read a staged entry and check manifest/strategy coherence
        (the checkpoint.py write-time verification discipline)."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("key_digest") != digest:
            raise StoreVerifyError("staged manifest key_digest mismatch")
        with open(os.path.join(path, "strategy.json")) as f:
            text = f.read()
        if strategy_sha256(text) != manifest.get("strategy_sha256"):
            raise StoreVerifyError("staged strategy.json digest mismatch")
        Strategy.from_json(text)  # must parse back

    # -- maintenance ----------------------------------------------------
    def entries(self) -> List[Tuple[str, Dict]]:
        """(digest, manifest) pairs, oldest created_at first; unreadable
        manifests are skipped (lookup() quarantines them on access)."""
        out = []
        try:
            names = os.listdir(self.strategies_dir)
        except OSError:
            return []
        for name in names:
            if name.startswith(".tmp-"):
                continue
            try:
                with open(os.path.join(self.strategies_dir, name,
                                       "manifest.json")) as f:
                    out.append((name, json.load(f)))
            except (OSError, ValueError):
                continue
        out.sort(key=lambda e: e[1].get("created_at", 0.0))
        return out

    def gc(self, keep_last: int) -> int:
        """Keep the `keep_last` newest entries by created_at, drop the
        rest (plus any stale tmp dirs); returns the number removed."""
        if keep_last < 0:
            raise ValueError(f"keep_last must be >= 0, got {keep_last}")
        removed = 0
        entries = self.entries()
        drop = entries[: max(0, len(entries) - keep_last)]
        for digest, _m in drop:
            shutil.rmtree(os.path.join(self.strategies_dir, digest),
                          ignore_errors=True)
            removed += 1
        try:
            now = time.time()
            for name in os.listdir(self.strategies_dir):
                if not name.startswith(".tmp-"):
                    continue
                p = os.path.join(self.strategies_dir, name)
                try:
                    age = now - os.path.getmtime(p)
                except OSError:
                    continue  # the publisher just renamed it away
                if age > STALE_TMP_AGE_S:
                    # old enough that its writer is dead, not mid-write
                    shutil.rmtree(p, ignore_errors=True)
        except OSError:
            pass
        if removed:
            self._count("gc_removed", removed)
        return removed

    def import_strategy(self, key: StoreKey, path: str, *,
                        created_at: Optional[float] = None,
                        overwrite: bool = False, **meta) -> bool:
        """Promote an on-disk Strategy JSON into a store entry:
        Strategy.load stays the compatibility surface, the store gains a
        verified, key-addressed copy."""
        strategy = Strategy.load(path)
        stats = dict(meta.pop("search_stats", {}) or {})
        stats.setdefault("imported_from", os.path.basename(path))
        return self.publish(
            key, strategy, search_stats=stats, created_at=created_at,
            overwrite=overwrite, **meta,
        )
