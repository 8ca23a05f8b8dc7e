"""Cross-replica KV block streaming (flexflow_tpu/serving/kv_transfer.py):
the FFKV frame, the fabrics it crosses and the migrator that adopts it.

A migration ships a sequence's written KV blocks from one replica's pool
into another's, so that the destination admits it as a prefix-cache hit
instead of running the tokens again.  The wire unit is the physical
block: every layer's [page, heads, d] k/v page of one block, read from
the card to the host once on the exporting worker thread
(PagedKVDecodeModel.export_block), crc32-stamped per block and keyed by
the pool's rolling-hash prefix key, the key admission verifies against,
so a torn or foreign payload is never admitted as shared content.

The frame is byte-compatible with the reference's: the same magic,
version, JSON header keys, schema names `<op>/<k_cache|v_cache>` and
crcs, so a frame either package writes unpacks in the other.

Fault model (the port's store/blobstore.py injection): the fabric may
raise (BLOB_TRANSIENT / BLOB_UNAVAILABLE), stall (BLOB_LATENCY) or land
a truncated object (BLOB_PARTIAL_UPLOAD: the put "succeeds").  Every
failure degrades to the same outcome: only crc-verified prefix blocks
are adopted (a verified prefix of a prefix is still a prefix), and the
rest is prefilled again on the destination, which writes the same
bytes, so the output is token-identical either way and the failure
shows in serving/kv_migration_failed.
"""
from __future__ import annotations

import json
import queue
import struct
import threading
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = b"FFKV"
_VERSION = 1


class KVTransferError(Exception):
    """Torn, truncated, or foreign KV stream payload."""


def content_key(prompt: Sequence[int], n_blocks: int,
                page_size: int) -> str:
    """Content address of a block-aligned prefix: the pool's rolling
    hash of the first n_blocks pages (kv_pool's index key), so equal
    prefixes collide on the fabric by design (idempotent re-sends)."""
    from .kv_pool import _HASH_EMPTY, _hash_block

    h = _HASH_EMPTY
    for j in range(n_blocks):
        h = _hash_block(h, prompt[j * page_size:(j + 1) * page_size])
    return f"{h:016x}-{n_blocks}b{page_size}p"


def pack_kv_blocks(pages: Sequence[Sequence[int]],
                   blocks: Sequence[Dict[str, np.ndarray]],
                   page_size: int,
                   trace: Optional[Dict] = None) -> bytes:
    """Serialize exported blocks: a JSON header (schema + per-block
    token pages + per-block crc32 of the raw bytes) followed by each
    block's arrays concatenated in schema order.  The header carries
    every crc, so a truncated payload still verifies (and admits) the
    intact prefix blocks.  `trace` (a request trace's wire dict) rides
    the header as the reference's does; the port's migrator writes
    none until request tracing is ported."""
    if len(pages) != len(blocks):
        raise ValueError("pages/blocks length mismatch")
    schema = []
    if blocks:
        schema = [{"name": n, "shape": list(a.shape),
                   "dtype": str(a.dtype)}
                  for n, a in sorted(blocks[0].items())]
    payloads: List[bytes] = []
    crcs: List[int] = []
    for blk in blocks:
        raw = b"".join(np.ascontiguousarray(blk[s["name"]]).tobytes()
                       for s in schema)
        payloads.append(raw)
        crcs.append(zlib.crc32(raw))
    hdr = {
        "v": _VERSION,
        "page_size": int(page_size),
        "pages": [[int(t) for t in p] for p in pages],
        "schema": schema,
        "crcs": crcs,
        "block_bytes": [len(p) for p in payloads],
    }
    if trace:
        hdr["trace"] = trace
    header = json.dumps(hdr).encode("utf-8")
    return b"".join([_MAGIC, struct.pack("<I", len(header)), header]
                    + payloads)


def unpack_kv_blocks(data: bytes, prompt: Sequence[int]
                     ) -> Tuple[List[Dict[str, np.ndarray]], bool]:
    """Parse + verify a KV stream against the prompt it claims to
    serve.  Returns (verified_blocks, complete): only the prefix of
    blocks whose crc matches AND whose token page equals the prompt's
    page lands; the first torn block stops the walk (complete=False).
    A mangled header raises KVTransferError — nothing is adoptable."""
    if len(data) < 8 or data[:4] != _MAGIC:
        raise KVTransferError("bad magic: not a KV stream")
    (hlen,) = struct.unpack("<I", data[4:8])
    if len(data) < 8 + hlen:
        raise KVTransferError("truncated header")
    try:
        hdr = json.loads(data[8:8 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise KVTransferError(f"mangled header: {e}") from e
    if hdr.get("v") != _VERSION:
        raise KVTransferError(f"version {hdr.get('v')} != {_VERSION}")
    page = int(hdr["page_size"])
    schema = hdr["schema"]
    out: List[Dict[str, np.ndarray]] = []
    complete = True
    off = 8 + hlen
    for j, (tokens, crc, nbytes) in enumerate(
            zip(hdr["pages"], hdr["crcs"], hdr["block_bytes"])):
        raw = data[off:off + nbytes]
        off += nbytes
        want = [int(t) for t in prompt[j * page:(j + 1) * page]]
        if (len(raw) != nbytes or zlib.crc32(raw) != crc
                or [int(t) for t in tokens] != want):
            complete = False
            break  # later blocks chain through this one: stop
        arrays: Dict[str, np.ndarray] = {}
        pos = 0
        for s in schema:
            n = int(np.prod(s["shape"])) * np.dtype(s["dtype"]).itemsize
            arrays[s["name"]] = np.frombuffer(
                raw[pos:pos + n], dtype=s["dtype"]).reshape(s["shape"])
            pos += n
        out.append(arrays)
    return out, complete


def frame_trace(data: bytes) -> Optional[Dict]:
    """The trace wire dict a KV frame header carries (None when absent
    or unparseable), read off the received bytes.  Never raises: a torn
    frame loses its trace linkage, not its safety (unpack still decides
    what is adopted)."""
    try:
        if len(data) < 8 or data[:4] != _MAGIC:
            return None
        (hlen,) = struct.unpack("<I", data[4:8])
        hdr = json.loads(data[8:8 + hlen].decode("utf-8"))
        trace = hdr.get("trace")
        return trace if isinstance(trace, dict) else None
    except Exception:  # noqa: BLE001
        return None


# -- transfer fabrics -----------------------------------------------------
class KVTransferFabric:
    """One migration hop: ship `data` under `key`, return the bytes as
    the receiver sees them.  Implementations may throw (unreachable
    fabric) or return torn bytes (partial upload) — the unpack
    verification downstream is the only trust boundary."""

    kind = "abstract"

    def transfer(self, key: str, data: bytes) -> bytes:
        raise NotImplementedError

    def stats(self) -> Dict[str, int]:
        return {}


class InProcessFabric(KVTransferFabric):
    """Same-host handoff: the payload bytes move by reference.  Still
    packed/crc-verified like the cross-host path, so the code path the
    tests harden is the one production runs."""

    kind = "inproc"

    def __init__(self):
        self.transfers = 0
        self.bytes_moved = 0

    def transfer(self, key: str, data: bytes) -> bytes:
        self.transfers += 1
        self.bytes_moved += len(data)
        return data

    def stats(self) -> Dict[str, int]:
        return {"transfers": self.transfers,
                "bytes_moved": self.bytes_moved}


class BlobStoreFabric(KVTransferFabric):
    """Cross-host hop over the store tier (store/blobstore.py): put on
    the exporting side, get on the importing side, best-effort delete
    after.  Wrapping the store in FaultyBlobStore injects the blob fault
    matrix into the stream: BLOB_PARTIAL_UPLOAD lands a truncated
    object that only the reader-side crc check catches."""

    kind = "blob"

    def __init__(self, store, prefix: str = "kvstream/"):
        self.store = store
        self.prefix = str(prefix)
        self.transfers = 0
        self.bytes_moved = 0

    def transfer(self, key: str, data: bytes) -> bytes:
        path = self.prefix + key
        self.store.put(path, data)
        got = self.store.get(path)
        try:
            self.store.delete(path)
        except Exception:  # noqa: BLE001 — cleanup is best-effort;
            pass           # a leaked object is re-keyed content
        self.transfers += 1
        self.bytes_moved += len(got)
        return got

    def stats(self) -> Dict[str, int]:
        return {"transfers": self.transfers,
                "bytes_moved": self.bytes_moved}


def resolve_kv_transfer(spec: str, store=None,
                        root: Optional[str] = None) -> KVTransferFabric:
    """Build-time gate for --kv-transfer: validate the spec and
    construct the fabric.  "blob"
    without an explicit store falls back to a LocalBlobStore under
    `root` (required then)."""
    spec = str(spec or "inproc").lower()
    if spec == "inproc":
        return InProcessFabric()
    if spec == "blob":
        if store is None:
            if root is None:
                raise ValueError(
                    "--kv-transfer blob needs a blob store (or a root "
                    "path for a LocalBlobStore)")
            from ..store.blobstore import LocalBlobStore

            store = LocalBlobStore(root)
        return BlobStoreFabric(store)
    raise ValueError(
        f"unknown kv transfer fabric {spec!r}: pick from "
        "['inproc', 'blob']")


class KVMigrator:
    """Asynchronous migration pipeline: pack -> transfer -> verify ->
    adopt and write on the importing replica's worker thread.

    The caller exports the blocks on the SOURCE worker thread (the only
    thread that touches that engine's pools) and hands the host arrays
    here; one migrator thread runs the fabric hop off the decode path,
    and the device writes are marshalled onto the TARGET worker through
    run_on_worker, so that they serialize with its steps and admissions.

    `on_done` fires exactly once per migration, success or any failure:
    the front requeues the request either way (a failed migration only
    means the destination prefills again)."""

    def __init__(self, fabric: KVTransferFabric, registry=None,
                 logger=None):
        self.fabric = fabric
        self.registry = registry
        self.logger = logger
        self.started = 0
        self.completed = 0
        self.failed = 0
        self.bytes_streamed = 0
        self.blocks_streamed = 0
        self._jobs: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="kv-migrator")
        self._worker.start()

    def migrate(self, *, prompt: Sequence[int],
                pages: Sequence[Sequence[int]],
                blocks: Sequence[Dict[str, np.ndarray]],
                page_size: int, target,
                on_done: Callable[[bool], None]) -> None:
        """Queue one migration of `blocks` (host arrays exported from
        the source pool) into `target` (a ContinuousScheduler-shaped
        engine with .pool, .model and run_on_worker).
        `on_done(complete)`."""
        self.started += 1
        if self.registry is not None:
            self.registry.counter("serving/kv_migration_started").inc()
        self._jobs.put(("prefix", list(prompt), list(pages),
                        list(blocks), int(page_size), target, on_done))

    def migrate_live(self, *, tokens: Sequence[int],
                     pages: Sequence[Sequence[int]],
                     blocks: Sequence[Dict[str, np.ndarray]],
                     page_size: int, target,
                     on_done: Callable[[bool, Dict], None]) -> None:
        """Queue a mid-decode handoff: `tokens` is the paused sequence's
        WRITTEN prefix (prompt + generated), so the last page, and its
        exported block, may be partial.  Full pages adopt into the
        target's prefix cache as in migrate(); the sub-page tail cannot
        be indexed, so its verified arrays come back through
        `on_done(ok, detail)` (detail["tail"]) for the resume admission
        to land in a fresh private block.  detail["fault"] names the
        handoff fault kind (torn / header / fabric / capacity /
        dest_death) when ok is False: every kind degrades to replay on
        the destination."""
        self.started += 1
        if self.registry is not None:
            self.registry.counter("serving/kv_migration_started").inc()
        self._jobs.put(("live", list(tokens), list(pages),
                        list(blocks), int(page_size), target, on_done))

    def close(self) -> None:
        self._stop.set()
        self._jobs.put(None)
        self._worker.join(timeout=5.0)
        # jobs the worker never reached: every on_done fires exactly
        # once, or a front-side request waits forever
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue.Empty:
                break
            if job is not None:
                self._fail(job[6], "migrator closed",
                           live=(job[0] == "live"))

    # -- internals --------------------------------------------------------
    def _fail(self, on_done, why: str, exc: Optional[Exception] = None,
              live: bool = False) -> None:
        self.failed += 1
        if self.registry is not None:
            self.registry.counter("serving/kv_migration_failed").inc()
        if self.logger is not None:
            self.logger.info("kv migration failed (%s): %s",
                             why, exc if exc is not None else "")
        try:
            if live:
                from .handoff import classify_handoff_fault

                on_done(False, {"fault": classify_handoff_fault(why, exc),
                                "reason": why, "tail": None,
                                "adopted_tokens": 0, "bytes": 0,
                                "blocks": 0})
            else:
                on_done(False)
        except Exception:  # noqa: BLE001 - a completion hook never kills
            pass           # the migrator thread

    def _loop(self) -> None:
        while not self._stop.is_set():
            job = self._jobs.get()
            if job is None:
                continue
            mode, toks, pages, blocks, page, target, on_done = job
            live = mode == "live"
            try:
                key = content_key(toks, len(blocks), page)
                data = pack_kv_blocks(pages, blocks, page)
                got = self.fabric.transfer(key, data)
                verified, complete = unpack_kv_blocks(got, toks)
            except Exception as e:  # fabric down / torn header
                self._fail(on_done, "transfer", e, live=live)
                continue
            if not verified:
                self._fail(on_done, "no block verified", live=live)
                continue
            if live:
                self._import_live(toks, verified, complete, len(got),
                                  page, target, on_done)
            else:
                self._import(toks, verified, complete, len(got),
                             target, on_done)

    def _count_streamed(self, nbytes: int, blocks: int) -> None:
        self.completed += 1
        self.bytes_streamed += nbytes
        self.blocks_streamed += blocks
        if self.registry is not None:
            self.registry.counter("serving/kv_migration_bytes").inc(nbytes)
            self.registry.counter("serving/kv_migration_blocks").inc(blocks)

    def _write_adopted(self, target, pairs, arrays, on_done,
                       live: bool) -> bool:
        """Write adopted blocks to the target's pools; on a failed write
        unwind the blocks whose bytes never landed (no admission may map
        them) and fail the migration."""
        done = 0
        try:
            for j, blk in pairs:
                target.model.import_block(blk, arrays[j])
                done += 1
        except Exception as e:
            target.pool.drop_adopted([blk for _, blk in pairs[done:]])
            self._fail(on_done, "device write", e, live=live)
            if getattr(e, "fatal_to_engine", False):
                raise
            return False
        return True

    def _import(self, prompt, verified, complete, nbytes, target,
                on_done) -> None:
        """Run the adoption on the target's worker thread: adopt_prefix
        registers the blocks and their bytes land before the worker's
        next admission, so no request maps a block still in flight."""
        def write():
            pairs = target.pool.adopt_prefix(prompt, len(verified))
            if not self._write_adopted(target, pairs, verified, on_done,
                                       live=False):
                return
            self._count_streamed(nbytes, len(verified))
            if complete:
                if self.registry is not None:
                    self.registry.counter(
                        "serving/kv_migration_done").inc()
            else:
                # a torn stream whose verified prefix still landed: the
                # request prefills the rest; count the failure AND the
                # partial win
                self.failed += 1
                if self.registry is not None:
                    self.registry.counter(
                        "serving/kv_migration_failed").inc()
            try:
                on_done(bool(complete))
            except Exception:  # noqa: BLE001
                pass

        self._on_target(target, write, on_done, live=False)

    def _import_live(self, toks, verified, complete, nbytes, page,
                     target, on_done) -> None:
        """The live-handoff import: full pages adopt into the target's
        prefix cache (the resume admission then hits them as it would a
        migrated prompt); the verified partial tail block's arrays ride
        back in the completion detail instead, since only the resumed
        sequence itself may own a sub-page tail."""
        n_full = len(toks) // page

        def write():
            full = verified[:n_full]
            pairs = target.pool.adopt_prefix(toks, len(full))
            if not self._write_adopted(target, pairs, full, on_done,
                                       live=True):
                return
            # coverage as admission will see it: adopt_prefix stops early
            # when the pool has no reclaimable block (capacity), and the
            # resume then replays the unadopted rest
            adopted = target.pool.cached_prefix_tokens(toks)
            tail = (verified[n_full]
                    if complete and len(verified) > n_full else None)
            ok = bool(complete) and adopted >= n_full * page
            fault = None if ok else ("capacity" if complete else "torn")
            self._count_streamed(nbytes, len(verified))
            if ok:
                if self.registry is not None:
                    self.registry.counter(
                        "serving/kv_migration_done").inc()
            else:
                self.failed += 1
                if self.registry is not None:
                    self.registry.counter(
                        "serving/kv_migration_failed").inc()
            try:
                on_done(ok, {"fault": fault, "tail": tail,
                             "adopted_tokens": int(adopted),
                             "bytes": nbytes, "blocks": len(verified)})
            except Exception:  # noqa: BLE001
                pass

        self._on_target(target, write, on_done, live=True)

    def _on_target(self, target, write, on_done, live: bool) -> None:
        try:
            target.run_on_worker(
                write, on_dropped=lambda err: self._fail(
                    on_done, "target gone", err, live=live))
        except Exception as e:  # target closed
            self._fail(on_done, "target closed", e, live=live)

    def stats(self) -> Dict[str, int]:
        out = {
            "started": self.started,
            "completed": self.completed,
            "failed": self.failed,
            "bytes_streamed": self.bytes_streamed,
            "blocks_streamed": self.blocks_streamed,
            "fabric": self.fabric.kind,
        }
        out.update({f"fabric_{k}": v
                    for k, v in self.fabric.stats().items()})
        return out
