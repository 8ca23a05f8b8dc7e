"""A minimal object-store interface (flexflow_tpu/store/blobstore.py).

The operations the durable tiers need: put, get, stat, list and delete,
plus a generation-conditional put for crash-safe pointer updates (the
GCS `ifGenerationMatch` primitive).  Backends:

  * `LocalBlobStore`: objects are files under a root directory, written
    tmp + fsync + rename so that a reader never sees a torn object, with
    per-object generation counters behind the conditional put.  The
    hermetic stand-in for GCS or S3 (an NFS mount used this way is a
    deployment for a single cluster).
  * `FaultyBlobStore`: wraps any backend and injects the upload faults
    of a seeded `resilience.faults.FaultPlan`: transient errors,
    truncated uploads, latency spikes and outage windows.
  * `blobstore_from_uri`: `file:///path` or a bare path build a
    `LocalBlobStore`; `gs://` and `s3://` raise until their SDKs are
    provisioned (no import-time dependency).

Keys are `/`-separated relative UTF-8 paths without `..` segments.
Every operation is whole-object and atomic per key.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

_log = logging.getLogger("flexflow_tpu_torch.blobstore")


class BlobStoreError(RuntimeError):
    """Base of blob-store failures (network, backend, precondition)."""


class BlobNotFound(BlobStoreError, KeyError):
    """get/delete of a key that does not exist."""


class BlobUnavailableError(BlobStoreError):
    """Transient backend failure: the operation may succeed on retry
    (the 429/503/connection-reset class).  Callers retry under a
    jittered-backoff budget and degrade gracefully past it."""


class BlobPreconditionFailed(BlobStoreError):
    """A conditional put's generation precondition did not hold —
    another writer updated (or created) the object first."""


@dataclasses.dataclass
class BlobInfo:
    key: str
    size: int
    generation: int


def _check_key(key: str) -> str:
    if not key or key.startswith("/") or key.endswith("/"):
        raise ValueError(f"blob key must be a relative path, got {key!r}")
    parts = key.split("/")
    if any(p in ("", ".", "..") for p in parts):
        raise ValueError(f"blob key must not contain empty/dot segments: "
                         f"{key!r}")
    return key


class BlobStore:
    """Abstract whole-object store.  Generation semantics follow GCS:
    generation 0 means "the object does not exist", so
    `put(key, data, if_generation_match=0)` is create-if-absent and
    `put(key, data, if_generation_match=g)` replaces only the exact
    version a reader previously observed."""

    def put(self, key: str, data: bytes, *,
            if_generation_match: Optional[int] = None) -> int:
        """Write one object atomically; returns its new generation.
        Raises BlobPreconditionFailed when `if_generation_match` names
        a generation other than the current one."""
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        """Full object bytes; raises BlobNotFound."""
        raise NotImplementedError

    def stat(self, key: str) -> Optional[BlobInfo]:
        """BlobInfo for `key`, or None when absent."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        """Sorted keys under `prefix` (flat namespace, like GCS)."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        """Remove one object; returns False when it was already gone."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        return self.stat(key) is not None


class LocalBlobStore(BlobStore):
    """Filesystem-backed BlobStore.

    Objects live at `<root>/<key>`; per-object generation counters live
    in a parallel `<root>/.meta/<key>` tree (kept out of list()).
    Writes stage to a `.tmp-*` sibling, fsync, then `os.replace` — a
    reader never observes a torn object, mirroring real object stores'
    whole-object atomicity.  Generations are protected by an in-process
    lock; cross-process writers on one root still get atomic objects,
    but conditional-put races between *processes* are best-effort (the
    production backends this stands in for arbitrate server-side).
    """

    _META = ".meta"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()

    def _data_path(self, key: str) -> str:
        return os.path.join(self.root, *_check_key(key).split("/"))

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.root, self._META, *key.split("/"))

    def _generation(self, key: str) -> int:
        try:
            with open(self._meta_path(key)) as f:
                return int(json.load(f)["generation"])
        except (OSError, ValueError, KeyError):
            # object present but meta torn/absent (foreign writer, crash
            # between data and meta): treat as generation 1 so readers
            # still see it and unconditional puts still supersede it
            return 1 if os.path.exists(self._data_path(key)) else 0

    def put(self, key: str, data: bytes, *,
            if_generation_match: Optional[int] = None) -> int:
        path = self._data_path(key)
        with self._lock:
            cur = self._generation(key)
            if if_generation_match is not None \
                    and cur != int(if_generation_match):
                raise BlobPreconditionFailed(
                    f"{key}: generation {cur} != required "
                    f"{if_generation_match}"
                )
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
                try:
                    with open(tmp, "wb") as f:
                        f.write(data)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, path)
                except OSError:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise
                gen = cur + 1
                mpath = self._meta_path(key)
                os.makedirs(os.path.dirname(mpath), exist_ok=True)
                mtmp = f"{mpath}.tmp-{os.getpid()}-{threading.get_ident()}"
                with open(mtmp, "w") as f:
                    json.dump({"generation": gen}, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(mtmp, mpath)
            except OSError as e:
                # every `except BlobStoreError` handler in the durability
                # tiers must see filesystem trouble too (read-only NFS,
                # EPERM on a foreign uid's object) — same contract as get()
                raise BlobUnavailableError(f"{key}: {e}") from e
            return gen

    def get(self, key: str) -> bytes:
        try:
            with open(self._data_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise BlobNotFound(key) from None
        except OSError as e:
            raise BlobUnavailableError(f"{key}: {e}") from e

    def stat(self, key: str) -> Optional[BlobInfo]:
        path = self._data_path(key)
        try:
            size = os.path.getsize(path)
        except OSError:
            return None
        return BlobInfo(key=key, size=size, generation=self._generation(key))

    def list(self, prefix: str = "") -> List[str]:
        out = []
        # root the walk at the prefix's directory portion, so that a
        # poll of one prefix does not stat every object in the tree
        base = prefix.rsplit("/", 1)[0] if "/" in prefix else ""
        start = (os.path.join(self.root, *base.split("/"))
                 if base else self.root)
        if not os.path.isdir(start):
            return out
        for dirpath, dirnames, filenames in os.walk(start):
            # the generation tree and staged writes are implementation
            # detail, never listed
            dirnames[:] = [d for d in dirnames if d != self._META]
            for name in filenames:
                if ".tmp-" in name:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> bool:
        with self._lock:
            existed = False
            try:
                os.unlink(self._data_path(key))
                existed = True
            except FileNotFoundError:
                pass
            except OSError as e:
                raise BlobUnavailableError(f"{key}: {e}") from e
            try:
                os.unlink(self._meta_path(key))
            except OSError:
                pass
            return existed


class FaultyBlobStore(BlobStore):
    """Fault-injecting wrapper around any BlobStore.

    Faults come from a seeded `resilience.faults.FaultPlan` whose
    object-store `FaultKind`s (BLOB_TRANSIENT / BLOB_PARTIAL_UPLOAD /
    BLOB_LATENCY / BLOB_UNAVAILABLE) target the wrapper's own operation
    counter — `Fault.step` is "fire at or after the Nth blob op", so a
    plan is deterministic regardless of training cadence.  Each fault
    fires once; BLOB_UNAVAILABLE opens a window of `payload["ops"]`
    consecutive operations (default 5) that all raise
    `BlobUnavailableError`.

    A partial upload truncates the put's bytes to `payload["fraction"]`
    (default 0.5) and lets the truncated object LAND — exactly the torn
    upload a real store can surface — so only the reader-side manifest
    verification can catch it (which is the property under test).
    """

    def __init__(self, inner: BlobStore, plan=None, *,
                 sleep: Callable[[float], None] = time.sleep):
        from ..resilience.faults import FaultPlan

        self.inner = inner
        self.plan = plan or FaultPlan()
        self.sleep = sleep
        self.ops = 0  # operations attempted so far (the fault clock)
        self._unavailable_until = -1  # op index the outage window ends at
        self.counters: Dict[str, int] = {
            "transient_errors": 0,
            "partial_uploads": 0,
            "latency_injections": 0,
            "unavailable_rejections": 0,
        }

    # -- fault clock -----------------------------------------------------
    def _tick(self, op: str, key: str) -> Optional[float]:
        """Advance the op counter and fire due faults.  Returns the
        put-truncation fraction when a partial-upload fault hit (the
        caller applies it), else None."""
        from ..resilience.faults import FaultKind

        self.ops += 1
        if self.ops <= self._unavailable_until:
            self.counters["unavailable_rejections"] += 1
            raise BlobUnavailableError(
                f"injected outage window: {op} {key} (op {self.ops})"
            )
        fraction = None
        for f in self.plan.faults:
            if f.fired or self.ops < f.step:
                continue
            if f.kind == FaultKind.BLOB_TRANSIENT:
                f.fired = True
                self.counters["transient_errors"] += 1
                raise BlobUnavailableError(
                    f"injected transient error: {op} {key} (op {self.ops})"
                )
            if f.kind == FaultKind.BLOB_UNAVAILABLE:
                f.fired = True
                window = int(f.payload.get("ops", 5))
                self._unavailable_until = self.ops + window
                self.counters["unavailable_rejections"] += 1
                raise BlobUnavailableError(
                    f"injected outage window ({window} ops): {op} {key}"
                )
            if f.kind == FaultKind.BLOB_LATENCY:
                f.fired = True
                self.counters["latency_injections"] += 1
                self.sleep(float(f.payload.get("delay_s", 0.05)))
            elif f.kind == FaultKind.BLOB_PARTIAL_UPLOAD and op == "put":
                f.fired = True
                self.counters["partial_uploads"] += 1
                fraction = float(f.payload.get("fraction", 0.5))
        return fraction

    # -- delegated ops ---------------------------------------------------
    def put(self, key: str, data: bytes, *,
            if_generation_match: Optional[int] = None) -> int:
        fraction = self._tick("put", key)
        if fraction is not None:
            cut = max(0, min(len(data), int(len(data) * fraction)))
            _log.warning(
                "injected partial upload of %s: %d of %d bytes land",
                key, cut, len(data),
            )
            data = data[:cut]
        return self.inner.put(key, data,
                              if_generation_match=if_generation_match)

    def get(self, key: str) -> bytes:
        self._tick("get", key)
        return self.inner.get(key)

    def stat(self, key: str) -> Optional[BlobInfo]:
        self._tick("stat", key)
        return self.inner.stat(key)

    def list(self, prefix: str = "") -> List[str]:
        self._tick("list", prefix)
        return self.inner.list(prefix)

    def delete(self, key: str) -> bool:
        self._tick("delete", key)
        return self.inner.delete(key)


def blobstore_from_uri(uri: str) -> BlobStore:
    """Resolve a `--remote-store` URI to a backend.

    `file:///abs/path` and bare paths build a LocalBlobStore (hermetic
    tests, NFS fleet mounts); `gs://`/`s3://` are the production
    backends this interface is shaped for — their SDKs are not baked
    into this container, so they raise a clear provisioning error
    instead of a deep ImportError at first use."""
    uri = str(uri).strip()
    if not uri:
        raise ValueError("remote store URI must be non-empty")
    if uri.startswith("file://"):
        return LocalBlobStore(uri[len("file://"):] or "/")
    if "://" in uri:
        scheme = uri.split("://", 1)[0]
        raise NotImplementedError(
            f"remote store scheme {scheme!r} needs its cloud SDK "
            "provisioned; use file:// (or a bare path) for the "
            "filesystem backend"
        )
    return LocalBlobStore(uri)


def rmtree_blob_prefix(store: BlobStore, prefix: str) -> int:
    """Delete every key under `prefix`; returns the count removed (the
    blob analogue of shutil.rmtree, used by quarantine and pruning)."""
    removed = 0
    for key in store.list(prefix):
        if store.delete(key):
            removed += 1
    return removed


__all__ = [
    "BlobInfo",
    "BlobNotFound",
    "BlobPreconditionFailed",
    "BlobStore",
    "BlobStoreError",
    "BlobUnavailableError",
    "FaultyBlobStore",
    "LocalBlobStore",
    "blobstore_from_uri",
    "rmtree_blob_prefix",
]
