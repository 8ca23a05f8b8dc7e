"""The checkpoints' second tier (flexflow_tpu/resilience/offload.py):
verified steps mirrored to an object store, so that a lost host keeps a
restore target.

A `CheckpointOffloader` takes each step the local checkpoint manager
publishes (checkpoint.py, rank 0 on a group) and mirrors it to a
`RemoteCheckpointStore` on a background thread (the single-writer FIFO
of `async_writer.AsyncCheckpointWriter`), checks every leaf's crc32
against the bytes read back from the store, and only then advances the
`REMOTE_LATEST` pointer, with a conditional put that never moves it
back.  Each step after the first uploads only the leaves whose crc32
changed since the last mirrored step (a delta; its manifest names the
step that holds each skipped leaf), for at most MAX_DELTA_CHAIN steps in
a row before the next full upload.

Layout under the blob store's `ckpt/` prefix, the reference's:

    ckpt/step_00000004/state.npz      # the local step's files
    ckpt/step_00000004/meta.json
    ckpt/step_00000004/manifest.json  # put last
    ckpt/REMOTE_LATEST                # {"step": N}

A mirror never stalls training:
  * a transient store error is retried on the uploader thread under a
    jittered-backoff `RetryPolicy`;
  * a torn upload fails the read-back check: the remote step is deleted
    and REMOTE_LATEST stays where it was;
  * an outage that outlives the retry budget leaves the run with the
    local tier alone, counted in `offload_unavailable`;
  * a full queue skips the cadence point (`offload_skipped`): the local
    tier still holds the step.

A remote step is the local step's npz files (a DCP step's leaves are
written as state.npz for the mirror), so the reference's
`RemoteCheckpointStore.verify_step` checks a step the port mirrored.
Restore walks local, then the same step's mirror, then older steps
(checkpoint.py); a new host with an empty directory restores from the
mirror alone.
"""
from __future__ import annotations

import io
import json
import logging
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..checkpoint import _leaf_crc
from ..store.blobstore import (
    BlobNotFound,
    BlobPreconditionFailed,
    BlobStore,
    BlobStoreError,
    BlobUnavailableError,
    rmtree_blob_prefix,
)
from .async_writer import AsyncCheckpointWriter
from .faults import CheckpointWriteFault, FaultPlan
from .retry import RetryPolicy

_log = logging.getLogger("flexflow_tpu_torch.offload")

#: blob names mirrored per step, in upload order (manifest last: a
#: reader that sees the manifest knows the data blobs were put first)
STEP_FILES = ("state.npz", "meta.json", "manifest.json")
REMOTE_LATEST = "REMOTE_LATEST"

_STEP_KEY_RE = re.compile(r"step_(\d{8})/manifest\.json$")


class RemoteVerifyError(RuntimeError):
    """A mirrored step's remotely-read bytes do not match its manifest."""


#: delta-mirror chain bound: after this many consecutive delta steps the
#: next mirror re-uploads every leaf, so a restore never chases more
#: than MAX_DELTA_CHAIN base fetches and prune's base-retention set
#: stays small
MAX_DELTA_CHAIN = 4


class UploadReport:
    """What upload_step moved: the leaves a delta skipped, the bytes
    put and the manifest."""

    __slots__ = ("leaves_skipped", "bytes_uploaded", "manifest")

    def __init__(self, leaves_skipped: int, bytes_uploaded: int,
                 manifest: Dict):
        self.leaves_skipped = leaves_skipped
        self.bytes_uploaded = bytes_uploaded
        self.manifest = manifest


class RemoteCheckpointStore:
    """The remote half of the two-tier checkpoint protocol: step
    mirrors + the REMOTE_LATEST pointer, on any BlobStore."""

    def __init__(self, blob: BlobStore, prefix: str = "ckpt/"):
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        self.blob = blob
        self.prefix = prefix

    # -- layout ---------------------------------------------------------
    def _step_prefix(self, step: int) -> str:
        return f"{self.prefix}step_{step:08d}/"

    def _latest_key(self) -> str:
        return f"{self.prefix}{REMOTE_LATEST}"

    def list_steps(self) -> List[int]:
        """Steps with a manifest blob present, ascending.  The manifest
        is uploaded LAST, so its presence implies the data blobs were
        put (their integrity is still only promised by verify)."""
        out = []
        for key in self.blob.list(self.prefix):
            m = _STEP_KEY_RE.search(key)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # -- REMOTE_LATEST pointer ------------------------------------------
    def read_latest(self) -> Optional[int]:
        try:
            return int(json.loads(self.blob.get(self._latest_key()))["step"])
        except (BlobNotFound, BlobStoreError, ValueError, KeyError,
                TypeError):
            return None

    def latest_verified_step(self) -> Optional[int]:
        """The newest step REMOTE_LATEST committed to, None when the
        pointer is absent or dangling (its step's blobs were pruned or
        never fully landed)."""
        step = self.read_latest()
        if step is None or not self.blob.exists(
            self._step_prefix(step) + "manifest.json"
        ):
            return None
        return step

    def advance_latest(self, step: int, force: bool = False) -> None:
        """Monotonic, lost-update-safe pointer advance: re-reads the
        current generation and writes conditionally, so two uploaders
        racing (e.g. an emergency save racing the background mirror)
        can never regress the pointer."""
        for _ in range(8):
            info = self.blob.stat(self._latest_key())
            gen = info.generation if info is not None else 0
            cur = self.read_latest() if info is not None else None
            if not force and cur is not None and cur >= step:
                return
            payload = json.dumps({"step": int(step)}).encode()
            try:
                self.blob.put(self._latest_key(), payload,
                              if_generation_match=gen)
                return
            except BlobPreconditionFailed:
                continue  # racer advanced it; re-read and re-decide
        raise BlobStoreError(
            f"REMOTE_LATEST contended past retry bound at step {step}"
        )

    # -- upload / verify -------------------------------------------------
    def _delta_files(self, step: int, files: Dict[str, bytes],
                     base_step: int, base_manifest: Dict,
                     ) -> Tuple[Dict[str, bytes], int]:
        """Rewrite one step's upload payload as a per-leaf delta against
        an already-mirrored base: leaves whose manifest crc32 matches
        the base's are dropped from state.npz and annotated in the
        manifest with {"base_step": N} — restore/verify resolve them
        through the base (download_step reassembles the full npz).
        Returns (files', leaves_skipped); returns the input unchanged
        when nothing is skippable or the delta chain is at its bound."""
        try:
            manifest = json.loads(files["manifest.json"])
            base_leaves = base_manifest.get("leaves", {})
            base_depth = int(base_manifest.get("delta_depth", 0))
        except (ValueError, TypeError, AttributeError):
            return files, 0
        if base_depth >= MAX_DELTA_CHAIN:
            return files, 0  # re-anchor: full upload bounds the chain
        leaves = manifest.get("leaves")
        if not isinstance(leaves, dict):
            return files, 0
        unchanged = [
            k for k, spec in leaves.items()
            if isinstance(base_leaves.get(k), dict)
            and base_leaves[k].get("crc32") == spec.get("crc32")
        ]
        if not unchanged:
            return files, 0
        try:
            with np.load(io.BytesIO(files["state.npz"])) as data:
                kept = {
                    k: data[k] for k in data.files if k not in set(unchanged)
                }
        except Exception:  # torn local npz: upload as-is, verify catches it
            return files, 0
        for k in unchanged:
            leaves[k] = dict(leaves[k])
            # FLATTEN the chain: point at the step that actually HOLDS
            # the bytes (the base's own base when the base is itself a
            # delta for this leaf) — restore fetches exactly one extra
            # step per leaf and prune's retention set stays at the
            # anchor steps, not every intermediate delta
            leaves[k]["base_step"] = int(
                base_leaves[k].get("base_step", base_step)
            )
        manifest["delta_depth"] = base_depth + 1
        buf = io.BytesIO()
        np.savez(buf, **kept)
        out = dict(files)
        out["state.npz"] = buf.getvalue()
        out["manifest.json"] = json.dumps(manifest).encode()
        return out, len(unchanged)

    def upload_step(self, step: int, files: Dict[str, bytes],
                    base_step: Optional[int] = None,
                    base_manifest: Optional[Dict] = None) -> UploadReport:
        """Mirror one verified local step: put data blobs, manifest
        last, then re-download and crc-verify before advancing
        REMOTE_LATEST.  A verification failure quarantines the remote
        step (deletes its blobs) and raises RemoteVerifyError — the
        pointer never advances onto unverified bytes.

        `base_step`/`base_manifest` (the previously mirrored step, as
        the offloader tracks it) turn the upload into a per-leaf DELTA:
        leaves whose crc32 is unchanged since the base are not
        re-uploaded — ZeRO-3-sized mirrors stop re-sending frozen
        embeddings and unchanged buffers every cadence point."""
        missing = [n for n in STEP_FILES if n not in files]
        if missing:
            raise ValueError(f"upload_step missing files {missing}")
        skipped = 0
        if base_step is not None and base_manifest and base_step != step:
            files, skipped = self._delta_files(
                step, files, base_step, base_manifest
            )
        prefix = self._step_prefix(step)
        for name in STEP_FILES:
            self.blob.put(prefix + name, files[name])
        try:
            manifest = self.verify_step(step)
        except RemoteVerifyError:
            removed = rmtree_blob_prefix(self.blob, prefix)
            _log.warning(
                "remote step %d failed crc verification; quarantined "
                "(%d blobs removed), REMOTE_LATEST unchanged", step, removed,
            )
            raise
        self.advance_latest(step)
        return UploadReport(
            leaves_skipped=skipped,
            bytes_uploaded=sum(len(b) for b in files.values()),
            manifest=manifest,
        )

    def verify_step(self, step: int) -> Dict:
        """Download one remote step and check every leaf against its
        manifest crc32 (the read side of verify-then-advance).  Returns
        the parsed manifest; raises RemoteVerifyError on any mismatch,
        truncation, or unparseable piece."""
        prefix = self._step_prefix(step)
        try:
            manifest = json.loads(self.blob.get(prefix + "manifest.json"))
            json.loads(self.blob.get(prefix + "meta.json"))  # must parse
            state = self.blob.get(prefix + "state.npz")
        except BlobUnavailableError:
            raise  # transient: caller's retry budget owns this
        except (BlobStoreError, ValueError) as e:
            raise RemoteVerifyError(
                f"remote step {step} unreadable: {e}"
            ) from e
        base_manifests: Dict[int, Dict] = {}
        try:
            with np.load(io.BytesIO(state)) as data:
                leaves = manifest.get("leaves")
                if not isinstance(leaves, dict):
                    raise RemoteVerifyError(
                        f"remote step {step}: manifest has no leaves"
                    )
                for key, spec in leaves.items():
                    base = spec.get("base_step")
                    if base is not None:
                        # delta leaf: its bytes live in the base step's
                        # mirror — verify the base vouches for the SAME
                        # crc (the base's own verify covered the bytes)
                        base = int(base)
                        bm = base_manifests.get(base)
                        if bm is None:
                            try:
                                bm = json.loads(self.blob.get(
                                    self._step_prefix(base)
                                    + "manifest.json"
                                ))
                            except BlobUnavailableError:
                                raise
                            except (BlobStoreError, ValueError) as e:
                                raise RemoteVerifyError(
                                    f"remote step {step}: delta base "
                                    f"{base} unreadable: {e}"
                                ) from e
                            base_manifests[base] = bm
                        bspec = bm.get("leaves", {}).get(key)
                        if (not isinstance(bspec, dict)
                                or bspec.get("crc32") != spec["crc32"]):
                            raise RemoteVerifyError(
                                f"remote step {step}: delta leaf {key!r} "
                                f"not vouched for by base step {base}"
                            )
                        continue
                    if key not in data.files:
                        raise RemoteVerifyError(
                            f"remote step {step}: leaf {key!r} in manifest "
                            "but not in state.npz"
                        )
                    crc = _leaf_crc(data[key])
                    if crc != spec["crc32"]:
                        raise RemoteVerifyError(
                            f"remote step {step}: leaf {key!r} crc32 "
                            f"{crc:#010x} != manifest {spec['crc32']:#010x}"
                        )
                # restore rejects leaves the manifest can't vouch for —
                # blessing them here would green-light a step that
                # cannot actually restore
                for key in data.files:
                    if key not in leaves:
                        raise RemoteVerifyError(
                            f"remote step {step}: leaf {key!r} in "
                            "state.npz but missing from the manifest "
                            "(unverifiable)"
                        )
        except RemoteVerifyError:
            raise
        except BlobUnavailableError:
            raise  # delta-base fetch blip: transient, NOT corruption —
            # wrapping it would quarantine a perfectly good step
        except Exception as e:  # torn npz, zip errors, bad dtypes
            raise RemoteVerifyError(
                f"remote step {step} undecodable: {e}"
            ) from e
        return manifest

    def download_step(self, step: int) -> Dict[str, bytes]:
        """The three step blobs as bytes (restore's materialize source);
        raises BlobNotFound/BlobStoreError straight through.

        Delta mirrors are REASSEMBLED here: leaves the manifest marks
        `base_step` are fetched from their base step's state.npz
        (chasing chains through each base's own manifest), and the
        returned payload is a SELF-CONTAINED full step — the local
        materialize path writes ordinary, annotation-free files."""
        prefix = self._step_prefix(step)
        files = {name: self.blob.get(prefix + name) for name in STEP_FILES}
        try:
            manifest = json.loads(files["manifest.json"])
            leaves = manifest.get("leaves", {})
        except (ValueError, TypeError):
            return files  # unparseable: hand back raw, restore verifies
        if not any(
            isinstance(s, dict) and s.get("base_step") is not None
            for s in leaves.values()
        ):
            return files
        with np.load(io.BytesIO(files["state.npz"])) as data:
            arrays = {k: data[k] for k in data.files}
        npz_cache: Dict[int, Dict[str, np.ndarray]] = {}
        manifest_cache: Dict[int, Dict] = {int(step): manifest}

        def _load_base(s: int):
            if s not in npz_cache:
                p = self._step_prefix(s)
                with np.load(io.BytesIO(self.blob.get(p + "state.npz"))) as d:
                    npz_cache[s] = {k: d[k] for k in d.files}
                manifest_cache[s] = json.loads(
                    self.blob.get(p + "manifest.json")
                )
            return npz_cache[s], manifest_cache[s]

        for key, spec in leaves.items():
            base = spec.get("base_step") if isinstance(spec, dict) else None
            seen = set()
            while base is not None:
                if base in seen:  # defensive: a cyclic chain is corrupt
                    raise BlobStoreError(
                        f"delta chain cycle at step {base} leaf {key!r}"
                    )
                seen.add(base)
                arrs, bman = _load_base(int(base))
                if key in arrs:
                    arrays[key] = arrs[key]
                    base = None
                else:
                    bspec = bman.get("leaves", {}).get(key, {})
                    base = bspec.get("base_step")
                    if base is None:
                        raise BlobStoreError(
                            f"delta leaf {key!r} unresolvable from its "
                            "base chain"
                        )
        for spec in leaves.values():
            if isinstance(spec, dict):
                spec.pop("base_step", None)
        manifest.pop("delta_depth", None)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        files["state.npz"] = buf.getvalue()
        files["manifest.json"] = json.dumps(manifest).encode()
        return files

    def delete_step(self, step: int) -> int:
        return rmtree_blob_prefix(self.blob, self._step_prefix(step))

    def _base_steps_of(self, step: int) -> List[int]:
        """Base steps a (possibly delta) mirrored step references.
        Store/parse failures PROPAGATE — treating an unreadable
        manifest as 'no bases' would let prune delete a base a kept
        delta still resolves leaves through (prune aborts instead)."""
        try:
            raw = self.blob.get(self._step_prefix(step) + "manifest.json")
        except BlobNotFound:
            return []  # dangling step: nothing it can reference
        manifest = json.loads(raw)
        return sorted({
            int(s["base_step"])
            for s in manifest.get("leaves", {}).values()
            if isinstance(s, dict) and s.get("base_step") is not None
        })

    def prune(self, keep: int) -> int:
        """Keep the `keep` newest mirrored steps; never delete the step
        REMOTE_LATEST names (the remote durability floor, mirroring the
        local manager's never-prune-the-verified-step rule) — NOR any
        base step a kept delta mirror still resolves leaves through
        (transitively: deleting a delta's base would orphan its
        unre-uploaded leaves)."""
        steps = self.list_steps()
        keep_set = set(steps[-max(1, keep):])
        latest = self.read_latest()
        if latest is not None:
            keep_set.add(latest)
        try:
            frontier = list(keep_set)
            while frontier:
                nxt = []
                for s in frontier:
                    for b in self._base_steps_of(s):
                        if b not in keep_set:
                            keep_set.add(b)
                            nxt.append(b)
                frontier = nxt
        except (BlobStoreError, ValueError, TypeError) as e:
            # can't prove which bases are still referenced: deleting
            # anything could orphan a kept delta's leaves — skip this
            # prune round, the next cadence point retries
            _log.warning("remote prune skipped: delta bases "
                         "unresolvable (%s)", e)
            return 0
        removed = 0
        for s in steps:
            if s not in keep_set:
                removed += self.delete_step(s)
        return removed


class CheckpointOffloader:
    """Background mirror of verified local checkpoints to a
    RemoteCheckpointStore.

    `maybe_submit(step, files)` is called by the local checkpoint
    manager right after a step publishes (on the async writer thread
    for wait=False saves — already off the critical path).  It honors
    the `every` cadence, never blocks (a full queue skips with a
    counter), and hands the upload to one daemon uploader thread that
    retries transients under `retry`'s jittered-backoff budget and
    degrades to local-only durability past it."""

    MAX_PENDING_UPLOADS = 2

    def __init__(
        self,
        remote: RemoteCheckpointStore,
        *,
        every: int = 1,
        keep: int = 3,
        retry: Optional[RetryPolicy] = None,
        fault_plan=None,
        registry=None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if every < 1:
            raise ValueError(f"offload cadence must be >= 1, got {every}")
        if keep < 1:
            raise ValueError(f"remote keep must be >= 1, got {keep}")
        self.remote = remote
        self.every = every
        self.keep = keep
        self.retry = retry or RetryPolicy(max_restarts=3, base_backoff=0.05)
        self.fault_plan = fault_plan or FaultPlan()
        self.registry = registry
        self.sleep = sleep
        self._writer = AsyncCheckpointWriter(name="ckpt-offload")
        if registry is not None:
            gauge = registry.gauge("resilience/offload_queue_depth")
            self._writer.depth_cb = gauge.set
        self._submitted = 0  # verified local publishes seen (cadence clock)
        self._last_queued: Optional[int] = None
        # last step that completed upload + remote verification (written
        # on the uploader thread; int read is atomic enough for dedupe)
        self._mirrored: Optional[int] = None
        # ...and its REMOTE manifest — the delta-mirror base: the next
        # upload skips leaves whose crc32 this manifest already vouches
        # for
        self._mirrored_manifest: Optional[Dict] = None
        self.counters: Dict[str, float] = {
            "offload_uploads": 0,      # steps durably mirrored + verified
            "offload_failures": 0,     # uploads abandoned past the budget
            "offload_retries": 0,      # transient-attempt retries
            "offload_skipped": 0,      # cadence points dropped (full queue)
            "offload_verify_failures": 0,  # remote crc misses (quarantined)
            "offload_unavailable": 0,  # degraded-to-local-only events
            "offload_bytes": 0,        # payload bytes durably uploaded
            "offload_leaves_skipped": 0,  # delta-mirror leaves not re-sent
        }

    # -- metrics --------------------------------------------------------
    def _count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if self.registry is not None:
            self.registry.counter(f"resilience/{name}").inc(n)

    # -- submission (manager-facing) ------------------------------------
    def maybe_submit(self, step: int, files: Dict[str, bytes],
                     force: bool = False) -> bool:
        """Queue one verified local step for mirroring.  Returns True
        when the job was queued; False when skipped (off-cadence, or
        the uploader is saturated — the step loop must never wait on
        the mirror).  `force` bypasses cadence and (best-effort) queue
        limits — emergency saves use it."""
        if force:
            # an emergency re-submit skips only when the step is KNOWN
            # durably mirrored — a queued-but-abandoned upload (outage
            # past the budget) must get its second chance
            if step == self._mirrored:
                return False
        elif step == self._last_queued:
            return False  # already queued (a restore-replay re-save)
        self._submitted += 1
        if not force and (self._submitted - 1) % self.every:
            return False
        if not force and self._writer.queue_depth >= self.MAX_PENDING_UPLOADS:
            self._count("offload_skipped")
            _log.warning(
                "offload queue saturated (%d pending): skipping step %d "
                "(local tier still holds it)",
                self._writer.queue_depth, step,
            )
            return False
        self._writer.submit(step, lambda: self._upload_job(step, files))
        self._last_queued = step
        return True

    @property
    def queue_depth(self) -> int:
        return self._writer.queue_depth

    # -- uploader thread --------------------------------------------------
    def _upload_job(self, step: int, files: Dict[str, bytes]) -> None:
        if step == self._mirrored:
            # duplicate job: an emergency force-submit raced the
            # cadence upload of the same step and that one has already
            # landed verified — don't burn the grace window re-uploading
            # (and double-counting) the identical payload
            return
        attempts = 0
        t0 = time.perf_counter()
        while True:
            try:
                # injected uploader-path CheckpointWriteFault (payload
                # target="remote"): fires once, then the retry succeeds
                self.fault_plan.check_offload(step)
                report = self.remote.upload_step(
                    step, files,
                    base_step=self._mirrored,
                    base_manifest=self._mirrored_manifest,
                )
            except Exception as e:  # noqa: BLE001 — classified below
                transient = isinstance(
                    e, (BlobUnavailableError, RemoteVerifyError,
                        CheckpointWriteFault, OSError)
                )
                if isinstance(e, RemoteVerifyError):
                    self._count("offload_verify_failures")
                if not transient:
                    self._count("offload_failures")
                    _log.warning(
                        "offload of step %d failed permanently: %s", step, e,
                    )
                    return
                attempts += 1
                if not self.retry.admits(attempts):
                    # past the budget: degrade to local-only durability —
                    # the run keeps training, the mirror catches up at
                    # the next cadence point if the store comes back
                    self._count("offload_failures")
                    if isinstance(e, BlobUnavailableError):
                        self._count("offload_unavailable")
                    _log.warning(
                        "offload of step %d abandoned after %d attempts "
                        "(%s); continuing with local-only durability",
                        step, attempts, e,
                    )
                    return
                self._count("offload_retries")
                self.sleep(self.retry.backoff(attempts))
                continue
            break
        self._count("offload_uploads")
        self._count("offload_bytes", report.bytes_uploaded)
        if report.leaves_skipped:
            self._count("offload_leaves_skipped", report.leaves_skipped)
        self._mirrored_manifest = report.manifest
        self._mirrored = step
        if self.registry is not None:
            self.registry.histogram("resilience/offload_upload_ms").observe(
                (time.perf_counter() - t0) * 1e3
            )
        try:
            self.remote.prune(self.keep)
        except BlobStoreError as e:
            _log.info("remote prune after step %d failed: %s", step, e)

    # -- lifecycle -------------------------------------------------------
    def drain(self) -> List:
        """Block until queued uploads finish (or are abandoned within
        their budgets).  Upload failures are already folded into
        counters — the returned list covers only uploader-thread
        crashes (a bug, not a store failure)."""
        return self._writer.drain()

    def close(self) -> None:
        self._writer.close()


def offloader_from_config(cfg, *, blob: Optional[BlobStore] = None,
                          fault_plan=None, registry=None,
                          sleep: Callable[[float], None] = time.sleep,
                          ) -> Optional[CheckpointOffloader]:
    """Build the run's CheckpointOffloader from FFConfig
    (remote_store/offload_every/remote_keep), or None when no remote
    tier is configured.  `blob` overrides the URI resolution (tests
    inject FaultyBlobStore here); an unusable remote root degrades to
    offload-off with a log line — durability tiers are upgrades, never
    crash sources."""
    uri = getattr(cfg, "remote_store", None)
    if blob is None:
        if not uri or str(uri).strip().lower() == "none":
            return None
        from ..store.blobstore import blobstore_from_uri

        try:
            blob = blobstore_from_uri(uri)
        except (OSError, ValueError, NotImplementedError) as e:
            _log.warning(
                "remote store %r unusable (%s); continuing without the "
                "offload tier", uri, e,
            )
            return None
    remote = RemoteCheckpointStore(blob)
    return CheckpointOffloader(
        remote,
        every=max(1, int(getattr(cfg, "offload_every", 1))),
        keep=max(1, int(getattr(cfg, "remote_keep", 3))),
        retry=RetryPolicy(
            max_restarts=getattr(cfg, "max_restarts", 3),
            base_backoff=getattr(cfg, "retry_backoff", 0.1),
            seed=getattr(cfg, "seed", 0),
        ),
        fault_plan=fault_plan,
        registry=registry,
        sleep=sleep,
    )


__all__ = [
    "MAX_DELTA_CHAIN",
    "REMOTE_LATEST",
    "STEP_FILES",
    "CheckpointOffloader",
    "RemoteCheckpointStore",
    "RemoteVerifyError",
    "UploadReport",
    "offloader_from_config",
]
