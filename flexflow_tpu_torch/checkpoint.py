"""Checkpoints of the full train state (flexflow_tpu/checkpoint.py):
verified saves off the step path, restore onto another mesh, and the
plain npz weight files.

A checkpoint holds every weight, every optimizer slot (and Adam's step
count), the op state (BatchNorm's running statistics, decode caches)
and the step's random-number generator, as global arrays: on a
`torch.distributed` group each sharded leaf is gathered first (ZeRO
stages 1-3 and the strategy's shardings alike), and rank 0 writes while
the other ranks wait for it.  Restore slices each global array to this
rank's shard through the executor's own layouts (`GraphExecutor.local`,
FFModel._shard's), so a checkpoint taken under one mesh or ZeRO stage
resumes under another, and it writes into the live tensors with
`copy_`: a captured step (capture.py) replays on the same weight, slot,
op-state and generator tensors every time, so rebinding them would
leave the replays training the old state.

  * **LocalCheckpointManager** (the reference's layout on disk):
    `step_%08d/{state.npz, meta.json, manifest.json}` and a `LATEST`
    pointer.  A step is staged in a `.tmp-*` directory, fsynced, read
    back and checked against its per-leaf crc32 manifest, then renamed
    into place, and only then does `LATEST` advance; keep-last-k
    retention never prunes the newest verified step; restore checks
    every leaf again and falls back past a corrupt, partial or
    incompatible step to the newest intact one.  `save(wait=False)`
    stalls the loop only for the copy to the host (on a card into
    pinned memory, with an event the writer waits on), and a background
    writer (resilience/async_writer.py) does the rest; `drain()` waits
    for it and returns the failures; at MAX_PENDING_SAVES queued saves
    the next one waits.
  * **CheckpointManager** is the same manager with the leaves written
    by `torch.distributed.checkpoint` (`step_%08d/state/` in place of
    `state.npz`), where the reference writes with orbax.
  * A saved tree that does not match the model raises
    `CheckpointCompatibilityError` naming every mismatched leaf.  A
    checkpoint saved per op restores onto a pipeline's stacked
    `__pipeline__` weights and back (FFModel._adapt_weight_layout, for
    the weights and each weight-shaped optimizer slot).

The leaves' keys are the reference's key strings:
`['weights']['<op>']['<w>']`, `['op_state']['<op>']['<name>']`,
`['opt_state']['<slot>']['<op>']['<w>']` and `['opt_state']['t']`.
The weight and op-state leaves are the reference's own arrays, so a
port checkpoint's weights load into the reference model and the
reference's `_verify_dir` checks a port step directory.  The optimizer
slots and the generator are the port's own: the slots hold what the
port's optimizer keeps (optimizer.py), and `['rng']` is the torch
generator's state (`Generator.get_state()`, uint8), where the
reference keeps a jax key.

  * **The remote tier** (resilience/offload.py): with an `offloader`,
    rank 0 hands every published step to it, which mirrors the step's
    files to an object store off the step path (a DCP step's leaves as
    one state.npz); `offload_step` mirrors one step whatever the
    cadence (the emergency save).  With a `remote` (the offloader's by
    default) restore walks every step of both tiers newest first: the
    local step, else the same step's verified mirror, downloaded,
    checked, written into the directory in the manager's own format and
    loaded from there, else the next older step; an empty directory on
    a new host restores from the mirror alone.

`save_weights_npz` and `load_weights_npz` are the weights-only npz
files, one key `op/weight` per trainable weight in the reference's
layout: a file written by either package loads into the other.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import json
import logging
import math
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .obs.metrics import registry_of
from .obs.trace import tracer_of

_log = logging.getLogger("flexflow_tpu_torch.checkpoint")

MANIFEST_VERSION = 1
_LATEST_FILE = "LATEST"


class CheckpointVerifyError(RuntimeError):
    """A checkpoint's bytes do not match its integrity manifest."""


class CheckpointCompatibilityError(RuntimeError):
    """The checkpoint's state tree does not match the model's: another
    architecture, optimizer or op-state layout.  The mesh size and the
    ZeRO stage never raise it (restore reshards)."""

    def __init__(self, step: int, mismatches: List[str],
                 meta: Optional[Dict] = None):
        self.step = step
        self.mismatches = list(mismatches)
        meta = meta or {}
        context = (f" (saved with num_devices={meta.get('num_devices')}, "
                   f"zero_stage={meta.get('zero_stage')}, "
                   f"wus_axis={meta.get('wus_axis')})" if meta else "")
        shown = "; ".join(self.mismatches[:8])
        more = (f"; ... {len(self.mismatches) - 8} more"
                if len(self.mismatches) > 8 else "")
        super().__init__(f"checkpoint step {step} is incompatible with the "
                         f"current run{context}: {shown}{more}")


def _meta(ff, step: int) -> Dict[str, Any]:
    """meta.json's fields, the reference's."""
    zero = int(getattr(ff.executor, "zero_stage", 0) or 0)
    return {
        "step": step,
        "version": 1,
        "strategy": ff.strategy.to_json() if ff.strategy is not None
        else None,
        "batch_size": ff.config.batch_size,
        "num_devices": int(ff.strategy.total_devices)
        if ff.strategy is not None else 1,
        "zero_stage": zero,
        "weight_update_sharding": zero >= 1,
        "wus_axis": ff.config.wus_axis,
    }


# -- the state tree -----------------------------------------------------

def _key(*path: str) -> str:
    return "".join(f"['{p}']" for p in path)


def _np_dtype(dtype: torch.dtype) -> str:
    try:
        return str(torch.empty(0, dtype=dtype).numpy().dtype)
    except TypeError:
        raise TypeError(f"a checkpoint leaf of dtype {dtype} has no numpy "
                        "counterpart") from None


def _state_leaves(ff) -> List[Tuple[str, torch.Tensor, Any, tuple]]:
    """(key, live tensor, layout of its global array or None, global
    shape) of every tensor leaf of the train state, in a fixed order;
    the generator is not among them (`['rng']`)."""
    ex = ff.executor
    mesh = ex.mesh
    out = []

    def add(key, t, layout):
        shape = tuple(t.shape)
        if mesh is not None and layout is not None:
            shape = tuple(
                n * math.prod(mesh.size(a) for a in axes)
                for n, axes in zip(shape, tuple(layout.spec)
                                   + ((),) * (len(shape) - len(layout.spec))))
        out.append((key, t, layout if mesh is not None else None, shape))

    for op, entries in ff._weights.items():
        for k, w in entries.items():
            add(_key("weights", op, k), w,
                ex.w_store[(op, k)] if mesh is not None else None)
    for slot, sub in (ff._opt_state or {}).items():
        if isinstance(sub, dict):
            for op, entries in sub.items():
                for k, v in entries.items():
                    lay = None
                    if mesh is not None:
                        lay = (ex.w_update[(op, k)]
                               if ex._sharded_update((op, k))
                               else ex.w_store[(op, k)])
                    add(_key("opt_state", slot, op, k), v, lay)
        else:
            add(_key("opt_state", slot), sub, None)
    for op, entries in (ff._state or {}).items():
        for k, v in entries.items():
            add(_key("op_state", op, k), v,
                ex.w_store[(op, k)] if mesh is not None else None)
    return out


def _current_specs(ff) -> Dict[str, Dict[str, Any]]:
    """{key: {shape, dtype}} of the model's train state (global shapes)."""
    specs = {key: {"shape": list(shape), "dtype": _np_dtype(t.dtype)}
             for key, t, _, shape in _state_leaves(ff)}
    rng = ff._generator.get_state()
    specs[_key("rng")] = {"shape": list(rng.shape),
                          "dtype": _np_dtype(rng.dtype)}
    return specs


def _is_writer() -> bool:
    """Whether this process writes: rank 0 of a group, or no group."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _group_size() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _agree(ok: bool) -> bool:
    """On a group, whether every rank had `ok` (a barrier that carries
    rank 0's write status to the others); alone, `ok`."""
    if _group_size() == 1:
        return ok
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([0 if ok else 1], dtype=torch.int32, device=device)
    dist.all_reduce(flag)
    return int(flag.item()) == 0


class _PinnedPool:
    """Page-locked host arenas for snapshots of a card's state, kept for
    the next save once a write is done: page-locking a gigabyte costs far
    more than the copy into it."""

    def __init__(self):
        self._free: List[torch.Tensor] = []
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            for i, arena in enumerate(self._free):
                if arena.numel() >= nbytes:
                    return self._free.pop(i)
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, arena: torch.Tensor) -> None:
        with self._lock:
            self._free.append(arena)


_ALIGN = 64  # bytes between leaves in an arena


class _Snapshot:
    """The train state copied to the host (global arrays, on the writing
    rank only).  From a card: into one page-locked arena (from `pool`,
    given back by `release()`), with non-blocking copies behind one
    event that `arrays()` waits on before numpy reads them.  On the CPU
    `own` copies the tensors (an async save must not alias tensors the
    next step updates in place)."""

    def __init__(self, ff, own: bool, pool: Optional[_PinnedPool] = None):
        from .parallel.collectives import gather_global, traffic_scope

        self.tensors: Dict[str, torch.Tensor] = {}
        self.event = None
        self._arena, self._pool = None, pool
        write = _is_writer()
        mesh = ff.executor.mesh
        on_card: List[Tuple[str, torch.Tensor]] = []
        with torch.no_grad(), traffic_scope("checkpoint"):
            for key, t, layout, _ in _state_leaves(ff):
                g = t.detach()
                if layout is not None:
                    g = gather_global(g, layout, mesh)
                if not write:
                    continue
                _np_dtype(g.dtype)  # refuse a dtype numpy cannot hold
                if g.device.type == "cuda":
                    on_card.append((key, g))
                    self.tensors[key] = None  # keeps the leaves' order
                else:
                    self.tensors[key] = g.clone() if own else g
            if on_card:
                sizes = [-(-g.numel() * g.element_size() // _ALIGN) * _ALIGN
                         for _, g in on_card]
                self._arena = (pool.take(sum(sizes)) if pool is not None
                               else torch.empty(sum(sizes), dtype=torch.uint8,
                                                pin_memory=True))
                off = 0
                for (key, g), size in zip(on_card, sizes):
                    n = g.numel() * g.element_size()
                    buf = self._arena[off:off + n].view(g.dtype).view(g.shape)
                    buf.copy_(g, non_blocking=True)
                    self.tensors[key] = buf
                    off += size
                self.event = torch.cuda.Event()
                self.event.record()
            if write:
                self.tensors[_key("rng")] = ff._generator.get_state().clone()
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in self.tensors.values())

    def arrays(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {k: t.numpy() for k, t in self.tensors.items()}

    def release(self) -> None:
        """Give the arena back to the pool (the arrays die with it)."""
        if self._arena is not None and self._pool is not None:
            self._pool.give(self._arena)
        self._arena = None
        self.tensors = {}


def _copy_into(ff, arrays: Dict[str, np.ndarray]) -> None:
    """Write validated global arrays into the model's live tensors (this
    rank's shard of each) and the generator's state."""
    mesh = ff.executor.mesh
    from .parallel.collectives import local_slice

    with torch.no_grad():
        for key, t, layout, _ in _state_leaves(ff):
            a = torch.as_tensor(arrays[key])
            if layout is not None:
                a = local_slice(a, layout, mesh)
            t.copy_(a)
    ff._generator.set_state(torch.tensor(arrays[_key("rng")]))
    if hasattr(ff, "_sync_decode_pos"):
        ff._sync_decode_pos()


# -- manifests and durable writes ---------------------------------------

def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))


def _build_manifest(step: int, flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    leaves = {key: {"crc32": _leaf_crc(arr), "bytes": int(arr.nbytes),
                    "shape": list(arr.shape), "dtype": str(arr.dtype)}
              for key, arr in flat.items()}
    return {"manifest_version": MANIFEST_VERSION, "step": step,
            "total_bytes": sum(v["bytes"] for v in leaves.values()),
            "leaves": leaves}


def _write_json_fsync(path: str, obj: Dict) -> None:
    """`obj` as JSON at `path`, flushed to the disk before returning."""
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Flush a directory's entries (a rename into it) to the disk."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # a platform without directory descriptors
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _LatestPointer:
    """The `LATEST` file: the newest step that passed verification.  It
    advances only after a save verified and published, so a reader that
    trusts it never lands on a torn write."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, _LATEST_FILE)

    def read(self) -> Optional[int]:
        try:
            with open(self.path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def advance(self, step: int, force: bool = False) -> None:
        cur = self.read()
        if not force and cur is not None and cur >= step:
            return
        # a name per thread: the writer thread and a synchronous save
        # must not share a staging file
        tmp = f"{self.path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(self.directory)


# -- layouts --------------------------------------------------------------

_KEYSTR_TOKEN_RE = re.compile(r"\['([^']*)'\]")


def _unflatten_keystr(flat: Dict[str, Any]) -> Optional[Dict]:
    """The nested dict a key-string-keyed mapping came from, or None when
    a key is not a path of string keys."""
    root: Dict = {}
    for key, leaf in flat.items():
        toks = _KEYSTR_TOKEN_RE.findall(key)
        if not toks or "".join(f"['{t}']" for t in toks) != key:
            return None
        d = root
        for t in toks[:-1]:
            d = d.setdefault(t, {})
            if not isinstance(d, dict):
                return None
        d[toks[-1]] = leaf
    return root


def _flatten_keystr(tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_flatten_keystr(v, key))
        else:
            out[key] = v
    return out


def _adapt_saved_layout(ff, arrays: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
    """A saved state mapped between the per-op and the
    `__pipeline__`-stacked weight layouts to match the model's executor,
    through FFModel._adapt_weight_layout for the weights and each
    weight-shaped optimizer slot.  A failed mapping returns the arrays
    as they are, so the spec check names the real mismatch."""
    saved_pp = any(k.startswith("['weights']['__pipeline__']")
                   for k in arrays)
    cur_pp = "__pipeline__" in (ff._weights or {})
    if saved_pp == cur_pp:
        return arrays
    nested = _unflatten_keystr(arrays)
    if nested is None or "weights" not in nested:
        return arrays
    try:
        out = dict(nested)
        out["weights"] = ff._adapt_weight_layout(nested["weights"])
        if isinstance(nested.get("opt_state"), dict):
            out["opt_state"] = {
                k: ff._adapt_weight_layout(sub) if isinstance(sub, dict)
                else sub for k, sub in nested["opt_state"].items()}
        return _flatten_keystr(out)
    except Exception as e:  # noqa: BLE001 - the spec check reports it
        _log.warning("pipeline layout adaptation failed (%s); restoring "
                     "with the saved layout as it is", e)
        return arrays


def _spec_mismatches(saved: Dict[str, Dict], current: Dict[str, Dict]
                     ) -> List[str]:
    """Every structural difference between a saved tree's specs and the
    model's (empty: compatible)."""
    problems = []
    for key in sorted(set(saved) - set(current)):
        problems.append(f"{key}: in checkpoint but not in current state")
    for key in sorted(set(current) - set(saved)):
        problems.append(f"{key}: required by current state, missing "
                        "from checkpoint")
    for key in sorted(set(saved) & set(current)):
        s, c = saved[key], current[key]
        if list(s["shape"]) != list(c["shape"]):
            problems.append(f"{key}: shape {tuple(s['shape'])} in checkpoint "
                            f"vs {tuple(c['shape'])} in current state")
        elif str(s["dtype"]) != str(c["dtype"]):
            problems.append(f"{key}: dtype {s['dtype']} in checkpoint vs "
                            f"{c['dtype']} in current state")
    return problems


def _verify_adapt_load(ff, arrays: Dict[str, np.ndarray],
                       manifest: Optional[Dict], meta: Optional[Dict],
                       step: int) -> None:
    """The restore core: crc-check every leaf against the manifest's
    saved keys first (corruption is a verify error, never a layout
    error), map per-op <-> `__pipeline__` layouts, check the specs,
    then write the arrays into the model."""
    if manifest is not None:
        for key, spec in manifest["leaves"].items():
            arr = arrays.get(key)
            if arr is None:
                raise CheckpointVerifyError(
                    f"step {step}: leaf {key!r} in manifest but not in "
                    "the saved leaves")
            crc = _leaf_crc(arr)
            if crc != spec["crc32"]:
                raise CheckpointVerifyError(
                    f"step {step}: leaf {key!r} crc32 {crc:#010x} != "
                    f"manifest {spec['crc32']:#010x}")
        unverified = sorted(set(arrays) - set(manifest["leaves"]))
        if unverified:
            shown = ", ".join(repr(k) for k in unverified[:5])
            more = (f", ... {len(unverified) - 5} more"
                    if len(unverified) > 5 else "")
            raise CheckpointVerifyError(
                f"step {step}: saved leaves missing from the manifest "
                f"(unverifiable): {shown}{more}")
    arrays = _adapt_saved_layout(ff, arrays)
    saved = {key: {"shape": list(arr.shape), "dtype": str(arr.dtype)}
             for key, arr in arrays.items()}
    mismatches = _spec_mismatches(saved, _current_specs(ff))
    if mismatches:
        raise CheckpointCompatibilityError(step, mismatches, meta)
    _copy_into(ff, arrays)


def state_arrays(ff) -> Dict[str, np.ndarray]:
    """The full train state as global numpy arrays keyed as a
    checkpoint's leaves, on every rank of a group (each sharded leaf
    gathered: every rank must call).  FFModel.recompile carries the state
    across a compile with it."""
    from .parallel.collectives import gather_global

    mesh = ff.executor.mesh
    out = {}
    with torch.no_grad():
        for key, t, layout, _ in _state_leaves(ff):
            g = t.detach()
            if layout is not None:
                g = gather_global(g, layout, mesh)
            _np_dtype(g.dtype)  # refuse a dtype numpy cannot hold
            out[key] = g.to("cpu", copy=True).numpy()
    out[_key("rng")] = ff._generator.get_state().clone().numpy()
    return out


def load_state_arrays(ff, arrays: Dict[str, np.ndarray]) -> None:
    """`state_arrays`' output written into a compiled model in place:
    per-op and `__pipeline__` layouts mapped, each leaf checked against
    the model's and sliced to this rank's shard."""
    _verify_adapt_load(ff, arrays, None, None, -1)


# -- the managers ----------------------------------------------------------

_STEP_DIR_RE = re.compile(r"step_(\d{8})")


@contextlib.contextmanager
def _dcp_errors(where):
    """DCP's CheckpointException (a BaseException) as a RuntimeError, so
    that the fallback walk and the async writer handle it as any other
    failed step."""
    from torch.distributed.checkpoint.api import CheckpointException

    try:
        yield
    except CheckpointException as e:
        raise RuntimeError(f"checkpoint {where}: {e}") from e


class LocalCheckpointManager:
    """Full-train-state checkpoints as one flat .npz, meta.json and a
    crc32 manifest.json per step (see the module's note).  Every rank of
    a group calls save, restore and drain; rank 0 writes.  The leaves'
    file format is `STATE` with `_write_leaves` and `_open_leaves`
    (CheckpointManager's is DCP's)."""

    # a save(wait=False) that finds this many jobs queued waits for the
    # backlog first: each queued job holds a host copy of the whole state
    MAX_PENDING_SAVES = 2
    #: the name of a step's leaves in its directory, and the spans' label
    STATE, BACKEND = "state.npz", "local"

    def __init__(self, directory: str, max_to_keep: int = 3,
                 offloader=None, remote=None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        if _is_writer():
            # staging directories of a writer that died mid-save
            for name in os.listdir(self.directory):
                if name.startswith(".tmp-"):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        self._latest = _LatestPointer(self.directory)
        self._writer = None  # made by the first wait=False save
        self._tmp_ids = itertools.count()
        self._pinned = _PinnedPool()
        # the second tier (resilience/offload.py): the offloader mirrors
        # each published step; `remote` alone serves restores
        self.offloader = offloader
        self.remote = remote if remote is not None else (
            offloader.remote if offloader is not None else None)

    # -- the leaves' file format ------------------------------------------
    @classmethod
    def _write_leaves(cls, step_dir: str, flat: Dict[str, np.ndarray]
                      ) -> None:
        with open(os.path.join(step_dir, cls.STATE), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())

    @classmethod
    def _open_leaves(cls, step_dir: str):
        """A context manager over {key: array} of a step's leaves (read
        lazily, leaf by leaf)."""
        return np.load(os.path.join(step_dir, cls.STATE))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self):
        return sorted(int(m.group(1)) for m in
                      map(_STEP_DIR_RE.fullmatch, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_verified_step(self) -> Optional[int]:
        """The step LATEST names, None when it is absent or names no
        directory."""
        step = self._latest.read()
        if step is None or not os.path.isdir(self._path(step)):
            return None
        return step

    def any_restorable(self) -> bool:
        """Whether either tier holds a step (a new host with an empty
        directory resumes from the remote mirror)."""
        return self.latest_step() is not None or bool(self._remote_steps())

    # -- save -----------------------------------------------------------
    def _writer_obj(self):
        if self._writer is None:
            from .resilience.async_writer import AsyncCheckpointWriter

            self._writer = AsyncCheckpointWriter()
        return self._writer

    def save(self, ff, step: int, wait: bool = True):
        """One checkpoint of the full train state.  wait=True: copied,
        written, verified and published before it returns.  wait=False:
        only the copy to the host happens here; the step appears in
        latest_step() and restore() once the writer publishes it
        (drain() waits for that)."""
        tracer = tracer_of(ff)
        registry = registry_of(ff)
        with tracer.span("checkpoint_write", cat="checkpoint", step=step,
                         backend=self.BACKEND,
                         mode="sync" if wait else "async"):
            with tracer.span("snapshot", cat="checkpoint", step=step):
                snap = _Snapshot(ff, own=not wait, pool=self._pinned)
                meta = _meta(ff, step)
            if registry is not None:
                registry.gauge("resilience/ckpt_bytes").set(snap.nbytes)
            if wait:
                ok = False
                try:
                    if _is_writer():
                        with tracer.span("flush", cat="checkpoint",
                                         step=step):
                            self._write_and_publish(step, snap.arrays(),
                                                    meta, registry)
                    ok = True
                finally:
                    snap.release()
                    agreed = _agree(ok)
                if not agreed:
                    raise RuntimeError(
                        f"checkpoint step {step}: rank 0's write failed")
                return
            if not _is_writer():
                return
            writer = self._writer_obj()
            if registry is not None:
                writer.depth_cb = registry.gauge(
                    "resilience/ckpt_queue_depth").set
            if writer.queue_depth >= self.MAX_PENDING_SAVES:
                _log.warning(
                    "async checkpoint writer backlog (%d pending) at step "
                    "%d: draining before the next save (the cadence "
                    "outruns the disk)", writer.queue_depth, step)
                writer.wait()  # the failures stay for drain()
            writer.submit(step, lambda: self._flush_job(
                step, snap, meta, tracer, registry))

    def _flush_job(self, step, snap, meta, tracer, registry):
        """The writer thread's half of an async save (a `flush` span on
        the writer's thread, beside the next steps)."""
        with tracer.span("flush", cat="checkpoint", step=step,
                         backend=self.BACKEND, mode="async"):
            try:
                self._write_and_publish(step, snap.arrays(), meta, registry)
            finally:
                snap.release()

    def _write_and_publish(self, step, flat, meta, registry=None):
        """Serialize, fsync, read back and crc-check, rename into place,
        advance LATEST, prune.  A failure leaves what was published, and
        the pointer, as they were."""
        t0 = time.perf_counter()
        manifest = _build_manifest(step, flat)
        tmp = os.path.join(self.directory,
                           f".tmp-{step}-{os.getpid()}-{next(self._tmp_ids)}")
        os.makedirs(tmp)
        try:
            self._write_leaves(tmp, flat)
            _write_json_fsync(os.path.join(tmp, "meta.json"), meta)
            _write_json_fsync(os.path.join(tmp, "manifest.json"), manifest)
            try:
                self._verify_dir(tmp, manifest)
            except CheckpointVerifyError:
                if registry is not None:
                    registry.counter("resilience/ckpt_verify_failures").inc()
                raise
            final = self._path(step)
            if os.path.exists(final):
                # a resumed run saving a step again: the fresh write wins
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._latest.advance(step)
        self._prune()
        if registry is not None:
            registry.histogram("resilience/ckpt_write_latency_s").observe(
                time.perf_counter() - t0)
        self._offload_published(step)

    @classmethod
    def _mirror_files(cls, step_dir: str) -> Dict[str, bytes]:
        """A published step's files as the remote tier keeps them:
        state.npz (a DCP step's leaves written as one), meta.json and
        manifest.json."""
        files = {}
        for name in ("meta.json", "manifest.json"):
            with open(os.path.join(step_dir, name), "rb") as f:
                files[name] = f.read()
        if cls.STATE == "state.npz":
            with open(os.path.join(step_dir, cls.STATE), "rb") as f:
                files["state.npz"] = f.read()
        else:
            buf = io.BytesIO()
            with cls._open_leaves(step_dir) as data:
                np.savez(buf, **data)
            files["state.npz"] = buf.getvalue()
        return files

    def _offload_published(self, step: int, force: bool = False) -> bool:
        """Hand one published step to the offload tier, its files read
        back from the step directory (what the write's verification
        passed).  Never raises into the publish: the local tier stays
        whole when the mirror is broken."""
        if self.offloader is None or not _is_writer():
            return False
        try:
            files = self._mirror_files(self._path(step))
        except (OSError, RuntimeError) as e:  # pruned or torn meanwhile
            _log.warning("offload of step %d skipped: its files are "
                         "unreadable (%s)", step, e)
            return False
        return self.offloader.maybe_submit(step, files, force=force)

    def offload_step(self, step: int) -> bool:
        """Mirror one published step whatever the cadence (the
        supervisor's emergency save)."""
        return self._offload_published(step, force=True)

    @classmethod
    def _verify_dir(cls, path: str, manifest: Optional[Dict] = None) -> Dict:
        """Read a step directory back and check every leaf against its
        manifest's crc32; CheckpointVerifyError on any mismatch, a
        missing leaf or a leaf the manifest does not list.  Returns the
        manifest."""
        if manifest is None:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        with cls._open_leaves(path) as data:
            for key, spec in manifest["leaves"].items():
                if key not in data:
                    raise CheckpointVerifyError(
                        f"{path}: leaf {key!r} in manifest but not in "
                        f"{cls.STATE}")
                crc = _leaf_crc(data[key])
                if crc != spec["crc32"]:
                    raise CheckpointVerifyError(
                        f"{path}: leaf {key!r} crc32 {crc:#010x} != "
                        f"manifest {spec['crc32']:#010x}")
            for key in data:
                if key not in manifest["leaves"]:
                    raise CheckpointVerifyError(
                        f"{path}: leaf {key!r} in {cls.STATE} but missing "
                        "from the manifest (unverifiable)")
        return manifest

    def drain(self) -> List[Tuple[int, Exception]]:
        """Wait for every queued save to publish or fail; returns the
        (step, error) failures.  On a group every rank waits for rank 0's
        writer."""
        failures = self._writer.drain() if self._writer is not None else []
        _agree(True)
        return failures

    def _prune(self):
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:])
        # the newest verified step is never pruned, even outside the
        # window
        verified = self.latest_verified_step()
        if verified is not None:
            keep.add(verified)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def _remote_steps(self) -> List[int]:
        """The steps the remote tier lists; none without one, or when it
        cannot be listed (restore then reads the local tier alone)."""
        if self.remote is None:
            return []
        try:
            return self.remote.list_steps()
        except Exception as e:  # noqa: BLE001 - any store failure
            _log.warning("remote checkpoint tier unlistable (%s); restoring "
                         "from the local tier only", e)
            return []

    def _materialize_remote(self, step: int) -> None:
        """Download one mirrored step, write it into a staging directory
        in this manager's format, check every leaf against its manifest,
        and publish it as a local step (a corrupt local copy gives way to
        it).  A torn or corrupt mirror never lands."""
        files = self.remote.download_step(step)
        tmp = os.path.join(self.directory, f".tmp-remote-{step}-"
                           f"{os.getpid()}-{next(self._tmp_ids)}")
        os.makedirs(tmp)
        try:
            if self.STATE == "state.npz":
                with open(os.path.join(tmp, self.STATE), "wb") as f:
                    f.write(files["state.npz"])
                    f.flush()
                    os.fsync(f.fileno())
            else:
                with np.load(io.BytesIO(files["state.npz"])) as data:
                    self._write_leaves(tmp, {k: data[k] for k in data.files})
            for name in ("meta.json", "manifest.json"):
                json.loads(files[name])  # must parse before it publishes
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(files[name])
                    f.flush()
                    os.fsync(f.fileno())
            self._verify_dir(tmp)
            final = self._path(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._latest.advance(step)

    def _restore_remote_step(self, ff, step: int) -> None:
        """Load a step from its remote mirror: rank 0 materializes it
        into the directory, every rank then loads it from there."""
        ok, err = True, None
        if _is_writer():
            try:
                self._materialize_remote(step)
            except Exception as e:  # noqa: BLE001 - raised below
                ok, err = False, e
        if not _agree(ok):
            raise err or RuntimeError(
                f"checkpoint step {step}: rank 0 could not fetch its remote "
                "mirror")
        self._load_step(ff, step)
        registry = registry_of(ff)
        if registry is not None:
            registry.counter("resilience/offload_remote_restores").inc()
        _log.info("step %d restored from the remote tier into %s", step,
                  self.directory)

    def restore(self, ff, step: Optional[int] = None) -> int:
        """Load a step into a compiled model, in place (see the module's
        note); returns it.  With step=None the newest step of either tier
        that restores: each step from the directory, else from its remote
        mirror, falling back past corrupt, partial or incompatible ones
        (and LATEST is pointed at the step that restored); a step asked
        for by number is strict (its mirror still serves it when the
        directory cannot)."""
        strict = step is not None
        local_steps = set(self.all_steps())
        remote_steps = set(self._remote_steps())
        if self.remote is not None:
            # every rank has listed before rank 0 materializes a step
            _agree(True)
        candidates = ([step] if strict
                      else sorted(local_steps | remote_steps, reverse=True))
        if not candidates:
            where = f"no checkpoints in {self.directory}"
            if self.remote is not None:
                where += " (remote tier empty too)"
            raise FileNotFoundError(where)
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                if s in local_steps or (strict and s not in remote_steps):
                    try:
                        self._load_step(ff, s)
                    except CheckpointCompatibilityError:
                        raise  # the mirror holds the same leaves
                    except Exception as e:  # noqa: BLE001 - try the mirror
                        if s not in remote_steps:
                            raise
                        _log.warning("local step %d unrestorable (%s); "
                                     "trying its remote mirror", s, e)
                        self._restore_remote_step(ff, s)
                else:
                    self._restore_remote_step(ff, s)
            except Exception as e:  # noqa: BLE001 - fall back, see above
                if strict:
                    raise
                _log.warning("checkpoint step %d in %s unrestorable (%s); "
                             "falling back to the previous step", s,
                             self.directory, e)
                last_err = e
                continue
            if last_err is not None:
                _log.warning("restored OLDER step %d from %s: newer step(s) "
                             "were corrupt or partial, their progress is "
                             "lost", s, self.directory)
                if _is_writer():
                    self._latest.advance(s, force=True)
            return int(s)
        raise last_err

    def _load_step(self, ff, step: int) -> None:
        path = self._path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)  # meta must parse for the step to count
        manifest = None
        manifest_path = os.path.join(path, "manifest.json")
        if os.path.exists(manifest_path):  # absent in older checkpoints
            with open(manifest_path) as f:
                manifest = json.load(f)
        with self._open_leaves(path) as data:
            arrays = {key: data[key] for key in data}
        _verify_adapt_load(ff, arrays, manifest, meta, step)

    def restore_meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self._path(step), "meta.json")) as f:
            return dict(json.load(f))

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class CheckpointManager(LocalCheckpointManager):
    """The same manager (snapshot, manifest, verify, publish, retention,
    LATEST, async writes and the fallback walk) with the leaves written
    by `torch.distributed.checkpoint` into `step_%08d/state/`, where the
    reference writes with orbax.  Rank 0 writes the gathered global
    arrays, as the npz manager does: DCP runs without collectives
    (`no_dist`), and a save in which each rank writes its own shards is
    not ported."""

    STATE, BACKEND = "state", "dcp"

    @classmethod
    def _write_leaves(cls, step_dir: str, flat: Dict[str, np.ndarray]
                      ) -> None:
        import torch.distributed.checkpoint as dcp

        # FileSystemWriter fsyncs each file it writes (sync_files)
        with _dcp_errors(step_dir):
            # (np.ascontiguousarray would make a 0-d leaf 1-d)
            dcp.save({k: torch.from_numpy(
                          v if v.flags.c_contiguous else v.copy())
                      for k, v in flat.items()},
                     storage_writer=dcp.FileSystemWriter(
                         os.path.join(step_dir, cls.STATE)),
                     no_dist=True)

    @classmethod
    @contextlib.contextmanager
    def _open_leaves(cls, step_dir: str):
        import torch.distributed.checkpoint as dcp

        path = os.path.join(step_dir, cls.STATE)
        with _dcp_errors(step_dir):
            specs = dcp.FileSystemReader(
                path).read_metadata().state_dict_metadata
            sd = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                  for k, m in specs.items()}
            dcp.load(sd, storage_reader=dcp.FileSystemReader(path),
                     no_dist=True)
        yield {k: v.numpy() for k, v in sd.items()}


class ModelCheckpoint:
    """The Keras-style callback (the reference's): saves the full train
    state at every epoch's end, or, with `every_steps` > 0, after every
    `every_steps` steps, numbered from `initial_step` (a resumed run
    passes the step it restored).  `directory` and `every_steps` default
    to FFConfig.checkpoint_dir and checkpoint_every.  `local` picks
    LocalCheckpointManager, else CheckpointManager; `async_save` saves
    with wait=False, and fit drains the manager in every exit; a save
    that failed raises at the end of training."""

    def __init__(self, directory: Optional[str] = None, max_to_keep: int = 3,
                 async_save: bool = False, every_steps: Optional[int] = None,
                 local: bool = False, initial_step: int = 0):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.every_steps = every_steps
        self.local = local
        self.initial_step = int(initial_step)
        self.manager = None
        if directory is not None:
            self._make_manager(directory)

    def _make_manager(self, directory: str) -> None:
        cls = LocalCheckpointManager if self.local else CheckpointManager
        self.manager = cls(directory, max_to_keep=self.max_to_keep)

    def on_train_begin(self, ffmodel):
        cfg = ffmodel.config
        if self.manager is None:
            if not cfg.checkpoint_dir:
                raise ValueError("ModelCheckpoint needs a directory (or "
                                 "FFConfig.checkpoint_dir)")
            self._make_manager(cfg.checkpoint_dir)
        if self.every_steps is None:
            self.every_steps = cfg.checkpoint_every

    def on_step_end(self, ffmodel, step: int):
        if self.every_steps and step % self.every_steps == 0:
            self.manager.save(ffmodel, self.initial_step + step,
                              wait=not self.async_save)

    def on_epoch_end(self, ffmodel, epoch: int, metrics):
        if not self.every_steps:
            self.manager.save(ffmodel, epoch, wait=not self.async_save)

    def on_train_end(self, ffmodel):
        """Drain and close the manager; an async save that failed raises
        here (fit's own drain, in a fit that raised, only waits)."""
        failures = self.manager.drain()
        self.manager.close()
        if failures:
            raise RuntimeError(
                "checkpoint saves failed: " + "; ".join(
                    f"step {step}: {err!r}" for step, err in failures))


# -- plain numpy weight files (the reference's npz path) --------------------

def save_weights_npz(ff, path: str):
    """The weights of `ff` as a flat .npz at `path`."""
    flat = {}
    for op_name, wdict in ff.get_weights().items():
        for wname, arr in wdict.items():
            flat[f"{op_name}/{wname}"] = np.asarray(arr)
    np.savez(path, **flat)


def load_weights_npz(ff, path: str):
    """Load a flat .npz into `ff`, checked name by name and shape by
    shape (FFModel.set_weights)."""
    nested: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            op_name, wname = key.rsplit("/", 1)
            nested.setdefault(op_name, {})[wname] = data[key]
    ff.set_weights(nested)
