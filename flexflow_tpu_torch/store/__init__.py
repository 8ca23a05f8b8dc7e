"""Persistent strategy and kernel store (flexflow_tpu/store/).

The search is the expensive, reusable part of a compile, so its results
are content-addressed artifacts:

  * StrategyStore: searched strategies keyed by (graph signature, mesh
    fingerprint, simulator version), written verify-then-publish and
    read with corrupt entries tolerated (store.py);
  * cached_search: the consult-then-publish wrapper around a search
    that FFModel.compile runs;
  * enable_compilation_cache: the built CUDA kernel libraries under the
    store root (ops/kernels/_build.py), so that a new process loads them
    instead of running nvcc again.

Config: FFConfig.strategy_store (--strategy-store DIR,
--no-strategy-store, or $FLEXFLOW_TPU_TORCH_STORE_DIR for a fleet),
FFConfig.compilation_cache (--compilation-cache [DIR]) and
FFConfig.remote_store (--remote-store URI).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

from ..logger import store_logger
from .blobstore import (
    BlobNotFound,
    BlobPreconditionFailed,
    BlobStore,
    BlobStoreError,
    BlobUnavailableError,
    FaultyBlobStore,
    LocalBlobStore,
    blobstore_from_uri,
)
from .key import (
    StoreKey,
    graph_signature,
    mesh_fingerprint,
    simulator_version,
    store_key_for,
)
from .store import (
    MANIFEST_VERSION,
    RemoteStrategyMirror,
    StoreVerifyError,
    StrategyStore,
)

#: env var naming a store root shared by every process of a fleet (a
#: run's --strategy-store overrides it, --no-strategy-store opts out);
#: the port's own, so that it never reads the JAX package's root
#: unasked
STORE_DIR_ENV = "FLEXFLOW_TPU_TORCH_STORE_DIR"


def resolve_store_dir(cfg) -> Optional[str]:
    """FFConfig.strategy_store as the store root, or None when the store
    is off.  None falls through to $FLEXFLOW_TPU_TORCH_STORE_DIR;
    ""/"none" is an explicit opt-out."""
    v = cfg.strategy_store
    if v is None:
        v = os.environ.get(STORE_DIR_ENV) or None
    if not v or str(v).strip().lower() == "none":
        return None
    return str(v)


def store_from_config(cfg, registry=None) -> Optional[StrategyStore]:
    """The run's StrategyStore, or None when it is off or unusable: an
    unwritable root means store-off, with a log line (the store speeds a
    compile up and never fails it).  FFConfig.remote_store attaches the
    fleet mirror under the blob root's `strategies/` prefix; the store's
    counters go to `registry` (obs.metrics.MetricsRegistry) when one is
    given."""
    root = resolve_store_dir(cfg)
    if root is None:
        return None
    remote = None
    uri = cfg.remote_store
    if uri and str(uri).strip().lower() != "none":
        try:
            remote = RemoteStrategyMirror(blobstore_from_uri(uri))
        except (OSError, ValueError, NotImplementedError) as e:
            store_logger.info(
                "fleet mirror %r unusable (%s); continuing with the local "
                "store only", uri, e)
    try:
        return StrategyStore(root, registry=registry, remote=remote)
    except OSError as e:
        store_logger.info(
            "strategy store root %s unusable (%s); continuing without the "
            "store", root, e)
        return None


def enable_compilation_cache(cfg) -> Optional[str]:
    """Build and load the CUDA kernel libraries under
    FFConfig.compilation_cache ("auto": <store root>/kernel_cache), so
    that a new process loads them from there instead of running nvcc.
    Returns the directory, or None when the cache is off.  It holds for
    the libraries this process has not loaded yet, for the whole
    process: point every model of one process at the same directory (a
    library's name carries its source and flag hash, so sharing is
    safe)."""
    from ..ops.kernels import _build

    spec = cfg.compilation_cache
    if not spec:
        return None
    if str(spec).strip().lower() == "auto":
        root = resolve_store_dir(cfg)
        if root is None:
            raise ValueError(
                "compilation_cache='auto' ties the kernel cache to the "
                "strategy store root, but no store is configured: set "
                f"--strategy-store/${STORE_DIR_ENV} or pass an explicit "
                "--compilation-cache DIR")
        path = os.path.join(root, "kernel_cache")  # StrategyStore layout
    else:
        path = str(spec)
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)
    return path


def cached_search(model, num_devices: int,
                  run_search: Callable[[], "object"]):
    """Consult-then-publish around one strategy search.

    Store off: run_search() unchanged.  Store on: a hit returns the
    published strategy, its search_stats carrying store_hit=True (the
    search and its op timings are skipped); a miss runs the search and
    publishes the winner under the same key, its search_stats carrying
    store_hit=False and store_key."""
    cfg = model.config
    store = store_from_config(
        cfg, registry=getattr(getattr(model, "telemetry", None), "metrics",
                              None))
    if store is None:
        return run_search()
    key = store_key_for(cfg, model.layers, num_devices)
    hit = store.lookup(key)
    if hit is not None:
        store_logger.info(
            "store hit %s: strategy restored for %d devices, search "
            "skipped", key.digest[:16], num_devices)
        return hit
    strategy = run_search()
    stats = getattr(strategy, "search_stats", None)
    if stats is None:
        stats = {}
        strategy.search_stats = stats
    stats["store_hit"] = False
    stats["store_key"] = key.digest
    store.publish(key, strategy,
                  searched_cost=getattr(strategy, "search_cost", None),
                  search_stats=stats, created_at=time.time())
    return strategy


__all__ = [
    "MANIFEST_VERSION",
    "STORE_DIR_ENV",
    "BlobNotFound",
    "BlobPreconditionFailed",
    "BlobStore",
    "BlobStoreError",
    "BlobUnavailableError",
    "FaultyBlobStore",
    "LocalBlobStore",
    "RemoteStrategyMirror",
    "StoreKey",
    "StoreVerifyError",
    "StrategyStore",
    "blobstore_from_uri",
    "cached_search",
    "enable_compilation_cache",
    "graph_signature",
    "mesh_fingerprint",
    "resolve_store_dir",
    "simulator_version",
    "store_from_config",
    "store_key_for",
]
