"""The blob-store agreement (flexflow_tpu/topology/rendezvous.py).

Every participant posts one JSON value under
`rendezvous/<run_id>/<kind>/host_<i>` and polls the prefix until the
whole quorum has posted or a hard deadline passes (a dead peer never
costs the agreement); the agreement is a reduction over the posted
values, MAX for steps and epochs (a laggard runs forward, nobody
rewinds).  Posts stay after the agreement (deleting them would race a
slower reader out of its quorum), so callers clear the prefix when a
run starts.  The preemption barrier (distributed.preemption_barrier)
is one caller, under its own `barrier/<run_id>/` layout; the
supervisor's re-formed group after a device loss is another
(`epoch_rendezvous`, resilience/supervisor.py).

Every blob failure degrades to the caller's own value with a warning: a
rendezvous coordinates, it never crashes a run.  The keys and the JSON
are the reference's, so hosts of either package agree through one store.
"""
from __future__ import annotations

import json
import logging
import time
from typing import Callable, Dict, List, Optional

_log = logging.getLogger("flexflow_tpu_torch.topology.rendezvous")

#: default key prefix; the preemption barrier keeps its legacy
#: "barrier/<run_id>/" layout for on-store compatibility
RENDEZVOUS_PREFIX = "rendezvous"


def post_and_agree(
    blob,
    run_id: str,
    kind: str,
    value: int,
    *,
    host_id: int,
    num_hosts: int,
    reduce: Callable[[List[int]], int] = max,
    timeout_s: float = 30.0,
    poll_s: float = 0.05,
    sleep: Callable[[float], None] = time.sleep,
    prefix: Optional[str] = None,
    field: str = "step",
) -> int:
    """Post `value`, await the quorum, return the reduced agreement.

    `prefix=None` uses `rendezvous/<run_id>/<kind>/`; the preemption
    barrier passes its legacy `barrier/<run_id>/` layout.  The caller's
    own value always participates in the reduction, so a degraded store
    or timeout returns something no worse than acting alone.
    """
    from ..store.blobstore import BlobStoreError

    if num_hosts <= 1:
        return int(value)
    if prefix is None:
        prefix = f"{RENDEZVOUS_PREFIX}/{run_id}/{kind}/"
    key = f"{prefix}host_{host_id:05d}"
    payload = json.dumps({"host": int(host_id), field: int(value)}).encode()
    try:
        blob.put(key, payload)
    except BlobStoreError as e:
        _log.warning(
            "rendezvous %s post failed (%s); continuing with local "
            "value %d without agreement", kind, e, value,
        )
        return int(value)
    deadline = time.monotonic() + timeout_s
    agreed = int(value)
    while True:
        # the caller's own post is EXCLUDED from the reduced values
        # (its local `value` joins exactly once below) so non-idempotent
        # reductions (sum, count) stay correct; it still counts toward
        # the quorum
        posted = 0
        peer_vals: List[int] = []
        try:
            for k in blob.list(prefix):
                try:
                    v = int(json.loads(blob.get(k))[field])
                except (BlobStoreError, ValueError, KeyError, TypeError):
                    continue  # a peer's post mid-write: next poll sees it
                posted += 1
                if k != key:
                    peer_vals.append(v)
        except BlobStoreError:
            posted, peer_vals = 0, []
        agreed = int(reduce(peer_vals + [int(value)]))
        if posted >= num_hosts:
            return agreed
        if time.monotonic() >= deadline:
            _log.warning(
                "rendezvous %s timed out with %d/%d participants; "
                "agreement so far: %d", kind, posted, num_hosts, agreed,
            )
            return agreed
        sleep(poll_s)


def clear_rendezvous(blob, run_id: str, kind: Optional[str] = None) -> int:
    """Remove posts under `rendezvous/<run_id>/[<kind>/]` — run-start
    hygiene so a previous incarnation can never satisfy a later quorum.
    Returns the count removed; failures are swallowed."""
    from ..store.blobstore import BlobStoreError

    prefix = f"{RENDEZVOUS_PREFIX}/{run_id}/"
    if kind:
        prefix += f"{kind}/"
    removed = 0
    try:
        for k in blob.list(prefix):
            if blob.delete(k):
                removed += 1
    except BlobStoreError as e:
        _log.info("rendezvous clear failed (%s)", e)
    return removed


def epoch_rendezvous(
    blob, run_id: str, epoch: int, *, slice_id: int, num_slices: int,
    round_id: int = 0,
    timeout_s: float = 30.0, poll_s: float = 0.05,
    sleep: Callable[[float], None] = time.sleep,
) -> int:
    """Cross-slice epoch agreement: after an elastic event every slice
    posts the newest epoch/step it can serve from its tier-2 mirror and
    resumes from the MAX (the slice behind runs deterministically
    forward; nobody rewinds — the preemption-barrier invariant at slice
    granularity).

    Posts persist for the life of the run, so each elastic EVENT must
    use a fresh `round_id` (monotonic per event) — otherwise a later
    rendezvous meets its quorum instantly on the previous round's
    stale posts and two slices can agree on divergent epochs."""
    return post_and_agree(
        blob, run_id, f"epoch_{int(round_id):08d}", int(epoch),
        host_id=slice_id, num_hosts=num_slices,
        reduce=max, timeout_s=timeout_s, poll_s=poll_s, sleep=sleep,
        field="epoch",
    )


def health_census(
    blob, run_id: str, *, slice_id: int, num_slices: int,
    healthy: bool = True, round_id: int = 0,
    timeout_s: float = 5.0, poll_s: float = 0.05,
    sleep: Callable[[float], None] = time.sleep,
) -> Dict[int, bool]:
    """Cross-slice liveness census: each slice posts its health bit;
    returns {slice_id: healthy} for every slice that posted before the
    deadline (absent slices are presumed dead — the caller sizes the
    degraded mesh from the survivors).

    Like epoch_rendezvous, each census EVENT needs a fresh `round_id`:
    a dead slice's post from a previous round would otherwise keep
    reporting it healthy forever."""
    from ..store.blobstore import BlobStoreError

    prefix = f"{RENDEZVOUS_PREFIX}/{run_id}/health_{int(round_id):08d}/"
    key = f"{prefix}host_{slice_id:05d}"
    payload = json.dumps(
        {"host": int(slice_id), "healthy": bool(healthy)}
    ).encode()
    try:
        blob.put(key, payload)
    except BlobStoreError as e:
        _log.warning("health census post failed (%s)", e)
        return {int(slice_id): bool(healthy)}
    deadline = time.monotonic() + timeout_s
    seen: Dict[int, bool] = {}
    while True:
        try:
            for k in blob.list(prefix):
                try:
                    d = json.loads(blob.get(k))
                    seen[int(d["host"])] = bool(d["healthy"])
                except (BlobStoreError, ValueError, KeyError, TypeError):
                    continue
        except BlobStoreError:
            pass
        seen[int(slice_id)] = bool(healthy)
        if len(seen) >= num_slices or time.monotonic() >= deadline:
            return seen
        sleep(poll_s)


__all__ = [
    "RENDEZVOUS_PREFIX",
    "clear_rendezvous",
    "epoch_rendezvous",
    "health_census",
    "post_and_agree",
]
