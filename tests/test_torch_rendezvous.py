"""The port's blob-store rendezvous (flexflow_tpu_torch/topology/
rendezvous.py and distributed.preemption_barrier) against flexflow_tpu's:
hosts of both packages post into one file:// store, on threads of this
process, and each side agrees on the other's posts.  The keys and the
JSON are the reference's, so a mixed quorum meets; a failing store
degrades to the caller's own value in both."""
import json
import threading

import pytest

torch = pytest.importorskip("torch")

from flexflow_tpu import distributed as r_dist  # noqa: E402
from flexflow_tpu.store import blobstore as r_blob  # noqa: E402
from flexflow_tpu.topology import rendezvous as r_rdv  # noqa: E402
from flexflow_tpu_torch import distributed as p_dist  # noqa: E402
from flexflow_tpu_torch import topology as p_topology  # noqa: E402
from flexflow_tpu_torch.resilience import (Fault, FaultKind,  # noqa: E402
                                           FaultPlan)
from flexflow_tpu_torch.store import blobstore as p_blob  # noqa: E402
from flexflow_tpu_torch.topology import rendezvous as p_rdv  # noqa: E402

# hosts 0 and 2 are the port's, 1 and 3 the reference's
SIDES = ((p_rdv, p_blob), (r_rdv, r_blob), (p_rdv, p_blob), (r_rdv, r_blob))


def _quorum(root, call, n=4):
    """call(host, rendezvous module, its blob store) on n threads, one
    host each, alternating the packages; the results by host."""
    out = [None] * n
    errors = []

    def host(i):
        rdv, blob = SIDES[i % 4]
        try:
            out[i] = call(i, rdv, blob.LocalBlobStore(root))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return out


@pytest.mark.parametrize("reduce,want", [(max, 7), (min, 1), (sum, 16)])
def test_mixed_quorum_agrees(tmp_path, reduce, want):
    values = [3, 7, 5, 1]
    got = _quorum(str(tmp_path), lambda i, rdv, blob: rdv.post_and_agree(
        blob, "run", "step", values[i], host_id=i, num_hosts=4,
        reduce=reduce, timeout_s=30.0, poll_s=0.005))
    assert got == [want] * 4


def test_the_same_keys_and_json(tmp_path):
    """A post of either package is the same key and the same bytes."""
    kw = dict(host_id=0, num_hosts=1)
    for rdv, blob, sub in ((p_rdv, p_blob, "p"), (r_rdv, r_blob, "r")):
        store = blob.LocalBlobStore(str(tmp_path / sub))
        # one host agrees alone without posting: post for two, time out
        rdv.post_and_agree(store, "run", "epoch_00000003", 5, host_id=1,
                           num_hosts=2, timeout_s=0.0, field="epoch")
        assert rdv.post_and_agree(store, "run", "x", 9, **kw) == 9
    p = p_blob.LocalBlobStore(str(tmp_path / "p"))
    r = r_blob.LocalBlobStore(str(tmp_path / "r"))
    assert p.list("") == r.list("") == [
        "rendezvous/run/epoch_00000003/host_00001"]
    key = p.list("")[0]
    assert json.loads(p.get(key)) == json.loads(r.get(key)) == {
        "host": 1, "epoch": 5}


def test_epoch_rendezvous_rounds_are_separate(tmp_path):
    """Each round agrees among its own posts: round 1's stale maximum
    does not leak into round 2."""
    root = str(tmp_path)
    r1 = _quorum(root, lambda i, rdv, blob: rdv.epoch_rendezvous(
        blob, "run", 10 + i, slice_id=i, num_slices=4, round_id=1,
        timeout_s=30.0, poll_s=0.005))
    r2 = _quorum(root, lambda i, rdv, blob: rdv.epoch_rendezvous(
        blob, "run", 2 * i, slice_id=i, num_slices=4, round_id=2,
        timeout_s=30.0, poll_s=0.005))
    assert r1 == [13] * 4 and r2 == [6] * 4


def test_health_census_presumes_the_silent_dead(tmp_path):
    """Three of four slices post (one unhealthy): every poster sees the
    same census, and the silent slice is absent."""
    healthy = [True, False, True]
    got = _quorum(str(tmp_path), lambda i, rdv, blob: rdv.health_census(
        blob, "run", slice_id=i, num_slices=4, healthy=healthy[i],
        timeout_s=0.5, poll_s=0.01), n=3)
    assert got == [{0: True, 1: False, 2: True}] * 3


def test_preemption_barrier_mixed_and_cleared(tmp_path):
    """The legacy barrier/<run_id>/ layout: hosts of both packages agree
    on the max step; either package's clear removes every post."""
    steps = [4, 6, 5, 6]
    barriers = {p_rdv: p_dist.preemption_barrier,
                r_rdv: r_dist.preemption_barrier}
    got = _quorum(str(tmp_path), lambda i, rdv, blob: barriers[rdv](
        blob, "job", steps[i], host_id=i, num_hosts=4, timeout_s=30.0,
        poll_s=0.005))
    assert got == [6] * 4
    p = p_blob.LocalBlobStore(str(tmp_path))
    assert sorted(p.list("barrier/job/")) == [
        f"barrier/job/host_{i:05d}" for i in range(4)]
    assert p_dist.clear_preemption_barrier(p, "job") == 4
    assert r_blob.LocalBlobStore(str(tmp_path)).list("barrier/") == []
    # one process (no group here) returns its own step at once
    assert p_dist.preemption_barrier(p, "job", 3) == 3


def test_clear_rendezvous_by_kind(tmp_path):
    p = p_blob.LocalBlobStore(str(tmp_path))
    for kind in ("a", "b"):
        r_rdv.post_and_agree(p, "run", kind, 1, host_id=0, num_hosts=2,
                             timeout_s=0.0)
    assert p_rdv.clear_rendezvous(p, "run", "a") == 1
    assert p.list("rendezvous/") == ["rendezvous/run/b/host_00000"]
    assert p_rdv.clear_rendezvous(p, "run") == 1


def test_a_missing_peer_times_out_with_the_best_so_far(tmp_path):
    got = _quorum(str(tmp_path), lambda i, rdv, blob: rdv.post_and_agree(
        blob, "run", "step", 2 + i, host_id=i, num_hosts=4, timeout_s=0.5,
        poll_s=0.01), n=3)
    assert got == [4, 4, 4]


@pytest.mark.parametrize("kind", [FaultKind.BLOB_UNAVAILABLE,
                                  FaultKind.BLOB_TRANSIENT])
def test_a_failing_store_degrades_to_the_own_value(tmp_path, kind):
    """A post that fails returns the caller's value, in both packages
    under the same fault plan."""
    plan = FaultPlan([Fault(0, kind, payload={"ops": 100})])
    from flexflow_tpu.resilience import faults as r_faults

    for rdv, blob, faults in ((p_rdv, p_blob, None), (r_rdv, r_blob,
                                                      r_faults)):
        fp = plan if faults is None else faults.FaultPlan.from_json(
            plan.to_json())
        store = blob.FaultyBlobStore(blob.LocalBlobStore(str(tmp_path)), fp)
        assert rdv.post_and_agree(store, "run", "step", 5, host_id=0,
                                  num_hosts=3, timeout_s=0.2) == 5


def test_exports():
    for name in p_rdv.__all__:
        assert getattr(p_topology, name) is getattr(p_rdv, name)
    assert p_rdv.__all__ == r_rdv.__all__
