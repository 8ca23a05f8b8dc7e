"""Replica death on real engines, the port against the reference (the
counterpart of tests/test_serving_handoff.py's slow death oracle): the
tiny GPT of tests/torch_handoff_support.py behind a 2-replica front
whose replica 0 hangs at its 6th dispatch (an injected HUNG_STEP, fatal
to its engine).  Its in-flight rows carry resume records out of the
dying scheduler, the front replays them on a live replica, and every
completion (greedy and at temperature 0.8) equals the uninterrupted
run's and the other package's; the dead replica restarts once."""
import time

import pytest

pytest.importorskip("torch")

from torch_handoff_support import (front_of, trained_pair,  # noqa: E402
                                   WAIT_S)

REQUESTS = [([3, 5, 7, 2], 11, 0.0), ([9, 4, 1], 8, 0.8),
            ([8, 2], 7, 0.0), ([5, 5, 5, 5], 6, 0.8)]


def _plan(pkg):
    from importlib import import_module

    base = "flexflow_tpu" if pkg == "ref" else "flexflow_tpu_torch"
    faults = import_module(f"{base}.resilience.faults")
    return faults.FaultPlan([faults.Fault(
        step=6, kind=faults.FaultKind.HUNG_STEP)])


def _run(front):
    handles = [front.generate_async(p, m, t) for p, m, t in REQUESTS]
    return [h.wait(WAIT_S) for h in handles], handles


def _legs(pkg, ff):
    oracle = front_of(pkg, ff)
    try:
        want, _ = _run(oracle)
    finally:
        oracle.close()
    front = front_of(pkg, ff, retry_backoff=0.0,
                     fault_plans={0: _plan(pkg)})
    try:
        got, handles = _run(front)
        # the restart runs on the replica's supervisor thread: wait for
        # it (bounded) before reading the counts
        r0 = front.replicas[0]
        for _ in range(int(WAIT_S / 0.02)):
            if r0.restarts:
                break
            time.sleep(0.02)
        rec = {"deaths": r0.deaths, "restarts": r0.restarts,
               "replays": front.handoff_replays,
               "resumed": [h.resume is not None for h in handles],
               "generated_before": [len(h.resume.generated)
                                    if h.resume is not None else 0
                                    for h in handles]}
    finally:
        front.close()
    return want, got, rec


@pytest.fixture(scope="module")
def runs():
    jf, tf = trained_pair()
    return {"ref": _legs("ref", jf), "port": _legs("port", tf)}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_death_resumes_by_replay_token_for_token(runs, pkg):
    want, got, rec = runs[pkg]
    assert got == want
    assert rec["deaths"] == rec["restarts"] == 1
    # the dying scheduler stamped resume records: the requeued rows
    # replayed their generated tokens instead of starting over
    assert rec["replays"] >= 1 and any(rec["resumed"])
    assert max(rec["generated_before"]) >= 1


def test_port_equals_the_reference_under_death(runs):
    """Completions, uninterrupted and under the death, equal the
    reference's (which rows were in flight at the death depends on the
    dispatcher's timing, so the counts are held per package only)."""
    assert runs["port"][0] == runs["ref"][0]
    assert runs["port"][1] == runs["ref"][1]
