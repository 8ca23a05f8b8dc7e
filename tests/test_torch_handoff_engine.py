"""Mid-decode handoff on real engines, the port against the reference
(the counterpart of tests/test_serving_handoff.py's slow pause oracle):
the reference's tiny GPT (hidden 32, 2 layers, page 4, a pool of 12
blocks, 2 slots, chunked prefill 4) trained on arithmetic sequences and
the port's twin with its weights, each behind a 2-replica front with
handoff on and the pool's invariants checked every step.  A greedy and a
0.8-temperature generation pause after writing 9 tokens (two full pages
and a one-token tail) and resume on the other replica from their
migrated KV blocks (the tail imported), then again with the live stream
refused (replay): every completion equals the uninterrupted run's and
the other package's.  Also: export_block -> import_block round-trips a
block's bytes in place on the port's engine."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_handoff_support import (arm_pause, front_of,  # noqa: E402
                                   run_sequential, trained_pair)

PROMPT = [3, 5, 7, 2]
MNT = 11
PAUSE_AT = 8  # written 9 = 2 full pages of 4 + a 1-token tail
# live greedy, live sampled, then the same with the stream refused
REQUESTS = [(PROMPT, MNT, 0.0), (PROMPT, MNT, 0.8)] * 2


class _RefusingFabric:
    """A fabric that refuses every stream: the handoff degrades to
    replay (fault "fabric")."""

    kind = "inproc"

    def transfer(self, key, data):
        raise RuntimeError("stream refused")

    def stats(self):
        return {}


def _legs(pkg, ff):
    """(oracle completions, handoff completions, handoff stats after
    the live pair, after all four, tail imports) of one package."""
    oracle = front_of(pkg, ff)
    try:
        want = run_sequential(oracle, REQUESTS)
    finally:
        oracle.close()
    from importlib import import_module

    base = "flexflow_tpu" if pkg == "ref" else "flexflow_tpu_torch"
    kvt = import_module(f"{base}.serving.kv_transfer")
    metrics = import_module(f"{base}.obs.metrics")
    reg = metrics.MetricsRegistry()
    front = front_of(pkg, ff, handoff=True, registry=reg)
    try:
        arm = arm_pause(front, PAUSE_AT)
        got = run_sequential(front, REQUESTS[:2], arm)
        live = dict(front.stats()["handoff"])
        mig = front._handoff_mig
        front._handoff_mig = kvt.KVMigrator(_RefusingFabric(),
                                            registry=reg)
        mig.close()
        got += run_sequential(front, REQUESTS[2:], arm)
        both = dict(front.stats()["handoff"])
    finally:
        front.close()
    tails = reg.counter("serving/handoff_tail_imports").value
    return want, got, live, both, tails


@pytest.fixture(scope="module")
def runs():
    jf, tf = trained_pair()
    return {"ref": _legs("ref", jf), "port": _legs("port", tf)}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_paused_generations_resume_token_for_token(runs, pkg):
    want, got, live, both, tails = runs[pkg]
    assert got == want
    assert want[0] == want[2] and want[1] != want[0]  # sampled differs
    # the live pair: both paused, both adopted, the tail imported
    assert live["requested"] == live["ok"] == 2
    assert live["replays"] == 0 and live["faults"] == {}
    assert live["migrate_decisions"] == 2
    assert tails >= 2
    # the refused pair: both replayed, counted as fabric faults
    assert both["requested"] == 4 and both["ok"] == 2
    assert both["replays"] == 2 and both["faults"] == {"fabric": 2}


def test_port_equals_the_reference_engine(runs):
    """The same weights, prompts and front seeds: the port's
    completions, uninterrupted and resumed, equal the reference's."""
    assert runs["port"][0] == runs["ref"][0]
    assert runs["port"][1] == runs["ref"][1]


def test_export_import_block_round_trips_in_place():
    """export_block reads one block of every layer's pools to host
    copies keyed <op>/<k_cache|v_cache>; import_block writes them into
    another block in place: the pools keep their storage, the bytes
    land, and a later write to the source does not reach the export."""
    from torch_handoff_support import PAGE, SLOTS, WIDTHS

    import flexflow_tpu_torch as T
    from flexflow_tpu_torch.models.transformer import build_gpt
    from flexflow_tpu_torch.serving import PagedKVDecodeModel

    tf = T.FFModel(T.FFConfig(batch_size=SLOTS, device="cpu"))
    build_gpt(tf, batch_size=SLOTS, **WIDTHS)
    tf.compile(comp_mode=T.CompMode.INFERENCE)
    model = PagedKVDecodeModel(tf, batch_slots=SLOTS, page_size=PAGE,
                               num_blocks=12)
    btab = np.zeros((SLOTS, model.max_blocks_per_seq), np.int32)
    btab[0, :2] = [3, 5]
    rng = np.random.RandomState(1)
    for t in range(6):
        model.step(rng.randint(0, 32, SLOTS).astype(np.int32),
                   np.array([t, 0], np.int32), btab)
    ptrs = {(op, k): v.data_ptr() for op, e in model._state.items()
            for k, v in e.items()}
    blk = model.export_block(5)
    assert sorted(blk) == sorted(f"{op}/{k}" for op, e in
                                 model._state.items()
                                 for k in ("k_cache", "v_cache") if k in e)
    assert all(a.dtype == np.float32 and a.shape[0] == PAGE
               for a in blk.values())
    assert any(np.abs(a).max() > 0 for a in blk.values())
    model.import_block(9, blk)
    for op, e in model._state.items():
        for k in ("k_cache", "v_cache"):
            if k in e:
                assert torch.equal(e[k][9], e[k][5])
                assert e[k].data_ptr() == ptrs[(op, k)]
    saved = {k: v.copy() for k, v in blk.items()}
    model.step(np.array([7, 0], np.int32), np.array([6, 0], np.int32),
               btab)
    assert all(np.array_equal(blk[k], saved[k]) for k in blk)
