"""Speculative rollback inside a prefix-cache-shared sequence, on real
engines in both packages: rows whose prompts map two shared prefix
blocks draft n-grams that the target rejects, so verify rounds roll the
rows back past blocks their drafts had just extended.  The tokens equal
the plain (spec off) run's and the reference engine's, and after every
round each live row's block-table row in the step buffers equals its
table in the pool (the refresh after a rollback,
ContinuousScheduler._spec_round, keeps them equal: without it a row
keeps a freed block's id past its kept tail).

Under the scheduler a rollback's kept tail never lies in a shared block:
the tail is past the row's prompt (drafts start in the decode phase),
and only full prompt pages are indexed while a row is live, so
KVPool.rollback's copy-on-write of a shared tail (held at the pool level
by tests/test_torch_speculative.py) does not arise here; the table
check is what sees a stale row."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.models.transformer import build_gpt as jax_gpt  # noqa: E402
from flexflow_tpu.serving import scheduler as jax_sched  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_gpt  # noqa: E402
from flexflow_tpu_torch.serving import scheduler as port_sched  # noqa: E402

V, S, SLOTS, PAGE, CHUNK, K = 64, 32, 4, 4, 4, 4
GPT = dict(batch_size=SLOTS, seq_length=S, hidden_size=32, num_layers=2,
           num_heads=4, intermediate_size=64, vocab_size=V)
PREFIX = [1, 2, 3, 1, 2, 3, 1, 2]  # two full pages, n-gram bait
FIRST = (PREFIX + [3, 1], 10)
FOLLOWERS = [(PREFIX + [3, 1, 2, 3], 12), (PREFIX + [3], 14),
             (PREFIX + [5, 1, 2], 11)]
WAIT_S = 30.0


@pytest.fixture(scope="module")
def gpts():
    jf = J.FFModel(J.FFConfig(batch_size=SLOTS, num_devices=1))
    jax_gpt(jf, **GPT)
    jf.compile(comp_mode=J.CompMode.INFERENCE,
               devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=SLOTS, device="cpu"))
    build_gpt(tf, **GPT)
    tf.compile()
    tf.set_weights(jf.get_weights())
    return jf, tf


def _engine(pkg, ff, spec):
    if pkg == "ref":
        model = jax_sched.PagedKVDecodeModel(
            ff, batch_slots=SLOTS, page_size=PAGE,
            devices=jax.devices("cpu")[:1], prefill_chunk=CHUNK,
            paged_kernel="gather", spec_decode=spec, spec_k=K)
        return jax_sched.ContinuousScheduler(model, check_invariants=True)
    return port_sched.ContinuousScheduler.from_trained(
        ff, batch_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
        spec_decode=spec, spec_k=K, check_invariants=True)


def _watch(sched):
    """After every round, each live row's step-buffer table row against
    its pool table; every rollback that dropped blocks."""
    seen = {"stale": [], "rounds": 0, "shrinks": 0, "shared_rows": 0}
    observe, rollback = sched._observe_step, sched.pool.rollback

    def observing():
        seen["rounds"] += 1
        for i, live in enumerate(sched._slots):
            if live is None:
                continue
            if sched.pool._shared_of.get(live.seq_id):
                seen["shared_rows"] += 1
            want = sched.pool.table_row(live.seq_id)
            if not np.array_equal(sched._btab[i], want):
                seen["stale"].append((i, list(sched._btab[i]),
                                      list(want)))
        observe()

    def rolling(seq_id, tokens):
        before = len(sched.pool.table_of(seq_id))
        out = rollback(seq_id, tokens)
        seen["shrinks"] += len(sched.pool.table_of(seq_id)) < before
        return out

    sched._observe_step = observing
    sched.pool.rollback = rolling
    return seen


def _run(pkg, ff, spec):
    sched = _engine(pkg, ff, spec)
    seen = _watch(sched)
    try:
        # the first request runs alone and retires its prompt pages into
        # the prefix cache; the followers then map them as shared blocks
        first = sched.generate(*FIRST, timeout=WAIT_S)
        handles = [sched.generate_async(p, m) for p, m in FOLLOWERS]
        outs = [first] + [h.wait(WAIT_S) for h in handles]
        stats = sched.stats()
    finally:
        sched.close()
    return outs, stats, seen


@pytest.fixture(scope="module")
def runs(gpts):
    jf, tf = gpts
    return {(pkg, spec): _run(pkg, jf if pkg == "ref" else tf, spec)
            for pkg in ("ref", "port") for spec in ("off", "ngram")}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_rollback_in_shared_rows_keeps_tokens_and_tables(runs, pkg):
    plain, _, _ = runs[(pkg, "off")]
    outs, stats, seen = runs[(pkg, "ngram")]
    assert outs == plain
    spec = stats["speculative"]
    assert spec["rounds"] > 0 and spec["accepted"] < spec["proposed"]
    assert stats["prefix_cache"]["hits"] >= len(FOLLOWERS)
    assert seen["shared_rows"] > 0 and seen["shrinks"] > 0
    assert seen["stale"] == []


def test_port_rollback_tokens_equal_the_reference_engine(runs):
    assert runs[("port", "ngram")][0] == runs[("ref", "ngram")][0]
    assert runs[("port", "off")][0] == runs[("ref", "off")][0]
