"""The port's speculative decoding (flexflow_tpu_torch/serving/
speculative.py and the scheduler's verify rounds) against flexflow_tpu's
on the CPU: every case of tests/test_speculative.py that needs no
ServingFront and no trained engine runs the same inputs through both
packages' classes, with the fake step models copied here.  Proposals,
AdaptiveK trajectories, tokens, dispatch counts, stats()["speculative"]
and the registries' serving/* metrics must be identical, and each case
keeps the reference test's own assertions.  Then KVPool.rollback's cases
of tests/test_kv_pool.py, run on both pools: tables, refcounts, index
entries and the returned copy-on-write pair identical."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from flexflow_tpu import config as jax_config  # noqa: E402
from flexflow_tpu.obs import metrics as jax_metrics  # noqa: E402
from flexflow_tpu.serving import kv_pool as jax_kv  # noqa: E402
from flexflow_tpu.serving import scheduler as jax_sched  # noqa: E402
from flexflow_tpu.serving import speculative as jax_spec  # noqa: E402
from flexflow_tpu_torch import config as port_config  # noqa: E402
from flexflow_tpu_torch.obs import metrics as port_metrics  # noqa: E402
from flexflow_tpu_torch.serving import kv_pool as port_kv  # noqa: E402
from flexflow_tpu_torch.serving import scheduler as port_sched  # noqa: E402
from flexflow_tpu_torch.serving import speculative as port_spec  # noqa: E402
from torch_spec_support import held_admission, registry_record  # noqa: E402

V = 16

REF = SimpleNamespace(name="reference", config=jax_config,
                      metrics=jax_metrics, kv=jax_kv, sched=jax_sched,
                      spec=jax_spec)
PORT = SimpleNamespace(name="port", config=port_config,
                       metrics=port_metrics, kv=port_kv, sched=port_sched,
                       spec=port_spec)


def both(case):
    """Run case(pkg) on the reference and the port; the two records
    must be equal.  Returns the port's."""
    want, got = case(REF), case(PORT)
    assert got == want
    return got


# -- n-gram proposer -----------------------------------------------------

def test_ngram_prefers_longest_then_most_recent():
    def case(pkg):
        p = pkg.spec.NGramProposer(max_ngram=3, min_ngram=1)
        return [p.propose({0: [7, 8, 9, 1, 2, 3, 7, 8, 9]}, 3),
                p.propose({0: [1, 2, 4, 1, 2, 5, 9, 1, 2]}, 2)]

    assert both(case) == [{0: [1, 2, 3]}, {0: [5, 9]}]


def test_ngram_no_match_omits_slot():
    def case(pkg):
        return pkg.spec.NGramProposer().propose(
            {0: [1, 2, 3, 4], 1: [5, 5, 5, 5]}, 4)

    out = both(case)
    assert 0 not in out and out[1] == [5]


def test_ngram_k_caps_draft_length():
    def case(pkg):
        p = pkg.spec.NGramProposer()
        ctx = [3, 4, 5, 6, 7, 8, 3, 4]
        return [p.propose({0: ctx}, 2), p.propose({0: ctx}, 10)]

    assert both(case) == [{0: [5, 6]}, {0: [5, 6, 7, 8, 3, 4]}]


def test_ngram_window_bounds_lookback():
    far = [1, 2, 9, 9] + [int(t) for t in np.arange(100) % 7 + 3]

    def case(pkg):
        return [pkg.spec.NGramProposer(max_window=50).propose(
                    {0: far + [1, 2]}, 4),
                pkg.spec.NGramProposer(max_window=4096).propose(
                    {0: far + [1, 2]}, 2)]

    narrow, wide = both(case)
    assert 0 not in narrow and wide == {0: [9, 9]}


def test_ngram_validates_bounds_and_tolerates_lifecycle():
    def case(pkg):
        with pytest.raises(ValueError, match="min_ngram") as e:
            pkg.spec.NGramProposer(max_ngram=2, min_ngram=3)
        p = pkg.spec.NGramProposer()
        p.release(42)
        p.reset()
        return str(e.value), p.stats()

    msg, stats = both(case)
    assert stats == {}


# -- adaptive k ----------------------------------------------------------

def test_adaptive_k_shrinks_on_misses_and_regrows():
    def case(pkg):
        ak = pkg.spec.AdaptiveK(4)
        path = [(ak.k, ak.rate)]
        for proposed, accepted in [(4, 0)] * 20 + [(1, 1)] * 20:
            ak.update(proposed, accepted)
            path.append((ak.k, ak.rate))
        return path

    path = both(case)
    assert path[0][0] == 4 and path[20][0] == 1 and path[-1][0] == 4


def test_adaptive_k_ignores_empty_rounds():
    def case(pkg):
        ak = pkg.spec.AdaptiveK(3)
        ak.update(0, 0)
        return ak.k, ak.rate

    assert both(case) == (3, 1.0)


# -- draft-model proposer ------------------------------------------------

class FakeDraftModel:
    """Draft-engine stand-in with the PagedKVDecodeModel step contract:
    argmax of the returned one-hot logits is (token + 1 + off) % V, so
    off=0 drafts the same successor chain as the fake target and off!=0
    is an always-wrong drafter."""

    def __init__(self, batch_slots=2, max_seq=32, page_size=4, off=0):
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.max_blocks_per_seq = max_seq // page_size
        self.num_blocks = 1 + batch_slots * self.max_blocks_per_seq
        self.vocab = V
        self.off = off
        self.steps = 0
        self.resets = 0
        self.fail_at_steps = set()

    def reset(self):
        self.resets += 1

    def step(self, tokens, seq_lens, block_tables):
        self.steps += 1
        if self.steps in self.fail_at_steps:
            raise RuntimeError(f"injected draft fault @{self.steps}")
        logits = np.zeros((self.batch_slots, V), np.float32)
        nxt = (np.asarray(tokens) + 1 + self.off) % V
        logits[np.arange(self.batch_slots), nxt] = 1.0
        return logits


def _pool_record(pool):
    return (sorted(pool._tables.items()), list(pool._free),
            sorted(pool._ref.items()), pool.used_blocks)


def test_draft_proposer_free_runs_successor_chain():
    def case(pkg):
        p = pkg.spec.DraftModelProposer(FakeDraftModel())
        first = p.propose({0: [3, 4, 5]}, 3)
        before = p.model.steps
        second = p.propose({0: [3, 4, 5, 6, 7, 8]}, 2)
        return (first, second, p.model.steps - before, p.stats(),
                _pool_record(p.pool))

    first, second, steps, stats, _ = both(case)
    assert first == {0: [6, 7, 8]} and second == {0: [9, 10]}
    assert steps <= 4 and stats["live_draft_seqs"] == 1


def test_draft_proposer_reconciles_after_rejection():
    def case(pkg):
        p = pkg.spec.DraftModelProposer(FakeDraftModel())
        out = [p.propose({0: [3, 4, 5]}, 3),
               p.propose({0: [3, 4, 5, 6, 9]}, 2)]
        p.pool.check_invariants()
        return out, _pool_record(p.pool)

    out, _ = both(case)
    assert out == [{0: [6, 7, 8]}, {0: [10, 11]}]


def test_draft_proposer_batches_slots_per_dispatch():
    def case(pkg):
        p = pkg.spec.DraftModelProposer(FakeDraftModel(batch_slots=2))
        return p.propose({0: [3, 4], 1: [8, 9, 10]}, 2), p.model.steps

    out, steps = both(case)
    assert out == {0: [5, 6], 1: [11, 12]} and steps <= 5


def test_draft_proposer_respects_limits_and_release():
    def case(pkg):
        p = pkg.spec.DraftModelProposer(FakeDraftModel())
        skipped = p.propose({0: [1, 2, 3]}, 4, limits={0: 3})
        out = p.propose({0: [1, 2, 3]}, 4, limits={0: 4})
        p.release(0)
        p.pool.check_invariants()
        return skipped, out, p.stats(), p.pool.used_blocks

    skipped, out, stats, used = both(case)
    assert 0 not in skipped and out == {0: [4, 5]}
    assert stats["live_draft_seqs"] == 0 and used == 0


def test_draft_fault_degrades_to_dead_and_reset_revives():
    def case(pkg):
        model = FakeDraftModel()
        model.fail_at_steps = {2}
        p = pkg.spec.DraftModelProposer(model)
        died = p.propose({0: [3, 4, 5]}, 3)
        dead_stats = p.stats()
        still = p.propose({0: [3, 4, 5, 6]}, 3)
        p.reset()
        return (died, dead_stats, still, model.resets, p.stats(),
                p.propose({0: [3, 4, 5]}, 2))

    died, dead_stats, still, resets, revived, out = both(case)
    assert died == {} and still == {}
    assert dead_stats["dead"] and dead_stats["draft_faults"] == 1
    assert resets == 1 and not revived["dead"]
    assert out == {0: [6, 7]}


def test_build_proposer_wiring():
    def case(pkg):
        kinds = [type(pkg.spec.build_proposer("ngram")).__name__,
                 type(pkg.spec.build_proposer(
                     "draft", FakeDraftModel())).__name__]
        msgs = []
        for args, match in (((("draft",)), "draft model"),
                            ((("off",)), "no proposer")):
            with pytest.raises(pkg.config.ConfigError, match=match) as e:
                pkg.spec.build_proposer(*args)
            msgs.append(str(e.value))
        return kinds, msgs

    kinds, _ = both(case)
    assert kinds == ["NGramProposer", "DraftModelProposer"]


# -- scheduler spec rounds against the fake model ------------------------

class FakeSpecModel:
    """The reference test's FakeSpecModel: a (token + 1) % V successor
    rule for the plain step and for every fed position of verify_step,
    so a successor-chain draft is always accepted and anything else is
    rejected at its first wrong position."""

    def __init__(self, batch_slots=2, max_seq=32, page_size=4,
                 num_blocks=None, prefill_chunk=0, spec_decode="ngram",
                 spec_k=4, draft_model=None):
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.max_blocks_per_seq = max_seq // page_size
        self.num_blocks = (num_blocks if num_blocks is not None
                           else 1 + batch_slots * self.max_blocks_per_seq)
        self.vocab = V
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = True
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.verify_chunk = spec_k + 1
        self.draft_model = draft_model
        self.steps = 0
        self.verify_calls = 0
        self.prefill_calls = 0
        self.copied_blocks = []
        self.fail_at_steps = set()
        self.fail_verify_at = set()
        self.resets = 0

    def reset(self):
        self.resets += 1

    def step(self, tokens, seq_lens, block_tables):
        self.steps += 1
        if self.steps in self.fail_at_steps:
            raise RuntimeError(f"injected step fault @{self.steps}")
        logits = np.zeros((self.batch_slots, V), np.float32)
        nxt = (np.asarray(tokens) + 1) % V
        logits[np.arange(self.batch_slots), nxt] = 1.0
        return logits

    def prefill_step(self, tokens, positions, block_tables):
        self.prefill_calls += 1

    def verify_step(self, tokens, seq_lens, counts, block_tables):
        self.verify_calls += 1
        if self.verify_calls in self.fail_verify_at:
            raise RuntimeError(
                f"injected verify fault @{self.verify_calls}")
        C = tokens.shape[1]
        logits = np.zeros((self.batch_slots, C, V), np.float32)
        nxt = (np.asarray(tokens) + 1) % V
        for j in range(C):
            logits[np.arange(self.batch_slots), j, nxt[:, j]] = 1.0
        return logits

    def copy_block(self, src, dst):
        self.copied_blocks.append((src, dst))


def expected(prompt, mnt):
    out = list(prompt)
    t = prompt[-1]
    for _ in range(mnt):
        t = (t + 1) % V
        out.append(t)
    return out


def cyclic(start, n):
    return [(start + i) % V for i in range(n)]


def run_engine(pkg, model, reqs, registry=False, after=(), **kw):
    """Admit `reqs` ((prompt, max_new[, temperature]) tuples) together,
    wait for each (a failed request records its error), then run the
    `after` requests one at a time; returns the record both packages
    must agree on."""
    reg = pkg.metrics.MetricsRegistry() if registry else None
    with held_admission(pkg.sched.ContinuousScheduler):
        sched = pkg.sched.ContinuousScheduler(model, registry=reg, **kw)
        hs = [sched.generate_async(*r) for r in reqs]
    try:
        outs = []
        for h in hs:
            try:
                outs.append(h.wait(30.0))
            except RuntimeError as e:
                outs.append(f"{type(e).__name__}: {e}")
        outs += [sched.generate(p, m, timeout=30.0) for p, m in after]
        sched.pool.check_invariants()
        rec = {
            "outs": outs,
            "spec": sched.stats()["speculative"],
            "steps": model.steps, "verify_calls": model.verify_calls,
            "prefill_calls": model.prefill_calls,
            "copied": model.copied_blocks, "resets": model.resets,
            "tokens_generated": sched.tokens_generated,
            "batches_run": sched.batches_run,
            "fallback_rounds": sched.spec_fallback_rounds,
            "requests_done": sched.requests_done,
            "handles": [(h.spec_proposed, h.spec_accepted) for h in hs],
            "used_blocks": sched.pool.used_blocks,
        }
        if model.draft_model is not None:
            rec["draft"] = (model.draft_model.steps,
                            model.draft_model.resets)
        if reg is not None:
            rec["registry"] = registry_record(reg)
        return rec
    finally:
        sched.close()


def test_spec_rounds_accept_ngram_drafts_token_identical():
    reqs = [(cyclic(3, V + 2), 30), (cyclic(9, V + 2), 26)]
    rec = both(lambda pkg: run_engine(
        pkg, FakeSpecModel(batch_slots=2, max_seq=64, spec_k=4), reqs,
        registry=True))
    assert rec["outs"] == [expected(p, m) for p, m in reqs]
    st = rec["spec"]
    assert st["mode"] == "ngram" and st["rounds"] > 0
    assert st["accepted"] == st["proposed"] > 0
    assert st["accepted_per_round"] > 1.5 and not st["degraded"]
    assert rec["tokens_generated"] > rec["verify_calls"] + rec["steps"]
    assert all(a == p > 0 for p, a in rec["handles"])
    assert rec["registry"]["serving/spec_accepted"] == (
        "Counter", st["accepted"])
    assert rec["registry"]["serving/spec_rounds"] == ("Counter",
                                                      st["rounds"])
    for name in ("serving/steps", "serving/ttft_ms",
                 "serving/request_latency_ms", "serving/per_token_ms",
                 "serving/kv_used_blocks", "serving/spec_proposed",
                 "serving/spec_accepted_per_round",
                 "serving/spec_rounds_per_s"):
        assert name in rec["registry"], name


def test_spec_rejection_rolls_back_and_stays_token_identical():
    reqs = [([3, 4, 5], 9), ([11], 7)]

    def case(pkg):
        draft = FakeDraftModel(batch_slots=2, off=7)  # always wrong
        return run_engine(pkg, FakeSpecModel(
            batch_slots=2, spec_decode="draft", spec_k=3,
            draft_model=draft), reqs)

    rec = both(case)
    assert rec["outs"] == [expected(p, m) for p, m in reqs]
    st = rec["spec"]
    assert st["proposed"] > 0 and st["accepted"] == 0
    assert st["k_current"] == 1 and rec["used_blocks"] == 0


def test_spec_draft_mode_accepts_and_reconciles():
    reqs = [([3, 4], 12), ([8], 10)]

    def case(pkg):
        draft = FakeDraftModel(batch_slots=2, off=0)
        return run_engine(pkg, FakeSpecModel(
            batch_slots=2, spec_decode="draft", spec_k=4,
            draft_model=draft), reqs)

    rec = both(case)
    assert rec["outs"] == [expected(p, m) for p, m in reqs]
    st = rec["spec"]
    assert st["accepted"] == st["proposed"] > 0
    assert st["proposer"]["draft_steps"] > 0
    assert st["proposer"]["live_draft_seqs"] == 0


def test_spec_falls_back_to_plain_decode_without_proposals():
    rec = both(lambda pkg: run_engine(
        pkg, FakeSpecModel(batch_slots=2, spec_decode="ngram"),
        [([3, 4], 6, 1.0)], seed=5))
    assert len(rec["outs"][0]) == 8
    assert rec["verify_calls"] == 0 and rec["steps"] > 0
    assert rec["fallback_rounds"] > 0 and rec["spec"]["rounds"] == 0


def test_spec_mixes_chunked_prefill_and_verify_rounds():
    reqs = [(cyclic(2, V + 2), 12), (cyclic(5, 33), 6)]
    rec = both(lambda pkg: run_engine(
        pkg, FakeSpecModel(batch_slots=2, max_seq=64, prefill_chunk=4,
                           spec_k=4), reqs))
    assert rec["outs"] == [expected(p, m) for p, m in reqs]
    assert rec["prefill_calls"] > 0 and rec["spec"]["rounds"] > 0


def test_transient_verify_fault_degrades_to_plain_decode():
    reqs = [(cyclic(3, V + 2), 10), (cyclic(7, V + 2), 8)]
    after = [(cyclic(1, V + 2), 5)]

    def case(pkg):
        model = FakeSpecModel(batch_slots=2, spec_k=4)
        model.fail_verify_at = {1}
        return run_engine(pkg, model, reqs, registry=True, after=after)

    rec = both(case)
    assert rec["outs"] == [expected(p, m) for p, m in reqs + after]
    st = rec["spec"]
    assert st["degraded"] and st["verify_faults"] == 1
    assert st["rounds"] == 0 and rec["verify_calls"] == 1
    assert rec["registry"]["serving/spec_verify_faults"] == ("Counter", 1)
    assert rec["requests_done"] == len(reqs) + len(after)


def test_step_fault_resets_proposer_state():
    after = [(cyclic(4, V + 2), 8)]

    def case(pkg):
        draft = FakeDraftModel(batch_slots=2, off=0)
        model = FakeSpecModel(batch_slots=2, spec_decode="draft",
                              spec_k=2, draft_model=draft)
        model.fail_at_steps = {2}
        return run_engine(pkg, model, [([3, 4], 6, 1.0)], registry=True,
                          after=after, seed=3)

    rec = both(case)
    assert "injected step fault" in rec["outs"][0]
    assert rec["outs"][1] == expected(*after[0])
    assert rec["resets"] == 1 and rec["draft"][1] == 1
    assert not rec["spec"]["degraded"]
    assert rec["registry"]["serving/step_failures"] == ("Counter", 1)


def test_spec_eos_inside_accepted_window_truncates():
    prompt = cyclic(3, V + 2)
    rec = both(lambda pkg: run_engine(
        pkg, FakeSpecModel(batch_slots=2, spec_k=4), [(prompt, 12)],
        eos_id=9))
    assert rec["outs"] == [prompt + [5, 6, 7, 8, 9]]
    assert rec["spec"]["rounds"] > 0 and rec["used_blocks"] == 0


def test_spec_off_never_builds_verify_surface():
    rec = both(lambda pkg: run_engine(
        pkg, FakeSpecModel(batch_slots=2, spec_decode="off"),
        [([3, 4], 6)]))
    assert rec["outs"] == [expected([3, 4], 6)]
    assert rec["verify_calls"] == 0 and rec["spec"]["mode"] == "off"


# -- KVPool.rollback (tests/test_kv_pool.py's rollback cases) -------------

def _state(pool):
    """Tables, refcounts, free list, cached blocks, index entries and
    the prefix counters (without the reference's KV-import counters:
    migration is not in the port yet)."""
    stats = {k: v for k, v in pool.prefix_stats().items()
             if k not in ("imports", "imported_blocks")}
    return {
        "tables": sorted((k, list(v)) for k, v in pool._tables.items()),
        "ref": sorted(pool._ref.items()),
        "free": list(pool._free),
        "cached": list(pool._cached),
        "index": sorted((k, e.block) for k, e in pool._index.items()),
        "block_key": sorted(pool._block_key.items()),
        "used": pool.used_blocks, "reserved": pool.reserved_blocks,
        "stats": stats,
    }


def _guard(fn, match):
    with pytest.raises(ValueError, match=match) as e:
        fn()
    return str(e.value)


def rb_truncates_and_reextends(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    assert pool.try_admit(1, 16)
    pool.extend(1, 12, written=12)
    log.append(_state(pool))
    assert pool.rollback(1, 5) is None
    assert len(pool.table_of(1)) == 2
    log.append(_state(pool))
    pool.extend(1, 16, written=16)
    assert len(pool.table_of(1)) == 4
    pool.retire(1)
    assert pool.used_blocks == 0
    return pool


def rb_to_zero(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    assert pool.try_admit(1, 8)
    pool.extend(1, 8, written=8)
    log.append(pool.rollback(1, 0))
    assert pool.table_of(1) == [] and pool.used_blocks == 0
    return pool


def rb_guards(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    log.append(_guard(lambda: pool.rollback(42, 0), "not admitted"))
    assert pool.try_admit(1, 8)
    pool.extend(1, 6, written=6)
    log.append(_guard(lambda: pool.rollback(1, 7), "past sequence"))
    return pool


PROMPT = [3, 5, 7, 2, 9, 4, 1, 8]


def rb_never_cuts_shared_prefix(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    assert pool.try_admit(1, 10, prompt=PROMPT)
    pool.extend(1, 8, written=8)
    pool.retire(1, tokens=PROMPT)
    assert pool.try_admit(2, 10, prompt=PROMPT)
    hit = pool.admit_hit_tokens(2)
    assert hit >= 4
    pool.extend(2, 8, written=8)
    log.append(_guard(lambda: pool.rollback(2, hit - 1), "shared-"))
    return pool


def rb_unregisters_stale_index(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    assert pool.try_admit(1, 12, prompt=PROMPT)
    pool.extend(1, 8, written=8)
    assert pool.cached_prefix_tokens(PROMPT) == 8
    log.append(_state(pool))
    pool.rollback(1, 4)
    assert pool.cached_prefix_tokens(PROMPT) == 4
    assert pool.prefix_stats()["invalidations"] >= 1
    return pool


def rb_cow_tail_vouched_elsewhere(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    assert pool.try_admit(1, 12, prompt=PROMPT)
    pool.extend(1, 8, written=8)
    blk0 = pool.table_of(1)[0]
    assert pool.try_admit(2, 10, prompt=PROMPT)
    copy = pool.rollback(1, 2)
    log.append(copy)
    assert copy is not None and copy[0] == blk0
    assert pool.table_of(1)[0] == copy[1] != blk0
    assert blk0 in pool.table_of(2)
    return pool


def rb_exactly_onto_shared_boundary(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    assert pool.try_admit(1, 10, prompt=PROMPT)
    pool.extend(1, 8, written=8)
    pool.retire(1, tokens=PROMPT)
    assert pool.try_admit(2, 10, prompt=PROMPT)
    hit = pool.admit_hit_tokens(2)
    assert hit % 4 == 0 and hit >= 4
    pool.extend(2, hit + 3, written=hit + 3)
    log.append(pool.rollback(2, hit))
    assert log[-1] is None and len(pool.table_of(2)) == hit // 4
    log.append(_guard(lambda: pool.rollback(2, hit - 1), "shared-"))
    pool.extend(2, hit + 1, written=hit + 1)
    assert len(pool.table_of(2)) == hit // 4 + 1
    return pool


def rb_slot_holding_cow_blocks(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    assert pool.try_admit(1, 12, prompt=PROMPT)
    pool.extend(1, 8, written=8)
    blk1 = pool.table_of(1)[1]
    pool.retire(1, tokens=PROMPT)
    assert pool.try_admit(2, 12, prompt=PROMPT)
    assert pool.admit_hit_tokens(2) == 8
    cow = pool.ensure_writable(2, 7)
    log.append(cow)
    assert cow is not None and cow[0] == blk1
    pool.extend(2, 10, written=10)
    log.append(pool.rollback(2, 6))
    assert log[-1] is None and pool.table_of(2)[1] == cow[1]
    assert pool.cached_prefix_tokens(PROMPT) == 8
    log.append(_state(pool))
    pool.retire(2)
    return pool


def rb_then_extend_reregisters(KVPool, log):
    pool = KVPool(num_blocks=9, page_size=4, max_blocks_per_seq=4)
    prompt = [3, 5, 7, 2]
    rejected = prompt + [9, 4, 1, 8]
    final = prompt + [6, 2, 6, 2]
    assert pool.try_admit(1, 12, prompt=prompt)
    pool.extend(1, 8, written=8)
    assert pool.cached_prefix_tokens(rejected) == 4
    log.append(pool.rollback(1, 5))
    pool.extend(1, 8, written=8)
    pool.retire(1, tokens=final)
    assert pool.cached_prefix_tokens(final) == 8
    assert pool.cached_prefix_tokens(rejected) == 4
    assert pool.try_admit(2, 12, prompt=final)
    assert pool.admit_hit_tokens(2) == 8
    return pool


def rb_random_interleaving(KVPool, log):
    """Block conservation under admit/extend/ROLLBACK/retire at the
    reference's seed, every step's state logged."""
    rng = np.random.RandomState(11)
    pool = KVPool(num_blocks=33, page_size=4, max_blocks_per_seq=8)
    live = {}
    next_id = 0
    rollbacks = 0
    for _ in range(2500):
        op = rng.randint(4)
        if op == 0:
            target = int(rng.randint(1, 33))
            if pool.try_admit(next_id, target):
                live[next_id] = [target, 0]
            next_id += 1
        elif op == 1 and live:
            sid = list(live)[rng.randint(len(live))]
            target, cur = live[sid]
            if cur < target:
                pool.extend(sid, cur + 1)
                pool.note_written(sid, cur + 1)
                live[sid][1] = cur + 1
        elif op == 2 and live:
            sid = list(live)[rng.randint(len(live))]
            cur = live[sid][1]
            if cur:
                to = int(rng.randint(0, cur + 1))
                assert pool.rollback(sid, to) is None
                live[sid][1] = to
                rollbacks += 1
        elif op == 3 and live:
            sid = list(live)[rng.randint(len(live))]
            del live[sid]
            pool.retire(sid)
        pool.check_invariants()
        assert pool.used_blocks == sum(len(pool.table_of(s)) for s in live)
        log.append((sorted(pool._tables.items()), sorted(pool._ref.items()),
                    list(pool._free)))
    assert rollbacks > 100
    for sid in list(live):
        pool.retire(sid)
    assert pool.used_blocks == 0 and pool.reserved_blocks == 0
    return pool


@pytest.mark.parametrize("scenario", [
    rb_truncates_and_reextends, rb_to_zero, rb_guards,
    rb_never_cuts_shared_prefix, rb_unregisters_stale_index,
    rb_cow_tail_vouched_elsewhere, rb_exactly_onto_shared_boundary,
    rb_slot_holding_cow_blocks, rb_then_extend_reregisters,
    rb_random_interleaving,
], ids=lambda f: f.__name__[3:])
def test_rollback_matches_the_reference(scenario):
    def case(pkg):
        log = []
        pool = scenario(pkg.kv.KVPool, log)
        pool.check_invariants()
        log.append(_state(pool))
        return log

    assert both(case)
