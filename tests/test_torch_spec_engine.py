"""The port's speculative engine on real paged twins, against its own
seq-1 stepping and against flexflow_tpu on the CPU with the same weights
(tests/test_torch_serving.py's GPT: hidden 32, 2 layers, 4 heads, vocab
64, seq 32, 4 slots, page 4, chunk 4): the verify step's per-position
logits and pool bytes, the chunk step, greedy completions under off,
ngram and draft (the target as its own drafter, and a 1-layer drafter
of the same widths) with the pool's invariants checked every step, a
transient and a fatal verify fault, the draft checks, and the serving/*
metrics of one workload in both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu import decoding as jax_dec  # noqa: E402
from flexflow_tpu.models.transformer import build_gpt as jax_gpt  # noqa: E402
from flexflow_tpu.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from flexflow_tpu.serving import scheduler as jax_sched  # noqa: E402
from flexflow_tpu_torch import decoding as port_dec  # noqa: E402
from flexflow_tpu_torch.config import ConfigError  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_gpt  # noqa: E402
from flexflow_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from flexflow_tpu_torch.serving import scheduler as port_sched  # noqa: E402
from torch_spec_support import held_admission, registry_record  # noqa: E402

V, S, SLOTS, PAGE, CHUNK, K = 64, 32, 4, 4, 4, 4
GPT = dict(batch_size=SLOTS, seq_length=S, hidden_size=32, num_layers=2,
           num_heads=4, intermediate_size=64, vocab_size=V)
DEVS = jax.devices("cpu")[:1]


def _pair(num_layers):
    """A reference and a port GPT at GPT's widths with the reference's
    initial weights carried across."""
    widths = dict(GPT, num_layers=num_layers)
    jf = J.FFModel(J.FFConfig(batch_size=SLOTS, num_devices=1))
    jax_gpt(jf, **widths)
    jf.compile(comp_mode=J.CompMode.INFERENCE, devices=DEVS)
    tf = T.FFModel(T.FFConfig(batch_size=SLOTS, device="cpu"))
    build_gpt(tf, **widths)
    tf.compile()
    tf.set_weights(jf.get_weights())
    return jf, tf


@pytest.fixture(scope="module")
def gpts():
    """(reference, port) target GPTs and (reference, port) 1-layer
    drafters."""
    return _pair(2), _pair(1)


def _pools(model, key):
    """A copy of every layer's pool (np.asarray of a CPU tensor would
    share its memory, which later steps write in place)."""
    return {op: np.array(e[key]) for op, e in model._state.items()
            if key in e}


def _snapshot(model):
    return {op: {k: v.clone() for k, v in e.items()}
            for op, e in model._state.items()}


def _restore(model, snap):
    with torch.no_grad():
        for op, e in model._state.items():
            for k, v in e.items():
                v.copy_(snap[op][k])


def _history(models, rng, btab, lens):
    """Decode steps writing each row's first lens[i] positions (rows of
    length 0 sit on scratch), the same tokens in every model."""
    for t in range(max(lens)):
        tokens = rng.randint(0, V, SLOTS).astype(np.int32)
        live = np.array([t < n for n in lens])
        slens = np.where(live, t, 0).astype(np.int32)
        tab = np.where(live[:, None], btab, 0).astype(np.int32)
        for m in models:
            m.step(tokens, slens, tab)


def test_verify_step_equals_seq1_stepping_and_the_reference(gpts):
    """Rows with counts 5, 1 and 5 whose last two steps pass max_seq,
    and an idle row on scratch: the live positions' logits equal the
    port's own seq-1 steps bit for bit and the reference's verify step
    within 1e-4, and the pools (scratch aside) its seq-1 steps bit for
    bit and the reference's within 1e-5; a dead step writes nothing of
    its row's."""
    (jf, tf), _ = gpts
    jm = jax_sched.PagedKVDecodeModel(
        jf, batch_slots=SLOTS, page_size=PAGE, devices=DEVS,
        paged_kernel="gather", spec_decode="ngram", spec_k=K)
    tm = port_sched.PagedKVDecodeModel(tf, batch_slots=SLOTS,
                                       page_size=PAGE, spec_decode="ngram",
                                       spec_k=K)
    assert tm.verify_chunk == K + 1
    rng = np.random.RandomState(3)
    width = S // PAGE
    blocks = rng.permutation(np.arange(1, tm.num_blocks))
    btab = np.zeros((SLOTS, width), np.int32)
    btab[0, :4] = blocks[0:4]
    btab[1, :3] = blocks[4:7]
    btab[2] = blocks[7:15]
    lens = [9, 6, 29, 0]
    _history([jm, tm], rng, btab, lens)
    snap = _snapshot(tm)
    tokens = rng.randint(0, V, (SLOTS, K + 1)).astype(np.int32)
    counts = np.array([K + 1, 1, K + 1, 0], np.int32)
    slens = np.array(lens, np.int32)
    got = tm.verify_step(tokens, slens, counts, btab)
    want = jm.verify_step(tokens, slens, counts, btab)
    assert got.shape == (SLOTS, K + 1, V) and got.dtype == np.float32
    live = [(i, j) for i in range(SLOTS) for j in range(K + 1)
            if j < counts[i] and lens[i] + j < S]
    assert (2, 2) in live and (2, 3) not in live and (1, 1) not in live
    verify_pools = {k: _pools(tm, k) for k in ("k_cache", "v_cache")}
    _restore(tm, snap)
    for j in range(K + 1):
        alive = np.array([(i, j) in live for i in range(SLOTS)])
        step = tm.step(tokens[:, j], np.where(alive, slens + j, 0),
                       np.where(alive[:, None], btab, 0))
        for i in np.flatnonzero(alive):
            assert np.array_equal(got[i, j], step[i]), (i, j)
    for i, j in live:
        np.testing.assert_allclose(got[i, j], want[i, j], rtol=0, atol=1e-4,
                                   err_msg=f"row {i} step {j}")
    for key in ("k_cache", "v_cache"):
        stepped, ref = _pools(tm, key), _pools(jm, key)
        for op, arr in verify_pools[key].items():
            assert np.array_equal(arr[1:], stepped[op][1:]), op
            np.testing.assert_allclose(arr[1:], ref[op][1:], rtol=0,
                                       atol=1e-5)
            # row 1's dead steps (positions 7-10) left its third block
            # alone
            assert np.array_equal(arr[btab[1, 2]],
                                  snap[op][key][btab[1, 2]].numpy())


def test_chunk_step_matches_the_reference(gpts):
    """One seq-4 forward of the chunk twin on the seq-1 twin's state,
    rows at their own positions (one past the position table's end),
    against the reference's build_paged_chunk_step: logits within 1e-4,
    pools within 1e-5."""
    (jf, tf), _ = gpts
    nb = 1 + SLOTS * (S // PAGE)
    with pytest.raises(ValueError, match="paged twin"):
        port_dec.make_gpt_decoder(tf, batch_size=SLOTS, step_tokens=CHUNK)
    with pytest.raises(ValueError, match="step_tokens"):
        port_dec.make_gpt_decoder(tf, batch_size=SLOTS, kv_page_size=PAGE,
                                  kv_num_blocks=nb, step_tokens=0)
    ffds = []
    for make, ff, kw in ((jax_dec.make_gpt_decoder, jf, {"devices": DEVS}),
                         (port_dec.make_gpt_decoder, tf, {})):
        seq1 = make(ff, batch_size=SLOTS, kv_page_size=PAGE,
                    kv_num_blocks=nb, **kw)
        twin = make(ff, batch_size=SLOTS, kv_page_size=PAGE,
                    kv_num_blocks=nb, step_tokens=CHUNK, **kw)
        ffds.append((seq1, twin))
    (jseq1, jtwin), (tseq1, ttwin) = ffds
    assert {op: {k: tuple(v.shape) for k, v in e.items()}
            for op, e in ttwin._state.items()} == \
        {op: {k: tuple(v.shape) for k, v in e.items()}
         for op, e in tseq1._state.items()}
    rng = np.random.RandomState(4)
    btab = rng.permutation(np.arange(1, nb)).reshape(
        SLOTS, S // PAGE).astype(np.int32)
    tokens = rng.randint(0, V, (SLOTS, CHUNK)).astype(np.int32)
    positions = np.array([0, 5, 12, 29], np.int32)
    jstep = jax_dec.build_paged_chunk_step(jtwin)
    want, jstate = jstep(jtwin._weights, jseq1._state, tokens, positions,
                         btab)
    tstep = port_dec.build_paged_chunk_step(ttwin)
    got, tstate = tstep(ttwin._weights, tseq1._state,
                        torch.as_tensor(tokens), torch.as_tensor(positions),
                        torch.as_tensor(btab))
    assert tuple(got.shape) == (SLOTS, CHUNK, V)
    inside = positions[:, None] + np.arange(CHUNK) < S
    assert not inside.all()  # row 3's last token is a pad past the table
    np.testing.assert_allclose(got.numpy()[inside],
                               np.asarray(want)[inside], rtol=0, atol=1e-4)
    for op, e in tstate.items():
        for key in ("k_cache", "v_cache"):
            np.testing.assert_allclose(e[key].numpy()[1:],
                                       np.asarray(jstate[op][key])[1:],
                                       rtol=0, atol=1e-5)


def _workload():
    """Greedy prompts of repeated motifs (for the n-gram drafter), inside
    the 32-entry position table; the last repeats the first, which by
    then is cached (a full-prompt prefix hit)."""
    rng = np.random.RandomState(5)
    prompts, mnts = [], []
    for n in (3, 4, 2, 5, 3):
        motif = rng.randint(0, V, n).tolist()
        prompts.append((motif * 4)[:int(rng.randint(7, 12))])
        mnts.append(int(rng.randint(10, 16)))
    return prompts + prompts[:1], mnts + mnts[:1]


def _submit(cls, make, prompts, mnts):
    """A scheduler from make(), with every request admitted together."""
    with held_admission(cls):
        sched = make()
        hs = [sched.generate_async(p, m) for p, m in zip(prompts, mnts)]
    return sched, hs


def _collect(sched, hs):
    """Completions (a failed request: its error), stats and whether the
    engine stopped, then close."""
    try:
        outs = []
        for h in hs:
            try:
                outs.append(h.wait(300))
            except RuntimeError as e:
                outs.append(f"{type(e).__name__}: {e}")
        return outs, sched.stats(), sched._stop.is_set()
    finally:
        sched.close()


def _engine(tf, spec="off", draft=None, registry=None, **kw):
    return port_sched.ContinuousScheduler.from_trained(
        tf, batch_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
        spec_decode=spec, spec_k=K, draft_ff=draft, registry=registry,
        check_invariants=True, **kw)


@pytest.fixture(scope="module")
def plain(gpts):
    """The reference's and the port's engines, speculation off, over the
    workload; the port's greedy decisions' top-2 gaps."""
    (jf, tf), _ = gpts
    prompts, mnts = _workload()
    jm = jax_sched.PagedKVDecodeModel(
        jf, batch_slots=SLOTS, page_size=PAGE, devices=DEVS,
        prefill_chunk=CHUNK, paged_kernel="gather")
    want, _, _ = _collect(*_submit(
        jax_sched.ContinuousScheduler,
        lambda: jax_sched.ContinuousScheduler(jm, check_invariants=True),
        prompts, mnts))
    gaps = []

    def make():
        sched = _engine(tf)
        step = sched.model.step

        def recording(tokens, slens, btab):
            logits = step(tokens, slens, btab)
            top2 = np.sort(logits, axis=-1)[:, -2:]
            gaps.extend((top2[:, 1] - top2[:, 0]).tolist())
            return logits

        sched.model.step = recording
        return sched

    got, stats, _ = _collect(*_submit(port_sched.ContinuousScheduler, make,
                                      prompts, mnts))
    return want, got, stats, min(gaps)


def test_plain_engine_matches_the_reference(plain):
    want, got, stats, gap = plain
    # a clear winner at every greedy decision (rows on scratch included,
    # which only makes the bound stricter)
    assert gap > 1e-5, gap
    assert got == want
    assert stats["speculative"]["mode"] == "off"
    assert stats["speculative"]["rounds"] == 0


@pytest.mark.parametrize("mode", ["ngram", "draft_self", "draft_small"])
def test_speculative_modes_are_token_identical(gpts, plain, mode):
    (_, tf), (_, tdraft) = gpts
    want = plain[1]
    spec, draft = {"ngram": ("ngram", None), "draft_self": ("draft", tf),
                   "draft_small": ("draft", tdraft)}[mode]
    prompts, mnts = _workload()
    got, stats, _ = _collect(*_submit(
        port_sched.ContinuousScheduler, lambda: _engine(tf, spec, draft),
        prompts, mnts))
    assert got == want
    st = stats["speculative"]
    assert st["mode"] == spec and st["rounds"] > 0
    assert st["verify_faults"] == 0 and not st["degraded"]
    if spec == "draft":
        assert st["proposer"]["draft_faults"] == 0
        assert not st["proposer"]["dead"]
        assert st["proposer"]["draft_steps"] > 0
    if mode == "draft_self":
        assert st["accepted_per_round"] > 1.5, st


def test_transient_verify_fault_degrades_token_identically(gpts, plain):
    (_, tf), _ = gpts
    prompts, mnts = _workload()
    calls = {"n": 0}

    def make():
        sched = _engine(tf, "draft", tf)
        real = sched.model.verify_step

        def flaky(tokens, seq_lens, counts, block_tables):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected verify fault")
            return real(tokens, seq_lens, counts, block_tables)

        sched.model.verify_step = flaky
        return sched

    got, stats, _ = _collect(*_submit(port_sched.ContinuousScheduler, make,
                                      prompts, mnts))
    assert got == plain[1]
    st = stats["speculative"]
    assert st["degraded"] and st["verify_faults"] == 1
    assert st["rounds"] == 1 and calls["n"] == 2


class _Fatal(RuntimeError):
    fatal_to_engine = True


def test_fatal_verify_fault_fails_in_flight_as_the_reference(gpts):
    """A verify exception marked fatal_to_engine ends the worker: every
    in-flight request fails with it, in both packages alike."""
    (jf, tf), _ = gpts
    prompts, mnts = _workload()

    def fatal(*a):
        raise _Fatal("device lost")

    jm = jax_sched.PagedKVDecodeModel(
        jf, batch_slots=SLOTS, page_size=PAGE, devices=DEVS,
        prefill_chunk=CHUNK, paged_kernel="gather", spec_decode="ngram",
        spec_k=K)
    records = []
    for cls, model in ((jax_sched.ContinuousScheduler, jm),
                       (port_sched.ContinuousScheduler,
                        port_sched.PagedKVDecodeModel(
                            tf, batch_slots=SLOTS, page_size=PAGE,
                            prefill_chunk=CHUNK, spec_decode="ngram",
                            spec_k=K))):
        model.verify_step = fatal
        outs, stats, stopped = _collect(*_submit(
            cls, lambda: cls(model), prompts[:SLOTS], mnts[:SLOTS]))
        records.append((outs, stopped,
                        stats["speculative"]["verify_faults"]))
    assert records[1] == records[0]
    assert records[1] == (["_Fatal: device lost"] * SLOTS, True, 0)


def test_draft_model_checks(gpts):
    """The reference's three checks on the draft engine, and a draft
    mode without one, as ConfigErrors at build."""
    (_, tf), _ = gpts

    class Draft:
        vocab, max_seq, batch_slots = V, S, SLOTS

    def build(draft):
        return port_sched.PagedKVDecodeModel(
            tf, batch_slots=SLOTS, page_size=PAGE, spec_decode="draft",
            spec_k=K, draft_model=draft)

    with pytest.raises(ConfigError, match="needs a draft model"):
        build(None)
    for attr, value, match in (("vocab", V + 1, "vocab"),
                               ("max_seq", S // 2, "position table"),
                               ("batch_slots", SLOTS - 1, "slots")):
        bad = Draft()
        setattr(bad, attr, value)
        with pytest.raises(ConfigError, match=match):
            build(bad)
    with pytest.raises(ConfigError, match="--spec-k must be >= 1"):
        port_sched.PagedKVDecodeModel(tf, batch_slots=SLOTS, page_size=PAGE,
                                      spec_decode="ngram", spec_k=0)
    assert build(Draft()).verify_chunk == K + 1


def test_registry_names_and_counts_match_the_reference(gpts):
    """The same ngram workload through both engines with a registry:
    the same serving/* names, counters, gauges and histogram counts
    (the reference's tensor-parallel gauges aside)."""
    (jf, tf), _ = gpts
    prompts, mnts = _workload()
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jm = jax_sched.PagedKVDecodeModel(
        jf, batch_slots=SLOTS, page_size=PAGE, devices=DEVS,
        prefill_chunk=CHUNK, paged_kernel="gather", spec_decode="ngram",
        spec_k=K)
    want, _, _ = _collect(*_submit(
        jax_sched.ContinuousScheduler,
        lambda: jax_sched.ContinuousScheduler(jm, registry=jreg),
        prompts, mnts))
    got, stats, _ = _collect(*_submit(
        port_sched.ContinuousScheduler,
        lambda: _engine(tf, "ngram", registry=treg), prompts, mnts))
    assert got == want
    rec = registry_record(treg)
    assert rec == registry_record(jreg)
    assert rec["serving/spec_rounds"] == ("Counter",
                                          stats["speculative"]["rounds"])
    assert rec["serving/steps"][1] == stats["steps"]
    assert rec["serving/requests_done"] == ("Counter", len(prompts))
    for name in ("serving/ttft_ms", "serving/request_latency_ms",
                 "serving/per_token_ms", "serving/kv_used_blocks",
                 "serving/kv_occupancy", "serving/spec_proposed",
                 "serving/spec_accepted", "serving/spec_accepted_per_round",
                 "serving/spec_rounds_per_s", "serving/prefix_hits"):
        assert name in rec, name
