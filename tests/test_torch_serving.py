"""The port's serving slice against flexflow_tpu's, on the CPU with the
same weights: the paged decode, prefill and copy-on-write steps of
PagedKVDecodeModel (the reference on its gather formulation), KVPool's
tables over one random request sequence, ContinuousScheduler's greedy
completions, and a serve_http round trip."""
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.models.transformer import build_gpt as jax_gpt  # noqa: E402
from flexflow_tpu.serving import kv_pool as jax_kv  # noqa: E402
from flexflow_tpu.serving import scheduler as jax_sched  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_gpt  # noqa: E402
from flexflow_tpu_torch.serving import kv_pool as port_kv  # noqa: E402
from flexflow_tpu_torch.serving import scheduler as port_sched  # noqa: E402

V, S, SLOTS, PAGE, CHUNK = 64, 32, 4, 4, 4
GPT = dict(batch_size=SLOTS, seq_length=S, hidden_size=32, num_layers=2,
           num_heads=4, intermediate_size=64, vocab_size=V)


@pytest.fixture(scope="module")
def engines():
    """(reference, port) PagedKVDecodeModels over the same weights."""
    jf = J.FFModel(J.FFConfig(batch_size=SLOTS, num_devices=1))
    jax_gpt(jf, **GPT)
    devs = jax.devices("cpu")[:1]
    jf.compile(comp_mode=J.CompMode.INFERENCE, devices=devs)
    tf = T.FFModel(T.FFConfig(batch_size=SLOTS, device="cpu"))
    build_gpt(tf, **GPT)
    tf.compile()
    tf.set_weights(jf.get_weights())
    jm = jax_sched.PagedKVDecodeModel(
        jf, batch_slots=SLOTS, page_size=PAGE, devices=devs,
        prefill_chunk=CHUNK, paged_kernel="gather")
    tm = port_sched.PagedKVDecodeModel(
        tf, batch_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK)
    return jm, tm


def _pools(model, key):
    return {op: np.asarray(e[key]) for op, e in model._state.items()
            if key in e}


def test_scripted_steps_prefill_and_copy(engines):
    """Chunked prefill of one row, then decode steps with rows admitted
    at different steps and positions, page crossings and an idle
    scratch row; then a copy-on-write."""
    jm, tm = engines
    jm.reset()
    tm.reset()
    rng = np.random.RandomState(0)
    width = S // PAGE
    blocks = rng.permutation(np.arange(1, jm.num_blocks))
    btab = np.zeros((SLOTS, width), np.int32)
    btab[0, :3] = blocks[0:3]
    btab[1, :2] = blocks[3:5]
    btab[3, :4] = blocks[5:9]          # row 2 stays idle on scratch
    # chunked prefill: row 3's positions 0..3 (the others on scratch)
    tok = rng.randint(0, V, (SLOTS, CHUNK)).astype(np.int32)
    pre_tab = np.zeros_like(btab)
    pre_tab[3] = btab[3]
    zeros = np.zeros(SLOTS, np.int32)
    jm.prefill_step(tok, zeros, pre_tab)
    tm.prefill_step(tok, zeros, pre_tab)
    for key in ("k_cache", "v_cache"):
        jp, tp = _pools(jm, key), _pools(tm, key)
        for op in jp:  # block 0 is scratch: idle rows' writes collide
            np.testing.assert_allclose(tp[op][1:], jp[op][1:], rtol=0,
                                       atol=1e-5)
    start = {0: 0, 1: None, 3: 4}      # row 1 is admitted at step 3
    for k in range(10):
        if k == 3:
            start[1] = -3
        slens = np.zeros(SLOTS, np.int32)
        live = [i for i, s0 in start.items() if s0 is not None]
        tab = np.zeros_like(btab)
        for i in live:
            slens[i] = start[i] + k
            tab[i] = btab[i]
        tokens = rng.randint(0, V, SLOTS).astype(np.int32)
        want = jm.step(tokens, slens, tab)
        got = tm.step(tokens, slens, tab)
        assert got.shape == (SLOTS, V) and got.dtype == np.float32
        np.testing.assert_allclose(got[live], want[live], rtol=0,
                                   atol=1e-4, err_msg=f"step {k}")
    src, dst = int(btab[3, 1]), int(blocks[-1])
    jm.copy_block(src, dst)
    tm.copy_block(src, dst)
    for key in ("k_cache", "v_cache"):
        tp = _pools(tm, key)
        for op, arr in tp.items():
            np.testing.assert_array_equal(arr[dst], arr[src])
            np.testing.assert_allclose(arr[dst], _pools(jm, key)[op][dst],
                                       rtol=0, atol=1e-5)


def test_kv_pool_tables_identical_to_reference():
    """One random admit / extend / write / COW / retire sequence through
    both pools gives the same tables, free list, cache and counters."""
    rng = np.random.RandomState(11)
    pools = [m.KVPool(16, 4, 8, prefix_cache=True)
             for m in (jax_kv, port_kv)]
    prefix = rng.randint(0, V, 8).tolist()
    live = {}
    for step in range(300):
        op = rng.randint(4)
        if op == 0 and len(live) < 5:
            # a bare prefix (n == 0) is the full-prompt hit that COWs
            k = int(rng.choice([0, 4, 8]))
            n = int(rng.randint(0 if k else 1, 14))
            prompt = prefix[:k] + rng.randint(0, V, n).tolist()
            sid = step
            need = len(prompt) + int(rng.randint(1, 8))
            res = [p.try_admit(sid, min(need, 32), prompt=prompt)
                   for p in pools]
            assert res[0] == res[1]
            if res[0]:
                hit = pools[0].admit_hit_tokens(sid)
                assert pools[1].admit_hit_tokens(sid) == hit
                start = min(hit, len(prompt) - 1)
                cows = [p.ensure_writable(sid, start) for p in pools]
                assert cows[0] == cows[1]
                for p in pools:
                    p.extend(sid, start + 1, written=start)
                live[sid] = [prompt, start, min(need, 32)]
        elif op in (1, 2) and live:
            sid = int(rng.choice(sorted(live)))
            prompt, pos, cap = live[sid]
            if pos + 1 < cap:
                pos += 1
                for p in pools:
                    p.extend(sid, pos + 1)
                    p.note_written(sid, pos)
                live[sid][1] = pos
        elif op == 3 and live:
            sid = int(rng.choice(sorted(live)))
            prompt, pos, _ = live.pop(sid)
            toks = (prompt + [1] * 32)[:pos]
            for p in pools:
                p.retire(sid, tokens=toks)
        a, b = pools
        assert a._tables == b._tables, f"step {step}"
        assert a._free == b._free and list(a._cached) == list(b._cached)
        assert a._ref == b._ref
        for sid in live:
            np.testing.assert_array_equal(a.table_row(sid),
                                          b.table_row(sid))
        b.check_invariants()
    ref_stats = a.prefix_stats()
    for k, v in b.prefix_stats().items():
        assert ref_stats[k] == v, k
    assert ref_stats["hits"] > 0 and ref_stats["cow_copies"] > 0
    assert ref_stats["evictions"] > 0


def _workload():
    rng = np.random.RandomState(9)
    prefix = rng.randint(0, V, 8).tolist()  # 2 full pages
    prompts = [prefix]
    prompts += [prefix + rng.randint(0, V, int(rng.randint(1, 6))).tolist()
                for _ in range(3)]
    prompts.append(rng.randint(0, V, 11).tolist())
    prompts.append(prefix)  # full-prompt COW re-hit
    mnts = [int(rng.randint(3, 8)) for _ in prompts]
    return prompts, mnts


def _run_waves(sched, prompts, mnts):
    """The first four requests in flight together, then the last two
    (which find the shared prefix cached: a hit and a full-prompt COW
    re-hit)."""
    out = []
    for wave in (slice(0, 4), slice(4, None)):
        handles = [sched.generate_async(p, m)
                   for p, m in zip(prompts[wave], mnts[wave])]
        out += [h.wait(300) for h in handles]
    return out


def test_continuous_greedy_token_identical(engines):
    jm, tm = engines
    prompts, mnts = _workload()
    jm.reset()
    ref = jax_sched.ContinuousScheduler(jm, check_invariants=True)
    try:
        want = _run_waves(ref, prompts, mnts)
    finally:
        ref.close()
    tm.reset()
    sched = port_sched.ContinuousScheduler(tm, check_invariants=True)
    gaps = []
    step = tm.step

    def recording(tokens, slens, btab):
        logits = step(tokens, slens, btab)
        for i, live in enumerate(sched._slots):
            if live is not None and live.pos >= len(live.req.prompt) - 1:
                top2 = np.sort(logits[i])[-2:]
                gaps.append((float(top2[1] - top2[0]), live.req.prompt,
                             int(slens[i])))
        return logits

    tm.step = recording
    try:
        got = _run_waves(sched, prompts, mnts)
        stats = sched.stats()
    finally:
        sched.close()
        del tm.step
    # every greedy decision had a clear winner, so identity is a real
    # check: a near tie would be named here, with where it happened
    assert gaps and min(g[0] for g in gaps) > 1e-4, min(gaps)
    assert got == want
    assert stats["prefix_cache"]["hits"] >= 1
    assert stats["prefix_cache"]["cow_copies"] >= 1
    assert stats["prefill_steps"] > 0
    assert stats["paged_kernel"]["formulation"] == "plain"
    assert stats["requests_done"] == len(prompts)


def test_serve_http_round_trip(engines):
    from flexflow_tpu_torch.serving import serve_http

    _, tm = engines
    tm.reset()
    sched = port_sched.ContinuousScheduler(tm)
    server = serve_http(generator=sched, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        prompts, _ = _workload()
        body = json.dumps({"prompts": prompts[:2],
                           "max_new_tokens": 3}).encode()
        req = urllib.request.Request(
            base + "/v2/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            toks = json.loads(r.read())["tokens"]
        assert toks == [sched.generate(p, 3) for p in prompts[:2]]
        with urllib.request.urlopen(base + "/v2/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(base + "/v2/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests_done"] == 4
        assert stats["continuous"]["paged_kernel"]["formulation"] == "plain"
        bad = urllib.request.Request(
            base + "/v2/generate", data=b'{"prompt": []}',
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        sched.close()
