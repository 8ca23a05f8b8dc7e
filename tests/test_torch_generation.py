"""GPT generation in the port against flexflow_tpu on the CPU: the
re-forward loops (models.transformer.gpt_generate, gpt_beam_search),
the dense-cache decode twin (make_gpt_decoder with kv_page_size 0,
FFModel.decode_step, the attention op's `_attend_decode`) and its
drivers (gpt_generate_cached, gpt_beam_search_cached,
gpt_generate_scan), `_reorder_cache_rows`, and the errors the
reference raises.

A tiny GPT (hidden 32, 2 layers, 4 heads, vocab 32, 12 positions) is
trained 20 SGD steps in the reference on an arithmetic-sequence task
and its weights carried into the port (convert.from_jax_weights), so
the argmaxes have margins.  Greedy tokens must be exactly equal across
the packages and across the port's three drivers; host-sampled tokens
(the same numpy RandomState draws on logits equal to ~1e-6) too.  Beam
scores (summed float64 log-probs of float32 logits) within 1e-5.
Decode-step logits and the k/v caches within 1e-5 of the output's
scale max(1, max|ref|): the port computes the same einsums in another
order (~1e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu.decoding as JD  # noqa: E402
import flexflow_tpu.models.transformer as JT  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
import flexflow_tpu_torch.decoding as TD  # noqa: E402
import flexflow_tpu_torch.models.transformer as TT  # noqa: E402
from flexflow_tpu_torch.ops.op import ShapeError  # noqa: E402

V, S, B = 32, 12, 4
TOL, SCORE_TOL = 1e-5, 1e-5
GPT = dict(batch_size=B, seq_length=S, hidden_size=32, num_layers=2,
           num_heads=4, intermediate_size=64, vocab_size=V)


def _cpu():
    return jax.devices("cpu")[:1]


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def pair():
    jf = J.FFModel(J.FFConfig(batch_size=B, num_devices=1))
    JT.build_gpt(jf, **GPT)
    jf.compile(optimizer=J.SGDOptimizer(lr=0.5),
               loss_type="sparse_categorical_crossentropy", devices=_cpu())
    rng = np.random.RandomState(0)
    start = rng.randint(0, V, (B, 1))
    step = rng.randint(1, 6, (B, 1))
    seq_ids = (start + step * np.arange(S + 1)) % V
    ids = seq_ids[:, :-1].astype(np.int32)
    labels = seq_ids[:, 1:].astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for _ in range(20):
        jf.train_step({"input": ids, "positions": pos}, labels)
    tf = T.FFModel(T.FFConfig(batch_size=B, device="cpu"))
    TT.build_gpt(tf, **GPT)
    tf.compile(comp_mode=T.CompMode.INFERENCE)
    tf.set_weights(jf.get_weights())
    return jf, tf, ids


@pytest.fixture(scope="module")
def decoders(pair):
    jf, tf, _ = pair
    return JD.make_gpt_decoder(jf, devices=_cpu()), TD.make_gpt_decoder(tf)


def test_gpt_generate_greedy_matches_reference(pair):
    jf, tf, ids = pair
    prompt = ids[:, :5]
    got = TT.gpt_generate(tf, prompt, max_new_tokens=6)
    want = JT.gpt_generate(jf, prompt, max_new_tokens=6)
    assert got.shape == (B, 11) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # cut at the model's seq length
    assert TT.gpt_generate(tf, prompt, max_new_tokens=50).shape == (B, S)


@pytest.mark.parametrize("kw", [dict(temperature=0.8, seed=3),
                                dict(temperature=1.0, seed=7, top_k=4),
                                dict(temperature=1.0, seed=7, top_p=0.8)])
def test_gpt_generate_sampled_matches_reference(pair, kw):
    jf, tf, ids = pair
    prompt = ids[:, :4]
    np.testing.assert_array_equal(TT.gpt_generate(tf, prompt, 5, **kw),
                                  JT.gpt_generate(jf, prompt, 5, **kw))


def test_cached_and_scan_equal_the_re_forward_loop(pair, decoders):
    jf, tf, ids = pair
    jd, td = decoders
    prompt = ids[:, :5]
    full = TT.gpt_generate(tf, prompt, max_new_tokens=6)
    cached = TD.gpt_generate_cached(td, prompt, max_new_tokens=6)
    scanned = TD.gpt_generate_scan(td, prompt, max_new_tokens=6)
    np.testing.assert_array_equal(cached, full)
    np.testing.assert_array_equal(scanned, full)
    np.testing.assert_array_equal(
        cached, JD.gpt_generate_cached(jd, prompt, max_new_tokens=6))
    # the decoder shares the trained tensors
    assert td._weights["lm_head"]["kernel"] is tf._weights["lm_head"]["kernel"]


def test_cached_sampling_matches_reference(pair, decoders):
    _, _, ids = pair
    jd, td = decoders
    kw = dict(temperature=0.8, top_k=8, top_p=0.9, seed=3)
    got = TD.gpt_generate_cached(td, ids[:, :4], 5, **kw)
    np.testing.assert_array_equal(
        got, JD.gpt_generate_cached(jd, ids[:, :4], 5, **kw))


def test_scan_with_ragged_prompts_and_sampling(pair, decoders):
    """Each row prefills to its own length then samples; at temperature
    0 the rows equal the host loop's on their own prompts; sampled
    tokens are in the vocabulary, the prompts verbatim, and one seed
    gives one result."""
    _, _, ids = pair
    _, td = decoders
    plens = np.array([3, 5, 4, 6], np.int32)
    pad = np.zeros((B, 9), np.int32)
    for i, n in enumerate(plens):
        pad[i, :n] = ids[i, :n]
    out = TD.run_generate_scan(td, pad, plens)
    for i, n in enumerate(plens):
        row = np.repeat(ids[i:i + 1, :n], B, axis=0)
        want = TD.gpt_generate_cached(td, row, 9 - n)[0]
        np.testing.assert_array_equal(out[i], want)
    a = TD.gpt_generate_scan(td, ids[:, :4], 5, temperature=0.8, seed=3)
    b = TD.gpt_generate_scan(td, ids[:, :4], 5, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (B, 9) and (a >= 0).all() and (a < V).all()
    np.testing.assert_array_equal(a[:, :4], ids[:, :4])


def test_beam_search_matches_reference(pair, decoders):
    jf, tf, ids = pair
    jd, td = decoders
    prompt = ids[:1, :5]
    want_toks, want_score = JT.gpt_beam_search(jf, prompt, 6, beam_size=4)
    toks, score = TT.gpt_beam_search(tf, prompt, 6, beam_size=4)
    np.testing.assert_array_equal(toks, want_toks)
    assert abs(score - want_score) <= SCORE_TOL
    ctoks, cscores = TD.gpt_beam_search_cached(td, prompt, 6, beam_size=4)
    np.testing.assert_array_equal(ctoks[0], want_toks)
    assert abs(cscores[0] - want_score) <= SCORE_TOL
    jtoks, jscores = JD.gpt_beam_search_cached(jd, prompt, 6, beam_size=4)
    np.testing.assert_array_equal(ctoks, jtoks)
    assert abs(cscores[0] - jscores[0]) <= SCORE_TOL
    # beam 1 is greedy
    t1, _ = TT.gpt_beam_search(tf, prompt, 4, beam_size=1)
    greedy = TT.gpt_generate(tf, np.repeat(prompt, B, axis=0), 4)[0]
    np.testing.assert_array_equal(t1, greedy)


def test_beam_search_eos_and_length_penalty_match_reference(pair, decoders):
    jf, tf, ids = pair
    _, td = decoders
    prompt = ids[:1, :4]
    kw = dict(max_new_tokens=7, beam_size=4, length_penalty=0.6,
              eos_id=int(ids[0, 6]))
    want_toks, want_score = JT.gpt_beam_search(jf, prompt, **kw)
    toks, score = TT.gpt_beam_search(tf, prompt, **kw)
    np.testing.assert_array_equal(toks, want_toks)
    assert abs(score - want_score) <= SCORE_TOL
    ctoks, cscores = TD.gpt_beam_search_cached(td, prompt, **kw)
    np.testing.assert_array_equal(ctoks[0], want_toks)
    assert abs(cscores[0] - want_score) <= SCORE_TOL


def test_beam_search_cached_batched_prompts(pair, decoders):
    """Two prompts x 2 beams in one pass equal each prompt's re-forward
    beam search (the row reorder keeps every row's cache with its
    hypothesis)."""
    _, tf, ids = pair
    _, td = decoders
    prompts = np.stack([ids[0, :5], ids[2, 1:6]])
    toks, scores = TD.gpt_beam_search_cached(td, prompts, 5, beam_size=2)
    for p in range(2):
        want_toks, want_score = TT.gpt_beam_search(tf, prompts[p], 5,
                                                   beam_size=2)
        np.testing.assert_array_equal(toks[p], want_toks)
        assert abs(scores[p] - want_score) <= SCORE_TOL


def test_decode_steps_match_reference_logits_and_caches(pair, decoders):
    jf, tf, ids = pair
    jd, td = decoders
    jd.reset_decode_state()
    td.reset_decode_state()
    for t in range(4):
        feed = {"input": ids[:, t:t + 1],
                "positions": np.full((B, 1), t, np.int32)}
        got = td.decode_step(feed).numpy()
        want = np.asarray(jd.decode_step(feed))
        assert got.shape == want.shape == (B, 1, V)
        assert _scaled(got, want) <= TOL
    got_s, want_s = td.get_state(), jd._state
    assert sorted(got_s) == sorted(want_s) == ["attn_0", "attn_1"]
    for op, entries in want_s.items():
        assert sorted(got_s[op]) == ["cache_pos", "k_cache", "v_cache"]
        for k, v in entries.items():
            assert got_s[op][k].dtype == np.asarray(v).dtype
            assert _scaled(got_s[op][k], v) <= TOL, f"{op}.{k}"
    assert int(got_s["attn_0"]["cache_pos"][0]) == 4 == td._decode_pos


def test_reorder_cache_rows_gathers_in_place(pair, decoders):
    _, _, ids = pair
    _, td = decoders
    td.reset_decode_state()
    for t in range(3):
        td.decode_step({"input": ids[:, t:t + 1],
                        "positions": np.full((B, 1), t, np.int32)})
    before = td.get_state()
    tensors = {op: dict(e) for op, e in td._state.items()}
    perm = np.array([2, 2, 0, 3])
    TD._reorder_cache_rows(td, perm)
    after = td.get_state()
    for op in before:
        for k in ("k_cache", "v_cache"):
            np.testing.assert_array_equal(after[op][k], before[op][k][perm])
            assert td._state[op][k] is tensors[op][k]
        np.testing.assert_array_equal(after[op]["cache_pos"],
                                      before[op]["cache_pos"])
    TD._reorder_cache_rows(td, np.arange(B))  # the identity: no change
    for op in after:
        np.testing.assert_array_equal(td.get_state()[op]["k_cache"],
                                      after[op]["k_cache"])


@pytest.mark.parametrize("causal", [True, False])
def test_dense_decode_attention_op_matches_reference(causal):
    """Two steps of 2 tokens through one decode-mode attention op: the
    outputs, the caches and cache_pos against the reference op's."""
    ops = []
    for P, ff in ((J, J.FFModel(J.FFConfig(batch_size=2, num_devices=1))),
                  (T, T.FFModel(T.FFConfig(batch_size=2, device="cpu")))):
        x = ff.create_tensor([2, 2, 16], name="x")
        ops.append(ff.multihead_attention(x, x, x, 16, 4, causal=causal,
                                          decode_max_seq=6).owner_op)
    jop, top = ops
    assert [(s.name, s.shape.logical_shape) for s in top.weight_specs] == \
        [(s.name, s.shape.logical_shape) for s in jop.weight_specs]
    rng = np.random.RandomState(3)
    ws = [rng.randn(*s.shape.logical_shape).astype(np.float32) * 0.3
          for s in top.weight_specs[:4]]
    jstate = [jnp.zeros((2, 6, 4, 4)), jnp.zeros((2, 6, 4, 4)),
              jnp.zeros((1,), jnp.int32)]
    tstate = [torch.zeros(2, 6, 4, 4), torch.zeros(2, 6, 4, 4),
              torch.zeros(1, dtype=torch.int32)]
    for _ in range(2):
        x = rng.randn(2, 2, 16).astype(np.float32)
        jout = jop.forward([jnp.asarray(x)] * 3,
                           [jnp.asarray(w) for w in ws] + jstate)
        tout = top.forward([torch.from_numpy(x)] * 3,
                           [torch.from_numpy(w) for w in ws] + tstate)
        assert tout[1] is tstate[0] and tout[3] is tstate[2]  # in place
        jstate = list(jout[1:])
        for g, w in zip(tout, jout):
            assert _scaled(g.numpy(), w) <= TOL
    assert int(tstate[2][0]) == 4


def test_decode_cache_uses_compute_dtype():
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu",
                              compute_dtype="bfloat16"))
    TT.build_gpt(ff, batch_size=2, seq_length=8, hidden_size=16,
                 num_layers=1, num_heads=2, intermediate_size=32,
                 vocab_size=V, decode_max_seq=8)
    ff.compile(comp_mode=T.CompMode.INFERENCE)
    caches = [v for e in ff._state.values() for k, v in e.items()
              if k in ("k_cache", "v_cache")]
    assert caches and all(c.dtype == torch.bfloat16 for c in caches)
    logits = ff.decode_step({"input": np.zeros((2, 1), np.int32),
                             "positions": np.zeros((2, 1), np.int32)})
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_decode_guard_reset_and_sync(pair, decoders):
    _, _, ids = pair
    _, td = decoders
    td.reset_decode_state()
    for t in range(S):
        td.decode_step({"input": ids[:, t:t + 1],
                        "positions": np.full((B, 1), t, np.int32)})
    with pytest.raises(ValueError, match="decode_max_seq"):
        td.decode_step({"input": ids[:, :1],
                        "positions": np.full((B, 1), S - 1, np.int32)})
    td.reset_decode_state()  # the guard resets with the caches
    assert td._decode_pos == 0
    for t in range(3):
        td.decode_step({"input": ids[:, t:t + 1],
                        "positions": np.full((B, 1), t, np.int32)})
    saved = td.get_state()
    td.reset_decode_state()
    td.set_state(saved)
    assert td._decode_pos == 3


def test_decode_guard_follows_a_loaded_state(pair, decoders):
    """set_state moves the guard with cache_pos, with no call between:
    a state loaded at an earlier position trips nothing early, and one
    loaded at position S - 1 leaves room for exactly one step."""
    _, _, ids = pair
    _, td = decoders

    def step(t):
        td.decode_step({"input": ids[:, t:t + 1],
                        "positions": np.full((B, 1), t, np.int32)})

    def assert_full():
        with pytest.raises(ValueError, match=f"position {S}\\)"):
            step(0)

    td.reset_decode_state()
    step(0)
    early = td.get_state()
    for t in range(1, S - 1):
        step(t)
    late = td.get_state()
    td.set_state(early)  # from S - 1 back to 1
    for t in range(1, S):
        step(t)
    assert_full()
    td.set_state(late)  # from S back to S - 1
    step(S - 1)
    assert_full()
    td.reset_decode_state()
    td.set_state(late)  # from 0 up to S - 1
    step(S - 1)
    assert_full()


def test_scan_refuses_a_buffer_past_the_caches(decoders):
    _, td = decoders
    with pytest.raises(ValueError, match="decode_max_seq"):
        TD.run_generate_scan(td, np.zeros((B, S + 2), np.int32),
                             np.ones(B, np.int32))


def test_errors_the_reference_raises(pair, decoders):
    jf, tf, ids = pair
    jd, td = decoders
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    ff.dense(ff.create_tensor([2, 8], name="x"), 4)
    with pytest.raises(ValueError, match="build_gpt"):
        TD.make_gpt_decoder(ff)
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    t = ff.create_tensor([2, 1, 32], name="x")
    with pytest.raises(ShapeError, match="decode mode"):
        ff.multihead_attention(t, t, t, 32, 4, add_bias_kv=True,
                               decode_max_seq=16)
    with pytest.raises(RuntimeError, match="decode_step"):
        td.forward({"input": ids[:, :1],
                    "positions": np.zeros((B, 1), np.int32)})
    for fn in (TD.gpt_generate_cached, TD.gpt_generate_scan):
        with pytest.raises(ValueError, match="decoder batch"):
            fn(td, ids[:2, :4], 3)
        with pytest.raises(ValueError, match="non-empty"):
            fn(td, ids[:, :0], 3)
    with pytest.raises(ValueError, match="decoder batch"):
        TD.gpt_beam_search_cached(td, ids[:1, :4], 3, beam_size=2)
    with pytest.raises(ValueError, match="exceeds compiled batch"):
        TT.gpt_beam_search(tf, ids[:1, :4], 2, beam_size=5)
    with pytest.raises(ValueError, match="sampling filter"):
        TT.gpt_generate(tf, ids[:, :4], 2, top_p=1.5)
    with pytest.raises(ValueError, match="sampling filter"):
        TD.gpt_generate_cached(td, ids[:, :4], 2, top_k=-1)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        TD.make_gpt_decoder(tf, tp=2)
    # the reference raises the same on each
    with pytest.raises(ValueError):
        JD.gpt_beam_search_cached(jd, ids[:1, :4], 3, beam_size=2)
    with pytest.raises(ValueError):
        JT.gpt_beam_search(jf, ids[:1, :4], 2, beam_size=5)
