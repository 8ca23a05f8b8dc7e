"""Weights cross from flexflow_tpu into the port unchanged:
from_jax_weights checks every op, weight name and shape and names the
first entry that is missing, extra or misshapen; the port's GPT graph
carries the reference's names, shapes and whole-model forward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.models.transformer import build_gpt as jax_gpt  # noqa: E402
from flexflow_tpu_torch.convert import from_jax_weights  # noqa: E402
from flexflow_tpu_torch.models.transformer import build_gpt  # noqa: E402

GPT = dict(batch_size=4, seq_length=32, hidden_size=32, num_layers=2,
           num_heads=4, intermediate_size=64, vocab_size=64)


@pytest.fixture(scope="module")
def pair():
    jf = J.FFModel(J.FFConfig(batch_size=4, num_devices=1))
    jax_gpt(jf, **GPT)
    jf.compile(comp_mode=J.CompMode.INFERENCE,
               devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=4, device="cpu"))
    build_gpt(tf, **GPT)
    tf.compile()
    return jf, tf


def test_round_trip_is_exact(pair):
    jf, tf = pair
    want = jf.get_weights()
    tf.set_weights(want)
    got = tf.get_weights()
    assert sorted(got) == sorted(want)
    for op, entries in want.items():
        assert sorted(got[op]) == sorted(entries)
        for k, v in entries.items():
            assert got[op][k].dtype == np.float32
            np.testing.assert_array_equal(got[op][k], np.asarray(v))


def test_whole_gpt_forward_matches(pair):
    jf, tf = pair
    tf.set_weights(jf.get_weights())
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (4, 32)).astype(np.int32)
    pos = np.tile(np.arange(32, dtype=np.int32), (4, 1))
    feed = {"input": ids, "positions": pos}
    np.testing.assert_allclose(tf.forward(feed).numpy(),
                               np.asarray(jf.forward(feed)), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("fault,match", [
    ("missing_op", "missing weights for op 'ffn2_1'"),
    ("missing_weight", "missing weight attn_0.wo"),
    ("extra_op", "unexpected weight group 'rogue'"),
    ("extra_weight", "unexpected weight ln1_0.scale"),
    ("misshapen", r"weight attn_1.wq has shape \(32, 4, 4\)"),
])
def test_bad_entries_raise_naming_them(pair, fault, match):
    jf, tf = pair
    w = {op: dict(v) for op, v in jf.get_weights().items()}
    if fault == "missing_op":
        del w["ffn2_1"]
    elif fault == "missing_weight":
        del w["attn_0"]["wo"]
    elif fault == "extra_op":
        w["rogue"] = {"kernel": np.zeros(3, np.float32)}
    elif fault == "extra_weight":
        w["ln1_0"]["scale"] = np.ones(32, np.float32)
    else:
        w["attn_1"]["wq"] = np.zeros((32, 4, 4), np.float32)
    with pytest.raises(ValueError, match=match):
        from_jax_weights(w, tf)


def test_decode_twin_shares_the_trained_tensors(pair):
    from flexflow_tpu_torch.decoding import make_gpt_decoder

    _, tf = pair
    twin = make_gpt_decoder(tf, batch_size=2, kv_page_size=4,
                            kv_num_blocks=9)
    for op, entries in twin._weights.items():
        for k, v in entries.items():
            assert v is tf._weights[op][k]
    assert twin._state["attn_0"]["k_cache"].shape == (9, 4, 4, 8)
