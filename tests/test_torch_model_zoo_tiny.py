"""The port's native model zoo trained against flexflow_tpu's on the
CPU: every builder of `models/` at tests/test_model_zoo.py's tiny sizes
(tests/test_torch_model_zoo.py's TINY) through both packages with the
same weights: the forward, then the metrics of 2 SGD steps and every
weight after them.  The tiny Inception-v3 converts between NCHW and
NHWC exactly where the reference's layout pass does: once at the input
and once before the head, every branch join staying channels_last.

Each TINY model's pair is built once: the layout check reads
Inception-v3's pair after its training case (both packages took the
same two steps).  Tolerances as in tests/test_torch_model_zoo.py."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.pcg.layout import \
    assign_layouts as jax_layouts  # noqa: E402
from flexflow_tpu_torch.pcg.layout import assign_layouts  # noqa: E402
from test_torch_model_zoo import (BATCH, OUT_TOL, TINY,  # noqa: E402
                                  _assert_metrics, _assert_weights, _pair,
                                  _scaled)

_PAIRS = {}


def _tiny_pair(name):
    """(reference model, port model) of a TINY builder, compiled once for
    the module."""
    if name not in _PAIRS:
        kwargs, (loss, metrics), _, _ = TINY[name]
        _PAIRS[name] = _pair(name, kwargs, loss, metrics)
    return _PAIRS[name]


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_builder_trains_like_reference(name):
    _, _, inputs, labels = TINY[name]
    jf, tf = _tiny_pair(name)
    rng = np.random.RandomState(1)
    feed = inputs(rng)
    got = tf.forward(feed).numpy()
    want = np.asarray(jf.forward(feed))
    assert got.shape == want.shape
    assert _scaled(got, want) <= OUT_TOL
    for _ in range(2):
        feed, y = inputs(rng), labels(rng)
        _assert_metrics(tf.train_step(feed, y), jf.train_step(feed, y))
    _assert_weights(tf, jf)


def _conversions(graph, t_layout, op_layout, nhwc):
    """{(op name, input index): "to_nhwc" | "to_nchw"} of the layout
    copies an executor makes: a 4-D input of an NHWC op that is stored
    logical, and an NHWC-stored input of a logical op."""
    out = {}
    for op in graph.topo_order():
        want = op_layout.get(op.guid)
        for i, t in enumerate(op.inputs):
            if t.shape.logical_rank != 4:
                continue
            stored = t_layout.get(t.guid)
            if want == nhwc and stored != nhwc:
                out[(op.name, i)] = "to_nhwc"
            elif want is None and stored == nhwc:
                out[(op.name, i)] = "to_nchw"
    return out


def test_tiny_inception_converts_layouts_where_the_reference_does():
    from flexflow_tpu.pcg.layout import NHWC as JNHWC
    from flexflow_tpu_torch.pcg.layout import NHWC

    jf, tf = _tiny_pair("build_inception_v3")
    got = _conversions(tf.layers, *assign_layouts(tf.layers), NHWC)
    want = _conversions(jf.layers, *jax_layouts(jf.layers), JNHWC)
    assert got == want
    assert sorted(got.values()) == ["to_nchw", "to_nhwc"]
    first = tf.layers.topo_order()[1]
    assert got[(first.name, 0)] == "to_nhwc"
    concats = [op for op in tf.layers.ops
               if op.op_type == T.OperatorType.CONCAT]
    assert len(concats) == 11
    assert all(tf.executor.op_layout[op.guid] == NHWC for op in concats)
    # the run: every join emits a channels_last tensor
    seen = []
    for op in concats:
        fwd = op.forward

        def watched(ins, ws, _fwd=fwd, **kw):
            outs = _fwd(ins, ws, **kw)
            seen.append(outs[0].is_contiguous(
                memory_format=torch.channels_last))
            return outs

        op.forward = watched
    x = np.random.RandomState(2).randn(BATCH, 3, 75, 75).astype(np.float32)
    out = tf.forward({"input": x}).numpy()
    assert seen == [True] * 11
    assert _scaled(out, np.asarray(jf.forward({"input": x}))) <= OUT_TOL
