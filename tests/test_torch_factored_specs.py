"""Factored per-op views in the port, their layouts: every tensor's
spec under each factored strategy of tests/test_torch_factored_views.py
(the mixed-degree MLP, the dry run's, a 2-layer BERT with attention at
channel 4 and the first FFN at channel 2 or 4, the port's Unity winner
for the narrow and wide graph over 8 H100s) against the reference's
`view_to_spec`, with the normalizer's factored bias placement and the
attention weights' opposite axis orders.  No group runs: the strategies
are applied and their views assigned on the CPU in both packages.
"""
import functools
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_ranks as R  # noqa: E402
from test_torch_factored_views import (BERT, DRY,  # noqa: E402
                                       _bert_strategies, narrow_wide,
                                       unity_winner)

import flexflow_tpu as RF  # noqa: E402
from flexflow_tpu.models.transformer import build_bert  # noqa: E402
from flexflow_tpu.ops.op import ShardConfig as RShard  # noqa: E402
from flexflow_tpu.parallel.machine import \
    view_to_spec as ref_view_to_spec  # noqa: E402
from flexflow_tpu.pcg.rewrite import \
    cancel_all_inverse_parallel_ops as ref_cancel  # noqa: E402
from flexflow_tpu.strategy import Strategy as RStrategy  # noqa: E402
from flexflow_tpu.strategy import apply_strategy as ref_apply  # noqa: E402
from flexflow_tpu.strategy import assign_views as ref_assign  # noqa: E402
from flexflow_tpu_torch import FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models.transformer import \
    build_bert as t_build_bert  # noqa: E402
from flexflow_tpu_torch.ops.op import ShardConfig  # noqa: E402
from flexflow_tpu_torch.parallel.machine import view_to_spec  # noqa: E402
from flexflow_tpu_torch.pcg.rewrite import \
    cancel_all_inverse_parallel_ops  # noqa: E402
from flexflow_tpu_torch.strategy import (Strategy, apply_strategy,  # noqa
                                         assign_views)


def spec_as_partition(spec):
    """A port spec in the reference's PartitionSpec entries (None, an
    axis name, or a tuple of names), trailing Nones dropped."""
    entries = [None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in spec]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _specs(build, strategy, ref_build, ref_strategy):
    ff = FFModel(FFConfig(device="cpu"))
    build(ff)
    g = cancel_all_inverse_parallel_ops(apply_strategy(ff.layers, strategy))
    assign_views(g, strategy.mesh_axes)
    ffr = RF.FFModel(RF.FFConfig())
    ref_build(ffr)
    gr = ref_cancel(ref_apply(ffr.layers, ref_strategy))
    ref_assign(gr, ref_strategy.mesh_axes)
    want = {pt.name: tuple(ref_view_to_spec(pt)) for op in gr.ops
            for pt in list(op.outputs) + list(op.weights)}
    got = {pt.name: spec_as_partition(view_to_spec(pt)) for op in g.ops
           for pt in list(op.outputs) + list(op.weights)}
    return got, want


@pytest.mark.parametrize("case", ["mlp", "dry", "bert2", "bert4", "unity"])
def test_views_equal_the_reference(case):
    """Every tensor's spec of each factored strategy is the reference's
    PartitionSpec, dims over two axes included."""
    if case in ("mlp", "dry"):
        build = (R.mixed_mlp if case == "mlp"
                 else functools.partial(R.mixed_mlp, **DRY))
        got, want = _specs(build, R.mixed_strategy(Strategy, ShardConfig),
                           build, R.mixed_strategy(RStrategy, RShard))
    elif case == "unity":
        best = unity_winner()
        got, want = _specs(narrow_wide, best, narrow_wide,
                           RStrategy.from_json(best.to_json()))
    else:
        rstrat, strat = _bert_strategies(int(case[-1]))
        got, want = _specs(
            functools.partial(t_build_bert, batch_size=4, **BERT), strat,
            functools.partial(build_bert, batch_size=4, **BERT), rstrat)
    assert got == want
    # the Unity winner ({model0: 4, model1: 2}) fits each degree on one
    # factored axis; every other case puts some dim on two
    assert (case == "unity") != any(isinstance(a, tuple)
                                    for spec in got.values() for a in spec)


def test_views_state_the_normalizers_factored_bias_placement():
    """The shared view normalizer puts fb's bias (channel 4 on model1 +
    model0) on (data, model0), an axis its kernel does not use: both
    packages do, and the port keeps it for parity (ROADMAP §3)."""
    got, want = _specs(R.mixed_mlp, R.mixed_strategy(Strategy, ShardConfig),
                       R.mixed_mlp, R.mixed_strategy(RStrategy, RShard))
    bias = next(k for k in got if k.startswith("fb") and "bias" in k)
    kernel = next(k for k in got if k.startswith("fb") and "kernel" in k)
    assert got[bias] == want[bias] == (("data", "model0"),)
    assert got[kernel] == want[kernel] == (None, ("model1", "model0"))


def test_attention_heads_lie_in_opposite_axis_orders():
    """wq/wk/wv take their heads on (model1, model0) and wo on (model0,
    model1), in both packages: each step moves wo between the orders."""
    rstrat, strat = _bert_strategies(2)
    got, want = _specs(functools.partial(t_build_bert, batch_size=4, **BERT),
                       strat,
                       functools.partial(build_bert, batch_size=4, **BERT),
                       rstrat)
    wq = next(k for k in got if k.startswith("attn_0") and k.endswith("wq"))
    wo = next(k for k in got if k.startswith("attn_0") and k.endswith("wo"))
    assert got[wq] == want[wq] == (None, ("model1", "model0"))
    assert got[wo] == want[wo] == (("model0", "model1"),)
