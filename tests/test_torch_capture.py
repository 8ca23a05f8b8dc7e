"""The captured step of the port (capture.py) on the CPU: what keeps a
plan from being captured, and the learning rate as a device tensor.

`capture_blockers` is a pure function of the compiled plan: a model on
the CPU names the CPU device; a one-device plan whose executor is built
for a CUDA device (a torch.device, no card needed) names nothing, so
its step would be captured; a gloo group names its staging through the
host; an expert-parallel plan whose GroupBy routes sharded tokens (the
MoE MLP under data 4, and under data 2 x expert 2) names its exchange,
whose split sizes are read on the host, where the experts split over 4
with the tokens on every rank (no exchange) does not.  The ranks run
in one spawned gloo group of 4 (tests/torch_dist_ranks.py).  On the
CPU build_step returns the eager step and `capture_status` says why.

The update reads the learning rate from a float32 0-d tensor on the
weights' device, which `set_learning_rate` writes in place: changed at
the end of each epoch of `fit` (a callback), the losses and weights
are the reference's (float32, other summation orders: 1e-5 per sample
on each epoch's summed loss, 1e-5 on SGD's weights, 1e-4 on Adam's,
whose first step moves each by about alpha whatever the gradient's
size).  The captured step itself runs on the
card only: tests/test_torch_gpu.py and chip_smoke.py's capture phase.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as R  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu_torch.capture import (CAPTURE_OFF,  # noqa: E402
                                        CapturedStep, capture_blockers)
from flexflow_tpu_torch.executor import GraphExecutor  # noqa: E402
from flexflow_tpu_torch.ops.op import ShardConfig  # noqa: E402
from flexflow_tpu_torch.strategy import Strategy  # noqa: E402
from flexflow_tpu_torch.strategy import data_parallel_strategy  # noqa: E402

CPU = "the cpu device"
GLOO = "a gloo group"
EXCHANGE = "expert-parallel exchange"


def _moe_strategy(mesh, ep):
    s = Strategy(mesh_axes=dict(mesh))
    if mesh.get("data", 1) > 1:
        s.edge_ops["__inputs__"] = [("repartition",
                                     {"dim": 0, "degree": mesh["data"]})]
    if ep:
        for n in ("group_by_0", "experts_dense_0"):
            s.shard_configs[n] = ShardConfig(expert=ep)
    return s


@pytest.fixture(scope="module")
def group():
    cases = [
        (R.capture_plan, (R.mlp_zero, data_parallel_strategy(4))),
        (R.capture_plan, (R.moe_mlp, _moe_strategy({"data": 4}, 0))),
        (R.capture_plan, (R.moe_mlp, _moe_strategy({"expert": 4}, 4))),
        (R.capture_plan, (R.mlp_zero, data_parallel_strategy(4), False)),
        (R.capture_plan, (R.moe_mlp,
                          _moe_strategy({"data": 2, "expert": 2}, 2))),
    ]
    return R.run_group(R.run_cases, 4, cases, timeout=150)


def _kinds(blockers):
    return [b for b in (CPU, GLOO, EXCHANGE)
            if any(x.startswith(b) for x in blockers)]


def test_a_cpu_model_names_the_cpu():
    ff = T.FFModel(T.FFConfig(batch_size=16, device="cpu"))
    R.mlp_zero(ff)
    ff.compile(seed=0)
    assert _kinds(capture_blockers(ff.executor)) == [CPU]
    assert ff.executor.capture_status == {
        "mode": "eager", "blockers": capture_blockers(ff.executor)}
    assert not isinstance(ff._step_fn, CapturedStep)


def test_a_one_device_plan_on_a_cuda_device_has_no_blocker():
    """The plan alone decides: an executor built for torch.device("cuda")
    (its weights never drawn) over the MLP, BERT and the MoE MLP."""
    for build in (R.mlp_zero, R.moe_mlp,
                  lambda ff: T.models.build_bert(
                      ff, batch_size=2, seq_length=8, hidden_size=16,
                      num_layers=1, num_heads=2, intermediate_size=32)):
        ff = T.FFModel(T.FFConfig(batch_size=16, device="cpu"))
        build(ff)
        ex = GraphExecutor(ff.layers, torch.device("cuda"))
        assert capture_blockers(ex) == []


def test_capture_off_is_named():
    """build_step(capture=False), the eager side of a comparison, names
    itself first, before what the plan holds."""
    ff = T.FFModel(T.FFConfig(batch_size=16, device="cpu"))
    R.mlp_zero(ff)
    ff.compile(seed=0)
    step = ff.executor.build_step(capture=False)
    assert not isinstance(step, CapturedStep)
    st = ff.executor.capture_status
    assert st["mode"] == "eager"
    assert st["blockers"][0] == CAPTURE_OFF
    assert _kinds(st["blockers"][1:]) == [CPU]


@pytest.mark.parametrize("case,want", [
    (0, [CPU, GLOO]),            # data parallel 4 over gloo
    (1, [CPU, GLOO, EXCHANGE]),  # the MoE MLP, tokens over data 4
    (2, [CPU, GLOO]),            # experts over 4, tokens on every rank
    (4, [CPU, GLOO, EXCHANGE]),  # tokens and experts over data 2
], ids=["dp4", "moe_dp4", "moe_ep4", "moe_dp2_ep2"])
def test_a_group_plan_names_its_blockers(group, case, want):
    for rank in group:
        got = rank[case]
        assert _kinds(got["blockers"]) == want
        assert got["status"] == {"mode": "eager",
                                 "blockers": got["blockers"]}
        if EXCHANGE in want:
            assert any("group_by_0" in b for b in got["blockers"])


def test_a_group_with_capture_off_names_that_first(group):
    st = group[0][3]["status"]
    assert st["mode"] == "eager"
    assert st["blockers"][0] == CAPTURE_OFF
    assert _kinds(st["blockers"][1:]) == [CPU, GLOO]


class _LearningRateSteps:
    """A callback that sets the learning rate at the end of each epoch
    (works with either package's fit)."""

    def __init__(self, rates):
        self.rates = list(rates)

    def on_train_begin(self, model):
        pass

    def on_epoch_end(self, model, epoch, metrics):
        model.set_learning_rate(self.rates[epoch])

    def on_train_end(self, model):
        pass


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_set_learning_rate_mid_fit_gives_the_reference_losses(opt):
    make = {"sgd": lambda P: P.SGDOptimizer(lr=0.05, momentum=0.9),
            "adam": lambda P: P.AdamOptimizer(alpha=0.01)}[opt]
    metrics = ["accuracy", "sparse_categorical_crossentropy"]
    jf = J.FFModel(J.FFConfig(batch_size=16, num_devices=1))
    R.mlp_zero(jf)
    jf.compile(optimizer=make(J), metrics=metrics,
               devices=jax.devices("cpu")[:1])
    tf = T.FFModel(T.FFConfig(batch_size=16, device="cpu"))
    R.mlp_zero(tf)
    tf.compile(optimizer=make(T), metrics=metrics)
    tf.set_weights(jf.get_weights())
    rate = tf.optimizer._rate_on(torch.device("cpu"))
    rng = np.random.RandomState(5)
    x = rng.randn(48, 32).astype(np.float32)
    y = rng.randint(0, 7, 48).astype(np.int32)
    rates = [0.2, 0.0, 0.01] if opt == "sgd" else [0.05, 0.0, 0.002]
    want = [pm.sparse_cce_loss for pm in jf.fit(
        x, y, epochs=3, verbose=False,
        callbacks=[_LearningRateSteps(rates)])]
    got = [pm.sparse_cce_loss for pm in tf.fit(
        x, y, epochs=3, verbose=False,
        callbacks=[_LearningRateSteps(rates)])]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 48)
    jw = jf.get_weights()
    atol = 1e-4 if opt == "adam" else 1e-5
    for op, entries in tf.get_weights().items():
        for k, v in entries.items():
            np.testing.assert_allclose(v, np.asarray(jw[op][k]), rtol=0,
                                       atol=atol)
    # written in place: the tensor a captured graph reads is the same one
    assert tf.optimizer._rate_on(torch.device("cpu")) is rate
    assert rate.dtype == torch.float32 and rate.dim() == 0
    assert float(rate) == np.float32(rates[-1])
    assert tf.optimizer.get_lr() == jf.optimizer.get_lr() == rates[-1]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_an_update_without_init_state_reads_a_rate_tensor(opt):
    """An update run before init_state binds its rate tensor on the
    weights' device, and set_lr then writes that same tensor: the
    update never reads the Python float (a capture would freeze it).
    A step moves each weight by lr * g under SGD (g = 1), and by alpha
    under Adam at a constant gradient (m-hat / sqrt(v-hat) = 1): 0.5,
    then 0.25 (rtol 2e-5: Adam's float32 bias corrections, up to ~1e-5)."""
    make = {"sgd": lambda: T.SGDOptimizer(lr=0.5),
            "adam": lambda: T.AdamOptimizer(alpha=0.5)}[opt]
    o = make()
    w = {"fc": {"kernel": torch.zeros(3)}}
    g = {"fc": {"kernel": torch.ones(3)}}
    state = ({} if opt == "sgd" else
             {"m": {"fc": {"kernel": torch.zeros(3)}},
              "v": {"fc": {"kernel": torch.zeros(3)}},
              "t": torch.zeros((), dtype=torch.int32)})
    o.update(w, g, state)
    rate = o._rate_on(torch.device("cpu"))
    assert rate.dtype == torch.float32 and float(rate) == 0.5
    np.testing.assert_allclose(w["fc"]["kernel"].numpy(), -0.5, rtol=2e-5)
    o.set_lr(0.25)
    assert o._rate_on(torch.device("cpu")) is rate and float(rate) == 0.25
    before = w["fc"]["kernel"].clone()
    o.update(w, g, state)
    np.testing.assert_allclose((before - w["fc"]["kernel"]).numpy(), 0.25,
                               rtol=2e-5)
