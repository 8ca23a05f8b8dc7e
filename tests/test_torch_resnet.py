"""The ResNet slice of the port against flexflow_tpu on the CPU.

Each new op (Conv2D, Pool2D, BatchNorm in training and eval mode and
with the fused residual, ElementUnary, the binary ops, Flat, Softmax):
shapes and weight specs, the forward and the autograd grads against
jax.vjp of the reference op, on the same seeded numpy inputs.  A small
ResNet built from the example's Bottleneck (stem 3->8, one block with a
downsample, one identity block, 32 px, batch 4, 10 classes) through
both torch.fx frontends with copy_weights: outputs in eval and training
mode, then the loss, every weight and every running statistic after 2
SGD steps, in float32 and in bfloat16.  Running statistics stay out of
autograd.  The port's graph of the full ResNet-50 at 224 px (built, not
run) has the reference's op names, types and shapes, and its BatchNorm
plan holds 53 P1 applies, 16 with the residual.

Tolerances.  float32 ops: the same formulas in other summation orders
(XLA's convolutions and reductions against oneDNN's and ATen's), 1e-5
of the output's scale max(1, max|ref|) forward and 1e-4 for grads,
which sum over up to batch * H * W products.  The small ResNet in
float32: 1e-5 on outputs and losses, 2e-5 on weights and running
statistics after 2 steps at lr 0.1.  In bfloat16 every op rounds its
output to 8 significant bits (2^-8 relative) and the two frameworks
round at other places (P1 rounds x * s + b + r once, XLA after each
op), so the model's outputs and losses get 2e-2, and so do the
running statistics after one training forward (two bfloat16 ulps at
their size of 1-2: the state passes through the compute dtype, as the
reference's executor casts it).  After 2 steps the
bfloat16 weights carry rounding noise of the size of the update itself
(the stem's kernel moves by 0.08 and the reference's own bfloat16 run
lands 0.04 from its float32 run), so there each weight and running
statistic of the port is held against the float32 reference: it may
lie at most twice as far from it as the reference's bfloat16 run does,
plus 2^-8.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn as nn  # noqa: E402

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.fftype import OpBinary as JOpBinary  # noqa: E402
from flexflow_tpu.fftype import OpUnary as JOpUnary  # noqa: E402
from flexflow_tpu.torch_frontend.model import \
    PyTorchModel as JaxPyTorchModel  # noqa: E402
from flexflow_tpu_torch.executor import plan_bn_applies  # noqa: E402
from flexflow_tpu_torch.fftype import OpBinary, OpUnary  # noqa: E402
from flexflow_tpu_torch.pcg.layout import NHWC, assign_layouts  # noqa: E402
from flexflow_tpu_torch.torch_frontend import PyTorchModel  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"
                    / "python" / "pytorch"))
from resnet50_search import Bottleneck, ResNet50  # noqa: E402

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
MODEL_TOL = {"float32": {"out": 1e-5, "loss": 1e-5, "weights": 2e-5,
                         "state": 2e-5},
             "bfloat16": {"out": 2e-2, "loss": 2e-2, "state": 2e-2}}
BF16_NOISE_FACTOR, BF16_NOISE_FLOOR = 2.0, 2.0 ** -8


def _scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _ops(build, shapes):
    """build(P, ff, input tensors) in both packages -> (jax op, port op),
    after checking that their outputs and weight specs agree."""
    ops = []
    for P, ff in ((J, J.FFModel(J.FFConfig(batch_size=shapes[0][0],
                                           num_devices=1))),
                  (T, T.FFModel(T.FFConfig(batch_size=shapes[0][0],
                                           device="cpu")))):
        ts = [ff.create_tensor(list(s), name=f"x{i}")
              for i, s in enumerate(shapes)]
        ops.append(build(P, ff, ts).owner_op)
    jop, top = ops
    assert jop.op_type.value == top.op_type.value
    assert [o.shape.logical_shape for o in jop.outputs] == \
        [o.shape.logical_shape for o in top.outputs]
    assert [(s.name, s.shape.logical_shape) for s in jop.weight_specs] == \
        [(s.name, s.shape.logical_shape) for s in top.weight_specs]
    return jop, top


def _check(jop, top, inputs, weights=(), state=(), training=False,
           nhwc=False, residual=None, relu=None):
    """Forward (and the new op state) and the grads of the first output
    over inputs and trainable weights, jax.vjp against autograd."""
    rng = np.random.RandomState(7)

    def jfwd(xs, ws):
        outs = jop.forward(list(xs[:len(inputs)]),
                           list(ws) + [jnp.asarray(s) for s in state],
                           training=training)
        y = outs[0]
        if residual is not None:  # the chain the port's P1 fuses
            y = jax.nn.relu(y + xs[-1])
        return y, outs[1:]

    jxs = [jnp.asarray(x) for x in inputs]
    if residual is not None:
        jxs.append(jnp.asarray(residual))
    jws = [jnp.asarray(w) for w in weights]
    jy, vjp, jaux = jax.vjp(jfwd, jxs, jws, has_aux=True)
    g = rng.randn(*jy.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g))

    def leaf(a):
        t = torch.tensor(np.asarray(a))
        if nhwc and t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t.requires_grad_()

    txs = [leaf(x) for x in inputs]
    tres = leaf(residual) if residual is not None else None
    tws = [leaf(w) for w in weights]
    kw = {} if residual is None else {"residual": tres, "relu": relu}
    outs = top.forward(txs, tws + [torch.tensor(s) for s in state],
                       training=training, **kw)
    assert _scaled(outs[0].detach().numpy(), jy) <= FWD_TOL
    for got, want in zip(outs[1:], jaux):
        assert not got.requires_grad
        assert _scaled(got.numpy(), want) <= FWD_TOL
    wrt = txs + ([tres] if tres is not None else []) + tws
    grads = torch.autograd.grad(outs[0], wrt, torch.from_numpy(g),
                                allow_unused=True)
    for got, want in zip(grads, list(jdx) + list(jdw)):
        got = np.zeros(want.shape, np.float32) if got is None else got
        assert _scaled(np.asarray(got), want) <= GRAD_TOL


def _weights(op, rng):
    """Weights for the trainable specs of op (a port op)."""
    nt = op.num_trainable_weights()
    return [(0.3 * rng.randn(*s.shape.logical_shape)).astype(np.float32)
            for s in op.weight_specs[:nt]]


@pytest.mark.parametrize("cin,out,k,stride,pad,groups,bias,act", [
    (6, 8, (3, 3), (2, 2), (1, 1), 1, True, "NONE"),
    (6, 4, (3, 2), (1, 2), (1, 0), 2, False, "NONE"),
    (6, 6, (1, 1), (1, 1), (0, 0), 3, True, "RELU"),
    (3, 8, (7, 7), (2, 2), (3, 3), 1, False, "NONE"),
])
def test_conv2d_matches_reference(cin, out, k, stride, pad, groups, bias,
                                  act):
    jop, top = _ops(lambda P, ff, ts: ff.conv2d(
        ts[0], out, k[0], k[1], stride[0], stride[1], pad[0], pad[1],
        activation=getattr(P.ActiMode, act), groups=groups, use_bias=bias,
        name="conv"), [(2, cin, 9, 8)])
    rng = np.random.RandomState(cin * out + k[1])
    x = rng.randn(2, cin, 9, 8).astype(np.float32)
    _check(jop, top, [x], _weights(top, rng), nhwc=True)


@pytest.mark.parametrize("kind,k,stride,pad", [
    ("max", 3, 2, 1), ("avg", 3, 2, 1), ("max", 2, 2, 0),
    ("avg", 3, 1, 2), ("max", 3, 1, 2), ("avg", 7, 7, 0)])
def test_pool2d_matches_reference(kind, k, stride, pad):
    """Max pool pads with -inf, avg pool divides by the whole window,
    padding included; a padding over half the window takes the explicit
    pad."""
    jop, top = _ops(lambda P, ff, ts: ff.pool2d(
        ts[0], k, k, stride, stride, pad, pad, pool_type=kind,
        name="pool"), [(2, 5, 7, 7)])
    x = np.random.RandomState(k + pad).randn(2, 5, 7, 7).astype(np.float32)
    _check(jop, top, [x], nhwc=True)


def _bn_ops(relu):
    return _ops(lambda P, ff, ts: ff.batch_norm(ts[0], relu=relu,
                                                name="bn"), [(4, 6, 5, 3)])


def _bn_case(seed):
    rng = np.random.RandomState(seed)
    x = (2.0 + 3.0 * rng.randn(4, 6, 5, 3)).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(6)).astype(np.float32)
    beta = (0.3 * rng.randn(6)).astype(np.float32)
    state = [(0.5 * rng.randn(6)).astype(np.float32),
             (0.5 + rng.rand(6)).astype(np.float32)]
    return rng, x, [gamma, beta], state


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_matches_reference(training, relu):
    """The reference's rules: one-pass float32 statistics, biased
    variance, momentum 0.9 on the running statistics (returned as op
    state, outside autograd); in eval mode the running statistics."""
    jop, top = _bn_ops(relu)
    assert top.num_trainable_weights() == 2 and top.has_aux_state
    _, x, ws, state = _bn_case(3)
    _check(jop, top, [x], ws, state, training=training, nhwc=True)


def test_batch_norm_with_fused_residual_matches_the_reference_chain():
    """BatchNorm -> add -> ReLU of the reference against the port's one
    P1 apply with the residual, in training mode."""
    jop, top = _bn_ops(False)
    rng, x, ws, state = _bn_case(4)
    res = rng.randn(*x.shape).astype(np.float32)
    _check(jop, top, [x], ws, state, training=True, nhwc=True,
           residual=res, relu=True)


def test_batch_norm_refuses_nchw_memory():
    _, top = _bn_ops(False)
    _, x, ws, state = _bn_case(5)
    with pytest.raises(ValueError, match="channels_last"):
        top.forward([torch.tensor(x)], [torch.tensor(a) for a in ws + state],
                    training=True)


_POSITIVE = {"log", "sqrt", "rsqrt", "pow"}


@pytest.mark.parametrize("op", [u.name for u in OpUnary])
def test_element_unary_matches_reference(op):
    scalar = {"POW": 1.5, "SCALAR_MULTIPLY": -2.5, "SCALAR_ADD": 0.75,
              "SCALAR_SUB": 1.25, "SCALAR_TRUE_DIV": 4.0}.get(op, 0.0)

    def build(P, ff, ts):
        kind = (JOpUnary if P is J else OpUnary)[op]
        return ff._unary(kind, ts[0], scalar=scalar, name="u")

    jop, top = _ops(build, [(3, 4, 5)])
    x = np.random.RandomState(len(op)).randn(3, 4, 5).astype(np.float32)
    if OpUnary[op].value in _POSITIVE:
        x = np.abs(x) + 0.5
    _check(jop, top, [x])


@pytest.mark.parametrize("op", [b.name for b in OpBinary])
def test_element_binary_matches_reference(op):
    def build(P, ff, ts):
        kind = (JOpBinary if P is J else OpBinary)[op]
        return ff._binary(kind, ts[0], ts[1], name="b")

    jop, top = _ops(build, [(3, 4, 5), (4, 5)])
    rng = np.random.RandomState(len(op))
    a = np.abs(rng.randn(3, 4, 5)).astype(np.float32) + 0.5
    b = rng.randn(4, 5).astype(np.float32)
    _check(jop, top, [a, b])


def test_flat_and_softmax_match_reference():
    x = np.random.RandomState(9).randn(3, 4, 2, 2).astype(np.float32)
    jop, top = _ops(lambda P, ff, ts: ff.flat(ts[0], name="f"),
                    [(3, 4, 2, 2)])
    assert top.outputs[0].shape.logical_shape == (3, 16)
    _check(jop, top, [x])
    for axis in (-1, 1):
        jop, top = _ops(lambda P, ff, ts: ff.softmax(ts[0], axis=axis,
                                                     name="s"), [(3, 7, 2)])
        _check(jop, top, [x.reshape(3, 8, 2)[:, :7].copy()])


# -- the small ResNet through both frontends --------------------------------

class SmallResNet(ResNet50):
    """ResNet50's stem and head around two of the example's Bottlenecks:
    stem 3 -> 8, a downsampling block (8 -> 16, stride 2), an identity
    block."""

    def __init__(self, classes=10):
        nn.Module.__init__(self)
        self.stem = nn.Conv2d(3, 8, 7, 2, 3, bias=False)
        self.bn = nn.BatchNorm2d(8)
        self.pool = nn.MaxPool2d(3, 2, 1)
        self.relu = nn.ReLU()
        self.layers = nn.Sequential(Bottleneck(8, 4, 2), Bottleneck(16, 4, 1))
        self.avg = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(16, classes)


def _trained_module(seed=0):
    """A SmallResNet whose running statistics are not the init's."""
    torch.manual_seed(seed)
    m = SmallResNet()
    m.train()
    with torch.no_grad():
        for _ in range(3):
            m(torch.randn(8, 3, 32, 32))
    return m


def _resnet_pair(module, compute_dtype="float32", batch=4, px=32):
    jf = J.FFModel(J.FFConfig(batch_size=batch, num_devices=1,
                              compute_dtype=compute_dtype))
    tf = T.FFModel(T.FFConfig(batch_size=batch, device="cpu",
                              compute_dtype=compute_dtype))
    pts = []
    for P, ff, Importer in ((J, jf, JaxPyTorchModel), (T, tf, PyTorchModel)):
        x = ff.create_tensor([batch, 3, px, px], name="input")
        pt = Importer(module)
        (out,) = pt.torch_to_ff(ff, [x])
        ff.softmax(out)
        kw = {"devices": jax.devices("cpu")[:1]} if P is J else {}
        ff.compile(optimizer=P.SGDOptimizer(lr=0.1),
                   loss_type=P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   **kw)
        pt.copy_weights(ff)
        pts.append(pt)
    return jf, tf


def _jax_state(jf):
    return {op: {k: np.asarray(v) for k, v in e.items()}
            for op, e in jf._state.items()}


def _assert_trees(got, want, tol, what):
    assert sorted(got) == sorted(want)
    for op, entries in want.items():
        assert sorted(got[op]) == sorted(entries), op
        for k, v in entries.items():
            err = float(np.abs(got[op][k] - np.asarray(v)).max())
            assert err <= tol, f"{what} {op}.{k}: {err} > {tol}"


def _assert_bf16_trees(got, ref16, ref32, what):
    """Each entry of got no farther from the float32 reference than
    BF16_NOISE_FACTOR times the reference's own bfloat16 run, plus
    BF16_NOISE_FLOOR."""
    assert sorted(got) == sorted(ref32)
    for op, entries in ref32.items():
        assert sorted(got[op]) == sorted(entries), op
        for k, v in entries.items():
            v = np.asarray(v)
            err = float(np.abs(got[op][k] - v).max())
            noise = float(np.abs(np.asarray(ref16[op][k]) - v).max())
            tol = BF16_NOISE_FACTOR * noise + BF16_NOISE_FLOOR
            assert err <= tol, f"{what} {op}.{k}: {err} > {tol}"


def _two_steps(ff, x, y):
    """Two SGD steps on the batches x[4:8] and x[8:12]: the losses."""
    return [float(ff.train_step({"input": x[s:s + 4]}, y[s:s + 4])["loss"])
            for s in (4, 8)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_small_resnet_matches_reference(compute_dtype):
    tol = MODEL_TOL[compute_dtype]
    jf, tf = _resnet_pair(_trained_module(), compute_dtype)
    _assert_trees(tf.get_weights(), jf.get_weights(), 0.0, "weights")
    _assert_trees(tf.get_state(), _jax_state(jf), 0.0, "state")
    rng = np.random.RandomState(1)
    x = rng.randn(12, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 12).astype(np.int32)
    # eval mode: the running statistics
    want = np.asarray(jf.forward({"input": x[:4]}))
    got = tf.forward({"input": x[:4]}).numpy()
    assert np.abs(got - want).max() <= tol["out"]
    # training mode: batch statistics, and the running statistics they
    # give, on copies of the state
    jout, jstate, _, _ = jf.executor.run_forward(
        jf._weights, jf._state, {"input": jnp.asarray(x[:4])}, True, None)
    tstate = {op: {k: v.clone() for k, v in e.items()}
              for op, e in tf._state.items()}
    with torch.no_grad():
        tout, _ = tf.executor.run_forward(
            tf._weights, tstate, {"input": torch.from_numpy(x[:4])},
            training=True)
    assert np.abs(tout.numpy() - np.asarray(jout)).max() <= tol["out"]
    _assert_trees({op: {k: v.numpy() for k, v in e.items()}
                   for op, e in tstate.items()},
                  {op: {k: np.asarray(v) for k, v in e.items()}
                   for op, e in jstate.items()}, tol["state"], "state")
    # two SGD steps
    lj, lt = _two_steps(jf, x, y), _two_steps(tf, x, y)
    assert np.abs(np.subtract(lt, lj)).max() <= tol["loss"]
    if compute_dtype == "float32":
        _assert_trees(tf.get_weights(), jf.get_weights(), tol["weights"],
                      "weights")
        _assert_trees(tf.get_state(), _jax_state(jf), tol["state"], "state")
        return
    j32, _ = _resnet_pair(_trained_module(), "float32")
    _two_steps(j32, x, y)
    _assert_bf16_trees(tf.get_weights(), jf.get_weights(), j32.get_weights(),
                       "weights")
    _assert_bf16_trees(tf.get_state(), _jax_state(jf), _jax_state(j32),
                       "state")


def test_running_statistics_stay_out_of_autograd():
    _, tf = _resnet_pair(_trained_module(1))
    before = {op: {k: (v, v.clone()) for k, v in e.items()}
              for op, e in tf._state.items()}
    rng = np.random.RandomState(2)
    for _ in range(2):
        tf.train_step({"input": rng.randn(4, 3, 32, 32).astype(np.float32)},
                      rng.randint(0, 10, 4).astype(np.int32))
    for op, entries in tf._state.items():
        for k, v in entries.items():
            assert v is before[op][k][0]  # updated in place
            assert not v.requires_grad and v.grad_fn is None, f"{op}.{k}"
            assert not torch.equal(v, before[op][k][1]), f"{op}.{k}"


def test_copy_weights_carries_running_statistics_for_eval():
    """Eval-mode output of the port against the torch module itself,
    whose running statistics copy_weights carried over."""
    module = _trained_module(3).eval()
    _, tf = _resnet_pair(module)
    x = np.random.RandomState(3).randn(4, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        want = torch.softmax(module(torch.from_numpy(x)), dim=-1).numpy()
    np.testing.assert_allclose(tf.forward({"input": x}).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("fault,match", [
    ("missing", "missing state bn.running_var"),
    ("extra", "unexpected state bn.bias"),
    ("shape", "state bn.running_var has shape"),
    ("group", "unexpected state group 'rogue'")])
def test_set_state_checks_names_and_shapes(fault, match):
    _, tf = _resnet_pair(_trained_module(4))
    state = tf.get_state()
    if fault == "missing":
        del state["bn"]["running_var"]
    elif fault == "extra":
        state["bn"]["bias"] = np.zeros(8, np.float32)
    elif fault == "shape":
        state["bn"]["running_var"] = np.zeros(9, np.float32)
    else:
        state["rogue"] = {}
    with pytest.raises(ValueError, match=match):
        tf.set_state(state)


def _plan_counts(plans):
    counts = {"res_relu": 0, "relu": 0, "none": 0}
    for p in plans.values():
        counts["res_relu" if p.residual is not None
               else "relu" if p.relu else "none"] += 1
    return counts


def test_small_resnet_plan_and_schedule():
    _, tf = _resnet_pair(_trained_module(5))
    ex = tf.executor
    assert _plan_counts(ex.bn_plans) == {"res_relu": 2, "relu": 5,
                                         "none": 1}
    ran = [op for op, _ in ex.schedule]
    absorbed = {g for p in ex.bn_plans.values() for g in p.absorbed}
    assert len(ran) == len(ex.order) - len(absorbed)
    assert len({op.guid for op in ran}) == len(ran)
    # the downsample block's add: bn3 (first operand) carries the
    # downsample BatchNorm's output as its residual
    add = next(op for op in ex.order if op.name == "add")
    (bn3_plan,) = [p for g, p in ex.bn_plans.items()
                   if p.residual is not None and add.guid in p.absorbed]
    assert bn3_plan.residual == add.inputs[1].guid
    assert add.inputs[1].owner_op.name == "layers_0_down_1"


def _tiny_graph(chain):
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    x = ff.create_tensor([2, 4, 5, 5], name="input")
    c = ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="c")
    b = ff.batch_norm(c, relu=False, name="b")
    chain(ff, x, c, b)
    return ff.layers


@pytest.mark.parametrize("case,want", [
    ("relu_second_consumer", {"res_relu": 0, "relu": 0, "none": 1}),
    ("sink", {"res_relu": 0, "relu": 0, "none": 1}),
    ("second_operand", {"res_relu": 0, "relu": 0, "none": 1}),
    ("add_then_relu", {"res_relu": 1, "relu": 0, "none": 0}),
    ("relu", {"res_relu": 0, "relu": 1, "none": 0}),
])
def test_fusion_plan_rules(case, want):
    """Only a BatchNorm whose only consumer is a ReLU, or an add (as its
    first operand) whose only consumer is a ReLU, is fused; nothing that
    is a sink or has a second consumer."""
    def chain(ff, x, c, b):
        if case == "relu_second_consumer":
            ff.add(b, ff.relu(c, name="r0"), name="a")
            ff.relu(b, name="r")
        elif case == "second_operand":
            ff.relu(ff.add(c, b, name="a"), name="r")
        elif case == "add_then_relu":
            ff.relu(ff.add(b, c, name="a"), name="r")
        elif case == "relu":
            ff.flat(ff.relu(b, name="r"), name="f")

    graph = _tiny_graph(chain)
    plans = plan_bn_applies(graph, assign_layouts(graph)[0])
    assert _plan_counts(plans) == want


def test_resnet50_graph_matches_reference_and_plans_53_applies():
    """The example's ResNet-50 at 224 px, built (not run) through both
    frontends: the same op names, types and output shapes; every conv,
    pool and BatchNorm in channels_last; 53 P1 applies per forward."""
    torch.manual_seed(0)
    module = ResNet50(classes=1000)
    graphs = []
    for P, Importer in ((J, JaxPyTorchModel), (T, PyTorchModel)):
        kw = {"num_devices": 1} if P is J else {"device": "cpu"}
        ff = P.FFModel(P.FFConfig(batch_size=2, **kw))
        x = ff.create_tensor([2, 3, 224, 224], name="input")
        (out,) = Importer(module).torch_to_ff(ff, [x])
        ff.softmax(out)
        graphs.append(ff.layers)
    desc = [{op.name: (op.op_type.value,
                       [o.shape.logical_shape for o in op.outputs])
             for op in g.ops} for g in graphs]
    assert desc[0] == desc[1] and len(desc[1]) > 170
    t_layout, op_layout = assign_layouts(graphs[1])
    for op in graphs[1].ops:
        prefer = op.op_type.value in ("conv2d", "pool2d", "batch_norm")
        assert (op_layout.get(op.guid) == NHWC) == prefer, op.name
    flat = next(op for op in graphs[1].ops if op.op_type.value == "flat")
    assert flat.guid not in op_layout
    plans = plan_bn_applies(graphs[1], t_layout)
    assert len(plans) == 53
    assert _plan_counts(plans) == {"res_relu": 16, "relu": 33, "none": 4}


@pytest.mark.parametrize("module,what", [
    (nn.Sequential(nn.Linear(4, 4), nn.Dropout(0.1)), "Dropout"),
    (nn.Sequential(nn.Flatten(0, -1)), "Reshape"),
])
def test_frontend_names_the_roadmap_item_for_missing_ops(module, what):
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    x = ff.create_tensor([2, 4], name="input")
    with pytest.raises(NotImplementedError, match=what) as info:
        PyTorchModel(module).torch_to_ff(ff, [x])
    assert "ROADMAP.md §1.B.2" in str(info.value)


class _Cat(nn.Module):
    def forward(self, x):
        return torch.cat([x, x.view(2, 4)], dim=1)


def test_frontend_raises_for_functions_and_methods_it_lacks():
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu"))
    x = ff.create_tensor([2, 4], name="input")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PyTorchModel(_Cat()).torch_to_ff(ff, [x])
