"""Spawned torch.distributed groups for the port's multi-rank tests.

`run_group(fn, world, *args)` starts `world` processes on the CPU, joins
them into one `gloo` group through flexflow_tpu_torch.distributed, runs
`fn(rank, world, *args)` in each and returns what each rank returned.
The ranks meet through a file store in the group's own temporary
directory, so two groups started at the same moment (by two test
workers) cannot take each other's rendezvous, as two TCP stores on one
free port could.
The ranks import torch and the port only (the builders below import
flexflow_tpu only when the test process hands them the reference's
FFModel), and run one thread each.  Every group has its own time limit: a
rank that outlives it is killed and the call raises.

The rank functions of the tests live here too, so that a spawned
process can import them without importing a test module (which would
import jax).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
import weakref


def _rank_main(rank, world, store, fn, args, out_dir):
    import torch

    torch.set_num_threads(1)
    from flexflow_tpu_torch import distributed

    result = None
    try:
        distributed.initialize(f"file://{store}", world, rank,
                               device="cpu")
        result = ("ok", fn(rank, world, *args))
    except Exception:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    if dist.is_initialized() and result[0] == "ok":
        dist.destroy_process_group()


def run_group(fn, world: int, *args, timeout: float = 150.0):
    """[fn(rank, world, *args) for each rank], run in `world` spawned
    processes of one gloo group; raises with the first rank's traceback
    when a rank fails, and kills every rank when the group outlives
    `timeout` seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        store = os.path.join(out_dir, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store, fn, args, out_dir),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r in range(world):
            path = os.path.join(out_dir, f"{r}.pkl")
            if not os.path.exists(path):
                results.append(("error", f"rank {r} wrote no result "
                                f"(exit code {procs[r].exitcode})"))
                continue
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still ran after "
                           f"{timeout} s and were killed")
    for r, (status, value) in enumerate(results):
        if status != "ok":
            raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
    return [value for _, value in results]


# -- rank functions --------------------------------------------------------

def train_steps(rank, world, build, strategy, weights, batches, opt,
                loss_type="sparse_categorical_crossentropy", cfg=None,
                state=None, fit_last=False):
    """Compile `build(ff)` under `strategy`, load `weights` (and op
    `state`), run one train_step per (inputs, labels) in `batches` (the
    last through fit, whose loader cuts each rank's shard, when
    `fit_last`); return the losses, the gathered weights and state, and
    an eval_step's loss on the first batch after them."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(FFConfig(device="cpu", **(cfg or {})))
    build(ff)
    ff.compile(optimizer=opt(), loss_type=loss_type, strategy=strategy,
               seed=0)
    if weights is not None:
        ff.set_weights(weights)
    if state is not None:
        ff.set_state(state)
    losses = []
    for i, (inputs, labels) in enumerate(batches):
        if fit_last and i == len(batches) - 1:
            step = ff.train_step

            def recording(*a):
                m = step(*a)
                losses.append(float(m["loss"]))
                return m

            ff.train_step = recording
            ff.fit(inputs, labels, batch_size=len(labels), epochs=1,
                   verbose=False)
            del ff.train_step
        else:
            losses.append(float(ff.train_step(inputs, labels)["loss"]))
    return {"losses": losses, "weights": ff.get_weights(),
            "state": ff.get_state(), "rank": rank,
            "eval_loss": float(ff.eval_step(*batches[0])["loss"]),
            "zero_stage": ff.executor.zero_stage,
            "fallback": ff.executor.zero_fallback_leaves(),
            "opt_bytes": ff.executor.opt_state_bytes(ff._opt_state)}


def forward(rank, world, build, strategy, weights, inputs):
    """Compile under `strategy`, load `weights`, one forward."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(FFConfig(device="cpu"))
    build(ff)
    ff.compile(strategy=strategy, seed=0)
    ff.set_weights(weights)
    return ff.forward(inputs).numpy()


def run_cases(rank, world, cases):
    """Several (function, args[, kwargs]) cases in one group, in
    order."""
    return [c[0](rank, world, *c[1], **(c[2] if len(c) > 2 else {}))
            for c in cases]


def placements(rank, world, build, strategy):
    """{tensor name: its view's spec} of the compiled graph."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.parallel.machine import view_to_spec

    ff = FFModel(FFConfig(device="cpu"))
    build(ff)
    ff.compile(strategy=strategy, seed=0)
    return {pt.name: view_to_spec(pt) for op in ff.operators.ops
            for pt in list(op.outputs) + list(op.weights)}


# -- model builders (called with either package's FFModel) --------------------

def mlp_tp(ff):
    """tests/test_parallelism.py's MLP: fc1 column parallel, fc2 row
    parallel under tp_strategy."""
    relu = _relu(ff)
    x = ff.create_tensor([16, 32], name="x")
    t = ff.dense(x, 64, activation=relu, name="fc1")
    t = ff.dense(t, 64, activation=relu, name="fc2")
    ff.dense(t, 4, name="fc3")


def attention_heads(ff):
    x = ff.create_tensor([4, 16, 32], name="x")
    t = ff.multihead_attention(x, x, x, 32, 8, name="attn")
    ff.dense(t, 8, name="out")


def embedding_attribute(ff):
    ids = ff.create_tensor([16, 8], dtype="int32", name="ids")
    t = ff.embedding(ids, 100, 32, name="emb")
    ff.dense(t, 4, name="head")


def mlp_zero(ff, hidden=64):
    """tests/test_zero_ladder.py's MLP: a 7-wide head whose bias no axis
    of 8 divides (with hidden=0: the head alone)."""
    x = ff.create_tensor([16, 32], name="x")
    t = x
    if hidden:
        t = ff.dense(x, hidden, activation=_relu(ff), name="fc")
    t = ff.dense(t, 7, name="head")
    ff.softmax(t)


def cnn_bn(ff, batch=16):
    """Two conv + BatchNorm blocks (the second with a residual add and
    a ReLU after it), a pool and a dense head."""
    x = ff.create_tensor([batch, 3, 8, 8], name="x")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="conv1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    u = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1, name="conv2")
    u = ff.batch_norm(u, relu=False, name="bn2")
    t = ff.relu(ff.add(u, t, name="res"), name="res_relu")
    t = ff.pool2d(t, 2, 2, 2, 2, name="pool")
    t = ff.flat(t, name="flat")
    ff.dense(t, 4, name="head")


def _relu(ff):
    if type(ff).__module__.startswith("flexflow_tpu_torch"):
        from flexflow_tpu_torch.fftype import ActiMode
    else:
        from flexflow_tpu.fftype import ActiMode
    return ActiMode.RELU


def ring_case(rank, world, q, k, v, impl, causal, scale):
    """The flash or the dense ring (`impl`) over a `seq` axis of the
    whole group on this rank's sequence shard of global q, k, v [b, s,
    h, d]: the local output and the local grads of the sum of its
    squares."""
    import torch

    from flexflow_tpu_torch.parallel import ring_attention as ra
    from flexflow_tpu_torch.parallel.machine import make_mesh

    mesh = make_mesh({"seq": world}, "cpu")
    n = q.shape[1] // world
    sl = slice(rank * n, (rank + 1) * n)
    qt, kt, vt = (torch.tensor(a[:, sl], requires_grad=True)
                  for a in (q, k, v))
    ring = {"flash": ra._ring_flash, "dense": ra._ring_dense}[impl]
    o = ring(qt, kt, vt, mesh, "seq", scale, causal)
    (o.float() ** 2).sum().backward()
    return (o.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(),
            vt.grad.numpy())


def fit_run(rank, world, build, strategy, weights, x, y, opt, cfg, epochs,
            batch):
    """Compile under `strategy` with FFConfig(**cfg), load `weights`, fit
    (each rank loads its shard of every batch); the per-epoch summed
    sparse cross-entropy, the weights after and the ladder's
    bookkeeping."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(FFConfig(device="cpu", batch_size=batch, **cfg))
    build(ff)
    ff.compile(optimizer=opt(), strategy=strategy, seed=0,
               metrics=["accuracy", "sparse_categorical_crossentropy"])
    ff.set_weights(weights)
    hist = ff.fit(x, y, epochs=epochs, verbose=False)
    return {"losses": [pm.sparse_cce_loss for pm in hist],
            "weights": ff.get_weights(),
            "fallback": ff.executor.zero_fallback_leaves(),
            "zero_stage": ff.executor.zero_stage,
            "opt_bytes": ff.executor.opt_state_bytes(ff._opt_state)}


def redistribute_cases(rank, world, axis_sizes, x, g, cases):
    """For each (src, dst) pair of (spec, partial axes): this rank's
    `src` shard of the global x (a partial one weighted by the rank's
    coordinates on the partial axes, so that the shards sum to x),
    redistributed to `dst`, and the grad of the input when the output's
    grad stands for g in dst's adjoint layout (weighted the same way
    over the axes dst replicates, whole over those it sums)."""
    import torch

    from flexflow_tpu_torch.parallel.collectives import (Layout,
                                                         local_slice,
                                                         redistribute)
    from flexflow_tpu_torch.parallel.machine import make_mesh

    mesh = make_mesh(axis_sizes, "cpu")

    def weight(axes):
        w = 1.0
        for a in axes:
            n, c = mesh.size(a), mesh.coord(a)
            w *= (1 + c) / (n * (n + 1) / 2)
        return w

    out = []
    for (s_spec, s_part), (d_spec, d_part) in cases:
        src, dst = Layout(s_spec, frozenset(s_part)), Layout(d_spec,
                                                             frozenset(d_part))
        loc = torch.tensor(local_slice(x, src, mesh) * weight(s_part),
                           requires_grad=True)
        y = redistribute(loc, src, dst, mesh)
        d_rep = [a for a in mesh.names
                 if a not in dst.axes() and a not in d_part]
        y.backward(torch.tensor(local_slice(g, Layout(d_spec), mesh)
                                * weight(d_rep)))
        out.append((y.detach().numpy(), loc.grad.numpy(),
                    dict(mesh.coords)))
    return out


# -- pipelines ---------------------------------------------------------------

def tanh_block(p, x):
    """tests/test_pipeline.py's block."""
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def _pipe_mesh(dp, pp):
    from flexflow_tpu_torch.parallel.machine import make_mesh

    return make_mesh({"data": dp, "pp": pp}, "cpu")


def _data_rows(a, mesh, dp):
    n = a.shape[0] // dp
    c = mesh.coord("data")
    return a[c * n:(c + 1) * n]


def pipelined_case(rank, world, dp, pp, mb, params, x, grads=False):
    """pipelined_apply of tanh_block over a data x pp mesh on this rank's
    blocks and rows of the global params and x: (data coordinate, pp
    coordinate, local output) and, with grads, the local blocks' grads of
    the global output's sum, summed over the data axis."""
    import torch

    from flexflow_tpu_torch.parallel.collectives import all_reduce_
    from flexflow_tpu_torch.parallel.pipeline import (local_blocks,
                                                      pipelined_apply)

    mesh = _pipe_mesh(dp, pp)
    local = {k: v.requires_grad_(grads) for k, v in local_blocks(
        {k: torch.tensor(v) for k, v in params.items()}, mesh).items()}
    xl = torch.tensor(_data_rows(x, mesh, dp))
    y = pipelined_apply(tanh_block, local, xl, mesh=mesh,
                        num_microbatches=mb)
    out = [mesh.coord("data"), mesh.coord("pp"), y.detach().numpy()]
    if grads:
        # the pp ranks hold the same rows: the seed 1/pp per rank adds up
        # to the global sum's cotangent through the group's all-reduce
        g = torch.autograd.grad(y.sum() / pp, list(local.values()))
        for t in g:
            if dp > 1:
                all_reduce_(t, mesh.group("data"))
        out.append({k: t.numpy() for k, t in zip(local, g)})
    return out


def transformer_case(rank, world, dp, pp, kw, params, x, y, steps,
                     schedule, remat=False, count_saved=False):
    """make_pipelined_transformer_step over a data x pp mesh from the
    global `params` (the reference's init_fn's, as numpy), `steps` steps
    on this rank's rows of x and y: the losses and the global params
    after them; with count_saved, the peak bytes of the tensors autograd
    saved at any one time during the steps."""
    import torch

    from flexflow_tpu_torch.parallel.collectives import all_gather
    from flexflow_tpu_torch.parallel.pipeline import (
        local_params, make_pipelined_transformer_step)

    mesh = _pipe_mesh(dp, pp)
    _, step = make_pipelined_transformer_step(mesh, schedule=schedule,
                                              remat=remat, **kw)
    p = local_params({"blocks": {k: torch.tensor(v) for k, v in
                                 params["blocks"].items()},
                      "head": {"head": torch.tensor(params["head"])}},
                     mesh)
    xl = torch.tensor(_data_rows(x, mesh, dp))
    yl = torch.tensor(_data_rows(y, mesh, dp))
    live, peak = [0], [0]

    class Saved:
        """A saved tensor, counted while autograd holds it."""

        def __init__(self, t):
            self.t, self.n = t, t.numel() * t.element_size()
            live[0] += self.n
            peak[0] = max(peak[0], live[0])

        def __del__(self):
            live[0] -= self.n

    losses = []
    for _ in range(steps):
        if count_saved:
            with torch.autograd.graph.saved_tensors_hooks(
                    Saved, lambda s: s.t):
                p, loss = step(p, xl, yl)
        else:
            p, loss = step(p, xl, yl)
        losses.append(float(loss))
    blocks = {k: all_gather(v, 0, pp, mesh.group("pp")).numpy()
              if pp > 1 else v.numpy() for k, v in p["blocks"].items()}
    return {"losses": losses, "blocks": blocks,
            "head": p["head"]["head"].numpy(), "saved_peak": peak[0]}


# -- expert parallelism ------------------------------------------------------

def balance_losses(rank, world, build, strategy, weights, inputs):
    """Compile under `strategy`, load `weights`, one training forward of
    the global `inputs`: each Aggregate's balance loss, in graph order,
    and the MoE ops' collective bytes by (op class, kind)."""
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.parallel import collectives

    ff = FFModel(FFConfig(device="cpu"))
    build(ff)
    ff.compile(strategy=strategy, seed=0)
    ff.set_weights(weights)
    collectives.traffic.clear()
    aux = []
    with torch.no_grad():
        ff.executor.run_forward(ff._weights, ff._state,
                                {k: torch.tensor(v) for k, v in
                                 inputs.items()},
                                training=True, aux_losses=aux)
    return {"aux": [float(a) for a in aux],
            "traffic": dict(collectives.traffic)}


def exchange_rank(rank, world, cases):
    """cases[rank]'s function on this rank."""
    fn, args = cases[rank]
    return fn(rank, world, *args)


def exchange_case(rank, world, rows, send, recv):
    """collectives.exchange over a `t` axis of the whole group: this
    rank's `rows` (send[j] to rank j), what arrives, and the grad of the
    rows when each received row's grad is its value times the receiver's
    rank + 1."""
    import torch

    from flexflow_tpu_torch.parallel.collectives import exchange
    from flexflow_tpu_torch.parallel.machine import make_mesh

    mesh = make_mesh({"t": world}, "cpu")
    x = torch.tensor(rows, requires_grad=True)
    got = exchange(x, mesh, "t", send, recv)
    (got * got.detach() * (rank + 1)).sum().backward()
    return got.detach().numpy(), x.grad.numpy()


def moe_mlp(ff, batch=16, num_exp=4, alpha=2.0, **kw):
    """tests/test_parallelism.py-sized MoE MLP with either package's
    FFModel (its moe builder)."""
    mod = ("flexflow_tpu_torch.models.moe"
           if type(ff).__module__.startswith("flexflow_tpu_torch")
           else "flexflow_tpu.models.moe")
    import importlib

    importlib.import_module(mod).build_moe_mlp(
        ff, batch_size=batch, input_dim=16, num_classes=4, num_exp=num_exp,
        num_select=2, hidden_size=16, alpha=alpha, **kw)


def moe_encoder(ff, batch=8, layers=2, num_exp=4, alpha=2.0):
    """A tiny MoE encoder (seq 8, hidden 16) with either package's
    FFModel."""
    mod = ("flexflow_tpu_torch.models.moe"
           if type(ff).__module__.startswith("flexflow_tpu_torch")
           else "flexflow_tpu.models.moe")
    import importlib

    importlib.import_module(mod).build_moe_encoder(
        ff, batch_size=batch, seq_length=8, hidden_size=16,
        num_layers=layers, num_heads=2, num_exp=num_exp, alpha=alpha,
        num_classes=4)


def moe_spec(ff, num_exp=4):
    """The MoE MLP through AggregateSpec (each sample's k predictions)."""
    x = ff.create_tensor([16, 16], name="input")
    gate = ff.dense(x, num_exp, name="gate")
    gate_sm = ff.softmax(gate, name="gate_sm")
    values, assign = ff.top_k(gate_sm, 2, name="topk")
    grouped = ff.group_by(x, assign, num_exp, 2.0, name="group_by_0")
    hidden = ff.experts_dense(grouped, 4, activation=_relu(ff),
                              name="experts_dense_0")
    out = ff.aggregate_spec(values, assign, gate_sm, hidden, num_exp, 0.04,
                            name="agg")
    ff.softmax(out, name="softmax")


# -- factored per-op views and the slice hierarchy ----------------------------

def mixed_mlp(ff, batch=8, width=16, a=32, b=64):
    """tests/test_per_op_views.py's MLP (batch 8, 16 -> 32 -> 64 -> 4;
    with width 32, a 64 and b 128: __graft_entry__.py's dry-run
    per-op-views model)."""
    relu = _relu(ff)
    x = ff.create_tensor([batch, width], name="x")
    t = ff.dense(x, a, activation=relu, name="fa")
    t = ff.dense(t, b, activation=relu, name="fb")
    t = ff.dense(t, 4, name="head")
    ff.softmax(t)


def mixed_strategy(cls, shard):
    """fa at channel 2, fb at channel 4 over {data: 2, model0: 2,
    model1: 2}, each output combined (test_per_op_views.py:37)."""
    s = cls(mesh_axes={"data": 2, "model0": 2, "model1": 2})
    s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": 2})]
    s.shard_configs["fa"] = shard(channel=2)
    s.edge_ops["fa.out0"] = [("combine", {"dim": 1, "degree": 2})]
    s.shard_configs["fb"] = shard(channel=4)
    s.edge_ops["fb.out0"] = [("combine", {"dim": 1, "degree": 4})]
    return s


def bert_factored(cls, shard, layers, attn=4, ffn1=2):
    """A BERT strategy over {model0: 2, model1: 2}: every attention at
    channel `attn` and every first FFN at channel `ffn1`."""
    s = cls(mesh_axes={"model0": 2, "model1": 2})
    for i in range(layers):
        s.shard_configs[f"attn_{i}"] = shard(channel=attn)
        s.shard_configs[f"ffn1_{i}"] = shard(channel=ffn1)
    return s


def slice_mlp(ff):
    """tests/test_topology.py's _fit_model graph: [16, 32] -> 64 ReLU
    -> 8 -> softmax."""
    x = ff.create_tensor([16, 32], name="x")
    t = ff.dense(x, 64, activation=_relu(ff))
    t = ff.dense(t, 8)
    ff.softmax(t)


def slice_fit(rank, world, strategy, weights, x, y, cfg, flat=False):
    """slice_mlp compiled under `strategy` with FFConfig(batch_size=16,
    **cfg), SGD at lr 0.05, `weights` loaded (None: the seed's), fit
    for 2 epochs; with `flat` the hierarchical reduction is switched
    off on the same mesh.  The mesh, hier_axis, wus_axis, the strategy's
    mesh axes, the weights after and the update's collective bytes."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.optimizer import SGDOptimizer
    from flexflow_tpu_torch.parallel import collectives

    ff = FFModel(FFConfig(device="cpu", batch_size=16, **cfg))
    slice_mlp(ff)
    ff.compile(optimizer=SGDOptimizer(lr=0.05), strategy=strategy, seed=0)
    ex = ff.executor
    hier = ex.hier_axis
    if flat:
        ex.hier_axis = None
    if weights is not None:
        ff.set_weights(weights)
    collectives.traffic.clear()
    ff.fit(x, y, epochs=2, verbose=False)
    return {"mesh": dict(ex.mesh.axis_sizes), "hier_axis": hier,
            "wus_axis": ex.wus_axis, "zero_stage": ex.zero_stage,
            "strategy_mesh": dict(ff.strategy.mesh_axes),
            "weights": ff.get_weights(),
            "update_bytes": {k: v for (scope, k), v in
                             collectives.traffic.items()
                             if scope == "update"}}


def compile_error(rank, world, build, strategy):
    """The NotImplementedError compile raises for `strategy` (its
    message), or None."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(FFConfig(device="cpu"))
    build(ff)
    try:
        ff.compile(strategy=strategy, seed=0)
    except NotImplementedError as e:
        return str(e)
    return None


# -- the captured step and the rest of the ZeRO ladder ------------------------

def capture_plan(rank, world, build, strategy, capture=True):
    """Compile `build(ff)` under `strategy` on the CPU (the step built
    again with capture off unless `capture`): what capture_blockers
    finds in the plan, and the executor's capture_status."""
    from flexflow_tpu_torch.capture import capture_blockers
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(FFConfig(device="cpu"))
    build(ff)
    ff.compile(strategy=strategy, seed=0)
    if not capture:
        ff.executor.build_step(capture=False)
    return {"blockers": capture_blockers(ff.executor),
            "status": dict(ff.executor.capture_status)}


def _storage_bytes() -> int:
    """Bytes of the distinct storages of every tensor the collector
    sees."""
    import gc

    import torch

    gc.collect()
    out = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor):
            st = o.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
    return sum(out.values())


def zero_grad_bytes(rank, world, build, strategy, weights, x, y, opt,
                    stage):
    """One train_step at ZeRO `stage` from `weights`: the executor's
    grad_bytes (stage 2's ScatterBuckets count) and the model's full
    grad bytes, the weights left holding a .grad, the loss and the
    fallback leaves.  `held_bytes`: the bytes of the tensor storages
    alive at the update's entry (once the backward has ended) less
    those alive before the step, found by a walk over the collector's
    objects, not counted from shapes."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(FFConfig(device="cpu", zero_stage=stage))
    build(ff)
    ff.compile(optimizer=opt(), strategy=strategy, seed=0)
    ff.set_weights(weights)
    ex, held = ff.executor, []
    sync = ex._sync_and_update

    def reading(*a, **k):
        # gloo's worker thread lets go of a finished collective's tensor
        # a moment after the caller's wait returns: read until three
        # readings 20 ms apart agree
        seen = [_storage_bytes()]
        while len(seen) < 3 or len(set(seen[-3:])) > 1:
            time.sleep(0.02)
            seen.append(_storage_bytes())
        held.append(seen[-1] - base)
        return sync(*a, **k)

    ex._sync_and_update = reading
    base = _storage_bytes()
    loss = float(ff.train_step({"x": x}, y)["loss"])
    del ex._sync_and_update
    return {"grad_bytes": dict(ff.executor.grad_bytes), "loss": loss,
            "held_bytes": held[0],
            "full_grad_bytes": ff.executor.full_grad_bytes(ff._weights),
            "with_grad": [f"{op}.{k}" for op, e in ff._weights.items()
                          for k, w in e.items() if w.grad is not None],
            "fallback": ff.executor.zero_fallback_leaves(),
            "shards": sorted(
                f"{op}.{k}" for op, e in ff._weights.items() for k in e
                if ff.executor._sharded_update((op, k)))}


def zero3_prefetch(rank, world, build, strategy, weights, batches, opt,
                   remat=False):
    """ZeRO stage 3 from `weights` over `batches` (one train_step each),
    with every issued gather of a scattered weight and every op's run
    logged in order, and the asynchronous all-gathers counted; with
    `remat`, under FFConfig.remat (the inline gathers).  Then one
    eval_step on the first batch: at each op's run, the weights whose
    issued gather is still alive (its finisher, which holds the
    gathered tensor, not yet freed)."""
    from flexflow_tpu_torch import executor as E
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.parallel import collectives as C

    log, calls = [], [0]
    gather, run, gather_async = (E.GraphExecutor._z3_gather,
                                 E.GraphExecutor._exec, C.all_gather_async)

    issued, live_at = [], {}

    def logged_gather(self, key, w):
        log.append(("gather", ".".join(key)))
        finish = gather(self, key, w)
        issued.append((".".join(key), weakref.ref(finish)))
        return finish

    def logged_run(self, op, *a):
        log.append(("run", op.name))
        live_at[op.name] = sorted(k for k, r in issued if r() is not None)
        return run(self, op, *a)

    def counted(*a, **k):
        calls[0] += 1
        return gather_async(*a, **k)

    E.GraphExecutor._z3_gather = logged_gather
    E.GraphExecutor._exec = logged_run
    C.all_gather_async = counted
    try:
        ff = FFModel(FFConfig(device="cpu", zero_stage=3, remat=remat))
        build(ff)
        ff.compile(optimizer=opt(), strategy=strategy, seed=0)
        ff.set_weights(weights)
        losses, steps = [], []
        for inputs, labels in batches:
            del log[:]
            calls[0] = 0
            losses.append(float(ff.train_step(inputs, labels)["loss"]))
            steps.append({"log": list(log), "async_gathers": calls[0]})
        del issued[:]
        live_at.clear()
        ff.eval_step(*batches[0])
        eval_live = dict(live_at)
    finally:
        E.GraphExecutor._z3_gather = gather
        E.GraphExecutor._exec = run
        C.all_gather_async = gather_async
    return {"losses": losses, "steps": steps, "weights": ff.get_weights(),
            "eval_live": eval_live,
            "scattered": sorted(".".join(k) for k in ff.executor._z3),
            "remat_plan": ff.executor._remat_plan is not None}


def mlp3_zero(ff):
    """Three dense layers (64 wide, ReLU) and an 8-way head, every weight
    divisible by 8: the stage-3 prefetch's order over three ops."""
    x = ff.create_tensor([16, 32], name="x")
    t = ff.dense(x, 64, activation=_relu(ff), name="fc1")
    t = ff.dense(t, 64, activation=_relu(ff), name="fc2")
    t = ff.dense(t, 8, name="head")
    ff.softmax(t)


# -- checkpoints ----------------------------------------------------------------

def blocks(ff, batch=16, width=8, layers=4, classes=4):
    """tests/test_durability.py's MLP of identical dense blocks and a
    head: the repeated-block graph a pipeline stacks."""
    x = ff.create_tensor([batch, width], name="x")
    t = x
    for i in range(layers):
        t = ff.dense(t, width, activation=_relu(ff), name=f"blk{i}")
    t = ff.dense(t, classes, name="head")
    ff.softmax(t)


def _global_state(ff):
    """{leaf key: global array} of the train state (the checkpoint's own
    snapshot): on rank 0; {} on the others."""
    from flexflow_tpu_torch.checkpoint import _Snapshot

    return _Snapshot(ff, own=True).arrays()


def ckpt_case(rank, world, build, strategy, opt, batches, cfg=None,
              weights=None, restore=None, save_at=None, dirs=None):
    """Compile `build` under `strategy` (FFConfig fields `cfg`), then load
    `weights`, or restore from `restore` = (manager kind, directory)
    ("local": LocalCheckpointManager, "dcp": CheckpointManager); run one
    train step per batch, after `save_at` of them saving into every
    (kind, directory) of `dirs`.  Returns the global train state after
    the restore, at the save and at the end (rank 0's), the losses and
    the parallel/zero_fallback_leaves counter."""
    from flexflow_tpu_torch.checkpoint import (CheckpointManager,
                                               LocalCheckpointManager)
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    kinds = {"local": LocalCheckpointManager, "dcp": CheckpointManager}
    ff = FFModel(FFConfig(device="cpu", **(cfg or {})))
    build(ff)
    ff.compile(optimizer=opt(), strategy=strategy, seed=0)
    out = {"rank": rank, "losses": [], "saved": None,
           "fallback": ff.telemetry.metrics.counter(
               "parallel/zero_fallback_leaves").value}
    if weights is not None:
        ff.set_weights(weights)
    if restore is not None:
        kind, path = restore
        out["restored_step"] = kinds[kind](path).restore(ff)
    out["restored"] = _global_state(ff)
    for i, (inputs, labels) in enumerate(batches):
        if i == save_at:
            for kind, path in (dirs or {}).items():
                kinds[kind](path).save(ff, i)
            out["saved"] = _global_state(ff)
        out["losses"].append(float(ff.train_step(inputs, labels)["loss"]))
    if save_at == len(batches):
        for kind, path in (dirs or {}).items():
            kinds[kind](path).save(ff, save_at)
        out["saved"] = _global_state(ff)
    out["final"] = _global_state(ff)
    return out


# -- the supervisor (tests/test_torch_supervisor.py) ------------------------

def sup_mlp(ff, batch=16):
    """tests/test_resilience.py's MLP: 8 -> 32 (ReLU) -> 4, softmax."""
    x = ff.create_tensor([batch, 8], name="x")
    t = ff.dense(x, 32, activation=_relu(ff))
    t = ff.dense(t, 4)
    ff.softmax(t)


def _sup_model(weights, opt, **cfg):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel

    ff = FFModel(FFConfig(device="cpu", batch_size=16, **cfg))
    sup_mlp(ff)
    ff.compile(optimizer=opt(), loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], seed=0)
    ff.set_weights(weights)
    return ff


def _signal_at(plan, step):
    """SIGTERM raised in this process when the supervisor checks `step`
    (delivered at once, in the main thread: during that step)."""
    import signal

    check = plan.check_step

    def at(s):
        if s == step:
            signal.raise_signal(signal.SIGTERM)
        check(s)

    plan.check_step = at
    return plan


def _report(rep):
    return {"final_step": rep.final_step, "losses": rep.losses,
            "counters": rep.counters, "preempted": rep.preempted,
            "left_group": rep.left_group, "recoveries": rep.recoveries,
            "agreed_step": rep.agreed_step}


def supervisor_group(rank, world, root, weights, x, y, sgd, adam,
                     loss_plan):
    """The supervisor on a group of 4 ranks, over the directory `root`:
      1. data 4, ZeRO-1 under Adam, async saves, every rank signalled
         (SIGTERM) during step 3: the emergency save;
      2. ranks 0-2 signalled during step 2, rank 3 during step 3, the
         barrier over the remote tier (root/remote_b);
      3. the device loss of `loss_plan` (4 -> 2 survivors), the strategies
         from the store at root/store (which the test seeded), the remote
         tier at root/remote: ranks 2-3 leave, ranks 0-1 go on as a group
         of 2;
      4. on the 2 survivors: case 1's emergency save restored at ZeRO-1.
    Each case's report, the final weights (gathered) and, for the
    restores, the full state (rank 0's)."""
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.checkpoint import LocalCheckpointManager
    from flexflow_tpu_torch.resilience import (FaultPlan,
                                               TrainingSupervisor)

    out = {"rank": rank}
    no_sleep = lambda s: None  # noqa: E731
    ff = _sup_model(weights, adam, zero_stage=1, checkpoint_async=True)
    rep = TrainingSupervisor(
        ff, f"{root}/z", checkpoint_every=100,
        fault_plan=_signal_at(FaultPlan(), 3), sleep=no_sleep).run(x, y, 8)
    out["zero1"] = dict(_report(rep), weights=ff.get_weights(),
                        state=_global_state(ff))

    ff = _sup_model(weights, sgd, remote_store=f"file://{root}/remote_b")
    rep = TrainingSupervisor(
        ff, f"{root}/b", checkpoint_every=100,
        fault_plan=_signal_at(FaultPlan(), 2 if rank < 3 else 3),
        run_id="barrier", sleep=no_sleep).run(x, y, 8)
    out["barrier"] = dict(_report(rep), latest=LocalCheckpointManager(
        f"{root}/b").latest_verified_step())

    ff = _sup_model(weights, sgd, strategy_store=f"{root}/store",
                    search_budget=8, remote_store=f"file://{root}/remote")
    sup = TrainingSupervisor(ff, f"{root}/loss", checkpoint_every=2,
                             fault_plan=FaultPlan.from_json(loss_plan),
                             run_id="loss", sleep=no_sleep)
    rep = sup.run(x, y, 6)
    out["loss"] = _report(rep)
    if rep.left_group:
        return out
    out["loss"].update(
        weights=ff.get_weights(), world=distributed.world_size(),
        rank_after=distributed.rank(),
        devices=ff.strategy.total_devices,
        store_hit=ff.strategy.search_stats.get("store_hit"),
        strategy=ff.strategy.to_json())
    assert sup.manager.restore(ff, step=4) == 4
    out["loss"]["weights_at_4"] = ff.get_weights()

    ff = _sup_model(weights, adam, zero_stage=1)
    out["zero1_restored"] = {
        "step": LocalCheckpointManager(f"{root}/z").restore(ff),
        "zero_stage": ff.executor.zero_stage, "state": _global_state(ff)}
    return out


def bn_net(ff, batch=16):
    """tests/test_recompile.py's BatchNorm net: [16, 4, 4, 4] -> BN (ReLU)
    -> flat -> dense 4 -> softmax."""
    x = ff.create_tensor([batch, 4, 4, 4], name="x")
    t = ff.batch_norm(x, relu=True)
    t = ff.flat(t)
    t = ff.dense(t, 4)
    ff.softmax(t)


def recompile_group(rank, world, mlp_weights, x, y, bn_weights, bn_state,
                    xb, yb):
    """FFModel.recompile across re-formed groups (tests/
    test_torch_recompile.py):
      1. the MLP on 4 ranks: fit one epoch, a forward, recompile onto
         data 2 on ranks 0-1 (ranks 2-3 leave), the same forward, two
         more epochs;
      2. on those 2 ranks, the BatchNorm net: fit two epochs, then
         recompile onto rank 0 alone; the op state and the generator's
         state before and after (rank 0's)."""
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.optimizer import SGDOptimizer
    from flexflow_tpu_torch.strategy import data_parallel_strategy

    def model(build, weights, lr):
        ff = FFModel(FFConfig(device="cpu", batch_size=16))
        build(ff)
        ff.compile(optimizer=SGDOptimizer(lr=lr),
                   loss_type="sparse_categorical_crossentropy",
                   metrics=["sparse_categorical_crossentropy"], seed=0)
        ff.set_weights(weights)
        return ff

    out = {"rank": rank}
    ff = model(sup_mlp, mlp_weights, 0.05)
    ff.fit(x, y, epochs=1, verbose=False)
    before = ff.forward({"x": x[:16]}).numpy()
    stayed = ff.recompile(strategy=data_parallel_strategy(2), devices=[0, 1])
    out["stayed"] = stayed
    if not stayed:
        out["compiled"] = ff.executor is not None
        return out
    out["world"] = distributed.world_size()
    out["forward"] = (before, ff.forward({"x": x[:16]}).numpy())
    ff.fit(x, y, epochs=2, verbose=False)
    out["weights"] = ff.get_weights()

    ff = model(bn_net, bn_weights, 0.01)
    ff.set_state(bn_state)
    ff.fit(xb, yb, epochs=2, verbose=False)
    state, rng = ff.get_state(), ff._generator.get_state().clone()
    stayed = ff.recompile(strategy=data_parallel_strategy(1), devices=[0])
    if stayed:
        out["bn"] = {"world": distributed.world_size(), "before": state,
                     "after": ff.get_state(),
                     "rng": bool((ff._generator.get_state() == rng).all())}
    return out


# -- compile(devices=...) (tests/test_torch_compile_devices.py) -----------------

def keras_mlp(K, cfg):
    """tests/test_keras_frontend.py's Sequential MLP: 16 -> 32 (ReLU) -> 4."""
    return K.Sequential([K.Dense(32, activation="relu", name="d0"),
                         K.Dense(4, name="d1")], input_shape=(16,),
                        config=cfg)


def keras_branches(K, cfg):
    """tests/test_keras_frontend.py's functional two-branch model."""
    a = K.Input((8,), name="a")
    b = K.Input((8,), name="b")
    ha = K.Dense(16, activation="relu", name="ha")(a)
    hb = K.Dense(16, activation="relu", name="hb")(b)
    merged = K.Concatenate(name="cat0")([ha, hb])
    res = K.Add(name="add")([ha, hb])
    out = K.Dense(4, name="out")(K.Concatenate(name="cat1")([merged, res]))
    return K.Model(inputs=[a, b], outputs=out, config=cfg)


def keras_small(K, cfg):
    """tests/test_keras_frontend.py's scheduler and early-stopping MLP."""
    return K.Sequential([K.Dense(8, activation="relu", name="s0"),
                         K.Dense(2, name="s1")], input_shape=(4,),
                        config=cfg)


def keras_lstm(K, cfg):
    """tests/test_keras_frontend.py's Embedding -> LSTM -> Dense."""
    return K.Sequential([K.Embedding(200, 16, input_length=16, name="emb"),
                         K.LSTM(16, return_sequences=False, name="lstm"),
                         K.Dense(46, activation="softmax", name="head")],
                        config=cfg)


#: name -> (builder, batch, compile kwargs, epochs) of the Keras cases
KERAS_CASES = {
    "mlp": (keras_mlp, 16, dict(optimizer="sgd", metrics=["accuracy"]), 5),
    "branches": (keras_branches, 16, {}, 3),
    "lstm": (keras_lstm, 16, dict(optimizer="sgd", metrics=["accuracy"]),
             2),
}

PERF_FIELDS = ("train_all", "train_correct", "cce_loss", "sparse_cce_loss",
               "mse_loss", "mae_loss")


def history(hist):
    """Each epoch's PerfMetrics fields, as plain numbers."""
    return [{f: float(getattr(pm, f)) for f in PERF_FIELDS} for pm in hist]


def keras_case(K, name, cfg, weights, x, y, devices):
    """One KERAS_CASES model compiled with `devices`, given `weights`:
    predict's output on the first batch, then fit's epochs and the
    weights after them (None on a rank outside `devices`, with the
    errors its fit and train_step raise)."""
    build, batch, kw, epochs = KERAS_CASES[name]
    m = build(K, cfg(batch))
    m.compile(devices=devices, **kw)
    if m.ffmodel._step_fn is None:
        errors = []
        for call in (lambda: m.fit(x, y, epochs=1, verbose=False),
                     lambda: m.ffmodel.train_step({}, y[:batch])):
            try:
                call()
                errors.append(None)
            except RuntimeError as e:
                errors.append(str(e))
        return {"left": True, "errors": errors}
    m.ffmodel.set_weights(weights)
    first = ({k: v[:batch] for k, v in x.items()} if isinstance(x, dict)
             else x[:batch])
    pred = m.predict(first)
    hist = m.fit(x, y, epochs=epochs, verbose=False)
    return {"left": False, "predict": pred, "history": history(hist),
            "weights": m.ffmodel.get_weights(), "summary": m.summary()}


def compile_devices_group(rank, world, cases, small, recompile):
    """compile(devices=...) on a group of 2 (tests/
    test_torch_compile_devices.py), in this order:
      1. each Keras case of `cases` ({name: (weights, x, y)}) compiled
         with devices=[0, 1] (the whole group: nothing re-forms);
      2. the scheduler and early-stopping model on [0, 1] (`small`:
         weights, x, y): the rates the schedule saw, the epochs each fit
         ran;
      3. FFModel with devices=[0, 1] (`recompile`: weights, x, y): the
         trigger counter, a forward before and after recompile(data 2)
         with devices=None (compile's own), two more epochs;
      4. the Keras MLP compiled with devices=[0]: rank 1 leaves (its fit
         and train_step raise), rank 0 trains it on a group of 1 (the
         MLP's weights and data of `cases`)."""
    import flexflow_tpu_torch.keras as K
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.optimizer import SGDOptimizer
    from flexflow_tpu_torch.recompile import RecompileState
    from flexflow_tpu_torch.strategy import data_parallel_strategy

    def cfg(batch):
        return FFConfig(batch_size=batch, device="cpu")

    out = {"keras": {name: keras_case(K, name, cfg, w, x, y, [0, 1])
                     for name, (w, x, y) in cases.items()}}

    weights, x, y = small
    m = keras_small(K, cfg(8))
    m.compile(devices=[0, 1])
    m.ffmodel.set_weights(weights)
    lrs = []

    def sched(epoch, lr):
        lrs.append(lr)
        return lr * 0.5

    m.fit(x, y, epochs=3, verbose=False,
          callbacks=[K.LearningRateScheduler(sched)])
    stop = m.fit(x, y, epochs=50, verbose=False,
                 callbacks=[K.EarlyStopping(monitor="accuracy", patience=1)])
    out["small"] = {"lrs": lrs, "early_stop_epochs": len(stop),
                    "weights": m.ffmodel.get_weights()}

    weights, x, y = recompile
    ff = FFModel(FFConfig(batch_size=16, device="cpu"))
    sup_mlp(ff)
    ff.compile(optimizer=SGDOptimizer(lr=0.05),
               loss_type="sparse_categorical_crossentropy",
               metrics=["sparse_categorical_crossentropy"], devices=[0, 1])
    ff.set_weights(weights)
    fired = []
    r = RecompileState(trigger_func=lambda m: len(fired) < 2,
                       alter_func=lambda m: fired.append(1), ff=ff)
    triggers = [ff.recompile_on_condition(r) for _ in range(3)]
    ff.fit(x, y, epochs=1, verbose=False)
    before = ff.forward({"x": x[:16]}).numpy()
    stayed = ff.recompile(strategy=data_parallel_strategy(2))
    out["recompile"] = {
        "triggers": triggers, "recompilations": r.recompilations,
        "stayed": stayed, "world": distributed.world_size(),
        "forward": (before, ff.forward({"x": x[:16]}).numpy()),
        "history": history(ff.fit(x, y, epochs=2, verbose=False)),
        "weights": ff.get_weights()}

    w, x, y = cases["mlp"]
    out["leave"] = keras_case(K, "mlp", cfg, w, x, y, [0])
    import torch.distributed as dist

    out["leave"]["in_group"] = dist.is_initialized()
    out["leave"]["world"] = distributed.world_size()
    return out


def nccl_reform_rank(rank, world, store, new_store, out_dir):
    """An NCCL rank on card `rank` (tests/test_torch_gpu.py): an
    all-reduce over the group of `world`, then reform_group onto ranks
    0-1 through `new_store`, and on those an all-reduce over the new
    group; what it saw goes to out_dir/<rank>.pkl."""
    import torch

    from flexflow_tpu_torch import distributed

    result = None
    try:
        distributed.initialize(f"file://{store}", world, rank,
                               local_device_ids=[rank], backend="nccl")
        import torch.distributed as dist

        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        first = float(t[0])
        new = distributed.reform_group([0, 1], f"file://{new_store}",
                                       device="cuda")
        second = None
        if new is not None:
            t = torch.full((4,), float(new + 1), device="cuda")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            second = (dist.get_world_size(), dist.get_backend(), float(t[0]))
            dist.destroy_process_group()
        result = ("ok", (first, new, second))
    except Exception:  # reported to the test
        import traceback

        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def keras_devices_rank(rank, world, store, backend, job, out_dir):
    """A rank on card rank % cards (tests/test_torch_gpu.py): chip_smoke's
    keras_devices leg body (Keras compile(devices=[0, 1]) on a group of
    `world`, then the 2-card run); its report goes to out_dir/<rank>.pkl."""
    import sys

    import torch

    from flexflow_tpu_torch import distributed

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    result = None
    try:
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        distributed.initialize(f"file://{store}", world, rank,
                               local_device_ids=[card], backend=backend)
        result = ("ok", chip_smoke._keras_devices_body(
            torch, rank, {"keras_devices": job}, out_dir))
    except Exception:  # reported to the test
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
