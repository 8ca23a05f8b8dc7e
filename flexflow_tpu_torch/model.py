"""FFModel of the PyTorch port (flexflow_tpu/model.py).

The layer API that the `models` builders and the torch.fx frontend
call (dense, conv2d, pool2d, embedding, attention, batch_matmul,
batch_norm, layer_norm, softmax, dropout, cast, the shape ops,
weight_tensor, mean, the binary and unary elementwise ops and the
scalar ones, the MoE calls top_k, group_by, aggregate,
aggregate_spec, experts_dense and moe, and lstm), `compile` on one
device (training or inference) under a given, imported or searched
strategy (pcg/search.py), or the layer graph as it is; on a
`torch.distributed` group (distributed.initialize) the strategy runs
sharded over its ranks (executor.py, parallel/spmd.py), factored per-op
views (a dim over several mesh axes) included, over the two-level mesh
of a multi-slice run (FFConfig.slices, topology/hierarchy.py), with
pipelines (parallel/pipeline.py), expert parallelism
(parallel/expert_parallel.py), the ZeRO ladder and remat,
`train_step`, `eval_step`, `fit`, `forward`, the reference's step
surface (`set_learning_rate`, `zero_gradients`, `backward`, `update`,
`init_operators`), the dense-cache decode surface (`decode_step`,
`reset_decode_state`), and weight and op-state
access in the reference's {op: {name: array}} layout.  The device
comes from FFConfig.device: "cuda" by default, which raises on a
machine without CUDA; "cpu" runs on the host.

A train step updates the weight tensors in place (the optimizer runs
under torch.no_grad()), where the reference's jitted step donated them
and returned new ones; `get_weights` copies them out.  On a CUDA device
the step is captured as one CUDA graph after its warm-up and replayed
for every later `train_step` (capture.py), unless
the plan holds something that keeps it eager
(`executor.capture_status`).  With FFConfig.perform_fusion (`--fusion`)
compile folds trailing activations into their linear and conv2d
producers (pcg/rewrite.py `fuse_activations`).

`fit_resilient` trains under the resilience supervisor
(resilience/supervisor.py); `recompile` compiles again with the train
state carried over (onto fewer ranks of the group: a re-formed group),
and `recompile_on_condition` runs a RecompileState (recompile.py) whose
trigger may read a `cache` op's staleness score.

`FFModel.telemetry` (obs/) is the run's telemetry, built from
FFConfig.trace_dir, telemetry and profile_steps: compile's spans
(compile, search, init_weights, build_step_fns) and gauges, fit's step
spans and metrics, the epoch's device drain, the fidelity record of the
best epoch, and the strategy store's and the search's counters.  With
telemetry off, fit makes no span and its steps launch what they would
launch without it.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import distributed
from .capture import CapturedStep
from .config import FFConfig, resolve_device
from .dataloader import SingleDataLoader, to_device
from .executor import PIPELINE, GraphExecutor
from .fftype import (ActiMode, AggrMode, CompMode, DataType, LossType,
                     MetricsType, OpBinary, OperatorType, OpUnary)
from .initializer import ArrayInitializer, Initializer
from .loss import Loss
from .metrics import Metrics, PerfMetrics
from .obs import RunTelemetry
from .obs.fidelity import report_fidelity
from .ops.attention import MultiHeadAttention, MultiHeadAttentionParams
from .ops.dense import (BatchMatmul, BatchMatmulParams, Conv2D,
                        Conv2DParams, Embedding, EmbeddingParams, Linear,
                        LinearParams, Pool2D, Pool2DParams)
from .ops.element import (Cast, CastParams, Dropout, DropoutParams,
                          ElementBinary, ElementBinaryParams, ElementUnary,
                          ElementUnaryParams)
from .ops.experts import ExpertsDense, ExpertsDenseParams
from .ops.moe import (Aggregate, AggregateParams, AggregateSpec, Cache,
                      CacheParams, GroupBy, GroupByParams, TopK, TopKParams)
from .ops.norm import (BatchNorm, BatchNormParams, LayerNorm,
                       LayerNormParams, Softmax, SoftmaxParams)
from .ops.op import Op, WeightSpec
from .ops.recurrent import LSTM, LSTMParams
from .ops.shape import (Concat, ConcatParams, Expand, ExpandParams, Flat,
                        Gather, GatherParams, Mean, Pad, PadParams, Reduce,
                        ReduceParams, Reshape, ReshapeParams, Reverse,
                        ReverseParams, Split, SplitParams, Transpose,
                        TransposeParams)
from .ops.sources import InputOp, SourceParams, WeightOp
from .optimizer import Optimizer, SGDOptimizer
from .parallel.machine import make_mesh
from .pcg.graph import Graph
from .strategy import (Strategy, apply_strategy, assign_views,
                       data_parallel_strategy)
from .tensor import ParallelTensor, ParallelTensorShape


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.device = resolve_device(self.config.device)
        # the run's telemetry (obs/): the null tracer and an in-memory
        # registry unless FFConfig.trace_dir or telemetry turns it on
        self.telemetry = RunTelemetry.from_config(self.config)
        self.layers = Graph()
        self.operators: Optional[Graph] = None
        self.strategy: Optional[Strategy] = None
        self.executor: Optional[GraphExecutor] = None
        self._weights = None
        self._state = None
        self.comp_mode: Optional[CompMode] = None
        self.optimizer: Optional[Optimizer] = None
        self.loss: Optional[Loss] = None
        self.metrics: Optional[Metrics] = None
        self._opt_state = None
        self._step_fn = None
        self._eval_fn = None
        self._generator: Optional[torch.Generator] = None
        self._stop_training = False  # set by early-stopping callbacks
        self._label_replication = 1  # k under AggregateSpec
        self._decode_pos = 0  # host shadow of the dense caches' cache_pos
        self._decode_limit = None
        self._used_names: set = set()
        self._name_counts: Dict[str, int] = {}
        self._compile_args = None  # what compile() was given, for recompile
        # why this rank has no compiled step after compile or recompile
        # left it out of `devices` (None: it was never left out)
        self._left_group: Optional[str] = None
        # the Cache ops of the layer graph (the user's handles, which
        # keep the host rings), and the last step's taps, folded in one
        # step late
        self._cache_ops: List[Op] = []
        self._pending_taps = None

    # -- tensor / naming helpers -----------------------------------------
    def _name(self, base: str, name: Optional[str]) -> str:
        if name:
            if name in self._used_names:
                raise ValueError(f"duplicate layer name: {name!r}")
            self._used_names.add(name)
            return name
        while True:
            n = self._name_counts.get(base, 0)
            self._name_counts[base] = n + 1
            candidate = f"{base}_{n}"
            if candidate not in self._used_names:
                self._used_names.add(candidate)
                return candidate

    def create_tensor(self, dims: Sequence[int],
                      dtype: Union[DataType, str] = DataType.FLOAT,
                      name: Optional[str] = None) -> ParallelTensor:
        shape = ParallelTensorShape.make(dims, DataType.from_any(dtype))
        op = InputOp(SourceParams(shape), [], name=self._name("input", name))
        self.layers.add_op(op)
        return op.outputs[0]

    def _add(self, op: Op):
        self.layers.add_op(op)
        return op.outputs[0] if len(op.outputs) == 1 else tuple(op.outputs)

    # -- layer API ---------------------------------------------------------
    def dense(self, input: ParallelTensor, out_dim: int,
              activation: ActiMode = ActiMode.NONE, use_bias: bool = True,
              dtype: Union[DataType, str] = DataType.FLOAT,
              kernel_initializer: Optional[Initializer] = None,
              bias_initializer: Optional[Initializer] = None,
              name: Optional[str] = None) -> ParallelTensor:
        p = LinearParams(out_dim, use_bias, activation,
                         DataType.from_any(dtype))
        op = Linear(p, [input], name=self._name("dense", name))
        if kernel_initializer is not None:
            op.weight_specs[0] = op.weight_specs[0].__class__(
                "kernel", op.weight_specs[0].shape, kernel_initializer)
        if use_bias and bias_initializer is not None:
            op.weight_specs[1] = op.weight_specs[1].__class__(
                "bias", op.weight_specs[1].shape, bias_initializer)
        return self._add(op)

    def embedding(self, input: ParallelTensor, num_entries: int,
                  out_dim: int, aggr: AggrMode = AggrMode.NONE,
                  dtype: Union[DataType, str] = DataType.FLOAT,
                  kernel_initializer: Optional[Initializer] = None,
                  name: Optional[str] = None) -> ParallelTensor:
        p = EmbeddingParams(num_entries, out_dim, aggr,
                            DataType.from_any(dtype))
        op = Embedding(p, [input], name=self._name("embedding", name))
        if kernel_initializer is not None:
            op.weight_specs[0] = op.weight_specs[0].__class__(
                "weight", op.weight_specs[0].shape, kernel_initializer)
        return self._add(op)

    def multihead_attention(self, query: ParallelTensor,
                            key: ParallelTensor, value: ParallelTensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = False, add_bias_kv: bool = False,
                            add_zero_attn: bool = False,
                            causal: bool = False,
                            name: Optional[str] = None,
                            decode_max_seq: int = 0, kv_page_size: int = 0,
                            kv_num_blocks: int = 0) -> ParallelTensor:
        p = MultiHeadAttentionParams(embed_dim, num_heads, kdim, vdim,
                                     dropout, bias, add_bias_kv,
                                     add_zero_attn, causal)
        return self._add(MultiHeadAttention(
            p, [query, key, value], name=self._name("attention", name),
            decode_max_seq=decode_max_seq, kv_page_size=kv_page_size,
            kv_num_blocks=kv_num_blocks))

    def conv2d(self, input: ParallelTensor, out_channels: int,
               kernel_h: int, kernel_w: int, stride_h: int = 1,
               stride_w: int = 1, padding_h: int = 0, padding_w: int = 0,
               activation: ActiMode = ActiMode.NONE, groups: int = 1,
               use_bias: bool = True,
               name: Optional[str] = None) -> ParallelTensor:
        p = Conv2DParams(out_channels, (kernel_h, kernel_w),
                         (stride_h, stride_w), (padding_h, padding_w),
                         groups, use_bias, activation)
        return self._add(Conv2D(p, [input], name=self._name("conv2d", name)))

    def pool2d(self, input: ParallelTensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int = 0,
               padding_w: int = 0, pool_type: str = "max",
               activation: ActiMode = ActiMode.NONE,
               name: Optional[str] = None) -> ParallelTensor:
        p = Pool2DParams((kernel_h, kernel_w), (stride_h, stride_w),
                         (padding_h, padding_w), pool_type, activation)
        return self._add(Pool2D(p, [input], name=self._name("pool2d", name)))

    def batch_matmul(self, a: ParallelTensor, b: ParallelTensor,
                     a_seq_length_dim: int = -1, b_seq_length_dim: int = -1,
                     name: Optional[str] = None) -> ParallelTensor:
        p = BatchMatmulParams(a_seq_length_dim, b_seq_length_dim)
        return self._add(BatchMatmul(p, [a, b],
                                     name=self._name("batch_matmul", name)))

    # -- elementwise binary ---------------------------------------------
    def _binary(self, kind: OpBinary, x, y, inplace_a=False, name=None):
        p = ElementBinaryParams(kind, inplace_a)
        return self._add(ElementBinary(p, [x, y],
                                       name=self._name(kind.value, name)))

    def add(self, x, y, inplace_a=False, name=None):
        return self._binary(OpBinary.ADD, x, y, inplace_a, name)

    def subtract(self, x, y, inplace_a=False, name=None):
        return self._binary(OpBinary.SUB, x, y, inplace_a, name)

    def multiply(self, x, y, inplace_a=False, name=None):
        return self._binary(OpBinary.MUL, x, y, inplace_a, name)

    def divide(self, x, y, inplace_a=False, name=None):
        return self._binary(OpBinary.DIV, x, y, inplace_a, name)

    def max(self, x, y, name=None):
        return self._binary(OpBinary.MAX, x, y, False, name)

    def min(self, x, y, name=None):
        return self._binary(OpBinary.MIN, x, y, False, name)

    # -- elementwise unary ----------------------------------------------
    def _unary(self, kind: OpUnary, x, scalar=0.0, inplace=False,
               name=None):
        p = ElementUnaryParams(kind, inplace, scalar)
        return self._add(ElementUnary(p, [x],
                                      name=self._name(kind.value, name)))

    def exp(self, x, name=None):
        return self._unary(OpUnary.EXP, x, name=name)

    def log(self, x, name=None):
        return self._unary(OpUnary.LOG, x, name=name)

    def sin(self, x, name=None):
        return self._unary(OpUnary.SIN, x, name=name)

    def cos(self, x, name=None):
        return self._unary(OpUnary.COS, x, name=name)

    def relu(self, x, inplace=True, name=None):
        return self._unary(OpUnary.RELU, x, inplace=inplace, name=name)

    def gelu(self, x, name=None):
        return self._unary(OpUnary.GELU, x, name=name)

    def sigmoid(self, x, name=None):
        return self._unary(OpUnary.SIGMOID, x, name=name)

    def tanh(self, x, name=None):
        return self._unary(OpUnary.TANH, x, name=name)

    def elu(self, x, inplace=True, name=None):
        return self._unary(OpUnary.ELU, x, inplace=inplace, name=name)

    def identity(self, x, name=None):
        return self._unary(OpUnary.IDENTITY, x, name=name)

    def rsqrt(self, x, name=None):
        return self._unary(OpUnary.RSQRT, x, name=name)

    def sqrt(self, x, name=None):
        return self._unary(OpUnary.SQRT, x, name=name)

    def erf(self, x, name=None):
        return self._unary(OpUnary.ERF, x, name=name)

    def floor(self, x, name=None):
        return self._unary(OpUnary.FLOOR, x, name=name)

    def pow(self, x, exponent: float, name=None):
        return self._unary(OpUnary.POW, x, scalar=exponent, name=name)

    def scalar_multiply(self, x, scalar: float, inplace=True, name=None):
        return self._unary(OpUnary.SCALAR_MULTIPLY, x, scalar=scalar,
                           name=name)

    def scalar_add(self, x, scalar: float, inplace=True, name=None):
        return self._unary(OpUnary.SCALAR_ADD, x, scalar=scalar, name=name)

    def scalar_sub(self, x, scalar: float, inplace=True, name=None):
        return self._unary(OpUnary.SCALAR_SUB, x, scalar=scalar, name=name)

    def scalar_true_divide(self, x, scalar: float, inplace=True, name=None):
        return self._unary(OpUnary.SCALAR_TRUE_DIV, x, scalar=scalar,
                           name=name)

    # -- norm / softmax / shape ------------------------------------------
    def softmax(self, input, axis: int = -1, name=None):
        return self._add(Softmax(SoftmaxParams(axis), [input],
                                 name=self._name("softmax", name)))

    def batch_norm(self, input, relu: bool = True, eps: float = 1e-5,
                   momentum: float = 0.9, name=None):
        p = BatchNormParams(relu, float(eps), float(momentum))
        return self._add(BatchNorm(p, [input],
                                   name=self._name("batch_norm", name)))

    def flat(self, input, name=None):
        return self._add(Flat(None, [input], name=self._name("flat", name)))

    def concat(self, tensors: Sequence[ParallelTensor], axis: int,
               name=None):
        return self._add(Concat(ConcatParams(axis), list(tensors),
                                name=self._name("concat", name)))

    def split(self, input, sizes: Union[int, Sequence[int]], axis: int,
              name=None):
        """Split into `sizes` along axis; an int n splits into n equal
        parts."""
        if isinstance(sizes, int):
            sizes = [input.shape.logical_shape[axis] // sizes] * sizes
        p = SplitParams(tuple(sizes), axis)
        return self._add(Split(p, [input], name=self._name("split", name)))

    def weight_tensor(self, array, trainable: bool = True, name=None):
        """A standalone parameter as a tensor, initialized from `array`;
        a frozen one keeps its value in the op state."""
        arr = np.asarray(array)
        shape = ParallelTensorShape.make(arr.shape,
                                         DataType.from_any(str(arr.dtype)))
        op = WeightOp(SourceParams(shape, "weight", trainable), [],
                      name=self._name("weight", name))
        op.weight_specs = [WeightSpec("value", shape, ArrayInitializer(arr))]
        out = self._add(op)
        out.create_gradients = trainable
        return out

    def expand(self, input, sizes: Sequence[int], name=None):
        """Broadcast size-1 dims (torch Tensor.expand)."""
        p = ExpandParams(tuple(int(s) for s in sizes))
        return self._add(Expand(p, [input], name=self._name("expand", name)))

    def reshape(self, input, shape: Sequence[int], name=None):
        p = ReshapeParams(tuple(shape))
        return self._add(Reshape(p, [input],
                                 name=self._name("reshape", name)))

    def transpose(self, input, perm: Sequence[int], name=None):
        p = TransposeParams(tuple(perm))
        return self._add(Transpose(p, [input],
                                   name=self._name("transpose", name)))

    def reverse(self, input, axis: int, name=None):
        return self._add(Reverse(ReverseParams(axis), [input],
                                 name=self._name("reverse", name)))

    def pad(self, input, pads: Sequence[Sequence[int]], value: float = 0.0,
            name=None):
        """Constant padding: pads is ((before, after), ...) per logical
        dim."""
        p = PadParams(tuple((int(b), int(a)) for b, a in pads), float(value))
        return self._add(Pad(p, [input], name=self._name("pad", name)))

    def cast(self, input, dtype: Union[DataType, str], name=None):
        p = CastParams(DataType.from_any(dtype))
        return self._add(Cast(p, [input], name=self._name("cast", name)))

    def dropout(self, input, rate: float, seed: int = 0, name=None):
        p = DropoutParams(rate, seed)
        return self._add(Dropout(p, [input],
                                 name=self._name("dropout", name)))

    def gather(self, input, index, axis: int = 0, name=None):
        p = GatherParams(axis)
        return self._add(Gather(p, [input, index],
                                name=self._name("gather", name)))

    def reduce_sum(self, input, axes: Sequence[int], keepdims: bool = False,
                   name=None):
        p = ReduceParams(tuple(axes), keepdims, "sum")
        return self._add(Reduce(p, [input],
                                name=self._name("reduce_sum", name)))

    def layer_norm(self, input, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name=None):
        p = LayerNormParams(tuple(axes), elementwise_affine, eps)
        return self._add(LayerNorm(p, [input],
                                   name=self._name("layer_norm", name)))

    def mean(self, input, axes: Sequence[int], keepdims: bool = False,
             name=None):
        p = ReduceParams(tuple(axes), keepdims, "mean")
        return self._add(Mean(p, [input], name=self._name("mean", name)))

    # -- MoE ---------------------------------------------------------------
    def top_k(self, input, k: int, sorted: bool = False, name=None):
        return self._add(TopK(TopKParams(k, sorted), [input],
                              name=self._name("topk", name)))

    def group_by(self, data, assign, n: int, alpha: float, name=None):
        return self._add(GroupBy(GroupByParams(n, alpha), [data, assign],
                                 name=self._name("group_by", name)))

    def aggregate(self, gate_scores, assign, gate_full, expert_out, n: int,
                  lambda_bal: float = 0.0, name=None):
        p = AggregateParams(n, lambda_bal)
        return self._add(Aggregate(
            p, [gate_scores, assign, gate_full, expert_out],
            name=self._name("aggregate", name)))

    def aggregate_spec(self, gate_scores, assign, gate_full, expert_out,
                       n: int, lambda_bal: float = 0.0, name=None):
        """Aggregate keeping each of the k predictions per sample as a
        sample of its own; the step repeats each label k times."""
        p = AggregateParams(n, lambda_bal)
        op = AggregateSpec(p, [gate_scores, assign, gate_full, expert_out],
                           name=self._name("aggregate_spec", name))
        out = self._add(op)
        self._label_replication = op.inputs[1].shape.logical_shape[-1]
        return out

    def experts_dense(self, grouped, out_dim: int,
                      activation: ActiMode = ActiMode.NONE,
                      use_bias: bool = True, name=None):
        """Batched per-expert dense over stacked [n, cap, d] inputs."""
        p = ExpertsDenseParams(out_dim, use_bias, activation)
        return self._add(ExpertsDense(
            p, [grouped], name=self._name("experts_dense", name)))

    def cache(self, input, num_batches: int, *, score_fn=None, name=None):
        """The expert-activation cache (ops/moe.py Cache): the identity,
        whose input batches the host keeps in a ring of `num_batches`
        with a staleness score.  `score_fn` is the reference's
        four-argument scorer, or a `score_fn(ff)` that fit polls after
        every batch; the op's `trigger` (the latest score) feeds a
        RecompileState."""
        if score_fn is not None and not callable(score_fn):
            raise TypeError(f"score_fn must be callable, got {type(score_fn)}")
        op = Cache(CacheParams(num_batches), [input],
                   name=self._name("cache", name))
        op.score_fn = score_fn
        return self._add(op)

    def moe(self, input: ParallelTensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.0, name=None) -> ParallelTensor:
        """gate -> softmax -> top_k -> group_by -> per-expert FFN (ReLU)
        -> aggregate.  A rank-3 input [b, s, h] is flattened to [b·s, h]
        tokens around the dispatch and restored after it."""
        orig_shape = input.shape.logical_shape
        if len(orig_shape) == 3:
            b, s, h = orig_shape
            input = self.reshape(input, [b * s, h])
        gate = self.dense(input, num_exp, ActiMode.NONE)
        gate_sm = self.softmax(gate)
        values, assign = self.top_k(gate_sm, num_select)
        grouped = self.group_by(input, assign, num_exp, alpha)
        hidden = self.experts_dense(grouped, expert_hidden_size,
                                    activation=ActiMode.RELU)
        out = self.aggregate(values, assign, gate_sm, hidden, num_exp,
                             lambda_bal, name=name)
        if len(orig_shape) == 3:
            out = self.reshape(out, [orig_shape[0], orig_shape[1],
                                     expert_hidden_size])
        return out

    def lstm(self, input, hidden_size: int, return_sequences: bool = True,
             name=None):
        """The LSTM op (ops/recurrent.py) over [batch, seq, d]."""
        p = LSTMParams(hidden_size, return_sequences)
        return self._add(LSTM(p, [input], name=self._name("lstm", name)))

    # -- compile / run -----------------------------------------------------
    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: Union[LossType, str] =
                LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[Union[MetricsType, str]] =
                (MetricsType.ACCURACY,),
                comp_mode: CompMode = CompMode.TRAINING,
                strategy: Optional[Strategy] = None,
                devices: Optional[Sequence[int]] = None,
                seed: Optional[int] = None):
        """`_compile` under the telemetry's "compile" span, its time in
        the compile/total_ms gauge.

        `devices` are the ranks of the current torch.distributed group
        to compile onto (None: all of them), and len(devices) is the
        device count the search and the data-parallel default see (the
        reference's compile(devices=...)).  A list other than the whole
        group in order re-forms the group onto those ranks, in that
        order, as recompile does (`_join_devices`; every rank calls); a
        rank outside it leaves the group, its model uncompiled, and its
        train_step and fit raise RuntimeError.  Without a group the one
        device is rank 0: `devices` may be [0] only."""
        tel = self.telemetry
        self._compile_args = dict(loss_type=loss_type, metrics=metrics,
                                  comp_mode=comp_mode, seed=seed)
        if not self._join_devices(devices):
            return self
        t0 = time.perf_counter()
        with tel.tracer.span("compile", cat="compile"):
            result = self._compile(
                optimizer, loss_type, metrics, comp_mode, strategy, seed,
                len(devices) if devices is not None else None)
        tel.metrics.gauge("compile/total_ms").set(
            (time.perf_counter() - t0) * 1e3)
        return result

    def _join_devices(self, devices: Optional[Sequence[int]],
                      init_method: Optional[str] = None) -> bool:
        """Make the group the ranks `devices` names (None: the group as
        it is), and whether this rank is among them.  Ranks other than
        the whole group in order re-form it (distributed.reform_group,
        through `init_method`, by default a file store rank 0 names):
        whatever this model compiled is dropped first, on every rank; a
        rank outside `devices` leaves, its model uncompiled."""
        self._left_group = None
        if devices is None:
            return True
        ranks = []
        for d in devices:
            if isinstance(d, bool) or not isinstance(d, (int, np.integer)):
                raise ValueError(
                    f"devices are ranks of the torch.distributed group "
                    f"(ints), got {d!r} in {list(devices)}")
            ranks.append(int(d))
        world = distributed.world_size()
        if not torch.distributed.is_initialized():
            if ranks != [0]:
                raise ValueError(
                    f"devices={ranks} names {len(ranks)} rank(s), but no "
                    "torch.distributed group is initialized: without a "
                    "group the one device is rank 0 (devices=[0]); join "
                    f"a group of at least {max(ranks, default=0) + 1} "
                    "ranks first (distributed.initialize)")
            return True
        if ranks == list(range(world)):
            return True
        if len(set(ranks)) != len(ranks) or not all(
                0 <= r < world for r in ranks):
            raise ValueError(f"devices={ranks} are not distinct ranks of "
                             f"the torch.distributed group of {world}")
        if init_method is None:
            init_method = distributed.fresh_init_method()
        me = distributed.rank()
        if self.executor is not None:
            self._drop_step()
        if distributed.reform_group(ranks, init_method,
                                    device=str(self.device)) is None:
            self._left_group = (
                f"rank {me} left the torch.distributed group of {world} "
                f"when it re-formed onto ranks {ranks}: this model is not "
                "compiled on it")
            return False
        return True

    def _require_step(self, what: str) -> None:
        """RuntimeError unless a compiled step exists, saying why."""
        if self._step_fn is None:
            raise RuntimeError(f"{what}: {self._left_group}"
                               if self._left_group else
                               "call compile() first")

    def _compile(self, optimizer, loss_type, metrics, comp_mode, strategy,
                 seed, num_devices=None):
        """Pick the strategy, build the executor on the config's device,
        stamp FFConfig.flash_min_seq on every op, draw the weights and
        the optimizer's state.

        The strategy is `strategy`, else the config's
        import_strategy_file, else, with search_budget > 0 (and not
        only_data_parallel), the Unity or MCMC search's for
        `num_devices` (compile's len(devices)) or else
        FFConfig.resolve_num_devices() devices (every card on CUDA, one
        on the CPU, the group's size on a torch.distributed group),
        restored from the strategy store instead when one is configured
        and holds the search's key (store/); the strategy is written to
        export_strategy_file when one is named.  FFConfig.compilation_cache
        points the kernel build directory at its cache first.
        A chosen strategy's rewrites are replayed on the layer graph,
        under FFConfig.perform_fusion trailing activations are folded into
        their linear and conv2d producers (not where the strategy names
        the ops or tensors), the strategy applied, and inverse
        parallel-op pairs cancelled.
        On a group of more than one rank the strategy (by default
        data_parallel_strategy over the group) must span exactly the
        group, else ValueError; each rank then runs its shard of the
        step, with the strategy's pipeline (planned by
        parallel/pipeline_plan.py; a pipeline of degree 1 also runs on
        one process), its (or the config's) ZeRO stage over
        FFConfig.wus_axis and its remat plan (or FFConfig.remat); expert
        shardings run through parallel/expert_parallel.py.  With
        FFConfig.slices > 1 and no pipeline, the strategy's mesh runs
        expanded as topology.execution_mesh gives it (the placement axis
        split into a leading "slice" axis and its intra-slice remainder,
        ranks 0 to n/S - 1 in slice 0) and the grads of the weights
        replicated over both are reduced hierarchically over the
        remainder (executor.hier_axis); strategy.mesh_axes stays as the
        strategy gave it.  With no strategy and one rank, the layer
        graph runs as it is under data_parallel_strategy(1).

        The default optimizer is SGD at the config's learning rate and
        weight decay.  In TRAINING mode the trainable weights require
        grad, for train_step's autograd; INFERENCE leaves them plain.
        On a CUDA device the step is captured as one CUDA graph unless
        `executor.capture_status` names a blocker."""
        cfg = self.config
        self.comp_mode = comp_mode
        self.optimizer = optimizer or SGDOptimizer(
            lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
        # the reference's convention: a model ending in Softmax feeds
        # probabilities to the loss, not logits
        sink_is_softmax = self.layers.sink_op().op_type == \
            OperatorType.SOFTMAX
        self.loss = Loss(loss_type, from_logits=not sink_is_softmax)
        self.metrics = Metrics(self.loss.loss_type, metrics)
        cd = cfg.compute_dtype
        if cfg.compilation_cache:
            from .store import enable_compilation_cache

            # before any kernel is built: this compile's search times ops
            enable_compilation_cache(cfg)
        world = distributed.world_size()
        if strategy is None and world > 1 and not cfg.import_strategy_file \
                and not cfg.search_budget:
            strategy = data_parallel_strategy(world)
        picked = self._pick_strategy(strategy, num_devices)
        if self.strategy.total_devices != world:
            raise ValueError(
                f"the strategy spans {self.strategy.total_devices} devices "
                f"(mesh {dict(self.strategy.mesh_axes)}), the "
                f"torch.distributed group has {world} "
                f"rank{'s' if world > 1 else ''}")
        exec_axes, hier_axis = self.strategy.mesh_axes, None
        if world > 1 and cfg.slices > 1:
            from .topology.hierarchy import execution_mesh

            exec_axes, hier_axis = execution_mesh(
                self.strategy.mesh_axes, cfg.slices, world,
                self.strategy.placement, self.strategy.pipeline)
        self.operators = self._operators_for(picked, exec_axes)
        mesh = make_mesh(exec_axes, self.device) if world > 1 else None
        zero = (self.strategy.zero_stage
                if self.strategy.zero_stage is not None else cfg.zero_stage)
        pipeline_plan = None
        if self.strategy.pipeline:
            from .parallel.pipeline_plan import plan_pipeline

            pipeline_plan = plan_pipeline(self.operators,
                                          self.strategy.pipeline,
                                          self.strategy.mesh_axes)
        self.executor = GraphExecutor(
            self.operators, self.device,
            compute_dtype=None if cd == "float32" else getattr(torch, cd),
            loss=self.loss, metrics=self.metrics, optimizer=self.optimizer,
            label_replication=self._label_replication, mesh=mesh,
            zero_stage=zero, wus_axis=cfg.wus_axis, remat=cfg.remat,
            remat_segments=self.strategy.remat, pipeline_plan=pipeline_plan,
            hier_axis=hier_axis)
        for op in self.operators.topo_order():
            op._flash_min_seq = cfg.flash_min_seq
        # the Cache ops' rings stay on the layer graph's ops; a strategy's
        # clones take their use_cached flag
        self._cache_ops = [op for op in self.layers.topo_order()
                           if op.op_type == OperatorType.CACHE]
        flags = {op.name: op._load_cached for op in self._cache_ops}
        for op in self.operators.ops:
            if op.name in flags:
                op.use_cached(flags[op.name])
        tel = self.telemetry
        if self.executor.zero_stage >= 1:
            # the ladder's per-leaf fallback to the replicated update,
            # counted as the reference counts it
            fallback = self.executor.zero_fallback_leaves()
            tel.metrics.counter("parallel/zero_fallback_leaves").inc(
                len(fallback))
            if fallback and isinstance(getattr(self.strategy, "search_stats",
                                               None), dict):
                self.strategy.search_stats["zero_fallback_leaves"] = len(
                    fallback)
        seed = seed if seed is not None else cfg.seed
        with tel.tracer.span("init_weights", cat="compile"), torch.no_grad():
            self._weights, self._state = self.executor.init_weights(seed)
            self._opt_state = self.optimizer.init_state(
                self.executor.update_views(self._weights))
        if comp_mode == CompMode.TRAINING:
            for entries in self._weights.values():
                for w in entries.values():
                    w.requires_grad_(True)
        self.executor.map_kernels = tel.profiles
        with tel.tracer.span("build_step_fns", cat="compile"):
            self._step_fn = self.executor.build_step()
            self._eval_fn = self.executor.build_eval_step()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(cfg.seed))
        return self

    def set_iteration_config(self, seq_length: Optional[int]):
        """FFIterationConfig.seq_length: stamp it on every op, so that
        BatchMatmul masks positions at or past it on its declared seq
        dims (-1 masks nothing).  A captured step baked the old length
        into its graph, so it is captured again at its next call."""
        if seq_length is None:
            return
        for graph in (self.layers, self.operators):
            for op in (graph.ops if graph is not None else ()):
                op._iter_seq_length = int(seq_length)
        if isinstance(self._step_fn, CapturedStep):
            self._step_fn.reset()

    def _stamp_catalog(self, strategy: Strategy) -> None:
        """Record the identity of the catalog a fresh search's rewrites
        came from, so that a replay elsewhere cannot resolve other rules
        (rewrite.rules_for_replay checks its hash).  Only this process's
        own search results are stamped: stamping an imported or restored
        trace with the local catalog's hash would fabricate its
        provenance and defeat the replay check."""
        if strategy.catalog is not None or not any(
                str(n).startswith("taso_rule_") for n, _ in strategy.rewrites):
            return
        from .pcg.rewrite import catalog_fingerprint, catalog_for_config

        path = catalog_for_config(self.config)
        if path:
            strategy.catalog = catalog_fingerprint(path)

    def search_strategy(self, num_devices: int) -> Strategy:
        """The Unity (or, with search_algo "mcmc", the MCMC) search's
        strategy for the layer graph over `num_devices` devices, through
        store.cached_search: with a strategy store configured, the
        strategy published under the same key is restored and the search
        skipped (search_stats' store_hit and store_key)."""
        from .pcg.search import mcmc_search, unity_search
        from .store import cached_search

        def run_search():
            t0 = time.perf_counter()
            s = (mcmc_search(self, num_devices)
                 if self.config.search_algo == "mcmc"
                 else unity_search(self, num_devices))
            s.search_stats["search_s"] = time.perf_counter() - t0
            # stamped before the publish: a restored entry carries the
            # provenance its replay check needs
            self._stamp_catalog(s)
            return s

        return cached_search(self, num_devices, run_search)

    def _pick_strategy(self, strategy: Optional[Strategy],
                       num_devices: Optional[int] = None
                       ) -> Optional[Strategy]:
        """The strategy compile applies (None: the layer graph as it
        is), set on self.strategy with search_stats as the reference
        sets them; exported when export_strategy_file names a file."""
        cfg = self.config
        if strategy is None and cfg.import_strategy_file:
            strategy = Strategy.load(cfg.import_strategy_file)
        if (strategy is None and cfg.search_budget > 0
                and not cfg.only_data_parallel):
            tel = self.telemetry
            num_devices = num_devices or cfg.resolve_num_devices()
            t0 = time.perf_counter()
            with tel.tracer.span("search", cat="search",
                                 algo=cfg.search_algo, devices=num_devices):
                strategy = self.search_strategy(num_devices)
            tel.metrics.gauge("compile/search_ms").set(
                (time.perf_counter() - t0) * 1e3)
        self.strategy = strategy or data_parallel_strategy(1)
        if cfg.export_strategy_file:
            self.strategy.save(cfg.export_strategy_file)
        return strategy

    def _operators_for(self, strategy: Optional[Strategy],
                       mesh_axes: Optional[Dict[str, int]] = None) -> Graph:
        """The graph the executor runs: the layer graph (fused under
        FFConfig.perform_fusion), or (given a strategy) its rewrites
        replayed, the fusion pass, the strategy applied and inverse
        parallel-op pairs cancelled, with every tensor's MachineView
        assigned over `mesh_axes` (the execution mesh; by default the
        strategy's)."""
        from .pcg.rewrite import (apply_rewrites,
                                  cancel_all_inverse_parallel_ops,
                                  fuse_activations, rules_for_replay)

        if strategy is None:
            if self.config.perform_fusion:
                return fuse_activations(self.layers)
            return self.layers
        frontend = self.layers
        if strategy.rewrites:
            frontend = apply_rewrites(frontend, strategy.rewrites,
                                      rules_for_replay(self.config, strategy))
        if self.config.perform_fusion:
            # the reference's --fusion: nothing the strategy names
            protected = set(strategy.edge_ops) | set(strategy.shard_configs)
            frontend = fuse_activations(frontend, protected)
        graph = cancel_all_inverse_parallel_ops(
            apply_strategy(frontend, strategy))
        assign_views(graph, mesh_axes or strategy.mesh_axes)
        stamped = {op.name: op._iter_seq_length for op in self.layers.ops
                   if hasattr(op, "_iter_seq_length")}
        for op in graph.ops:
            if op.name in stamped:
                op._iter_seq_length = stamped[op.name]
        return graph

    def _is_decode_graph(self) -> bool:
        return any(getattr(op, "_decode_max_seq", 0)
                   for op in self.operators.ops)

    def _check_not_decode_graph(self, what: str):
        if self._is_decode_graph():
            raise RuntimeError(
                f"{what} on a decode-mode graph (decode_max_seq > 0) is "
                "not supported: the decode twin only serves")

    def put_batch(self, inputs, labels):
        """(inputs, labels) on the model's device, each input in its
        input tensor's dtype; on a group, a global numpy batch is cut to
        this rank's shard on the host, so only that shard is copied."""
        dtypes = {op.name: op.outputs[0].dtype.torch_dtype
                  for op in self.layers.source_ops()}
        ex = self.executor
        if ex is not None and ex.mesh is not None:
            inputs = {k: ex.host_shard(k, v) for k, v in inputs.items()}
            labels = ex.host_shard(None, labels)
        return ({k: to_device(v, self.device, dtypes.get(k))
                 for k, v in inputs.items()},
                to_device(labels, self.device))

    def train_step(self, inputs: Dict[str, np.ndarray],
                   labels: np.ndarray) -> Dict[str, torch.Tensor]:
        """One iteration: forward, loss, backward, the in-place update
        and the metrics.  Returns the metric sums and "loss" as tensors
        on the model's device (no host sync)."""
        self._require_step("train_step()")
        self._check_not_decode_graph("train_step()")
        if self.comp_mode != CompMode.TRAINING:
            raise RuntimeError("train_step() needs compile(comp_mode="
                               f"TRAINING), the model has {self.comp_mode}")
        if self.telemetry.enabled:
            with self.telemetry.tracer.span("host_transfer", cat="data"):
                feed, lab = self.put_batch(inputs, labels)
        else:  # the hot path: no span object when telemetry is off
            feed, lab = self.put_batch(inputs, labels)
        if not self._cache_ops:
            return self._step_fn(self._weights, self._opt_state, self._state,
                                 feed, lab, self._generator)
        for op in self._cache_ops:
            if op._load_cached:
                feed[f"__cache__{op.name}"] = torch.as_tensor(
                    op.cached_value()).to(self.device)
        m = self._step_fn(self._weights, self._opt_state, self._state, feed,
                          lab, self._generator)
        return self._update_caches(m)

    # -- the Cache ops' host side ------------------------------------------
    def _update_caches(self, m):
        """Fold the step's cache taps into the Cache ops' rings and
        scores, one step late: reading this step's tap on the host would
        wait for the device, so it waits for the next call (or a flush:
        use_cached, recompile_on_condition)."""
        taps = m.pop("__cache_taps__", None)
        pending, self._pending_taps = self._pending_taps, taps
        self._apply_taps(pending)
        return m

    def _apply_taps(self, taps):
        if not taps:
            return
        by_name = {op.name: op for op in self._cache_ops}
        for name, v in taps.items():
            op = by_name.get(name)
            if op is not None and not op._is_legacy_score():
                op.update(v.cpu().numpy())

    def _flush_cache_taps(self):
        pending, self._pending_taps = self._pending_taps, None
        self._apply_taps(pending)

    def use_cached(self, load_cached: bool, name: Optional[str] = None):
        """Switch the Cache ops (or the one named) between the identity
        and the replay of their cached batch (the reference's
        Cache::use_cached).  The step reads the flag at run time: a graph
        with a Cache op is never captured."""
        self._flush_cache_taps()
        hit = False
        for fop in self._cache_ops:
            if name is not None and fop.name != name:
                continue
            hit = True
            fop.use_cached(load_cached)
            for op in (self.operators.ops if self.operators is not None
                       else ()):
                if op.name == fop.name:
                    op.use_cached(load_cached)
        if name is not None and not hit:
            raise ValueError(f"no Cache op named {name!r}")

    def eval_step(self, inputs: Dict[str, np.ndarray],
                  labels: np.ndarray) -> Dict[str, torch.Tensor]:
        self._check_not_decode_graph("eval_step()")
        feed, lab = self.put_batch(inputs, labels)
        return self._eval_fn(self._weights, self._state, feed, lab)

    def fit(self, x: Union[np.ndarray, Sequence[np.ndarray],
                           Dict[str, np.ndarray]],
            y: np.ndarray, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, callbacks: Sequence = (),
            verbose: bool = True, shuffle: bool = False
            ) -> List[PerfMetrics]:
        """Train over numpy data, batched through SingleDataLoader (the
        reference's fit loop): one PerfMetrics per epoch, accumulated on
        the device and brought to the host once per epoch.  Callbacks
        get on_train_begin(model), on_epoch_end(model, epoch, metrics)
        and on_train_end(model), and those that have it
        on_step_end(model, steps done); one may set
        model._stop_training.

        With telemetry on, each step runs under a "step" span into the
        fit/step_ms histogram, the profile window's steps under
        torch.profiler with each op in a record_function range (a
        captured step replays, its kernels mapped to their ops by its
        warm-up's, obs/attribution.py), each
        epoch ends in a "device_drain" span and the fit/epoch_s,
        fit/throughput_sps and fit/metrics/* metrics, and the best
        epoch's seconds per step go into the fidelity record.  In every
        exit the artifacts are flushed and the callbacks' checkpoint
        managers drained, so a fit that crashed still writes them."""
        self._require_step("fit()")
        batch_size = batch_size or self.config.batch_size
        epochs = epochs or self.config.epochs
        input_ops = self.layers.source_ops()
        if isinstance(x, dict):
            x_map = x
        elif isinstance(x, (list, tuple)):
            x_map = {op.name: arr for op, arr in zip(input_ops, x)}
        else:
            x_map = {input_ops[0].name: x}
        loader = SingleDataLoader(self, x_map, y, batch_size=batch_size,
                                  shuffle=shuffle, seed=self.config.seed,
                                  index=self._feed_index(batch_size))
        tel = self.telemetry
        for cb in callbacks:
            cb.on_train_begin(self)
        try:
            return self._fit_loop(loader, epochs, callbacks, verbose,
                                  batch_size, tel)
        finally:
            if tel.enabled:
                self.executor.op_scopes = False
                tel.flush()
            # queued background saves land even when the loop died
            # before on_train_end
            for cb in callbacks:
                drain = getattr(getattr(cb, "manager", None), "drain", None)
                if callable(drain):
                    drain()

    def _fit_loop(self, loader, epochs, callbacks, verbose, batch_size, tel
                  ) -> List[PerfMetrics]:
        # all per-step telemetry sits behind one boolean, so the
        # disabled path makes no span object
        tracing = tel.enabled
        tracer = tel.tracer
        step_hist = tel.metrics.histogram("fit/step_ms") if tracing else None
        step_cbs = [cb for cb in callbacks if hasattr(cb, "on_step_end")]
        ex = self.executor
        history: List[PerfMetrics] = []
        epoch_step_s: List[float] = []
        global_step = 0
        for epoch in range(epochs):
            pm = PerfMetrics()
            t0 = time.perf_counter()
            try:
                for batch, labels in loader:
                    if tracing:
                        tel.on_step(global_step,
                                    ex.capture_status.get("kernel_ops"))
                        ex.op_scopes = tel.profiling
                        ts = time.perf_counter()
                        with tracer.span("step", cat="train",
                                         step=global_step, epoch=epoch):
                            m = self.train_step(batch, labels)
                        step_hist.observe((time.perf_counter() - ts) * 1e3)
                    else:
                        m = self.train_step(batch, labels)
                    global_step += 1
                    pm.accumulate(m)
                    for op in self._cache_ops:
                        # a model-level score_fn(ff) is polled here; the
                        # four-argument scorers ran in the step's taps
                        if op.score_fn is not None and op._is_legacy_score():
                            op.update_score(float(op.score_fn(self)))
                    for cb in step_cbs:
                        cb.on_step_end(self, global_step)
            finally:
                loader._stop_worker()  # a step that raised leaves it on
            with tracer.span("device_drain", cat="train", epoch=epoch):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            pm.finalize()  # the epoch's one metrics transfer
            throughput = loader.num_batches * batch_size / dt
            if tracing:
                epoch_step_s.append(dt / max(1, loader.num_batches))
                tel.metrics.histogram("fit/epoch_s").observe(dt)
                tel.metrics.gauge("fit/throughput_sps").set(throughput)
                tel.metrics.fold_counters("fit/metrics", {
                    f: getattr(pm, f) for f in PerfMetrics._FIELDS})
                tel.metrics.gauge("fit/metrics/accuracy").set(pm.accuracy)
            if verbose:
                print(f"epoch {epoch}: {pm.summary()} "
                      f"ELAPSED TIME = {dt:.4f}s, THROUGHPUT = "
                      f"{throughput:.2f} samples/s")
            history.append(pm)
            for cb in callbacks:
                cb.on_epoch_end(self, epoch, pm)
            if self._stop_training:
                self._stop_training = False
                break
        if tracing:
            # a window that ends with the last step closes here, before
            # the fidelity prediction times ops on the card
            tel.on_step(global_step, ex.capture_status.get("kernel_ops"))
            ex.op_scopes = tel.profiling
        for cb in callbacks:
            cb.on_train_end(self)
        if tracing and epoch_step_s:
            # the best epoch is the steady state (the first pays the
            # warm-up and the capture)
            report_fidelity(self, min(epoch_step_s),
                            steps_measured=global_step, source="fit")
        return history

    def _feed_index(self, batch_size: int):
        """{input name (None: the labels): this rank's index into one
        global batch (the executor's feed_index, as put_batch cuts)};
        None on one rank."""
        ex = self.executor
        if ex is None or ex.mesh is None:
            return None
        shapes = {op.name: (batch_size,)
                  + tuple(op.outputs[0].shape.logical_shape[1:])
                  for op in ex.graph.source_ops()}
        shapes[None] = (batch_size,)
        return {name: ex.feed_index(name, shape)
                for name, shape in shapes.items()}

    def forward(self, inputs: Dict[str, np.ndarray]) -> torch.Tensor:
        """One forward pass of a compiled (non-decode) graph on numpy or
        torch inputs; returns the sink output on the model's device (on
        a group, the whole output on every rank)."""
        if self._is_decode_graph():
            raise RuntimeError(
                "forward() on a decode-mode graph (decode_max_seq > 0) "
                "would discard the KV-cache updates; use decode_step or "
                "the paged step functions of decoding.py")
        feed = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(self.device)
                for k, v in inputs.items()}
        with torch.no_grad():
            out, _ = self.executor.run_forward(self._weights, self._state,
                                               feed)
            ex = self.executor
            if ex.mesh is not None:
                from .parallel.collectives import gather_global

                out = gather_global(out, ex.view[self.operators.sink_op()
                                                 .outputs[0].guid], ex.mesh)
        return out

    def fit_resilient(self, x, y: np.ndarray, num_steps: Optional[int] = None,
                      epochs: Optional[int] = None,
                      batch_size: Optional[int] = None,
                      directory: Optional[str] = None, fault_plan=None,
                      retry=None, resume: bool = False):
        """`fit` under the resilience supervisor
        (resilience/supervisor.py): periodic checkpoints (async with
        FFConfig.checkpoint_async, mirrored to FFConfig.remote_store),
        restore-and-retry on a transient failure, the SIGTERM/SIGINT
        grace, the hung-step watchdog (step_timeout), nan_policy, and on
        a device loss the re-formed group of the survivors with a
        re-searched strategy.  Batch i is rows [i*bs, (i+1)*bs) of the
        data, unshuffled, so an interrupted run replays bit for bit.
        `num_steps` defaults to the batches in (x, y) times `epochs`;
        resume=True continues from the newest checkpoint of either tier.
        Returns a SupervisorReport."""
        from .resilience import TrainingSupervisor

        self._require_step("fit_resilient()")
        batch_size = batch_size or self.config.batch_size
        directory = directory or self.config.checkpoint_dir
        if directory is None:
            raise ValueError(
                "fit_resilient needs a checkpoint directory: pass "
                "directory= or set FFConfig.checkpoint_dir/--checkpoint-dir")
        if num_steps is None:
            num_steps = (len(y) // batch_size) * (epochs or self.config.epochs)
        supervisor = TrainingSupervisor(self, directory, fault_plan=fault_plan,
                                        retry=retry)
        return supervisor.run(x, y, num_steps=num_steps,
                              batch_size=batch_size, resume=resume)

    # -- recompilation -------------------------------------------------------
    def _drop_step(self):
        """Let go of the compiled step and the train state (a captured
        step's graph and memory pool, whatever holds the group's
        communicators), so that none of it is alive when the next
        compile builds its own."""
        self._step_fn = self._eval_fn = None
        self.executor = None
        self._weights = self._opt_state = self._state = None
        self._pending_taps = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def recompile(self, strategy: Optional[Strategy] = None,
                  devices: Optional[Sequence[int]] = None,
                  init_method: Optional[str] = None,
                  carry: bool = True) -> bool:
        """Compile again under `strategy` (None: what compile picks) with
        compile's other arguments as they were, carrying the weights,
        the optimizer's slots, the op state and the generator's state
        over (checkpoint.state_arrays, per-op and `__pipeline__` layouts
        mapped; `carry=False` leaves the fresh ones, for a caller that
        restores a checkpoint next).  The old step is dropped before the
        new one is built, and the new one is captured again on a card.

        `devices` are ranks of the current group, as in compile.  None
        keeps compile's own: compile left the group equal to its
        devices, so that is the whole current group (after a device
        loss, the survivors' re-formed one).  Other ranks re-form the
        group as compile does (`_join_devices`, through `init_method`):
        every rank calls, and a rank outside `devices` returns False,
        its model no longer compiled.  True otherwise."""
        from .checkpoint import load_state_arrays, state_arrays

        if self._compile_args is None:
            raise RuntimeError("call compile() first")
        arrays = None
        if carry:
            if self.executor is None:
                raise RuntimeError("recompile(carry=True) needs a compiled "
                                   "model to carry the state of")
            self._flush_cache_taps()
            arrays = state_arrays(self)
        # (a re-form drops the step before the group goes)
        if not self._join_devices(devices, init_method):
            return False
        if self.executor is not None:
            self._drop_step()
        self.compile(optimizer=self.optimizer, strategy=strategy,
                     **self._compile_args)
        if arrays is not None:
            load_state_arrays(self, arrays)
        return True

    def recompile_on_condition(self, r) -> bool:
        """r.alter() when r.trigger() holds (recompile.py), after the
        pending cache taps are folded in, so that a trigger reads the
        current scores."""
        from .recompile import recompile_on_condition

        self._flush_cache_taps()
        return recompile_on_condition(self, r)

    # -- dense-cache decoding -----------------------------------------------
    def decode_step(self, inputs: Dict[str, np.ndarray]) -> torch.Tensor:
        """One incremental-decode forward of a graph built with
        decode-mode attention (decode_max_seq > 0, kv_page_size 0): the
        step's k/v land in the caches at cache_pos and cache_pos
        advances, in place.  Returns the logits on the model's device.
        Call reset_decode_state() before each new batch of sequences."""
        if self._decode_limit is None:
            limits = [op._decode_max_seq for op in self.operators.ops
                      if getattr(op, "_decode_max_seq", 0)]
            self._decode_limit = min(limits) if limits else 0
        dtypes = {op.name: op.outputs[0].dtype.torch_dtype
                  for op in self.layers.source_ops()}
        feed = {k: to_device(v if torch.is_tensor(v) else np.asarray(v),
                             self.device, dtypes.get(k))
                for k, v in inputs.items()}
        step = max((int(v.shape[1]) for v in feed.values() if v.dim() >= 2),
                   default=1)
        # the host guard: an index_copy_ past the cache's end faults on
        # the card (the reference's dynamic_update_slice would clamp it
        # and overwrite the last rows)
        if self._decode_limit and \
                self._decode_pos + step > self._decode_limit:
            raise ValueError(
                f"decode_step past decode_max_seq={self._decode_limit} "
                f"(position {self._decode_pos}); call reset_decode_state() "
                "to start a new sequence")
        with torch.no_grad():
            logits, _ = self.executor.run_forward(self._weights, self._state,
                                                  feed)
        self._decode_pos += step
        return logits

    def _sync_decode_pos(self):
        """Rebuild the host's position counter from the cache_pos state
        entries; every writer of cache_pos other than decode_step calls
        it."""
        pos = 0
        for entries in (self._state or {}).values():
            cp = entries.get("cache_pos")
            if cp is not None and cp.numel():
                pos = max(pos, int(cp.reshape(-1)[0]))
        self._decode_pos = pos

    def reset_decode_state(self):
        """Zero the decode caches (k_cache, v_cache, cache_pos, and the
        paged block_table and seq_lens) in place, so that the next
        decode_step starts a fresh sequence."""
        names = ("k_cache", "v_cache", "cache_pos", "block_table",
                 "seq_lens")
        with torch.no_grad():
            for entries in (self._state or {}).values():
                for k, v in entries.items():
                    if k in names:
                        v.zero_()
        self._decode_pos = 0

    # -- the reference's step pieces (each folded into train_step) ---------
    def init_operators(self):
        return None

    def zero_gradients(self):
        return None  # grads are made fresh by each step: nothing to zero

    def backward(self):
        raise RuntimeError(
            "backward is part of train_step (torch.autograd.grad over the "
            "step's loss); call train_step")

    def update(self):
        return None

    def set_learning_rate(self, lr: float):
        """Change the optimizer's learning rate: the update reads it from
        a device tensor, written here in place, so an eager step and a
        captured one (its graph replayed) both take it at the next
        update."""
        self.optimizer.set_lr(lr)

    # -- weight access -----------------------------------------------------
    def _host(self, op: str, k: str, v: torch.Tensor) -> np.ndarray:
        """A weight or state entry as a numpy copy of the global array
        (gathered on a group: every rank must call)."""
        return self.executor.gathered(op, k, v.detach()).to(
            "cpu", copy=True).numpy()

    def get_weights(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The weights as numpy copies (on the CPU too, where .numpy()
        alone would alias the tensors the next step updates in place);
        on a group, the global arrays, gathered on every rank.  Under a
        pipeline the block ops' weights come stacked, as the reference
        gives them: {"__pipeline__": {"<j>.<name>": [L, ...]}}."""
        return {op: {k: self._host(op, k, v) for k, v in entries.items()}
                for op, entries in self._weights.items()}

    def get_parameter(self, op_name: str, weight_name: str) -> np.ndarray:
        """One weight as a numpy copy (the global array)."""
        return self._host(op_name, weight_name,
                          self._weights[op_name][weight_name])

    def _adapt_weight_layout(self, weights):
        """`weights` in the layout the executor keeps: per-op weights
        stacked into the "__pipeline__" group (each template weight over
        the L blocks, keyed "<j>.<name>") under a pipeline, and a stacked
        group unstacked onto the block ops of the graph without one.
        Either way the other entries pass as they are."""
        plan = getattr(self.executor, "pipeline_plan", None)
        has_stacked = PIPELINE in weights
        if (plan is not None) == has_stacked:
            return weights
        if plan is not None:
            block_names = {op.name for blk in plan.blocks for op in blk}
            out = {k: dict(v) for k, v in weights.items()
                   if k not in block_names}
            out[PIPELINE] = {
                f"{j}.{spec.name}": np.stack([
                    np.asarray(weights[blk[j].name][spec.name])
                    for blk in plan.blocks])
                for j, t_op in enumerate(plan.blocks[0])
                for spec in t_op.weight_specs}
            return out
        from .pcg.segments import find_repeated_blocks

        blocks = find_repeated_blocks(self.layers)
        if not blocks:
            raise ValueError(
                "weights carry a '__pipeline__' group but the graph has no "
                "repeated block stack to unstack it onto")
        out = {k: dict(v) for k, v in weights.items()
               if k != PIPELINE}
        for key, stacked in weights[PIPELINE].items():
            j, wname = key.split(".", 1)
            arr = np.asarray(stacked)
            if arr.shape[0] != len(blocks):
                raise ValueError(
                    f"stacked weight {key!r} has {arr.shape[0]} block "
                    f"layers but the graph repeats {len(blocks)} blocks")
            for blk, row in zip(blocks, arr):
                out.setdefault(blk[int(j)].name, {})[wname] = row
        return out

    def set_weights(self, weights: Dict[str, Dict[str, np.ndarray]]):
        """Load weights in the reference's layout (FFModel.get_weights of
        either package, per op or with the block ops' weights stacked
        under "__pipeline__": `_adapt_weight_layout` converts to the one
        the strategy keeps), checked name by name and shape by shape.
        The values are copied into the existing tensors, so a decode
        twin that shares them sees the new weights."""
        from .convert import from_jax_weights

        new = from_jax_weights(self._adapt_weight_layout(weights), self)
        with torch.no_grad():
            for op, entries in new.items():
                for k, v in entries.items():
                    self._weights[op][k].copy_(self._shard(op, k, v))

    def _shard(self, op: str, k: str, v: torch.Tensor) -> torch.Tensor:
        """This rank's stored shard of a global weight or state entry."""
        ex = self.executor
        return v if ex.mesh is None else ex.local(v, op, k)

    def get_state(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The op state (BatchNorm's running statistics, decode caches)
        as numpy, in the layout of the reference's FFModel._state."""
        return {op: {k: self._host(op, k, v) for k, v in entries.items()}
                for op, entries in self._state.items()}

    def set_state(self, state: Dict[str, Dict[str, np.ndarray]]):
        """Load op state in the reference's _state layout, checked name
        by name and shape by shape, into the existing tensors."""
        from .convert import from_jax_state

        new = from_jax_state(state, self)
        with torch.no_grad():
            for op, entries in new.items():
                for k, v in entries.items():
                    self._state[op][k].copy_(self._shard(op, k, v))
        self._sync_decode_pos()
