"""FFModel of the PyTorch port (flexflow_tpu/model.py).

The layer API that `models.transformer.build_gpt` and `build_bert` and
the torch.fx frontend call (dense, conv2d, pool2d, embedding,
attention, batch_norm, layer_norm, softmax, flat, mean, the binary and
unary elementwise ops and the scalar ones), `compile` on one device
under the trivial strategy (training or inference), `train_step`,
`eval_step`, `fit`, `forward`, and weight and op-state access in the
reference's {op: {name: array}} layout.  The device comes
from FFConfig.device: "cuda" by default, which raises on a machine
without CUDA; "cpu" runs on the host.

A train step updates the weight tensors in place (the optimizer runs
under torch.no_grad()), where the reference's jitted step donated them
and returned new ones; `get_weights` copies them out.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import FFConfig, resolve_device
from .dataloader import SingleDataLoader, to_device
from .executor import GraphExecutor
from .fftype import (ActiMode, AggrMode, CompMode, DataType, LossType,
                     MetricsType, OpBinary, OperatorType, OpUnary)
from .initializer import Initializer
from .loss import Loss
from .metrics import Metrics, PerfMetrics
from .ops.attention import MultiHeadAttention, MultiHeadAttentionParams
from .ops.dense import (Conv2D, Conv2DParams, Embedding, EmbeddingParams,
                        Linear, LinearParams, Pool2D, Pool2DParams)
from .ops.element import (ElementBinary, ElementBinaryParams, ElementUnary,
                          ElementUnaryParams)
from .ops.norm import (BatchNorm, BatchNormParams, LayerNorm,
                       LayerNormParams, Softmax, SoftmaxParams)
from .ops.op import Op
from .ops.shape import Flat, Mean, Reduce, ReduceParams
from .ops.sources import InputOp, SourceParams
from .optimizer import Optimizer, SGDOptimizer
from .pcg.graph import Graph
from .tensor import ParallelTensor, ParallelTensorShape


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.device = resolve_device(self.config.device)
        self.layers = Graph()
        self.operators: Optional[Graph] = None
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
        self._used_names: set = set()
        self._name_counts: Dict[str, int] = {}

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

    # -- compile / run -----------------------------------------------------
    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: Union[LossType, str] =
                LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[Union[MetricsType, str]] =
                (MetricsType.ACCURACY,),
                comp_mode: CompMode = CompMode.TRAINING,
                seed: Optional[int] = None):
        """Build the executor on the config's device under the trivial
        strategy, stamp FFConfig.flash_min_seq on every op, draw the
        weights and the optimizer's state.  The default optimizer is
        SGD at the config's learning rate and weight decay.  In
        TRAINING mode the trainable weights require grad, for
        train_step's autograd; INFERENCE leaves them plain."""
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
        self.operators = self.layers
        self.executor = GraphExecutor(
            self.operators, self.device,
            compute_dtype=None if cd == "float32" else getattr(torch, cd),
            loss=self.loss, metrics=self.metrics, optimizer=self.optimizer)
        for op in self.operators.topo_order():
            op._flash_min_seq = cfg.flash_min_seq
        seed = seed if seed is not None else cfg.seed
        with torch.no_grad():
            self._weights, self._state = self.executor.init_weights(seed)
            self._opt_state = self.optimizer.init_state(self._weights)
        if comp_mode == CompMode.TRAINING:
            for entries in self._weights.values():
                for w in entries.values():
                    w.requires_grad_(True)
        self._step_fn = self.executor.build_step()
        self._eval_fn = self.executor.build_eval_step()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(cfg.seed))
        return self

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
        input tensor's dtype."""
        dtypes = {op.name: op.outputs[0].dtype.torch_dtype
                  for op in self.layers.source_ops()}
        return ({k: to_device(v, self.device, dtypes.get(k))
                 for k, v in inputs.items()},
                to_device(labels, self.device))

    def train_step(self, inputs: Dict[str, np.ndarray],
                   labels: np.ndarray) -> Dict[str, torch.Tensor]:
        """One iteration: forward, loss, backward, the in-place update
        and the metrics.  Returns the metric sums and "loss" as tensors
        on the model's device (no host sync)."""
        self._check_not_decode_graph("train_step()")
        if self.comp_mode != CompMode.TRAINING:
            raise RuntimeError("train_step() needs compile(comp_mode="
                               f"TRAINING), the model has {self.comp_mode}")
        feed, lab = self.put_batch(inputs, labels)
        return self._step_fn(self._weights, self._opt_state, self._state,
                             feed, lab, self._generator)

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
        and on_train_end(model); one may set model._stop_training."""
        if self._step_fn is None:
            raise RuntimeError("call compile() first")
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
                                  shuffle=shuffle, seed=self.config.seed)
        history: List[PerfMetrics] = []
        for cb in callbacks:
            cb.on_train_begin(self)
        for epoch in range(epochs):
            pm = PerfMetrics()
            t0 = time.perf_counter()
            for batch, labels in loader:
                pm.accumulate(self.train_step(batch, labels))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            pm.finalize()  # the epoch's one metrics transfer
            throughput = loader.num_batches * batch_size / dt
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
        for cb in callbacks:
            cb.on_train_end(self)
        return history

    def forward(self, inputs: Dict[str, np.ndarray]) -> torch.Tensor:
        """One forward pass of a compiled (non-decode) graph on numpy or
        torch inputs; returns the sink output on the model's device."""
        if self._is_decode_graph():
            raise RuntimeError(
                "forward() on a decode-mode graph (decode_max_seq > 0) "
                "would discard the KV-cache updates; use the paged step "
                "functions of decoding.py")
        feed = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(self.device)
                for k, v in inputs.items()}
        with torch.no_grad():
            out, _ = self.executor.run_forward(self._weights, self._state,
                                               feed)
        return out

    # -- weight access -----------------------------------------------------
    def get_weights(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The weights as numpy copies (on the CPU too, where .numpy()
        alone would alias the tensors the next step updates in place)."""
        return {op: {k: v.detach().to("cpu", copy=True).numpy()
                     for k, v in entries.items()}
                for op, entries in self._weights.items()}

    def set_weights(self, weights: Dict[str, Dict[str, np.ndarray]]):
        """Load weights in the reference's layout (FFModel.get_weights of
        either package), checked name by name and shape by shape.  The
        values are copied into the existing tensors, so a decode twin
        that shares them sees the new weights."""
        from .convert import from_jax_weights

        new = from_jax_weights(weights, self)
        with torch.no_grad():
            for op, entries in new.items():
                for k, v in entries.items():
                    self._weights[op][k].copy_(v)

    def get_state(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The op state (BatchNorm's running statistics, decode caches)
        as numpy, in the layout of the reference's FFModel._state."""
        return {op: {k: v.detach().to("cpu", copy=True).numpy()
                     for k, v in entries.items()}
                for op, entries in self._state.items()}

    def set_state(self, state: Dict[str, Dict[str, np.ndarray]]):
        """Load op state in the reference's _state layout, checked name
        by name and shape by shape, into the existing tensors."""
        from .convert import from_jax_state

        new = from_jax_state(state, self)
        with torch.no_grad():
            for op, entries in new.items():
                for k, v in entries.items():
                    self._state[op][k].copy_(v)
