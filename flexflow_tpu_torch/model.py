"""FFModel of the PyTorch port (flexflow_tpu/model.py).

The layer API that `models.transformer.build_gpt` calls, `compile` in
inference mode on one device, `forward`, and weight access in the
reference's {op: {name: array}} layout.  The device comes from
FFConfig.device: "cuda" by default, which raises on a machine without
CUDA; "cpu" runs on the host.  Training (optimizers, train_step, fit)
comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .config import FFConfig, resolve_device
from .executor import GraphExecutor
from .fftype import ActiMode, AggrMode, CompMode, DataType, OpBinary
from .initializer import Initializer
from .ops.attention import MultiHeadAttention, MultiHeadAttentionParams
from .ops.dense import Embedding, EmbeddingParams, Linear, LinearParams
from .ops.element import ElementBinary, ElementBinaryParams
from .ops.norm import LayerNorm, LayerNormParams
from .ops.op import Op
from .ops.sources import InputOp, SourceParams
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

    def add(self, x, y, inplace_a=False, name=None):
        p = ElementBinaryParams(OpBinary.ADD, inplace_a)
        return self._add(ElementBinary(p, [x, y],
                                       name=self._name("add", name)))

    def layer_norm(self, input, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name=None):
        p = LayerNormParams(tuple(axes), elementwise_affine, eps)
        return self._add(LayerNorm(p, [input],
                                   name=self._name("layer_norm", name)))

    # -- compile / run -----------------------------------------------------
    def compile(self, comp_mode: CompMode = CompMode.INFERENCE,
                seed: Optional[int] = None):
        """Build the executor on the config's device under the trivial
        strategy and draw the weights.  Only inference is in this
        slice of the port."""
        if comp_mode != CompMode.INFERENCE:
            raise NotImplementedError(
                "compile(comp_mode=TRAINING): training comes with the "
                "training slice of the port")
        cd = self.config.compute_dtype
        self.operators = self.layers
        self.executor = GraphExecutor(
            self.operators, self.device,
            compute_dtype=None if cd == "float32" else getattr(torch, cd))
        with torch.no_grad():
            self._weights, self._state = self.executor.init_weights(
                seed if seed is not None else self.config.seed)

    def _is_decode_graph(self) -> bool:
        return any(getattr(op, "_decode_max_seq", 0)
                   for op in self.operators.ops)

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
        return {op: {k: v.detach().cpu().numpy() for k, v in entries.items()}
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
