"""Keras-style Sequential and functional Model of the port
(flexflow_tpu/keras/models.py).

compile() lowers the recorded layer graph onto an FFModel of the port
(on FFConfig.device, "cuda" by default) and compiles it with the named
optimizer, loss and metrics; fit, evaluate and predict go through the
FFModel's training surface.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from ..config import FFConfig
from ..fftype import LossType, MetricsType
from ..model import FFModel
from ..optimizer import AdamOptimizer, Optimizer, SGDOptimizer
from .layers import Embedding, Input, KTensor, Layer, _Node

_LOSSES = {
    "categorical_crossentropy": LossType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
}

_METRICS = {
    "accuracy": MetricsType.ACCURACY,
    "sparse_categorical_crossentropy":
        MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "categorical_crossentropy": MetricsType.CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.MEAN_SQUARED_ERROR,
    "mse": MetricsType.MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.MEAN_ABSOLUTE_ERROR,
    "mae": MetricsType.MEAN_ABSOLUTE_ERROR,
}

_OPTIMIZERS = {
    "sgd": lambda: SGDOptimizer(lr=0.01),
    "adam": lambda: AdamOptimizer(alpha=0.001),
}


class _BaseModel:
    def __init__(self, config: Optional[FFConfig] = None,
                 name: str = "model"):
        self.name = name
        self.config = config
        self.ffmodel: Optional[FFModel] = None
        self._inputs: List[KTensor] = []
        self._outputs: List[KTensor] = []

    def compile(self, optimizer: Union[str, Optimizer] = "sgd",
                loss: Union[str, LossType] =
                "sparse_categorical_crossentropy",
                metrics: Sequence[Union[str, MetricsType]] = ("accuracy",),
                batch_size: Optional[int] = None,
                devices: Optional[Sequence] = None):
        """Lower the layer graph onto a new FFModel and compile it.  The
        reference's `devices` (a device mesh) comes with the multi-GPU
        slice; the device here is FFConfig.device."""
        if devices is not None:
            raise NotImplementedError(
                "compile(devices=...): device meshes come with the "
                "multi-GPU slice of the port; set FFConfig.device")
        cfg = self.config or FFConfig()
        if batch_size is not None:
            cfg.batch_size = batch_size
        ff = FFModel(cfg)
        # lower the symbolic graph in dependency order
        tensor_map: Dict[int, object] = {}
        for kt in self._inputs:
            dims = [cfg.batch_size] + list(kt.shape)
            tensor_map[id(kt)] = ff.create_tensor(
                dims, dtype=kt.dtype, name=getattr(kt, "name", None))

        def lower(kt: KTensor):
            if id(kt) in tensor_map:
                return tensor_map[id(kt)]
            node: _Node = kt.producer
            if node is None:
                raise ValueError("disconnected tensor (missing Input?)")
            ins = [lower(t) for t in node.inputs]
            result = node.layer.lower(ff, ins)
            outs = result if isinstance(result, (tuple, list)) else [result]
            for out_kt, ff_t in zip(node.outputs, outs):
                tensor_map[id(out_kt)] = ff_t
            return tensor_map[id(kt)]

        for out in self._outputs:
            lower(out)

        if isinstance(optimizer, str):
            optimizer = _OPTIMIZERS[optimizer.lower()]()
        if isinstance(loss, str):
            loss = _LOSSES[loss.lower()]
        metrics = [_METRICS[m.lower()] if isinstance(m, str) else m
                   for m in metrics]
        ff.compile(optimizer=optimizer, loss_type=loss, metrics=metrics)
        self.ffmodel = ff
        return self

    def _compiled(self) -> FFModel:
        if self.ffmodel is None:
            raise RuntimeError("call compile() first")
        return self.ffmodel

    def fit(self, x, y, batch_size: Optional[int] = None, epochs: int = 1,
            callbacks: Sequence = (), verbose: bool = True):
        return self._compiled().fit(
            x, y, batch_size=batch_size, epochs=epochs,
            callbacks=[_adapt(cb, self) for cb in callbacks],
            verbose=verbose)

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        """eval_step's metrics of each full batch, in order."""
        ff = self._compiled()
        bs = batch_size or ff.config.batch_size
        input_ops = ff.layers.source_ops()
        xs = x if isinstance(x, dict) else {input_ops[0].name: x}
        out = []
        for b in range(len(y) // bs):
            sl = slice(b * bs, (b + 1) * bs)
            out.append(ff.eval_step({k: v[sl] for k, v in xs.items()},
                                    y[sl]))
        return out

    def predict(self, x, batch_size: Optional[int] = None):
        """The sink output of one forward, as numpy."""
        ff = self._compiled()
        input_ops = ff.layers.source_ops()
        xs = x if isinstance(x, dict) else {input_ops[0].name: x}
        return ff.forward(xs).cpu().numpy()

    def summary(self) -> str:
        lines = [f'Model: "{self.name}"', "_" * 60]
        seen = []

        def walk(kt):
            node = kt.producer
            if node is None or node in seen:
                return
            for t in node.inputs:
                walk(t)
            seen.append(node)
            lines.append(f"{node.layer.name:<30}"
                         f"{type(node.layer).__name__:<20}"
                         f"{node.outputs[0].shape}")

        for out in self._outputs:
            walk(out)
        return "\n".join(lines)


class Model(_BaseModel):
    """Functional API: Model(inputs=..., outputs=...)."""

    def __init__(self, inputs, outputs, config: Optional[FFConfig] = None,
                 name: str = "model"):
        super().__init__(config, name)
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]


class Sequential(_BaseModel):
    """Stacked layers."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 input_shape: Optional[Sequence[int]] = None,
                 config: Optional[FFConfig] = None,
                 name: str = "sequential"):
        super().__init__(config, name)
        self._layers: List[Layer] = []
        self._input_shape = tuple(input_shape) if input_shape else None
        for layer in layers or []:
            self.add(layer)

    def add(self, layer: Layer):
        self._layers.append(layer)
        return self

    def compile(self, *args, input_shape: Optional[Sequence[int]] = None,
                **kwargs):
        shape = tuple(input_shape) if input_shape else self._input_shape
        dtype = "float32"
        first = self._layers[0] if self._layers else None
        if isinstance(first, Embedding):
            # Keras convention: an Embedding-first model takes int token
            # ids; input_length gives the shape when none was given
            dtype = "int32"
            if shape is None and first.input_length is not None:
                shape = (first.input_length,)
        if shape is None:
            raise ValueError(
                "Sequential needs input_shape (constructor or compile "
                "kwarg, or Embedding(input_length=...))")
        x = Input(shape, dtype=dtype)
        self._inputs = [x]
        t = x
        for layer in self._layers:
            t = layer(t)
        self._outputs = [t]
        return super().compile(*args, **kwargs)


def _adapt(cb, keras_model):
    """Expose the keras model on callbacks that expect `.model`."""
    cb.model = keras_model
    return cb
