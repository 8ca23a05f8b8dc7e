"""Keras-style layers of the port (flexflow_tpu/keras/layers.py):
symbolic graph nodes, each lowered onto one FFModel call of the port by
its `lower(ff, inputs)`, with the reference's shapes and names.
Image tensors are channels_first (NCHW), as FFModel.conv2d takes them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..fftype import ActiMode

_ACTIVATIONS = {
    None: ActiMode.NONE,
    "linear": ActiMode.NONE,
    "relu": ActiMode.RELU,
    "sigmoid": ActiMode.SIGMOID,
    "tanh": ActiMode.TANH,
    "gelu": ActiMode.GELU,
}


def _act(activation) -> ActiMode:
    if isinstance(activation, ActiMode):
        return activation
    if activation in _ACTIVATIONS:
        return _ACTIVATIONS[activation]
    raise ValueError(f"unknown activation {activation!r}")


class KTensor:
    """Symbolic tensor flowing between keras layers."""

    def __init__(self, shape: Tuple[int, ...], dtype: str = "float32",
                 producer=None, producer_idx: int = 0):
        self.shape = tuple(shape)  # (batch?, ...) — batch dim excluded
        self.dtype = dtype
        self.producer = producer  # (_Node) or None for Input
        self.producer_idx = producer_idx


def Input(shape: Sequence[int], dtype: str = "float32", name: Optional[str] = None):
    """Functional-API entry point: a batchless-shape placeholder."""
    t = KTensor(tuple(shape), dtype)
    t.name = name
    t.is_input = True
    return t


class _Node:
    def __init__(self, layer: "Layer", inputs: List[KTensor]):
        self.layer = layer
        self.inputs = inputs


class Layer:
    """Base layer: calling it on KTensors records a graph node."""

    _count = [0]

    def __init__(self, name: Optional[str] = None):
        if name is None:
            Layer._count[0] += 1
            name = f"{type(self).__name__.lower()}_{Layer._count[0]}"
        self.name = name

    def __call__(self, inputs):
        single = not isinstance(inputs, (list, tuple))
        ins = [inputs] if single else list(inputs)
        node = _Node(self, ins)
        out_shapes = self.compute_output_shape([t.shape for t in ins])
        outs = [
            KTensor(s, ins[0].dtype, producer=node, producer_idx=i)
            for i, s in enumerate(out_shapes)
        ]
        node.outputs = outs
        return outs[0] if len(outs) == 1 else outs

    # -- to override -----------------------------------------------------
    def compute_output_shape(self, input_shapes):
        return [input_shapes[0]]

    def lower(self, ff, inputs):
        raise NotImplementedError


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.units = units
        # Keras allows activation="softmax" on Dense; it is a separate
        # op here (reference convention: model ends in a Softmax op)
        self.softmax = activation == "softmax"
        self.activation = _act(None if self.softmax else activation)
        self.use_bias = use_bias

    def compute_output_shape(self, input_shapes):
        return [tuple(input_shapes[0][:-1]) + (self.units,)]

    def lower(self, ff, inputs):
        out = ff.dense(inputs[0], self.units, activation=self.activation,
                       use_bias=self.use_bias, name=self.name)
        if self.softmax:
            out = ff.softmax(out)
        return out


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(Layer):
    """channels_first (NCHW): input shape (C, H, W)."""

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding: str = "valid", activation=None,
                 use_bias: bool = True, groups: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.filters = filters
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides)
        assert padding in ("valid", "same")
        self.padding = padding
        self.activation = _act(activation)
        self.use_bias = use_bias
        self.groups = groups

    def _pads(self, h, w):
        if self.padding == "valid":
            return 0, 0
        # 'same' with stride 1: symmetric padding (stride>1 'same' needs
        # asymmetric pads — reject to stay exact)
        assert self.strides == (1, 1), "'same' padding requires stride 1"
        return (self.kernel[0] - 1) // 2, (self.kernel[1] - 1) // 2

    def compute_output_shape(self, input_shapes):
        c, h, w = input_shapes[0]
        ph, pw = self._pads(h, w)
        oh = (h + 2 * ph - self.kernel[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.kernel[1]) // self.strides[1] + 1
        return [(self.filters, oh, ow)]

    def lower(self, ff, inputs):
        h, w = inputs[0].shape.logical_shape[2:4]
        ph, pw = self._pads(h, w)
        return ff.conv2d(
            inputs[0], self.filters, self.kernel[0], self.kernel[1],
            self.strides[0], self.strides[1], ph, pw,
            activation=self.activation, groups=self.groups,
            use_bias=self.use_bias, name=self.name,
        )


class _Pool2D(Layer):
    kind = "max"

    def __init__(self, pool_size=(2, 2), strides=None, padding: str = "valid",
                 name: Optional[str] = None):
        super().__init__(name)
        self.pool = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool
        assert padding == "valid", "pooling supports 'valid' padding"

    def compute_output_shape(self, input_shapes):
        c, h, w = input_shapes[0]
        oh = (h - self.pool[0]) // self.strides[0] + 1
        ow = (w - self.pool[1]) // self.strides[1] + 1
        return [(c, oh, ow)]

    def lower(self, ff, inputs):
        return ff.pool2d(inputs[0], self.pool[0], self.pool[1],
                         self.strides[0], self.strides[1], 0, 0,
                         pool_type=self.kind, name=self.name)


class MaxPooling2D(_Pool2D):
    kind = "max"


class AveragePooling2D(_Pool2D):
    kind = "avg"


class Flatten(Layer):
    def compute_output_shape(self, input_shapes):
        n = 1
        for s in input_shapes[0]:
            n *= s
        return [(n,)]

    def lower(self, ff, inputs):
        return ff.flat(inputs[0], name=self.name)


class Dropout(Layer):
    def __init__(self, rate: float, name: Optional[str] = None):
        super().__init__(name)
        self.rate = rate

    def lower(self, ff, inputs):
        return ff.dropout(inputs[0], self.rate, name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int,
                 input_length: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.input_length = input_length

    def compute_output_shape(self, input_shapes):
        return [tuple(input_shapes[0]) + (self.output_dim,)]

    def lower(self, ff, inputs):
        return ff.embedding(inputs[0], self.input_dim, self.output_dim,
                            name=self.name)


class LSTM(Layer):
    """Keras-style LSTM over (seq, features) inputs (batch excluded from
    shapes per KTensor convention), lowered onto FFModel.lstm
    (ops/recurrent.py)."""

    def __init__(self, units: int, return_sequences: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.units = units
        self.return_sequences = return_sequences

    def compute_output_shape(self, input_shapes):
        (shape,) = input_shapes
        if len(shape) != 2:
            raise ValueError(f"LSTM expects (seq, features), got {shape}")
        if self.return_sequences:
            return [(shape[0], self.units)]
        return [(self.units,)]

    def lower(self, ff, inputs):
        return ff.lstm(inputs[0], self.units,
                       return_sequences=self.return_sequences, name=self.name)


class Activation(Layer):
    def __init__(self, activation, name: Optional[str] = None):
        super().__init__(name)
        self.activation = activation

    def lower(self, ff, inputs):
        x = inputs[0]
        if self.activation == "softmax":
            return ff.softmax(x, name=self.name)
        act = _act(self.activation)
        fn = {ActiMode.RELU: ff.relu, ActiMode.SIGMOID: ff.sigmoid,
              ActiMode.TANH: ff.tanh, ActiMode.GELU: ff.gelu,
              ActiMode.NONE: ff.identity}[act]
        return fn(x, name=self.name)


class BatchNormalization(Layer):
    def __init__(self, relu: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.relu = relu

    def lower(self, ff, inputs):
        return ff.batch_norm(inputs[0], relu=self.relu, name=self.name)


class LayerNormalization(Layer):
    def __init__(self, epsilon: float = 1e-5, name: Optional[str] = None):
        super().__init__(name)
        self.epsilon = epsilon

    def lower(self, ff, inputs):
        rank = inputs[0].shape.logical_rank
        return ff.layer_norm(inputs[0], [rank - 1], eps=self.epsilon,
                             name=self.name)


class Reshape(Layer):
    def __init__(self, target_shape: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        self.target = tuple(target_shape)

    def compute_output_shape(self, input_shapes):
        return [self.target]

    def lower(self, ff, inputs):
        batch = inputs[0].shape.logical_shape[0]
        return ff.reshape(inputs[0], (batch,) + self.target, name=self.name)


class Permute(Layer):
    def __init__(self, dims: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        self.dims = tuple(dims)  # keras convention: 1-indexed, no batch

    def compute_output_shape(self, input_shapes):
        s = input_shapes[0]
        return [tuple(s[d - 1] for d in self.dims)]

    def lower(self, ff, inputs):
        perm = (0,) + tuple(d for d in self.dims)
        return ff.transpose(inputs[0], perm, name=self.name)


class _Merge(Layer):
    def compute_output_shape(self, input_shapes):
        return [input_shapes[0]]


class Add(_Merge):
    def lower(self, ff, inputs):
        out = inputs[0]
        for t in inputs[1:]:
            out = ff.add(out, t, name=None)
        return out


class Subtract(_Merge):
    def lower(self, ff, inputs):
        assert len(inputs) == 2
        return ff.subtract(inputs[0], inputs[1], name=self.name)


class Multiply(_Merge):
    def lower(self, ff, inputs):
        out = inputs[0]
        for t in inputs[1:]:
            out = ff.multiply(out, t, name=None)
        return out


class Concatenate(Layer):
    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def compute_output_shape(self, input_shapes):
        # Keras axes are batch-INCLUSIVE; KTensor shapes exclude batch,
        # so batch-inclusive axis k maps to shape index k-1.
        full_rank = len(input_shapes[0]) + 1
        axis = self.axis if self.axis >= 0 else full_rank + self.axis
        if axis == 0:
            raise ValueError("Concatenate along the batch axis is not supported")
        out = list(input_shapes[0])
        out[axis - 1] = sum(s[axis - 1] for s in input_shapes)
        return [tuple(out)]

    def lower(self, ff, inputs):
        # FFModel axes include batch, matching Keras's convention directly
        return ff.concat(inputs, self.axis, name=self.name)
