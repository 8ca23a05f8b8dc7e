"""Keras-style frontend of the port (flexflow_tpu/keras): Sequential and
the functional Model over the port's FFModel, the layer classes,
callbacks, the datasets and the preprocessing helpers, with the
reference's names.  A model runs on FFConfig.device ("cuda" unless the
config passed to the model says otherwise).

Layout convention: image tensors are channels_first (NCHW), as
FFModel.conv2d takes them.
"""
from . import datasets, preprocessing
from .callbacks import (Callback, EarlyStopping, LearningRateScheduler,
                        ProgbarLogger, VerifyMetrics)
from .layers import (LSTM, Activation, Add, AveragePooling2D,
                     BatchNormalization, Concatenate, Conv2D, Dense,
                     Dropout, Embedding, Flatten, Input, LayerNormalization,
                     MaxPooling2D, Multiply, Permute, Reshape, Subtract)
from .models import Model, Sequential

__all__ = [
    "Activation", "Add", "AveragePooling2D", "BatchNormalization",
    "Callback", "Concatenate", "Conv2D", "Dense", "Dropout",
    "EarlyStopping", "Embedding", "Flatten", "Input",
    "LayerNormalization", "LearningRateScheduler", "LSTM", "MaxPooling2D",
    "Model", "Multiply", "Permute", "ProgbarLogger", "Reshape",
    "Sequential", "Subtract", "VerifyMetrics", "datasets", "preprocessing",
]
