"""Keras-style data preprocessing (flexflow_tpu/keras/preprocessing):
self-contained numpy implementations of the keras_preprocessing API,
copied so that the port imports nothing of flexflow_tpu.
"""
from . import sequence, text
from .sequence import make_sampling_table, pad_sequences, skipgrams
from .text import Tokenizer, one_hot, text_to_word_sequence

__all__ = [
    "sequence", "text", "pad_sequences", "make_sampling_table",
    "skipgrams", "Tokenizer", "one_hot", "text_to_word_sequence",
]
