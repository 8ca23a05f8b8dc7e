"""Sequence preprocessing: the keras_preprocessing.sequence API in
numpy (a copy of flexflow_tpu/keras/preprocessing/sequence.py)."""
from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np


def pad_sequences(sequences, maxlen: Optional[int] = None,
                  dtype: str = "int32", padding: str = "pre",
                  truncating: str = "pre", value=0.0) -> np.ndarray:
    """Pad/truncate a list of token-id lists to a [n, maxlen] array:
    the fixed-shape batch the graph's input tensor takes."""
    if padding not in ("pre", "post") or truncating not in ("pre", "post"):
        raise ValueError(
            f"padding/truncating must be 'pre' or 'post', got "
            f"{padding!r}/{truncating!r}"
        )
    seqs = [list(s) for s in sequences]
    if maxlen is None:
        maxlen = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), maxlen), value, dtype=dtype)
    for i, s in enumerate(seqs):
        if not s:
            continue
        trunc = s[-maxlen:] if truncating == "pre" else s[:maxlen]
        if padding == "pre":
            out[i, maxlen - len(trunc):] = trunc
        else:
            out[i, :len(trunc)] = trunc
    return out


def make_sampling_table(size: int, sampling_factor: float = 1e-5) -> np.ndarray:
    """Word-rank -> keep-probability table for skipgram subsampling
    (Mikolov et al. 2013 frequency-based subsampling under a Zipf
    assumption, the keras_preprocessing formula)."""
    gamma = 0.577
    rank = np.arange(size)
    rank[0] = 1
    inv_fq = rank * (np.log(rank) + gamma) + 0.5 - 1.0 / (12.0 * rank)
    f = sampling_factor * inv_fq
    return np.minimum(1.0, f / np.sqrt(f))


def skipgrams(sequence: Sequence[int], vocabulary_size: int,
              window_size: int = 4, negative_samples: float = 1.0,
              shuffle: bool = True, categorical: bool = False,
              sampling_table: Optional[np.ndarray] = None,
              seed: Optional[int] = None):
    """(couples, labels) skipgram pairs with sampled negatives."""
    couples: List[List[int]] = []
    labels: List = []
    for i, wi in enumerate(sequence):
        if not wi:
            continue
        if sampling_table is not None:
            if sampling_table[wi] < random.random():
                continue
        lo = max(0, i - window_size)
        for j in range(lo, min(len(sequence), i + window_size + 1)):
            if j == i:
                continue
            wj = sequence[j]
            if not wj:
                continue
            couples.append([wi, wj])
            labels.append([0, 1] if categorical else 1)
    if negative_samples > 0:
        num_neg = int(len(labels) * negative_samples)
        words = [c[0] for c in couples]
        random.shuffle(words)
        couples += [
            [words[i % len(words)], random.randint(1, vocabulary_size - 1)]
            for i in range(num_neg)
        ]
        labels += [[1, 0] if categorical else 0] * num_neg
    if shuffle:
        if seed is None:
            seed = random.randint(0, 10**6)
        random.Random(seed).shuffle(couples)
        random.Random(seed).shuffle(labels)
    return couples, labels
