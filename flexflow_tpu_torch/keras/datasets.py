"""Keras-style datasets: cifar10, mnist and reuters (a copy of
flexflow_tpu/keras/datasets.py, numpy only).

Each loader first looks for a cached copy under the directory named by
FLEXFLOW_KERAS_CACHE (default ``~/.keras/datasets``, the standard Keras
cache layout) and otherwise returns deterministic synthetic data of the
real shapes, dtypes and label ranges, flagged by the loader's
``synthetic`` attribute.  CIFAR-10 also reads the canonical
cifar-10-python.tar.gz, of which examples/data/cifar10_sample.tar.gz is
a sample shard.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_CACHE = os.environ.get("FLEXFLOW_KERAS_CACHE",
                        os.path.expanduser("~/.keras/datasets"))


def _parse_cifar_batch(fh):
    """One pickled CIFAR batch (the canonical cifar-10-python.tar.gz
    member format keras/src/datasets/cifar.py parses): dict with
    b'data' [N, 3072] uint8 rows (RGB planes) and b'labels'."""
    import pickle

    d = pickle.load(fh, encoding="bytes")
    data = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
    labels = np.asarray(d[b"labels"], np.int64).reshape(-1, 1)
    return data, labels


def _load_cifar_tar(path):
    """Parse the canonical CIFAR-10 python tarball: train batches
    data_batch_1..5 + test_batch, any subset accepted (a vendored
    sample shard carries fewer)."""
    import tarfile

    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    with tarfile.open(path, "r:*") as tar:
        for m in sorted(tar.getmembers(), key=lambda m: m.name):
            base = os.path.basename(m.name)
            if base.startswith("data_batch"):
                x, y = _parse_cifar_batch(tar.extractfile(m))
                xs_tr.append(x)
                ys_tr.append(y)
            elif base == "test_batch":
                x, y = _parse_cifar_batch(tar.extractfile(m))
                xs_te.append(x)
                ys_te.append(y)
    if not xs_tr:
        raise ValueError(f"{path}: no data_batch members")
    xtr = np.concatenate(xs_tr)
    ytr = np.concatenate(ys_tr)
    xte = np.concatenate(xs_te) if xs_te else xtr[:0]
    yte = np.concatenate(ys_te) if ys_te else ytr[:0]
    return (xtr, ytr), (xte, yte)


def _synthetic_images(n, shape, classes, seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, size=(n, 1)).astype(np.int64)
    x = np.zeros((n,) + shape, np.uint8)
    # class-dependent blobs so models can actually fit the data
    for c in range(classes):
        idx = np.nonzero(y[:, 0] == c)[0]
        base = rng.randint(0, 200, size=shape)
        x[idx] = np.clip(
            base[None] + rng.randint(-40, 40, size=(len(idx),) + shape), 0, 255
        ).astype(np.uint8)
    return x, y


class _Loader:
    synthetic = True


def _npz(path):
    try:
        return np.load(path, allow_pickle=True)
    except (OSError, ValueError):
        return None


class cifar10:
    """(50000, 3, 32, 32) uint8 train / (10000, ...) test, labels [0,10)."""

    synthetic = False

    @staticmethod
    def load_data(num_samples: int = 50000
                  ) -> Tuple[Tuple[np.ndarray, np.ndarray],
                             Tuple[np.ndarray, np.ndarray]]:
        # canonical format first: cifar-10-python.tar.gz (pickled
        # batches), the file the real keras loader downloads and parses
        tar_path = os.path.join(_CACHE, "cifar-10-python.tar.gz")
        if os.path.exists(tar_path):
            (xtr, ytr), (xte, yte) = _load_cifar_tar(tar_path)
            cifar10.synthetic = False
            return (xtr[:num_samples], ytr[:num_samples]), (xte, yte)
        cached = _npz(os.path.join(_CACHE, "cifar10.npz"))
        if cached is not None:
            cifar10.synthetic = False
            return ((cached["x_train"][:num_samples],
                     cached["y_train"][:num_samples]),
                    (cached["x_test"], cached["y_test"]))
        cifar10.synthetic = True
        n_test = max(1, num_samples // 5)
        xtr, ytr = _synthetic_images(num_samples, (3, 32, 32), 10, seed=0)
        xte, yte = _synthetic_images(n_test, (3, 32, 32), 10, seed=1)
        return (xtr, ytr), (xte, yte)


class mnist:
    """(60000, 28, 28) uint8 train / (10000, 28, 28) test, labels [0,10)."""

    synthetic = False

    @staticmethod
    def load_data(num_samples: int = 60000):
        cached = _npz(os.path.join(_CACHE, "mnist.npz"))
        if cached is not None:
            mnist.synthetic = False
            return ((cached["x_train"][:num_samples],
                     cached["y_train"][:num_samples]),
                    (cached["x_test"], cached["y_test"]))
        mnist.synthetic = True
        n_test = max(1, num_samples // 6)
        xtr, ytr = _synthetic_images(num_samples, (28, 28), 10, seed=2)
        xte, yte = _synthetic_images(n_test, (28, 28), 10, seed=3)
        return (xtr, ytr[:, 0]), (xte, yte[:, 0])


class reuters:
    """Newswire topic classification: variable-length int sequences,
    46 classes (returned pre-padded to maxlen for the synthetic path)."""

    synthetic = False
    num_classes = 46

    @staticmethod
    def load_data(num_words: int = 10000, maxlen: int = 200,
                  num_samples: int = 8982):
        cached = _npz(os.path.join(_CACHE, "reuters.npz"))
        if cached is not None:
            reuters.synthetic = False

            def norm(x, y, n):
                # the cache stores ragged object arrays of full-vocab
                # ids; out-of-vocab ids map to Keras's oov_char (2).
                # Deviation from the real loader: over-length sequences
                # are truncated to maxlen rather than dropped.
                x, y = x[:n], np.asarray(y[:n])
                out = np.zeros((len(x), maxlen), np.int64)
                for i, seq in enumerate(x):
                    seq = np.asarray(seq, np.int64)[:maxlen]
                    seq = np.where(seq < num_words, seq, 2)
                    out[i, : len(seq)] = seq
                return out, y

            return (norm(cached["x_train"], cached["y_train"], num_samples),
                    norm(cached["x_test"], cached["y_test"], len(cached["x_test"])))
        reuters.synthetic = True
        rng = np.random.RandomState(4)
        n_test = max(1, num_samples // 4)

        def make(n, seed):
            r = np.random.RandomState(seed)
            y = r.randint(0, reuters.num_classes, size=n).astype(np.int64)
            # topic-dependent word distributions
            x = np.zeros((n, maxlen), np.int64)
            for i in range(n):
                center = (y[i] + 1) * (num_words // (reuters.num_classes + 1))
                length = r.randint(maxlen // 4, maxlen)
                words = np.clip(
                    r.normal(center, num_words / 20, size=length).astype(np.int64),
                    1, num_words - 1,
                )
                x[i, :length] = words
            return x, y

        return make(num_samples, 5), make(n_test, 6)
