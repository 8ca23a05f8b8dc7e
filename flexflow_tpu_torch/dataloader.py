"""Batches for `FFModel.fit` (flexflow_tpu/dataloader.py).

`SingleDataLoader` holds the whole numpy dataset on the host and hands
out one batch at a time, moved to the model's device, in the
reference's order: `shuffle_indices(n, seed + epoch + 1)` per epoch, or
the identity.  The shuffle is the reference's xorshift64
Fisher-Yates, in Python (`_py_shuffle`, the mirror of its native
`ffdl_shuffle_indices`), so `fit(shuffle=True)` visits the same batches
as the reference.  There is no native gather and no prefetch thread.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch


def _py_shuffle(n: int, seed: int) -> np.ndarray:
    """Fisher-Yates over arange(n) driven by xorshift64 (13, 7, 17),
    seed 0 replaced by the golden-ratio constant."""
    idx = np.arange(n, dtype=np.int64)
    s = np.uint64(seed if seed else 0x9E3779B97F4A7C15)
    mask = np.uint64(0xFFFFFFFFFFFFFFFF)
    for i in range(n - 1, 0, -1):
        s = (s ^ (s << np.uint64(13))) & mask
        s = s ^ (s >> np.uint64(7))
        s = (s ^ (s << np.uint64(17))) & mask
        j = int(s % np.uint64(i + 1))
        idx[i], idx[j] = idx[j], idx[i]
    return idx


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    return _py_shuffle(n, seed)


def to_device(arr, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array (or tensor) on `device`.  Without `dtype`, 64-bit
    floats and ints narrow to 32 bits, as the reference's arrays do with
    JAX's 64-bit mode off."""
    t = arr if torch.is_tensor(arr) else torch.from_numpy(np.asarray(arr))
    if dtype is None:
        dtype = {torch.float64: torch.float32,
                 torch.int64: torch.int32}.get(t.dtype, t.dtype)
    return t.to(device=device, dtype=dtype)


class SingleDataLoader:
    """Batched, optionally shuffled loader bound to a compiled FFModel.
    API of the reference: num_samples, num_batches, next_batch, reset,
    iteration by epochs."""

    def __init__(self, ff, x: Union[np.ndarray, Dict[str, np.ndarray]],
                 y: np.ndarray, batch_size: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0):
        self.ff = ff
        input_ops = ff.layers.source_ops()
        if isinstance(x, dict):
            self.x_map = {k: np.ascontiguousarray(v) for k, v in x.items()}
        else:
            self.x_map = {input_ops[0].name: np.ascontiguousarray(x)}
        self.y = np.ascontiguousarray(y)
        self.num_samples = len(self.y)
        for k, v in self.x_map.items():
            if len(v) != self.num_samples:
                raise ValueError(f"input {k} has {len(v)} samples, labels "
                                 f"have {self.num_samples}")
        self.batch_size = batch_size or ff.config.batch_size
        self.num_batches = self.num_samples // self.batch_size
        if self.num_batches == 0:
            raise ValueError(
                f"dataset of {self.num_samples} samples smaller than batch "
                f"size {self.batch_size}")
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = -1  # the first reset() brings it to 0
        self._order = np.arange(self.num_samples, dtype=np.int64)
        self._next_index = 0
        self.reset()

    def reset(self):
        """Start the next epoch; each call advances the shuffle order."""
        self._epoch += 1
        if self.shuffle:
            self._order = shuffle_indices(self.num_samples,
                                          self.seed + self._epoch + 1)
        self._next_index = 0

    def next_batch(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(inputs, labels) of the next batch, on the model's device."""
        if self._next_index >= self.num_batches:
            raise StopIteration
        b = self._next_index
        self._next_index += 1
        idx = self._order[b * self.batch_size:(b + 1) * self.batch_size]
        return self.ff.put_batch(
            {k: np.take(v, idx, axis=0) for k, v in self.x_map.items()},
            np.take(self.y, idx, axis=0))

    def __iter__(self) -> Iterator[Tuple[Dict[str, torch.Tensor],
                                         torch.Tensor]]:
        if self._next_index > 0:
            self.reset()
        for _ in range(self.num_batches):
            yield self.next_batch()

    def __len__(self) -> int:
        return self.num_batches
