"""Batches for `FFModel.fit` (flexflow_tpu/dataloader.py).

`SingleDataLoader` holds the whole numpy dataset on the host and hands
out one batch at a time, on the model's device, in the reference's
order: `shuffle_indices(n, seed + epoch + 1)` per epoch, or the
identity.  The shuffle is the reference's xorshift64 Fisher-Yates, in
Python (`_py_shuffle`, the mirror of its native
`ffdl_shuffle_indices`), so `fit(shuffle=True)` visits the same batches
as the reference.

As in the reference, a background thread keeps a bounded queue of
`prefetch` batches ready.  It gathers each batch's rows with
`torch.index_select` on a `torch.from_numpy` view of the dataset, which
gives the rows of the reference's native `ffdl_gather_rows` and
releases the GIL while it copies.  On a CUDA device the rows land in a
ring of pinned staging buffers (`prefetch + 2` of them), each copied to
the card with `non_blocking=True` on a stream of the loader's own, with
an event recorded after the copy; a buffer is gathered into again only
once its last copy's event has completed.  `next_batch` makes the
current stream wait on the batch's event and records the batch's
tensors on that stream, so the caching allocator keeps them until the
step that reads them is done.  On the CPU the same thread and queue
run, without pinning and without a stream.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

# the host-side narrowing of JAX's arrays with its 64-bit mode off
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


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
        dtype = _NARROW.get(t.dtype, t.dtype)
    return t.to(device=device, dtype=dtype)


class _Staging:
    """One pinned host buffer per loader tensor, and the event of the
    last copy out of them (None until the first)."""

    def __init__(self, shapes: Dict[str, Tuple[Tuple[int, ...],
                                                torch.dtype]]):
        self.host = {k: torch.empty(shape, dtype=dtype, pin_memory=True)
                     for k, (shape, dtype) in shapes.items()}
        self.copied: Optional[torch.cuda.Event] = None


class SingleDataLoader:
    """Batched, optionally shuffled, prefetching loader bound to a
    compiled FFModel.  API of the reference: num_samples, num_batches,
    next_batch, reset, iteration by epochs."""

    def __init__(self, ff, x: Union[np.ndarray, Dict[str, np.ndarray]],
                 y: np.ndarray, batch_size: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0, prefetch: int = 2,
                 index: Optional[Dict[Optional[str], Tuple[slice, ...]]]
                 = None):
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
        self.prefetch = max(1, prefetch)
        self.device = torch.device(ff.device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            # the worker thread selects the device by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        # each input in its input tensor's dtype (put_batch's rule), the
        # labels narrowed; None is the label's key
        dtypes = {op.name: op.outputs[0].dtype.torch_dtype
                  for op in input_ops}
        self._src: Dict[Optional[str], torch.Tensor] = {
            k: torch.from_numpy(v) for k, v in self.x_map.items()}
        self._src[None] = torch.from_numpy(self.y)
        self._dtype = {k: dtypes.get(k) or _NARROW.get(t.dtype, t.dtype)
                       for k, t in self._src.items()}
        # on a torch.distributed group each rank loads its shard of every
        # batch: an index into one global batch per tensor (fit passes
        # its feed layout's; None is the labels' key)
        self._index = {}
        for k, t in self._src.items():
            first, *rest = (index or {}).get(k, (slice(0, self.batch_size),))
            if rest == [slice(0, n) for n in t.shape[1:1 + len(rest)]]:
                rest = []  # only rows: gathered straight into staging
            self._index[k] = (first, *rest)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        self._ring: Optional[list] = None  # the CUDA worker's staging
        self._epoch = -1  # the first reset() brings it to 0
        self._order = np.arange(self.num_samples, dtype=np.int64)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._next_index = 0
        self.reset()

    # -- reference API ---------------------------------------------------
    def reset(self):
        """Start the next epoch; each call advances the shuffle order.  A
        worker still filling the last epoch is cancelled first."""
        self._stop_worker()
        self._epoch += 1
        if self.shuffle:
            self._order = shuffle_indices(self.num_samples,
                                          self.seed + self._epoch + 1)
        self._next_index = 0
        self._queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(self._queue, self._stop, self._order),
            daemon=True)
        self._thread.start()

    def next_batch(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(inputs, labels) of the next batch, on the model's device,
        ready for the current stream.  An exception of the worker
        surfaces here."""
        if self._next_index >= self.num_batches:
            raise StopIteration
        self._next_index += 1
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        batch, copied = item
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in batch.values():
                t.record_stream(stream)
        labels = batch.pop(None)
        return batch, labels

    # -- iteration ---------------------------------------------------------
    def __iter__(self) -> Iterator[Tuple[Dict[str, torch.Tensor],
                                         torch.Tensor]]:
        if self._next_index > 0 or self._thread is None:
            self.reset()
        for _ in range(self.num_batches):
            yield self.next_batch()

    def __len__(self) -> int:
        return self.num_batches

    # -- internals ---------------------------------------------------------
    def _gather(self, idx: torch.Tensor, out: Optional[dict]) -> dict:
        """Each tensor's shard of the batch of rows idx, in its loader
        dtype: into the staging buffers `out` when given, else into new
        tensors."""
        rows = {}
        batch = idx
        for k, src in self._src.items():
            first, *rest = self._index[k]
            idx = batch[first]
            dst = None if out is None else out[k]
            if rest:
                got = torch.index_select(src, 0, idx)[(slice(None),)
                                                      + tuple(rest)]
                got = got.to(self._dtype[k])
                rows[k] = got if dst is None else dst.copy_(got)
            elif src.dtype == self._dtype[k]:
                rows[k] = (torch.index_select(src, 0, idx) if dst is None
                           else torch.index_select(src, 0, idx, out=dst))
            else:
                got = torch.index_select(src, 0, idx).to(self._dtype[k])
                rows[k] = got if dst is None else dst.copy_(got)
        return rows

    def _shard_shape(self, k, t: torch.Tensor) -> Tuple[int, ...]:
        """The shape of tensor k's shard of one batch."""
        full = (self.batch_size,) + tuple(t.shape[1:])
        index = self._index[k] + (slice(None),) * len(full)
        return tuple(len(range(n)[sl]) for n, sl in zip(full, index))

    def _staging(self, b: int) -> _Staging:
        """Batch b's slot of the ring, pinned at its first use (so the
        first batch waits for one buffer, not for the whole ring)."""
        if self._ring is None:
            self._ring = [None] * (self.prefetch + 2)
        i = b % len(self._ring)
        if self._ring[i] is None:
            self._ring[i] = _Staging(
                {k: (self._shard_shape(k, t), self._dtype[k])
                 for k, t in self._src.items()})
        return self._ring[i]

    def _put(self, out_queue: "queue.Queue", item,
             stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                out_queue.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def _worker(self, out_queue: "queue.Queue", stop: threading.Event,
                order: np.ndarray):
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            for b in range(self.num_batches):
                if stop.is_set():
                    return
                idx = torch.from_numpy(
                    order[b * self.batch_size:(b + 1) * self.batch_size])
                if not self._cuda:
                    self._put(out_queue, (self._gather(idx, None), None),
                              stop)
                    continue
                slot = self._staging(b)
                if slot.copied is not None:
                    slot.copied.synchronize()  # its last copy has landed
                host = self._gather(idx, slot.host)
                with torch.cuda.stream(self._stream):
                    batch = {k: h.to(self.device, non_blocking=True)
                             for k, h in host.items()}
                    copied = torch.cuda.Event()
                    copied.record(self._stream)
                slot.copied = copied
                self._put(out_queue, (batch, copied), stop)
        except Exception as e:  # surfaced by next_batch
            self._put(out_queue, e, stop)

    def _stop_worker(self):
        """Cancel the worker: it exits after at most the batch it is
        assembling, and the batches it queued are dropped."""
        t = self._thread
        if t is not None and t.is_alive():
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30.0)
        self._thread = None
