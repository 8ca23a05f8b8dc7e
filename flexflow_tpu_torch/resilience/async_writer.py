"""The background checkpoint writer (flexflow_tpu/resilience/
async_writer.py): serialization, fsync and publish off the step path.

A checkpoint manager's `save(wait=False)` copies the train state to the
host (the only stall of the step loop), then hands the write (npz
encode, fsync, checksum verification, atomic publish) to this writer,
and training goes on while it runs.

  * jobs run in order on one daemon thread, so step N's checkpoint
    publishes before step N+1's (LATEST never goes back);
  * a failing job (a full disk, a verify mismatch) kills neither the
    writer nor the training loop: the exception is logged, kept, and
    returned by the next `drain()`;
  * `drain()` blocks until every submitted job has finished; fit drains
    its checkpoint callbacks' managers in its `finally`.
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional, Tuple

_log = logging.getLogger("flexflow_tpu_torch.checkpoint")

_SENTINEL = object()


class AsyncCheckpointWriter:
    """One daemon thread that runs a FIFO queue of write jobs."""

    def __init__(self, name: str = "ckpt-writer"):
        self.name = name
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._failures: List[Tuple[int, Exception]] = []
        # called with the queue depth at every submit and completion (the
        # manager points it at resilience/ckpt_queue_depth)
        self.depth_cb: Optional[Callable[[int], None]] = None

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                step, fn = item
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 - kept for drain()
                    _log.warning("async checkpoint write for step %d "
                                 "failed: %s", step, e)
                    with self._lock:
                        self._failures.append((step, e))
            finally:
                self._q.task_done()
                self._notify_depth()

    def _notify_depth(self) -> None:
        cb = self.depth_cb
        if cb is not None:
            try:
                cb(self._q.unfinished_tasks)
            except Exception:  # a telemetry fault never breaks the writer
                pass

    def submit(self, step: int, fn: Callable[[], None]) -> None:
        """Queue one write job (`fn` holds the state already copied);
        returns at once."""
        self._ensure_thread()
        self._q.put((step, fn))
        self._notify_depth()

    @property
    def queue_depth(self) -> int:
        return self._q.unfinished_tasks

    def wait(self) -> None:
        """Block until every submitted job has run; the failures stay for
        the owner's drain()."""
        if self._thread is not None:
            self._q.join()

    def drain(self) -> List[Tuple[int, Exception]]:
        """Block until every submitted job has run; return (and clear) the
        (step, error) failures since the last drain."""
        self.wait()
        with self._lock:
            failures, self._failures = self._failures, []
        return failures

    def close(self) -> List[Tuple[int, Exception]]:
        """Drain, stop the thread and return the failures left.  Safe to
        call twice; a later submit() starts a thread again."""
        failures = self.drain()
        if self._thread is not None and self._thread.is_alive():
            self._q.put(_SENTINEL)
            self._thread.join(timeout=10.0)
        self._thread = None
        return failures
