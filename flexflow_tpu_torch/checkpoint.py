"""Plain numpy weight files (the npz half of flexflow_tpu/checkpoint.py)
and its durable-write helpers.

One flat .npz per model, a key `op/weight` per trainable weight, in the
reference's layout: a file written by either package loads into the
other.  `_write_json_fsync` and `_fsync_dir` are the verify-then-publish
writes the strategy store uses (store/store.py).  The checkpoint
managers and the Keras-style callback wait for the resilience layer
(ROADMAP §1 item 7).
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def save_weights_npz(ff, path: str):
    """The weights of `ff` as a flat .npz at `path`."""
    flat = {}
    for op_name, wdict in ff.get_weights().items():
        for wname, arr in wdict.items():
            flat[f"{op_name}/{wname}"] = np.asarray(arr)
    np.savez(path, **flat)


def load_weights_npz(ff, path: str):
    """Load a flat .npz into `ff`, checked name by name and shape by
    shape (FFModel.set_weights)."""
    nested: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            op_name, wname = key.rsplit("/", 1)
            nested.setdefault(op_name, {})[wname] = data[key]
    ff.set_weights(nested)


def _write_json_fsync(path: str, obj: Dict) -> None:
    """`obj` as JSON at `path`, flushed to the disk before returning."""
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Flush a directory's entries (a rename into it) to the disk."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # a platform without directory descriptors
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
