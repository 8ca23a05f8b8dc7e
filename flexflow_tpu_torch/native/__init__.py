"""Native (C++) runtime components, loaded through ctypes.

`taskgraph_sim.cc` is the event loop of the task-graph simulator
(sim/taskgraph.py).  `get_lib` compiles it with g++ at first use into
`flexflow_tpu_torch/_build/` (a library name carrying a hash of the
source and the flags, so an edited source builds anew) and loads it;
nothing is built when a module is imported.  A failed compile raises.
Where no C++ compiler is found, `get_lib` logs that once and returns
None, and the simulator runs its pure-Python event loop, which has the
same semantics (and records which loop ran in its result).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "taskgraph_sim.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
ABI_VERSION = 1

_log = logging.getLogger("flexflow_tpu_torch.native")
_lock = threading.Lock()
_state = {"lib": None, "tried": False}


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libffsim_{tag[:16]}.so"


def build(cxx: str) -> Path:
    """Compile the library with `cxx` unless it is built; its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({r.returncode}) building "
                           f"{SOURCE}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None (logged once) when
    the machine has no C++ compiler."""
    with _lock:
        if _state["lib"] is not None or _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        cxx = os.environ.get("CXX") or shutil.which("g++") \
            or shutil.which("c++")
        if cxx is None and not library_path().exists():
            _log.warning("no C++ compiler found: the task-graph simulator "
                         "runs its pure-Python event loop")
            return None
        lib = ctypes.CDLL(str(build(cxx)))
        lib.ffsim_abi_version.restype = ctypes.c_int
        if lib.ffsim_abi_version() != ABI_VERSION:
            raise RuntimeError(
                f"{SOURCE.name}: ABI {lib.ffsim_abi_version()}, expected "
                f"{ABI_VERSION}")
        D, I32, I64 = (ctypes.POINTER(t) for t in (
            ctypes.c_double, ctypes.c_int32, ctypes.c_int64))
        lib.ffsim_simulate.argtypes = [
            ctypes.c_int64, D, I32, I64, I32,          # tasks, deps
            ctypes.c_int64, I32, I32, D, I64, I32,     # edges, routes
            ctypes.c_int64, D, D,                      # links
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double), D, D]
        lib.ffsim_simulate.restype = ctypes.c_int
        _state["lib"] = lib
        return lib
