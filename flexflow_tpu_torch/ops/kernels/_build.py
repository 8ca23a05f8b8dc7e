"""Build and load the port's CUDA kernels.

Each source under `flexflow_tpu_torch/csrc/` becomes one shared library
with a plain C interface: nvcc compiles it for sm_90a at first use into
`flexflow_tpu_torch/_build/` (or the directory `set_build_dir` names:
the strategy store's kernel cache, store/enable_compilation_cache), and
ctypes loads it.  A library's name carries a hash of its source and of
the flags, so an edited source builds anew and one directory is safe to
share.  `build` starts one nvcc per missing library, all together, and
waits for them; nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# where the CUDA toolkit installs nvcc when it is not on PATH
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

class KernelLaunchError(RuntimeError):
    """A kernel did not launch: its library did not build or load, or
    its C entry point returned a CUDA error.  The serving replicas treat
    it as the death of their engine (serving/replica.py), never as a
    step to retry."""


_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()
# nvcc processes this process has started (a cache hit starts none)
nvcc_runs = 0


def set_build_dir(path) -> Path:
    """Build and load the libraries under `path` from now on; a library
    this process has loaded already stays loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    return BUILD_DIR


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install location."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the port's CUDA kernels: nvcc was not found "
        "($CUDA_HOME/bin, $PATH or " + DEFAULT_NVCC + ")")


def library_path(source: Path) -> Path:
    """Where `source`'s library is built, keyed on its content and the
    flags."""
    src = Path(source).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libff_{Path(source).stem}_{tag[:16]}.so"


def build(*sources: Path) -> List[Path]:
    """Compile the libraries of `sources` that are not built yet, one
    nvcc process each, started together; returns their paths in order."""
    global nvcc_runs
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if not todo:
        return outs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in todo:
        nvcc_runs += 1
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) building "
                            f"{src}:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build `source` (at first use) and load its library once per
    process; `bind` declares the entry points' argtypes and restypes.
    Every kernel launch calls this, so a loaded library costs one dict
    lookup."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            try:
                lib = ctypes.CDLL(str(build(source)[0]))
            except (RuntimeError, OSError) as e:
                raise KernelLaunchError(
                    f"{Path(source).name}: {e}") from e
            lib.ff_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ff_cuda_error_string.restype = ctypes.c_char_p
            bind(lib)
            _libs[source] = lib
        return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise KernelLaunchError if a C entry point returned a CUDA
    error."""
    if rc != 0:
        raise KernelLaunchError(
            f"{what} kernel launch failed: CUDA error {rc} "
            f"({lib.ff_cuda_error_string(rc).decode()})")
