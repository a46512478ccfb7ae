"""Build and load the hand-written Hopper kernels.

Each source `weasal_tpu_torch/csrc/<name>.cu` has a plain C interface
(device code shared between sources lives in `csrc/*.cuh`) and is
compiled by `nvcc` for `sm_90a` into `weasal_tpu_torch/_build/
lib<name>.so` (a directory git ignores), then loaded with `ctypes`.
Nothing includes PyTorch's headers, so a build takes seconds. A library
is built at first use, or by `build_all()`, which runs one `nvcc` per
source in parallel. Nothing is built or loaded when this module is
imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("radius_search", "kpconv_fwd", "kpconv_bwd", "maxpool_bwd",
           "inverse_lists", "marks", "deform_kpconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of weasal_tpu_torch "
                       "are built on the machine with the card")


def _paths(name: str):
    return CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header (`csrc/*.cuh`)."""
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in (src, *CSRC_DIR.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def _start(name: str, verbose: bool):
    """Start nvcc on one source; returns (process, temp output, library)."""
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, job) -> str:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)
    return out


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every stale source (every source when `verbose`), one nvcc
    process each, all at once. Returns the compiler output per source,
    with register and shared-memory use when `verbose`."""
    with _lock:
        jobs = {n: _start(n, verbose) for n in SOURCES
                if verbose or _stale(n)}
        return {n: _finish(n, job) for n, job in jobs.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first when stale.
    Raises when CUDA or nvcc is missing."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel library {name!r} needs a CUDA device")
    with _lock:
        if name in _libs:
            return _libs[name]
        if _stale(name):
            _finish(name, _start(name, verbose=False))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
