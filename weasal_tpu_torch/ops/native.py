"""The native host geometry library: ctypes bindings and its build.

Counterpart of weasal_tpu/ops/native.py. The source is the port's own
copy, `weasal_tpu_torch/cpp/geometry.cpp` (the same code as the JAX
package's), built by `g++` at first use into `weasal_tpu_torch/_build/
libwslgeometry.so` (a directory git ignores) and loaded with `ctypes`:
a plain C interface, no Python headers. The build writes a temporary
file and renames it, so processes that build at once never load a torn
library. Nothing is built or loaded when this module is imported.

`ops/subsample.grid_subsample` and the fixed-width `ops/neighbors.
radius_search` call it where the JAX package does; where it cannot be
built, or with `WEASAL_NO_NATIVE` set, `available()` is False and they
run their numpy / scipy versions.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "cpp" / "geometry.cpp"
LIBRARY = _PKG_DIR / "_build" / "libwslgeometry.so"
# The JAX package's flags (weasal_tpu/ops/native.py:33)
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_failed = False


def _build() -> bool:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as exc:
        print(f"native geometry build failed ({exc}); using the numpy "
              "versions")
        return False
    os.replace(tmp, LIBRARY)
    return True


def get_lib():
    """The loaded library (built first when missing or older than its
    source), or None where it cannot be built or `WEASAL_NO_NATIVE` is
    set."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if os.environ.get("WEASAL_NO_NATIVE"):
            _failed = True
            return None
        stale = (not LIBRARY.exists()
                 or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime)
        if stale and not _build():
            _failed = True
            return None
        lib = ctypes.CDLL(str(LIBRARY))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.wsl_grid_subsample.restype = ctypes.c_int
        lib.wsl_grid_subsample.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64, i32p,
            ctypes.c_float, f32p, f32p, i32p, ctypes.c_int64]
        lib.wsl_radius_search.restype = None
        lib.wsl_radius_search.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int64, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def grid_subsample_native(points: np.ndarray, dl: float, *,
                          features=None, labels=None, max_out: int = 0):
    """Voxel subsample with the contract of ops/subsample.grid_subsample
    (linear voxel order, barycenters, feature means, majority labels,
    ties to the smallest label); `max_out` > 0 keeps the first voxels."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native geometry library is not available")
    points = np.ascontiguousarray(points, dtype=np.float32)
    n = points.shape[0]
    fdim = 0
    if features is not None:
        features = np.ascontiguousarray(features, dtype=np.float32)
        if features.ndim == 1:
            features = features[:, None]
        fdim = features.shape[1]
    l_in = None
    if labels is not None:
        l_in = np.ascontiguousarray(np.squeeze(labels), dtype=np.int32)

    cap = max_out if max_out > 0 else n
    out_points = np.empty((cap, 3), np.float32)
    out_features = np.empty((cap, fdim), np.float32) if fdim else None
    out_labels = np.empty((cap,), np.int32) if l_in is not None else None
    count = lib.wsl_grid_subsample(
        _fptr(points), n, _fptr(features) if fdim else None, fdim,
        _iptr(l_in) if l_in is not None else None, ctypes.c_float(dl),
        _fptr(out_points), _fptr(out_features) if fdim else None,
        _iptr(out_labels) if out_labels is not None else None, cap)

    out = [out_points[:count]]
    if fdim:
        out.append(out_features[:count])
    if out_labels is not None:
        out.append(out_labels[:count])
    return out[0] if len(out) == 1 else tuple(out)


def radius_search_native(queries: np.ndarray, supports: np.ndarray,
                         radius: float, max_count: int) -> np.ndarray:
    """int32 [Nq, max_count] rows of the supports within `radius` (f32
    squared distances), sorted by distance, ties by index, padded with
    len(supports)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native geometry library is not available")
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    supports = np.ascontiguousarray(supports, dtype=np.float32)
    out = np.empty((queries.shape[0], max_count), np.int32)
    lib.wsl_radius_search(_fptr(queries), queries.shape[0],
                          _fptr(supports), supports.shape[0],
                          ctypes.c_float(radius), max_count, _iptr(out))
    return out
