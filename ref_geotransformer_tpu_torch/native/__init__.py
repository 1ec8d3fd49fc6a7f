"""ctypes bindings of the host C++ geometry kernels (`geoops.cpp`).

Counterpart of `ref_geotransformer_tpu/native/__init__.py`: the same C ABI
and the same signatures, numpy in and out. This is host preprocessing
(offline voxel downsampling, an oracle for the card's pyramid), not a card
kernel.

The library is built with g++ on first use, with the JAX package's flags
(`-O3 -std=c++17 -shared -fPIC`, no `-march=native`, no `-ffast-math`, so the
float sums come out bit-identical to its build), into `native/build/`, and
again when the source is newer than the library. Each process links to a
name of its own and then renames it into place, so that test workers and
spawned ranks may build at the same moment. Importing this module builds
nothing; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "geoops.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
LIBRARY = os.path.join(BUILD_DIR, "libgeoops.so")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the library if it is missing or older than its source; returns its path."""
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return LIBRARY
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native geometry kernels (native/geoops.cpp)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        lib.gt_grid_subsample.restype = ctypes.c_int64
        lib.gt_grid_subsample.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.gt_radius_neighbors.restype = None
        lib.gt_radius_neighbors.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_float,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return lib


def _points(a: np.ndarray, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{name}: expected an (N, 3) array, got shape {a.shape}")
    return a


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def grid_subsample_native(points: np.ndarray, voxel_size: float, capacity: Optional[int] = None
                          ) -> Tuple[np.ndarray, int]:
    """Voxel-grid centroids, in voxel-key order. Returns (s_points (K, 3),
    total_voxel_count); K = min(total, capacity)."""
    points = _points(points, "points")
    n = points.shape[0]
    cap = n if capacity is None else int(capacity)
    if cap < 0:
        raise ValueError(f"capacity must be >= 0, got {cap}")
    lib = _load()
    out = np.empty((cap, 3), np.float32)
    total = ctypes.c_int64(0)
    written = lib.gt_grid_subsample(_fptr(points), n, ctypes.c_float(voxel_size), _fptr(out), cap,
                                    ctypes.byref(total))
    return out[:written].copy(), int(total.value)


def radius_neighbors_native(q_points: np.ndarray, s_points: np.ndarray, radius: float, limit: int) -> np.ndarray:
    """(nq, limit) int32 neighbor indices, distance-sorted, sentinel == ns."""
    q_points = _points(q_points, "q_points")
    s_points = _points(s_points, "s_points")
    limit = int(limit)
    if limit < 0:
        raise ValueError(f"limit must be >= 0, got {limit}")
    lib = _load()
    out = np.empty((q_points.shape[0], limit), np.int32)
    lib.gt_radius_neighbors(_fptr(q_points), q_points.shape[0], _fptr(s_points), s_points.shape[0],
                            ctypes.c_float(radius), limit, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
