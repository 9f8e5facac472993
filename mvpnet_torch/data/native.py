"""ctypes bindings for the native host data-path library (``native/host_index.cpp``).

The port's copy of ``mvpnet_tpu/data/native.py``: an xy CSR grid index for
chunk extraction over multi-million-point scenes, and greedy view selection.
The library is compiled from the repository's ``native/host_index.cpp`` with
``g++`` into the port's git-ignored ``mvpnet_torch/build/`` at first use
(nothing is written into ``native/``), and rebuilt when the source is newer.
Without a compiler every function takes its NumPy path, which gives the same
results (tests compare both). This is host code; no device op falls back.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG), "native", "host_index.cpp")
_LIB_PATH = os.path.join(_PKG, "build", "libmvpnet_host.so")
# portable flags: the library may be built on one host and loaded on another
_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lib = None
_tried = False
_lock = threading.Lock()


def _build() -> None:
    """Compile the source into a temporary name and rename it into place, so
    processes that build at once never load a half-written file."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", *_CXX_FLAGS, "-o", tmp, _SOURCE], check=True, capture_output=True, timeout=120
    )
    os.replace(tmp, _LIB_PATH)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = not os.path.exists(_LIB_PATH) or os.path.getmtime(_SOURCE) > os.path.getmtime(_LIB_PATH)
        if stale:
            try:
                _build()
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.grid_build.restype = ctypes.c_int64
        lib.grid_build.argtypes = [f32p, ctypes.c_int64, ctypes.c_double, i64p, i64p, f64p]
        lib.grid_query.restype = ctypes.c_int64
        lib.grid_query.argtypes = [
            f32p, i64p, i64p, f64p,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, i64p, ctypes.c_int64,
        ]
        lib.greedy_cover.restype = None
        lib.greedy_cover.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class GridIndex:
    """xy CSR grid over a scene point cloud for O(box) chunk queries."""

    def __init__(self, points: np.ndarray, cell: float = 0.5):
        self.points = np.ascontiguousarray(points, np.float32)
        self.cell = float(cell)
        lib = _load()
        self._native = lib is not None
        if self._native:
            ncells = lib.grid_build(_ptr(self.points, ctypes.c_float), len(self.points), self.cell, None, None, None)
            self.cell_start = np.zeros(ncells + 1, np.int64)
            self.order = np.zeros(len(self.points), np.int64)
            self.meta = np.zeros(5, np.float64)
            lib.grid_build(
                _ptr(self.points, ctypes.c_float),
                len(self.points),
                self.cell,
                _ptr(self.cell_start, ctypes.c_int64),
                _ptr(self.order, ctypes.c_int64),
                _ptr(self.meta, ctypes.c_double),
            )

    def query_box(self, center_xy, half: float) -> np.ndarray:
        """Indices of points with both |x-cx|, |y-cy| <= half."""
        if not self._native:
            near = np.abs(self.points[:, :2] - np.asarray(center_xy))
            return np.nonzero((near[:, 0] <= half) & (near[:, 1] <= half))[0]
        lib = _load()
        cap = len(self.points)
        out = np.zeros(cap, np.int64)
        n = lib.grid_query(
            _ptr(self.points, ctypes.c_float),
            _ptr(self.cell_start, ctypes.c_int64),
            _ptr(self.order, ctypes.c_int64),
            _ptr(self.meta, ctypes.c_double),
            float(center_xy[0]),
            float(center_xy[1]),
            float(half),
            _ptr(out, ctypes.c_int64),
            cap,
        )
        return out[:n]


def greedy_cover_native(coverage: np.ndarray, k: int) -> np.ndarray | None:
    """Native greedy max-coverage; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    cov = np.ascontiguousarray(coverage.astype(np.uint8))
    out = np.zeros(k, np.int64)
    lib.greedy_cover(_ptr(cov, ctypes.c_uint8), cov.shape[0], cov.shape[1], k, _ptr(out, ctypes.c_int64))
    return out
