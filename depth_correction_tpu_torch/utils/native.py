"""ctypes bindings for the native host runtime (``csrc/dc_native.cpp``;
counterpart of ``depth_correction_tpu/utils/native.py``).

The port keeps its own copy of the C++ source and builds it with ``g++``
at first use into ``depth_correction_tpu_torch/_build/`` under a name keyed
by a hash of the source, the compiler and its flags, and the host's machine
type (an edited source, or a build directory copied to another kind of
host, rebuilds). The flags name no host CPU (no ``-march=native``), so a
library built on one x86-64 host runs on any other. It exposes numpy
wrappers of the KD-tree's kNN and radius queries, which serve
``nn_backend = 'native'`` (``preproc._host_neighbors``). A failed build raises
:class:`NativeBuildError` with the compiler's output: there is no quiet
fallback to scipy. Nothing builds at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from typing import Tuple

import numpy as np

__all__ = ["KDTree", "NativeBuildError", "build", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "dc_native.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
COMPILER = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
# Seconds of the last build (0.0 when a keyed library was reused).
BUILD_SECONDS = 0.0


class NativeBuildError(RuntimeError):
    """The native library failed to build or load."""


def library_path() -> str:
    h = hashlib.sha256(" ".join((platform.machine(), COMPILER) + FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "libdcnative_%s.so" % h.hexdigest()[:16])


def build() -> str:
    """Compile the source if the keyed library is missing; returns its path.
    Raises :class:`NativeBuildError` naming the command and its output."""
    global BUILD_SECONDS
    path = library_path()
    if os.path.exists(path):
        BUILD_SECONDS = 0.0
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = [COMPILER, *FLAGS, SOURCE, "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError("native build failed: %s: %s" % (" ".join(cmd), e)) from e
    if proc.returncode != 0:
        raise NativeBuildError("native build failed (exit %d): %s\n%s"
                               % (proc.returncode, " ".join(cmd), proc.stdout + proc.stderr))
    os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
    BUILD_SECONDS = time.perf_counter() - t0
    return path


def load():
    """The bound library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        P, L, D, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        lib.dc_kdtree_build.restype = P
        lib.dc_kdtree_build.argtypes = [P, L]
        lib.dc_kdtree_free.argtypes = [P]
        lib.dc_kdtree_knn.argtypes = [P, P, L, I, D, P, P]
        lib.dc_kdtree_radius.argtypes = [P, P, L, D, I, P, P]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class KDTree:
    """Median-split KD-tree over (N, 3) float64 points."""

    def __init__(self, points: np.ndarray):
        self._lib = load()
        self._pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 3)
        self._handle = self._lib.dc_kdtree_build(_ptr(self._pts), len(self._pts))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.dc_kdtree_free(self._handle)
            self._handle = None

    def query(self, queries: np.ndarray, k: int = 1,
              distance_upper_bound: float = -1.0) -> Tuple[np.ndarray, np.ndarray]:
        """kNN: (dist (Q, k), idx (Q, k) -1-padded), nearest first; a
        negative bound means none."""
        q = np.ascontiguousarray(queries, dtype=np.float64)
        nq = len(q)
        idx = np.empty((nq, k), dtype=np.int64)
        dist = np.empty((nq, k), dtype=np.float64)
        self._lib.dc_kdtree_knn(self._handle, _ptr(q), nq, int(k), float(distance_upper_bound),
                                _ptr(idx), _ptr(dist))
        return dist, idx

    def query_ball(self, queries: np.ndarray, r: float, k_max: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Radius search: (idx (Q, k_max) -1-padded, nearest first; the
        true counts (Q,))."""
        q = np.ascontiguousarray(queries, dtype=np.float64)
        nq = len(q)
        idx = np.empty((nq, k_max), dtype=np.int64)
        counts = np.empty(nq, dtype=np.int64)
        self._lib.dc_kdtree_radius(self._handle, _ptr(q), nq, float(r), int(k_max), _ptr(idx),
                                   _ptr(counts))
        return idx, counts
