"""ctypes bindings of the repository's native host library,
``csrc/gprf_native.cpp`` (the port's own binding of the library that
``gprf_tpu/sparse/native.py`` binds; the C++ source is shared, not copied).

    range_pairs    kd-tree fixed-radius pair enumeration
    rcm_order      reverse Cuthill-McKee fill-reducing ordering
    NativeCholesky sparse Cholesky factor and its L-multiply (the prior draw)

The library is compiled with ``g++`` at first use into
``gprf_torch/csrc/build/native-<hash>/``, keyed on a hash of the source and
the flags (the flags of ``csrc/Makefile``, so both packages run the same
machine code).  Host code, no GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "gprf_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "csrc" / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib = None

_D = ctypes.POINTER(ctypes.c_double)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
# name -> (restype, argtypes) of the C functions used here
SIGNATURES = {
    "range_pairs": (ctypes.c_int64, (_D, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                     _I32, _I32, ctypes.c_int64)),
    "rcm_order": (None, (ctypes.c_int, _I64, _I32, _I32)),
    "sparse_chol_factor": (ctypes.c_void_p, (ctypes.c_int, _I64, _I32, _D)),
    "sparse_chol_lmult": (None, (ctypes.c_void_p, _D, ctypes.c_int)),
    "sparse_chol_free": (None, (ctypes.c_void_p,)),
}


def _library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"native-{key}" / "libgprf_native.so"


def load_library() -> ctypes.CDLL:
    """Build (once per source and flags) and load the library; thread-safe,
    and safe against other processes building it at the same time (each
    links into a file of its own and renames it into place)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
            os.close(fd)
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def _dptr(a):
    return a.ctypes.data_as(_D)


def _i32ptr(a):
    return a.ctypes.data_as(_I32)


def _i64ptr(a):
    return a.ctypes.data_as(_I64)


def range_pairs(pts: np.ndarray, radius: float):
    """All (i, j), i >= j, with euclidean distance <= radius, as int32
    (rows, cols): the lower triangle with the diagonal."""
    lib = load_library()
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n, dim = pts.shape
    count = lib.range_pairs(_dptr(pts), n, dim, radius, None, None, 0)
    if count < 0:
        raise RuntimeError(f"range_pairs failed: {count}")
    rows = np.empty(count, dtype=np.int32)
    cols = np.empty(count, dtype=np.int32)
    got = lib.range_pairs(_dptr(pts), n, dim, radius, _i32ptr(rows), _i32ptr(cols), count)
    if got != count:
        raise RuntimeError("range_pairs count mismatch")
    return rows, cols


def rcm_order(n: int, colptr: np.ndarray, rowidx: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a symmetric pattern (both
    triangles): perm[k] is the old index placed at new position k."""
    lib = load_library()
    colptr = np.ascontiguousarray(colptr, dtype=np.int64)
    rowidx = np.ascontiguousarray(rowidx, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    lib.rcm_order(n, _i64ptr(colptr), _i32ptr(rowidx), _i32ptr(perm))
    return perm


class NativeCholesky:
    """Sparse Cholesky L L^T = A of an SPD matrix given as its CSC lower
    triangle."""

    def __init__(self, n, Ap, Ai, Ax):
        lib = load_library()
        Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        Ai = np.ascontiguousarray(Ai, dtype=np.int32)
        Ax = np.ascontiguousarray(Ax, dtype=np.float64)
        self._lib = lib
        self.n = n
        self._h = lib.sparse_chol_factor(n, _i64ptr(Ap), _i32ptr(Ai), _dptr(Ax))
        if not self._h:
            raise np.linalg.LinAlgError("sparse matrix not positive definite")

    def lmult(self, z: np.ndarray) -> np.ndarray:
        """L z for z of shape [n] or [n, k] (a prior draw from iid z); the C
        routine works in place on each right-hand side, contiguous."""
        z = np.asarray(z, dtype=np.float64)
        Z = np.ascontiguousarray(z.reshape(self.n, -1).T)
        self._lib.sparse_chol_lmult(self._h, _dptr(Z), Z.shape[0])
        return Z.T[:, 0] if z.ndim == 1 else Z.T

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sparse_chol_free(h)
            self._h = None
