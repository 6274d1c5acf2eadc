"""ctypes bindings of the native host library ``gprf_torch/csrc/gprf_native.cpp``
(the port's own byte-equal copy of the C++ source that
``gprf_tpu/sparse/native.py`` binds; a test holds the two files equal).

    range_pairs    kd-tree fixed-radius pair enumeration
    rcm_order      reverse Cuthill-McKee fill-reducing ordering
    NativeCholesky sparse Cholesky factor: log-determinant, solve,
                   L-multiply (the prior draw), the factor itself and the
                   Takahashi selected inverse (the sparse llgrad)

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
import scipy.sparse
import scipy.sparse.csgraph

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gprf_native.cpp"
BUILD_ROOT = SOURCE.parent / "build"
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
    "sparse_chol_logdet": (ctypes.c_double, (ctypes.c_void_p,)),
    "sparse_chol_nnz": (ctypes.c_int64, (ctypes.c_void_p,)),
    "sparse_chol_export": (None, (ctypes.c_void_p, _I64, _I32, _D)),
    "sparse_chol_solve": (None, (ctypes.c_void_p, _D, ctypes.c_int)),
    "sparse_chol_selected_inv": (None, (ctypes.c_void_p, _D)),
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


def _rcm_connected(n, colptr, rowidx):
    lib = load_library()
    colptr = np.ascontiguousarray(colptr, dtype=np.int64)
    rowidx = np.ascontiguousarray(rowidx, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    lib.rcm_order(n, _i64ptr(colptr), _i32ptr(rowidx), _i32ptr(perm))
    return perm


def rcm_order(n: int, colptr: np.ndarray, rowidx: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a symmetric pattern (both
    triangles): perm[k] is the old index placed at new position k.

    The native routine seeds each breadth-first sweep at the first node of
    least degree among the unvisited ones at or past the first unvisited
    node s, and then goes on past s.  Where that seed lies in another
    connected component than s, s is never visited and the routine reads
    past its order (a truncated kernel's pattern falls apart when the
    support radius is short against the points' spread).  Where that never
    happens, which is when the components ordered by (least degree, its
    first node) come in the order of their first nodes, the native order is
    taken whole, the one ``gprf_tpu`` computes.  Otherwise each component
    is ordered by the routine alone and the components are laid out as the
    sweeps would visit them."""
    colptr = np.asarray(colptr)
    pattern = scipy.sparse.csc_matrix((np.ones(len(rowidx), dtype=np.int8), rowidx, colptr),
                                      shape=(n, n))
    ncomp, labels = scipy.sparse.csgraph.connected_components(pattern, directed=False)
    if ncomp > 1:
        degree = np.diff(colptr)
        by_degree = np.lexsort((np.arange(n), degree))  # least degree, then first node
        seed_order = labels[by_degree][np.sort(np.unique(labels[by_degree],
                                                          return_index=True)[1])]
        first_order = labels[np.sort(np.unique(labels, return_index=True)[1])]
        if not np.array_equal(seed_order, first_order):
            parts = []
            for c in seed_order[::-1]:  # the order is reversed as a whole
                nodes = np.flatnonzero(labels == c)
                sub = pattern[nodes][:, nodes].tocsc()
                sub.sort_indices()
                parts.append(nodes[_rcm_connected(len(nodes), sub.indptr, sub.indices)])
            return np.concatenate(parts).astype(np.int32)
    return _rcm_connected(n, colptr, rowidx)


def _rcm_connected(n, colptr, rowidx):
    """The native routine (:func:`rcm_order` says where it is right)."""
    lib = load_library()
    colptr = np.ascontiguousarray(colptr, dtype=np.int64)
    rowidx = np.ascontiguousarray(rowidx, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    lib.rcm_order(n, _i64ptr(colptr), _i32ptr(rowidx), _i32ptr(perm))
    return perm


class NativeCholesky:
    """Sparse Cholesky L L^T = A of an SPD matrix given as its CSC lower
    triangle.  The handle is freed once, by the process that made it."""

    def __init__(self, n, Ap, Ai, Ax):
        lib = load_library()
        Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        Ai = np.ascontiguousarray(Ai, dtype=np.int32)
        Ax = np.ascontiguousarray(Ax, dtype=np.float64)
        self._lib = lib
        self.n = n
        self._pid = os.getpid()
        self._h = lib.sparse_chol_factor(n, _i64ptr(Ap), _i32ptr(Ai), _dptr(Ax))
        if not self._h:
            raise np.linalg.LinAlgError("sparse matrix not positive definite")

    def logdet(self) -> float:
        return float(self._lib.sparse_chol_logdet(self._h))

    def nnz(self) -> int:
        return int(self._lib.sparse_chol_nnz(self._h))

    def _columns(self, b, routine):
        """``routine`` on a copy of b [n] or [n, k], in place on each
        right-hand side, each contiguous (the C layout)."""
        b = np.asarray(b, dtype=np.float64)
        B = np.array(b.reshape(self.n, -1).T, order="C")
        routine(self._h, _dptr(B), B.shape[0])
        return B.T[:, 0] if b.ndim == 1 else B.T

    def solve(self, b: np.ndarray) -> np.ndarray:
        """A^-1 b for b of shape [n] or [n, k]."""
        return self._columns(b, self._lib.sparse_chol_solve)

    def lmult(self, z: np.ndarray) -> np.ndarray:
        """L z for z of shape [n] or [n, k] (a prior draw from iid z)."""
        return self._columns(z, self._lib.sparse_chol_lmult)

    def _export(self, values=None):
        """The factor's CSC pattern with the factor's values, or with
        ``values`` aligned to it."""
        nnz = self.nnz()
        Lp = np.empty(self.n + 1, dtype=np.int64)
        Li = np.empty(nnz, dtype=np.int32)
        Lx = np.empty(nnz, dtype=np.float64)
        self._lib.sparse_chol_export(self._h, _i64ptr(Lp), _i32ptr(Li), _dptr(Lx))
        return scipy.sparse.csc_matrix((Lx if values is None else values, Li, Lp),
                                       shape=(self.n, self.n))

    def selected_inverse_lower(self):
        """The entries of A^-1 on the lower-triangular pattern of L
        (Takahashi's recurrences), as a scipy CSC matrix aligned with the
        factor."""
        Zx = np.empty(self.nnz(), dtype=np.float64)
        self._lib.sparse_chol_selected_inv(self._h, _dptr(Zx))
        return self._export(Zx)

    def L(self):
        """The factor as a scipy CSC matrix."""
        return self._export()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and self._pid == os.getpid():
            self._lib.sparse_chol_free(h)
        self._h = None
