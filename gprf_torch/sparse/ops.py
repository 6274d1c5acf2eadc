"""Sparse kernel matrices, their factor and the prior draws for large n
(mirror of ``gprf_tpu/sparse/ops.py``).

The kernel's support is truncated at ``max_scaled_dist`` scaled
lengthscales; the surviving pattern comes from the native kd-tree range
query, and the sparse SPD matrix is factored by the native up-looking
Cholesky after an RCM fill-reducing permutation
(:mod:`gprf_torch.sparse.native`).  Host code, float64: the same source,
permutation and normal draws give the reference's Y.

Past 20,000 points the sparse factor's fill-in is impractical on one core,
so the exact draw there is banded: the same RCM order makes the truncated
kernel a band matrix that LAPACK's banded Cholesky factors at dense-BLAS
speed (:func:`sample_y_banded`).
"""

from __future__ import annotations

import time

import numpy as np
import scipy.linalg
import scipy.sparse
from scipy.linalg.blas import dtbmv

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.kernels.hostnp import AVG_EARTH_RADIUS_KM, _host
from gprf_torch.sparse.native import NativeCholesky, range_pairs, rcm_order


def _query_coords(X: np.ndarray, cov: GPCov):
    """(coordinates, radius inflation): a euclidean embedding in which a
    radius-D query returns a superset of the pairs at scaled distance <= D.

    euclidean: coordinates over lengthscales (exact).  lld: the surface
    point in ECEF over l_h; the chord underestimates the arc, so the radius
    is inflated and the exact scaled distance filters afterwards."""
    dfn_params = _host(cov.dfn_params)
    if cov.dfn_str == "euclidean":
        return np.ascontiguousarray(X / dfn_params), 1.0
    if cov.dfn_str == "lld":
        lon = np.radians(X[:, 0])
        lat = np.radians(X[:, 1])
        r = AVG_EARTH_RADIUS_KM
        ecef = np.stack([r * np.cos(lat) * np.cos(lon), r * np.cos(lat) * np.sin(lon),
                         r * np.sin(lat)], axis=1)
        return np.ascontiguousarray(ecef / dfn_params[0]), 1.05
    raise ValueError(cov.dfn_str)


def _scaled_r2_pairs(X, rows, cols, cov: GPCov):
    """Exact scaled squared distance of an explicit pair list."""
    dfn_params = _host(cov.dfn_params)
    Xi = X[rows]
    Xj = X[cols]
    if cov.dfn_str == "euclidean":
        d = (Xi - Xj) / dfn_params
        return np.sum(d * d, axis=1)
    if cov.dfn_str == "lld":
        rlon1, rlat1 = np.radians(Xi[:, 0]), np.radians(Xi[:, 1])
        rlon2, rlat2 = np.radians(Xj[:, 0]), np.radians(Xj[:, 1])
        hav = (
            np.sin((rlat1 - rlat2) / 2.0) ** 2
            + np.cos(rlat1) * np.cos(rlat2) * np.sin((rlon1 - rlon2) / 2.0) ** 2
        )
        d_surf = 2.0 * np.arcsin(np.minimum(np.sqrt(hav), 1.0)) * AVG_EARTH_RADIUS_KM
        d_depth = Xi[:, 2] - Xj[:, 2]
        return (d_surf / dfn_params[0]) ** 2 + (d_depth / dfn_params[1]) ** 2
    raise ValueError(cov.dfn_str)


def _profile_np(cov: GPCov, r2):
    sv = float(_host(cov.wfn_params)[0])
    if cov.wfn_str == "se":
        return sv * np.exp(-r2)
    if cov.wfn_str == "matern32":
        r = np.sqrt(r2)
        s3 = np.sqrt(3.0)
        return sv * (1.0 + s3 * r) * np.exp(-s3 * r)
    raise ValueError(cov.wfn_str)


def sparse_kernel_matrix(X, cov: GPCov, max_scaled_dist=4.0, noise_var=0.0):
    """The kernel matrix truncated at ``max_scaled_dist`` scaled
    lengthscales, as a scipy CSC matrix (both triangles)."""
    X = np.asarray(X, dtype=np.float64)
    n = len(X)
    coords, inflate = _query_coords(X, cov)
    rows, cols = range_pairs(coords, max_scaled_dist * inflate)
    r2 = _scaled_r2_pairs(X, rows, cols, cov)
    keep = r2 <= max_scaled_dist**2
    rows, cols, r2 = rows[keep], cols[keep], r2[keep]
    vals = _profile_np(cov, r2)
    lower = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n))
    diag_mask = rows == cols
    K = lower + lower.T - scipy.sparse.coo_matrix(
        (vals[diag_mask], (rows[diag_mask], cols[diag_mask])), shape=(n, n))
    if noise_var:
        K = K + noise_var * scipy.sparse.eye(n)
    return K.tocsc()


class SparseFactor:
    """RCM-permuted sparse Cholesky of an SPD scipy matrix: the solve, the
    log-determinant, the permuted factor ``L`` and permutation ``P``, the
    selected inverse (the sparse llgrad) and the prior draw
    ``lmult_prior_sample``."""

    def __init__(self, K_csc):
        K = K_csc.tocsc()
        n = K.shape[0]
        self.n = n
        self.perm = rcm_order(n, K.indptr.astype(np.int64), K.indices.astype(np.int32))
        self.iperm = np.argsort(self.perm)
        Kp = K[self.perm][:, self.perm].tocsc()
        lower = scipy.sparse.tril(Kp, format="csc")
        self._chol = NativeCholesky(n, lower.indptr.astype(np.int64),
                                    lower.indices.astype(np.int32), lower.data)

    def logdet(self) -> float:
        return self._chol.logdet()

    def solve(self, b):
        """K^-1 b for b [n] or [n, k], in the original order."""
        return self._chol.solve(np.asarray(b, dtype=np.float64)[self.perm])[self.iperm]

    def lmult_prior_sample(self, z):
        """P^T L z: a draw from N(0, K) given iid normal z."""
        return self._chol.lmult(np.asarray(z, dtype=np.float64))[self.iperm]

    def L(self):
        """The factor of the permuted matrix, scipy CSC."""
        return self._chol.L()

    def selected_inverse(self):
        """K^-1 on the factor's pattern (a superset of K's), symmetric, in
        the original order, as scipy CSR: exact on every entry that the
        sparse gradient's elementwise products read."""
        Zl = self._chol.selected_inverse_lower()  # the permuted lower pattern
        Zsym = Zl + Zl.T - scipy.sparse.diags(Zl.diagonal())
        return Zsym[self.iperm][:, self.iperm].tocsr()

    def P(self):
        """The permutation: row k of the factor is row ``P()[k]`` of K."""
        return self.perm


def sample_y_sparse(X, cov: GPCov, noise_var, yd, max_scaled_dist=4.0, *, rng):
    """Y ~ N(0, K_truncated + noise_var I), [n, yd], with the normal draws
    from ``rng`` (a ``RandomState`` seeded as the reference seeds NumPy's
    global state gives the reference's Y)."""
    K = sparse_kernel_matrix(X, cov, max_scaled_dist=max_scaled_dist, noise_var=noise_var)
    factor = SparseFactor(K)
    return factor.lmult_prior_sample(rng.standard_normal((K.shape[0], yd)))


def sample_y_banded(X, cov: GPCov, noise_var, yd, max_scaled_dist=4.0, *, rng, verbose=False):
    """The exact draw from N(0, K_truncated + noise_var I), [n, yd], by a
    banded Cholesky: the truncated pattern in RCM order stored as LAPACK's
    lower band, factored by ``scipy.linalg.cholesky_banded`` (should it
    fail, again with a diagonal jitter of 1e-8 times the mean diagonal,
    growing tenfold a try) and multiplied into the normal draws of ``rng``
    by ``dtbmv``,
    then permuted back: P^T L z.  The same law as :func:`sample_y_sparse`,
    which factors the same matrix another way."""
    t0 = time.time()
    K = sparse_kernel_matrix(X, cov, max_scaled_dist=max_scaled_dist, noise_var=noise_var)
    n = K.shape[0]
    perm = rcm_order(n, K.indptr.astype(np.int64), K.indices.astype(np.int32))
    rank = np.empty(n, dtype=np.int64)
    rank[perm] = np.arange(n)
    Kc = K.tocoo()
    pr, pc = rank[Kc.row], rank[Kc.col]
    lower = pr >= pc
    pr, pc, vals = pr[lower], pc[lower], Kc.data[lower]
    del Kc, K
    bw = int((pr - pc).max()) if len(pr) else 0
    if verbose:
        print("sample_y_banded: n=%d nnz(tril)=%d rcm bandwidth=%d (%.1fs)"
              % (n, len(vals), bw, time.time() - t0))
    ab = np.zeros((bw + 1, n), dtype=np.float64)
    ab[pr - pc, pc] = vals
    del pr, pc, vals
    jitter = 0.0
    for attempt in range(7):
        try:
            c = scipy.linalg.cholesky_banded(ab, lower=True, check_finite=False)
            break
        except np.linalg.LinAlgError:
            new_jitter = max(ab[0].mean() * 1e-8 * (10.0**attempt), 1e-12)
            ab[0] += new_jitter - jitter
            jitter = new_jitter
    else:
        raise np.linalg.LinAlgError("banded kernel matrix not positive definite")
    if verbose:
        print("sample_y_banded: dpbtrf done (%.1fs)" % (time.time() - t0))
    z = rng.standard_normal((n, yd))
    yp = np.empty((n, yd), dtype=np.float64)
    for j in range(yd):
        yp[:, j] = dtbmv(bw, c, np.ascontiguousarray(z[:, j]), lower=1)
    out = np.empty_like(yp)
    out[perm] = yp
    if verbose:
        print("sample_y_banded: draw complete (%.1fs)" % (time.time() - t0))
    return out
