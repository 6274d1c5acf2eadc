"""The truncated-support sparse Gaussian log-likelihood of one block and its
gradients (mirror of ``gprf_tpu/model/sparse_llgrad.py``; the ``--sparse``
path of the host engine).

The kernel is truncated at ``max_distance`` scaled lengthscales (the native
kd-tree range query), factored by the native sparse Cholesky after an RCM
permutation (:class:`~gprf_torch.sparse.ops.SparseFactor`), and the trace
terms tr(K^-1 dK) of the gradients read the Takahashi *selected inverse*:
the entries of K^-1 on the factor's pattern, exactly the ones the
elementwise products read.  The pattern derivatives are closed forms for
SE and Matern-3/2 over the euclidean and the lon-lat-depth distances.

Host NumPy and scipy in float64 throughout, as in the reference: no
kernel, no GPU.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from gprf_torch.data.seismic import AVG_EARTH_RADIUS_KM
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.kernels.hostnp import _host
from gprf_torch.sparse.native import range_pairs
from gprf_torch.sparse.ops import SparseFactor, _profile_np, _query_coords, _scaled_r2_pairs

_SQRT3 = np.sqrt(3.0)
LOG_2PI = np.log(2.0 * np.pi)


def _dprofile_dr2(cov: GPCov, r2, k_vals):
    """d k / d r2 on the pattern."""
    sv = float(_host(cov.wfn_params)[0])
    if cov.wfn_str == "se":
        return -k_vals
    if cov.wfn_str == "matern32":
        r = np.sqrt(np.maximum(r2, 0.0))
        return -1.5 * sv * np.exp(-_SQRT3 * r)
    raise ValueError(cov.wfn_str)


def _haversine(Xi, Xj):
    """(h, phi1, lam1, phi2, lam2): the haversine of the surface angle
    between the (lon, lat) rows, and the rows in radians."""
    phi1, lam1 = np.radians(Xi[:, 1]), np.radians(Xi[:, 0])
    phi2, lam2 = np.radians(Xj[:, 1]), np.radians(Xj[:, 0])
    h = (np.sin((phi1 - phi2) / 2.0) ** 2
         + np.cos(phi1) * np.cos(phi2) * np.sin((lam1 - lam2) / 2.0) ** 2)
    return h, phi1, lam1, phi2, lam2


def _arc_km(h):
    return 2.0 * np.arcsin(np.minimum(np.sqrt(np.maximum(h, 0.0)), 1.0)) * AVG_EARTH_RADIUS_KM


def _dr2_dx_rows(X, rows, cols, cov: GPCov):
    """[nnz, dx]: d r2(x_rows, x_cols) / d x_rows."""
    dfn = _host(cov.dfn_params)
    Xi = X[rows]
    Xj = X[cols]
    if cov.dfn_str == "euclidean":
        return 2.0 * (Xi - Xj) / dfn**2
    if cov.dfn_str == "lld":
        l1, l2 = dfn
        h, phi1, lam1, phi2, lam2 = _haversine(Xi, Xj)
        # s = R 2 asin(sqrt(h)); ds/dh = R / sqrt(h (1 - h)), guarded at both
        # singular ends (coincident and antipodal points)
        safe = (h > 1e-300) & (h < 1.0 - 1e-12)
        ds_dh = np.where(safe, AVG_EARTH_RADIUS_KM / np.sqrt(np.where(safe, h * (1 - h), 1.0)),
                         0.0)
        dh_dphi1 = (0.5 * np.sin(phi1 - phi2)
                    - np.sin(phi1) * np.cos(phi2) * np.sin((lam1 - lam2) / 2.0) ** 2)
        dh_dlam1 = 0.5 * np.cos(phi1) * np.cos(phi2) * np.sin(lam1 - lam2)
        dr2_ds_deg = 2.0 * _arc_km(h) / l1**2 * ds_dh * (np.pi / 180.0)
        out = np.empty((len(rows), 3))
        out[:, 0] = dr2_ds_deg * dh_dlam1  # lon
        out[:, 1] = dr2_ds_deg * dh_dphi1  # lat
        out[:, 2] = 2.0 * (Xi[:, 2] - Xj[:, 2]) / l2**2  # depth
        return out
    raise ValueError(cov.dfn_str)


def _dr2_dlength(X, rows, cols, cov: GPCov, which: int):
    """d r2 / d lengthscale[which] on the pattern."""
    dfn = _host(cov.dfn_params)
    Xi = X[rows]
    Xj = X[cols]
    if cov.dfn_str == "euclidean":
        d = Xi[:, which] - Xj[:, which]
        return -2.0 * d * d / dfn[which] ** 3
    if cov.dfn_str == "lld":
        if which == 0:
            s = _arc_km(_haversine(Xi, Xj)[0])
            return -2.0 * s * s / dfn[0] ** 3
        dz = Xi[:, 2] - Xj[:, 2]
        return -2.0 * dz * dz / dfn[1] ** 3
    raise ValueError(cov.dfn_str)


def gaussian_llgrad_sparse(X, Y, cov: GPCov, noise_var, grad_X: bool = False,
                           grad_cov: bool = False, max_distance: float = 5.0):
    """(ll, gradX [n, dx], gradC [2 + k]) of one Gaussian block with the
    kernel truncated at ``max_distance`` scaled lengthscales.  A gradient
    not asked for is a 0-d zero, as in the reference; an empty block gives
    ``(0.0, zeros(X.shape), zeros(2 + k))``."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    n, dx = X.shape
    dy = Y.shape[1]
    ncov = 2 + len(_host(cov.dfn_params))
    if n == 0:
        return 0.0, np.zeros(X.shape), np.zeros((ncov,))

    # the pattern within max_distance scaled lengthscales, both triangles
    coords, inflate = _query_coords(X, cov)
    lr, lc = range_pairs(coords, max_distance * inflate)
    r2l = _scaled_r2_pairs(X, lr, lc, cov)
    keep = r2l <= max_distance**2
    lr, lc, r2l = lr[keep], lc[keep], r2l[keep]
    offd = lr != lc
    rows = np.concatenate([lr, lc[offd]])
    cols = np.concatenate([lc, lr[offd]])
    r2 = np.concatenate([r2l, r2l[offd]])
    k_vals = _profile_np(cov, r2)
    diag = rows == cols
    K = scipy.sparse.csr_matrix((k_vals + noise_var * diag, (rows, cols)), shape=(n, n))

    factor = SparseFactor(K.tocsc())
    alpha = factor.solve(Y)
    logdet = factor.logdet()
    ll = -0.5 * np.sum(Y * alpha) - 0.5 * dy * logdet - 0.5 * dy * n * LOG_2PI

    gradX = np.zeros(())
    gradC = np.zeros(())
    if not (grad_X or grad_cov):
        return ll, gradX, gradC

    Z = factor.selected_inverse()  # K^-1 on the factor's pattern, symmetric
    dk_dr2 = _dprofile_dr2(cov, r2, k_vals)

    def pattern_matrix(vals):
        return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))

    if grad_X:
        gradX = np.zeros((n, dx))
        dr2_dx = _dr2_dx_rows(X, rows, cols, cov)
        for i in range(dx):
            # the self-derivative is zeroed, as in the original's gprf.py:354
            sdK = pattern_matrix(np.where(diag, 0.0, dk_dr2 * dr2_dx[:, i]))
            d_logdet = -dy * np.asarray(sdK.multiply(Z).sum(axis=1)).reshape(-1)
            gradX[:, i] = d_logdet + np.sum((sdK @ alpha) * alpha, axis=1)

    if grad_cov:
        gradC = np.zeros((ncov,))
        sv = float(_host(cov.wfn_params)[0])
        for i in range(ncov):
            if i == 0:
                dKdi = scipy.sparse.eye(n, format="csr")
            elif i == 1:
                dKdi = pattern_matrix(k_vals / sv)
            else:
                dKdi = pattern_matrix(dk_dr2 * _dr2_dlength(X, rows, cols, cov, i - 2))
            gradC[i] = (0.5 * np.sum(alpha * (dKdi @ alpha))
                        - 0.5 * dy * dKdi.multiply(Z).sum())

    return ll, gradX, gradC
