"""Float64 NumPy kernel matrices on the host (a copy of
``gprf_tpu/kernels/hostnp.py``).

Data generation and analysis build kernel matrices once, in float64,
whatever device and dtype the objective runs at; a parity test pins these
to :mod:`gprf_torch.kernels.covfn`.
"""

from __future__ import annotations

import numpy as np

from gprf_torch.kernels.gpcov import GPCov

AVG_EARTH_RADIUS_KM = 6371.0
_SQRT3 = 1.7320508075688772


def _host(t) -> np.ndarray:
    """A GPCov parameter (a tensor on any device) as a float64 array."""
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, dtype=np.float64)


def _sq_euclidean_np(X1, X2, lscales):
    """One [n1, n2] term per input dimension (no [n1, n2, dx] temporary: at
    10,500 points that would be 1.8 GB)."""
    U = X1 / lscales
    V = X2 / lscales
    r2 = np.zeros((len(U), len(V)))
    for k in range(U.shape[1]):
        d = U[:, k, None] - V[None, :, k]
        d *= d
        r2 += d
    return r2


def _sq_lld_np(X1, X2, lscales):
    r1 = np.radians(X1[:, :2])
    r2 = np.radians(X2[:, :2])
    lon1, lat1 = r1[:, 0:1], r1[:, 1:2]
    lon2, lat2 = r2[None, :, 0], r2[None, :, 1]
    hav = (
        np.sin((lat1 - lat2) / 2.0) ** 2
        + np.cos(lat1) * np.cos(lat2) * np.sin((lon1 - lon2) / 2.0) ** 2
    )
    d_surf = 2.0 * np.arcsin(np.minimum(np.sqrt(np.maximum(hav, 0.0)), 1.0)) * AVG_EARTH_RADIUS_KM
    d_depth = X1[:, 2][:, None] - X2[:, 2][None, :]
    return (d_surf / lscales[0]) ** 2 + (d_depth / lscales[1]) ** 2


def scaled_sq_distance_np(dfn_str, X1, X2, dfn_params):
    if dfn_str == "euclidean":
        return _sq_euclidean_np(X1, X2, dfn_params)
    if dfn_str == "lld":
        return _sq_lld_np(X1, X2, dfn_params)
    raise ValueError(dfn_str)


def cov_value_np(cov: GPCov, r2):
    sv = float(_host(cov.wfn_params)[0])
    if cov.wfn_str == "se":
        return sv * np.exp(-r2)
    if cov.wfn_str == "matern32":
        r = np.sqrt(np.maximum(r2, 0.0))
        return sv * (1.0 + _SQRT3 * r) * np.exp(-_SQRT3 * r)
    raise ValueError(cov.wfn_str)


def cross_kernel_matrix_np(cov: GPCov, X1, X2) -> np.ndarray:
    X1 = np.asarray(X1, dtype=np.float64)
    X2 = np.asarray(X2, dtype=np.float64)
    return cov_value_np(cov, scaled_sq_distance_np(cov.dfn_str, X1, X2, _host(cov.dfn_params)))


def kernel_matrix_np(cov: GPCov, X, noise_var=0.0) -> np.ndarray:
    K = cross_kernel_matrix_np(cov, X, X)
    if noise_var:
        K = K + noise_var * np.eye(len(K))
    return K
