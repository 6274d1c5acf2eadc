"""Covariance profiles over scaled distances (mirror of
``gprf_tpu/kernels/covfn.py``).  Inputs and hyperparameters may carry
leading batch dimensions (:mod:`gprf_torch.kernels.distances`)."""

from __future__ import annotations

import torch

from gprf_torch.kernels.distances import safe_sqrt, scaled_sq_distance
from gprf_torch.kernels.gpcov import GPCov

_SQRT3 = 1.7320508075688772


def _profile(wfn_str: str, r2, wfn_params):
    """Profile of the scaled squared distance.  SE works in r^2 directly
    (smooth through coincident points); Matern-3/2 goes through safe_sqrt.
    ``wfn_params [..., 1]`` broadcasts against r2."""
    sv = wfn_params[..., 0:1]
    if wfn_str == "se":
        return sv * torch.exp(-r2)
    if wfn_str == "matern32":
        r = safe_sqrt(r2)
        return sv * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)
    raise ValueError(f"unknown weight function {wfn_str!r}")


def cov_value(cov: GPCov, r2):
    return _profile(cov.wfn_str, r2, cov.wfn_params)


def cross_kernel_matrix(cov: GPCov, X1, X2):
    """Dense kernel matrix k(X1, X2), no noise term."""
    return cov_value(cov, scaled_sq_distance(cov.dfn_str, X1, X2, cov.dfn_params))


def kernel_matrix(cov: GPCov, X, noise_var=0.0):
    """Symmetric k(X, X) + noise_var * I."""
    K = cross_kernel_matrix(cov, X, X)
    n = X.shape[-2]
    return K + noise_var * torch.eye(n, dtype=K.dtype, device=K.device)
