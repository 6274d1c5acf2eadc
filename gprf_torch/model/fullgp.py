"""Exact (single-block) Gaussian process regression (mirror of
``gprf_tpu/model/fullgp.py``).

The treegp ``gp.GP`` surface the reference's predictive scoring relies on:
train on (X, y) with a GPCov and a noise variance, predict means and
covariances at test inputs.  One Cholesky factorization on the device and
at the width it is given (float64 for scoring); results come back as
float64 NumPy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from gprf_torch.kernels.covfn import cross_kernel_matrix, kernel_matrix
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.kernels.hostnp import kernel_matrix_np
from gprf_torch.linalg.jitchol import jitchol


class GP:
    """Exact GP with zero prior mean.

    ``predict``, ``covariance``, ``factor``, ``log_likelihood`` and a mutable
    ``y`` / ``alpha_r`` pair (the reference swaps output columns in place).
    """

    def __init__(self, X, y, cov_main: GPCov, noise_var, *, device: torch.device | str,
                 dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.X = np.asarray(X, dtype=np.float64)
        self.cov_main = cov_main.to(device=self.device, dtype=dtype)
        self.noise_var = float(noise_var)
        self._X = self._tensor(self.X)
        self._L = torch.linalg.cholesky(kernel_matrix(self.cov_main, self._X, self.noise_var))
        self.y = np.asarray(y).reshape(len(self.X), -1)
        self.alpha_r = self.factor(self.y)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    @staticmethod
    def _host(t):
        return t.double().cpu().numpy()

    def factor(self, y):
        """K^-1 y through the cached Cholesky factor."""
        y = np.asarray(y).reshape(len(self.X), -1)
        return self._host(torch.cholesky_solve(self._tensor(y), self._L))

    def predict(self, Xstar):
        """Posterior mean at Xstar; 1-d for a single output column."""
        Ks = cross_kernel_matrix(self.cov_main, self._tensor(Xstar), self._X)
        mean = self._host(Ks @ self._tensor(self.alpha_r))
        return mean[:, 0] if mean.shape[1] == 1 else mean

    def covariance(self, Xstar, include_obs: bool = False):
        """Posterior covariance at Xstar (+ the observation noise if asked)."""
        Xs = self._tensor(Xstar)
        Ks = cross_kernel_matrix(self.cov_main, Xs, self._X)
        V = torch.linalg.solve_triangular(self._L, Ks.mT, upper=False)
        cov = cross_kernel_matrix(self.cov_main, Xs, Xs) - V.mT @ V
        if include_obs:
            cov = cov + self.noise_var * torch.eye(len(Xs), dtype=cov.dtype, device=cov.device)
        return self._host(cov)

    def log_likelihood(self):
        n, dy = self.y.shape
        logdet = 2.0 * float(torch.sum(torch.log(torch.diagonal(self._L))))
        quad = np.sum(self.y * self.alpha_r)
        return -0.5 * quad - 0.5 * dy * logdet - 0.5 * dy * n * np.log(2 * np.pi)


def mcov(X, cov: GPCov, noise_var):
    """Dense covariance including the noise, float64 on the host (treegp's
    ``gp.mcov``)."""
    return kernel_matrix_np(cov, X, noise_var=noise_var)


def prior_sample(X, cov: GPCov, noise_var, rng: np.random.RandomState | np.random.Generator,
                 n_samples=1):
    """A draw from the GP prior at X (treegp's ``gp.prior_sample``)."""
    K = mcov(X, cov, noise_var)
    return jitchol(K) @ rng.standard_normal((len(K), n_samples))
