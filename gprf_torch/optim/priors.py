"""Priors on latent locations and (log-scale) covariance hyperparameters
(a copy of ``gprf_tpu/optim/priors.py``).  Host NumPy: they are O(n) and
feed the scipy driver directly.
"""

from __future__ import annotations

import numpy as np


def synthetic_cov_prior(c):
    """Near-uniform prior on log-scale cov params: N(-1, 10^2) iid."""
    c = np.asarray(c, dtype=np.float64)
    mean = -1.0
    std = 10.0
    r = (c - mean) / std
    ll = -0.5 * np.sum(r**2) - 0.5 * len(c) * np.log(2 * np.pi * std**2)
    lderiv = -(c - mean) / (std**2)
    return ll, lderiv


def seismic_cov_prior(c):
    """Seismic log-scale cov prior: N([-2.3, 0, 3.6, 3.6], 1.5^2) plus an
    exp(70 * (log l_h - 5)) penalty above log-lengthscale 5."""
    c = np.asarray(c, dtype=np.float64).reshape(-1)
    means = np.array((-2.3, 0.0, 3.6, 3.6))
    std = 1.5
    r = (c - means) / std
    ll = -0.5 * np.sum(r**2) - 0.5 * len(c) * np.log(2 * np.pi * std**2)
    lderiv = (-(c - means) / (std**2)).reshape(-1)
    if c[2] > 5:
        penalty = np.exp(70 * (c[2] - 5))
        ll -= penalty
        lderiv[2] -= 70 * np.exp(70 * (c[2] - 5))
    return ll, lderiv


def gaussian_x_prior(X, means, stds):
    """Diagonal Gaussian prior ll + gradient over a location array X;
    ``stds`` broadcasts against X (per-column stds are supported)."""
    X = np.asarray(X, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    stds = np.broadcast_to(np.asarray(stds, dtype=np.float64), X.shape)
    r = (X - means) / stds
    ll = -0.5 * np.sum(r**2) - np.sum(np.log(np.sqrt(2 * np.pi) * stds))
    lderiv = -r / stds
    return ll, lderiv
