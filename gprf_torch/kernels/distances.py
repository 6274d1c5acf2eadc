"""Pairwise scaled distances with a safe gradient at coincident points.

Mirror of ``gprf_tpu/kernels/distances.py``.  Every function takes optional
leading batch dimensions: ``X1 [..., n1, dx]``, ``X2 [..., n2, dx]``.

Gradient policy at coincident points: :func:`safe_sqrt` has a zero
derivative at a (numerically) zero radicand, so d r / d x -> 0 as x' -> x
instead of the undefined 1/r limit.
"""

from __future__ import annotations

import torch

_SAFE_EPS = 1e-20
_QUADRATIC_EXPANSION_MIN_DIM = 16


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(torch.clamp_min(x, 0.0))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        safe = x > _SAFE_EPS
        dydx = torch.where(safe, 0.5 / torch.where(safe, y, torch.ones_like(y)),
                           torch.zeros_like(y))
        return g * dydx


def safe_sqrt(x):
    """sqrt with a zero derivative at x <= 1e-20 (instead of inf/nan)."""
    return _SafeSqrt.apply(x)


def sq_euclidean(X1, X2, lscales):
    """r2[..., a, b] = sum_d ((X1[..., a, d] - X2[..., b, d]) / lscales[d])^2.

    For low-dimensional inputs (dx < 16) the broadcast-difference form is
    exact (no cancellation); wide inputs use the quadratic expansion
    ``|u|^2 - 2 u.v + |v|^2`` with one matrix product."""
    U = X1 / lscales
    V = X2 / lscales
    if X1.shape[-1] < _QUADRATIC_EXPANSION_MIN_DIM:
        diff = U[..., :, None, :] - V[..., None, :, :]
        return torch.sum(diff * diff, dim=-1)
    u2 = torch.sum(U * U, dim=-1)
    v2 = torch.sum(V * V, dim=-1)
    r2 = u2[..., :, None] - 2.0 * (U @ V.mT) + v2[..., None, :]
    return torch.clamp_min(r2, 0.0)


def sq_lld(X1, X2, lscales):
    raise NotImplementedError("seismic slice")


def scaled_sq_distance(dfn_str: str, X1, X2, dfn_params):
    """Dispatch: scaled *squared* distance matrix for a dfn_str."""
    if dfn_str == "euclidean":
        return sq_euclidean(X1, X2, dfn_params)
    if dfn_str == "lld":
        return sq_lld(X1, X2, dfn_params)
    raise ValueError(f"unknown distance function {dfn_str!r}")


def scaled_distance(dfn_str: str, X1, X2, dfn_params):
    """Scaled distance matrix (with a safe gradient at zero)."""
    return safe_sqrt(scaled_sq_distance(dfn_str, X1, X2, dfn_params))
