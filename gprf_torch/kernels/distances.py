"""Pairwise scaled distances with a safe gradient at coincident points.

Mirror of ``gprf_tpu/kernels/distances.py``.  Every function takes optional
leading batch dimensions: ``X1 [..., n1, dx]``, ``X2 [..., n2, dx]``, and
lengthscales ``[..., k]`` that broadcast against X1 (one set of
hyperparameters per replica of a batch).

Gradient policy at coincident points: :func:`safe_sqrt` has a zero
derivative at a (numerically) zero radicand, so d r / d x -> 0 as x' -> x
instead of the undefined 1/r limit; the great-circle angle's derivative is
zero at coincident and antipodal points (:class:`_CentralAngle`).
"""

from __future__ import annotations

import torch

AVG_EARTH_RADIUS_KM = 6371.0
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


class _CentralAngle(torch.autograd.Function):
    """2 asin(sqrt(hav)) with a guarded derivative: 1 / sqrt(hav (1 - hav))
    is singular at coincident (hav = 0) and antipodal (hav = 1) points, and
    both ends take a zero derivative."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return 2.0 * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        safe = (h > torch.finfo(h.dtype).tiny) & (h < 1.0 - 1e-7)
        denom = torch.sqrt(torch.where(safe, h * (1.0 - h), torch.ones_like(h)))
        return g * torch.where(safe, 1.0 / denom, torch.zeros_like(h))


def _haversine_km(lonlat1, lonlat2):
    """Great-circle surface distance matrix [..., n1, n2] in km between two
    (lon, lat) degree arrays."""
    r1 = torch.deg2rad(lonlat1)
    r2 = torch.deg2rad(lonlat2)
    lon1, lat1 = r1[..., :, None, 0], r1[..., :, None, 1]
    lon2, lat2 = r2[..., None, :, 0], r2[..., None, :, 1]
    sin_dlat = torch.sin((lat1 - lat2) / 2.0)
    sin_dlon = torch.sin((lon1 - lon2) / 2.0)
    hav = sin_dlat**2 + torch.cos(lat1) * torch.cos(lat2) * sin_dlon**2
    return _CentralAngle.apply(hav) * AVG_EARTH_RADIUS_KM


def sq_lld(X1, X2, lscales):
    """Scaled squared lon/lat/depth distance matrix,

    r2[..., a, b] = (d_km(X1[a], X2[b]) / l_h)^2 + ((depth_a - depth_b) / l_z)^2

    with ``lscales = [l_h, l_z]`` in km; X's columns are (lon_deg, lat_deg,
    depth_km)."""
    d_surf = _haversine_km(X1[..., :2], X2[..., :2])
    d_depth = X1[..., :, None, 2] - X2[..., None, :, 2]
    return (d_surf / lscales[..., 0:1]) ** 2 + (d_depth / lscales[..., 1:2]) ** 2


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
