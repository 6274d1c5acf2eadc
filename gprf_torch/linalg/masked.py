"""Padding-safe Gaussian log-density (mirror of ``gprf_tpu/linalg/masked.py``).

Ragged blocks live in one padded ``[B, m, m]`` tensor: rows and columns
outside the mask become an identity sub-block, which factors trivially,
adds exactly zero to the log-determinant and the quadratic form, and passes
zero gradient back to padded entries.  Functions take optional leading
batch dimensions.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def pad_kernel_matrix(K, mask):
    """Zero rows/columns where ``mask`` is 0 and put 1 on their diagonal."""
    mask = mask.to(K.dtype)
    return K * (mask[..., :, None] * mask[..., None, :]) + torch.diag_embed(1.0 - mask)


def cholesky_nan(K):
    """Lower Cholesky factor; for a K that is not positive definite its
    lower triangle is NaN, as ``jnp.linalg.cholesky`` gives, with no host
    sync (``cholesky_ex`` does not check ``info``)."""
    L, info = torch.linalg.cholesky_ex(K)
    m = K.shape[-1]
    lower = torch.ones((m, m), dtype=torch.bool, device=K.device).tril()
    return L.masked_fill((info != 0)[..., None, None] & lower, float("nan"))


def masked_gaussian_ll(K, Y, mask):
    """Gaussian log-density of the masked rows of Y under N(0, K):

        ll = -1/2 sum(Y * K^-1 Y) - dy/2 logdet K - dy n_active/2 log 2 pi

    K includes the noise diagonal; rows of Y outside the mask are ignored."""
    ll, _, _ = masked_gaussian_ll_cached(K, Y, mask)
    return ll


def masked_gaussian_ll_cached(K, Y, mask):
    """As :func:`masked_gaussian_ll`, also returning (L, alpha) with
    ``L L^T = pad(K)`` and ``alpha = pad(K)^-1 Y_masked``."""
    dy = Y.shape[-1]
    maskf = mask.to(K.dtype)
    L = cholesky_nan(pad_kernel_matrix(K, mask))
    Ym = Y * maskf[..., :, None]
    alpha = torch.cholesky_solve(Ym, L)
    quad = torch.sum(Ym * alpha, dim=(-2, -1))
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    n_active = torch.sum(maskf, dim=-1)
    ll = -0.5 * quad - 0.5 * dy * logdet - 0.5 * dy * n_active * _LOG_2PI
    return ll, L, alpha
