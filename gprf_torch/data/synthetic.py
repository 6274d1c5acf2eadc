"""Synthetic GP-LVM data generation (mirror of ``gprf_tpu/data/synthetic.py``).

Latent locations X are sampled uniformly or from structured "crazy shapes"
selected by seed ranges (<1000 uniform, 1000-1099 fault, 1100-1199 X,
1200-1299 diamond, 1300-1349 crazy-lines, 1350-1399 tight crazy-lines), and
outputs Y are drawn from the GP prior.

Random numbers come from one ``np.random.RandomState(seed)`` per dataset,
passed along explicitly; it yields the stream that the reference draws from
NumPy's global state after ``np.random.seed(seed)``, so a seed gives the
same dataset in both packages.

The kernel matrix of the prior draw is always built in float64 on the host
(:func:`gprf_torch.kernels.hostnp.kernel_matrix_np`).  The reference builds
it with its device kernel at the process's default float width, so its
dataset depends on whether 64-bit mode was switched on before the draw; the
two packages agree when the reference runs in 64-bit mode.  At n = 10,500
this is one 10,500 x 10,500 float64 Cholesky (~0.9 GB) on the host.

Below 12,000 points the draw is dense.  Above, ``GPRF_SAMPLER`` picks it,
as in the reference: by default the truncated-support sparse draw of
:mod:`gprf_torch.sparse.ops` up to 20,000 points and its exact banded draw
above; ``vecchia`` the approximate Vecchia draw :func:`sample_y_blocked`
(the draw of the reference's earlier large-n datasets) and ``hi`` the same
with four times the conditioning points and neighbors.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.kernels.hostnp import cross_kernel_matrix_np, kernel_matrix_np
from gprf_torch.linalg.jitchol import jitchol
from gprf_torch.partition.morton import sort_morton

DENSE_SAMPLING_LIMIT = 12000  # above it the reference's sparse and blocked samplers take over


def sample_points_line(n, x1, x2, std=0.005, *, rng):
    x1 = np.asarray(x1, dtype=float)
    x2 = np.asarray(x2, dtype=float)
    v = x2 - x1
    rs = rng.rand(int(n))
    pts = x1[None, :] + rs[:, None] * v[None, :]
    return pts + rng.randn(*pts.shape) * std


def sample_crazy_shape(seed, n, std=0.005, rng=None):
    """Structured latent point clouds selected by seed range.  ``rng``
    defaults to a fresh ``RandomState(seed)``."""
    if rng is None:
        rng = np.random.RandomState(seed)
    if seed % 1000 > 4:
        std = 0.27386127875258309 / np.sqrt(n)

    def line(n, a, b, std=0.005):
        return sample_points_line(n, a, b, std=std, rng=rng)

    def sample_X(n):
        X1 = line(n // 2, (0.1, 0.1), (0.9, 0.9))
        X2 = line(n - n // 2, (0.1, 0.9), (0.9, 0.1))
        return np.vstack([X1, X2])

    def sample_diamond(n):
        q = n // 4
        X1 = line(q, (0.5, 0.9), (0.9, 0.5))
        X2 = line(q, (0.5, 0.9), (0.1, 0.5))
        X3 = line(q, (0.1, 0.5), (0.5, 0.1))
        X4 = line(n - 3 * q, (0.5, 0.1), (0.9, 0.5))
        return np.vstack([X1, X2, X3, X4])

    def sample_crazy_lines(n, std=0.005):
        seg_npts = 250
        segments = max(n // seg_npts, 1)
        segment_len = 41.10960958218894 / np.sqrt(n)  # length 1.3 at 1000 pts
        Xs = []
        remaining = n
        for i in range(segments):
            npts = seg_npts if i < segments - 1 else remaining
            while True:
                x1 = rng.rand(2)
                v = rng.rand(2)
                v /= np.linalg.norm(v)
                x2 = x1 + v * segment_len
                if 0 < x2[0] < 1 and 0 < x2[1] < 1:
                    Xs.append(line(npts, x1, x2, std=std))
                    remaining -= npts
                    break
        return np.vstack(Xs)

    def sample_fault(n, std=0.005):
        sn = n // 10
        pts = [
            ((0.1, 0.1), (0.2, 0.2)),
            ((0.2, 0.2), (0.2, 0.5)),
            ((0.2, 0.2), (0.3, 0.3)),
            ((0.3, 0.3), (0.5, 0.1)),
            ((0.3, 0.3), (0.4, 0.45)),
            ((0.4, 0.45), (0.2, 0.8)),
            ((0.4, 0.45), (0.5, 0.6)),
            ((0.5, 0.6), (0.9, 0.4)),
            ((0.5, 0.6), (0.8, 0.9)),
            ((0.9, 0.4), (0.8, 0.1)),
        ]
        Xs = [line(sn, a, b, std=std) for a, b in pts[:-1]]
        Xs.append(line(n - 9 * sn, *pts[-1], std=std))
        return np.vstack(Xs)

    if seed < 1100:
        return sample_fault(n=n)
    elif seed < 1200:
        return sample_X(n=n)
    elif seed < 1300:
        return sample_diamond(n=n)
    elif seed < 1350:
        return sample_crazy_lines(n=n, std=0.005)
    elif seed < 1400:
        return sample_crazy_lines(n=n, std=0.00005)
    raise ValueError(f"seed {seed} outside crazy-shape ranges")


def sample_y(X, cov: GPCov, noise_var, yd, sparse_lscales=4.0, *, rng):
    """Draw Y ~ N(0, K(X) + noise_var I), [n, yd]: by one dense float64
    Cholesky on the host below :data:`DENSE_SAMPLING_LIMIT` points; above
    it, by the sampler ``GPRF_SAMPLER`` names (module docstring), the
    sparse and banded draws from the kernel truncated at ``sparse_lscales``
    scaled lengthscales."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    if n < DENSE_SAMPLING_LIMIT:
        L = jitchol(kernel_matrix_np(cov, X, noise_var=noise_var))
        return L @ rng.randn(n, yd)
    from gprf_torch.sparse.ops import sample_y_banded, sample_y_sparse

    sampler = os.environ.get("GPRF_SAMPLER", "")
    if sampler == "hi":
        return sample_y_blocked(X, cov, noise_var, yd, n_condition=8192, knn=96, rng=rng)
    if sampler == "vecchia":
        return sample_y_blocked(X, cov, noise_var, yd, rng=rng)
    if not sampler and n <= 20000:
        return sample_y_sparse(X, cov, noise_var, yd, max_scaled_dist=sparse_lscales, rng=rng)
    return sample_y_banded(X, cov, noise_var, yd, max_scaled_dist=sparse_lscales, rng=rng,
                           verbose=True)


def sample_y_blocked(X, cov: GPCov, noise_var, yd, blocksize=512, n_condition=1536, knn=24, *,
                     rng):
    """The Vecchia draw from the GP prior for large n: Morton-order the
    points, cut them into consecutive blocks, and draw each block from its
    exact conditional given the nearest points drawn before it (the union
    of each new point's ``knn`` nearest, at most ``n_condition`` of them,
    the closest to the block's centroid), with the normal draws from
    ``rng``.  Conditioning on the nearest points, not on a window of the
    Morton order, leaves no seams in the field where the order turns."""
    from scipy.spatial import cKDTree

    X = np.asarray(X, dtype=np.float64)
    n = len(X)
    Xs, perm = sort_morton(X)
    Y = np.zeros((n, yd))
    for start in range(0, n, blocksize):
        end = min(start + blocksize, n)
        Xb = Xs[start:end]
        Kbb = cross_kernel_matrix_np(cov, Xb, Xb) + noise_var * np.eye(end - start)
        if start == 0:
            Y[start:end] = jitchol(Kbb) @ rng.standard_normal((end - start, yd))
            continue
        _, idx = cKDTree(Xs[:start]).query(Xb, k=min(knn, start))
        cond = np.unique(np.asarray(idx).reshape(-1))
        if len(cond) > n_condition:
            dc = np.linalg.norm(Xs[cond] - Xb.mean(axis=0), axis=1)
            cond = cond[np.argsort(dc)[:n_condition]]
        Xc = Xs[cond]
        Kcb = cross_kernel_matrix_np(cov, Xc, Xb)
        Lc = jitchol(cross_kernel_matrix_np(cov, Xc, Xc) + noise_var * np.eye(len(cond)))
        A = np.linalg.solve(Lc, Kcb)  # Lc^-1 Kcb
        mean = A.T @ np.linalg.solve(Lc, Y[cond])
        Ls = jitchol(Kbb - A.T @ A)
        Y[start:end] = mean + Ls @ rng.standard_normal((end - start, yd))
    out = np.empty_like(Y)
    out[perm] = Y
    return out


def sampler_suffix(n) -> str:
    """Cache-key and run-directory suffix naming the large-n prior sampler
    in effect (``GPRF_SAMPLER``; other samplers give other data)."""
    sampler = os.environ.get("GPRF_SAMPLER", "")
    if sampler == "vecchia":
        return ""
    if not sampler:
        sampler = "exact" if n > 20000 else ""
    return "_y%s" % sampler if sampler else ""


def sample_synthetic(seed=1, n=400, xd=2, yd=10, lscale=0.1, noise_var=0.01):
    """(X, Y, cov): latent locations, GP-prior outputs and the generating
    covariance (float64 on the host)."""
    rng = np.random.RandomState(seed)
    if seed < 1000:
        X = rng.rand(n, xd)
    else:
        X = sample_crazy_shape(seed, n, rng=rng)
        assert X.shape[0] == n
    cov = GPCov.create([1.0], [lscale] * xd, "euclidean", "se", device="cpu", dtype=torch.float64)
    y = sample_y(X, cov, noise_var, yd, rng=rng)
    return X, y, cov
