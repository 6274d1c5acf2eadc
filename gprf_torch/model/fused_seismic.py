"""Fused per-step evaluation for the seismic workload (mirror of
``gprf_tpu/model/fused_seismic.py``).

    theta -> [device] PD-tree re-block (traversal of the frozen split tree
             over wrapped (lon, lat)), gather, Matern-3/2 great-circle
             Schur-form objective, location and hyperparameter priors
             -> loss;  autograd -> gradient

for tasks ``x``, ``cov`` and ``xcov``.  The transforms of the seismic
driver are kept: the depth coordinate is divided by ``depth_scale`` (100)
in theta, the covariance parameters are optimized in log space with the
signal variance pinned at 1 and the clamps nv <= 10, 1 <= lengthscales <=
999, and the cov prior carries its lengthscale explosion penalty.  Like the
reference's device engine, it does not clip the cov gradient (the host
driver's clip is a heuristic for scipy's L-BFGS-B).

As in :mod:`gprf_torch.model.fused`, the losses take theta [ntheta] or R
replicas [R, ntheta], and ``ops``, ``mvn_inv`` and ``unary_doubling`` pick
the leaf primitives and the route of the objective.  ``pair_chunk`` chunks
the pair pass; unlike the synthetic engine's, it has no default (none).

The loss marks its PD-tree re-block (``pdtree_reblock``) and its priors
(``prior``) with spans of :mod:`gprf_torch.utils.profiling`;
:func:`~gprf_torch.model.objective.gprf_ll_schur` marks its ``unary_pass``
and ``pair_pass``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.fused import block_counts, stacked_layout
from gprf_torch.model.objective import GPRFParams, gprf_ll_schur
from gprf_torch.ops.mvn import KERNEL_OPS, Ops
from gprf_torch.partition.pdtree import wrap_lon
from gprf_torch.partition.pdtree_device import FlatPDTree, assign_blocks_pdtree
from gprf_torch.utils.profiling import span

_LOG2PI = math.log(2.0 * math.pi)
_COV_PRIOR_MEANS = (-2.3, 0.0, 3.6, 3.6)


class FusedSeismicGPRF:
    """Fused seismic GPRF evaluation over a frozen PD-tree.

    theta layout: [x_scaled.flatten()] (tasks x, xcov; depth / depth_scale)
    ++ [log_c (4)] (tasks cov, xcov; log of [nv, sv, l_h, l_z]).  For task
    cov the locations stay at the prior means."""

    def __init__(self, X0, Y, tree, edges, prior_means, prior_std, cov: GPCov, noise_var,
                 task: str = "xcov", m: int | None = None, depth_scale: float = 100.0, *,
                 device: torch.device | str, dtype: torch.dtype, acc_dtype=None,
                 ops: Ops = KERNEL_OPS, mvn_inv: bool = False, unary_doubling: bool = False,
                 pair_chunk: int | None = None):
        if task not in ("x", "cov", "xcov"):
            raise ValueError(f"unknown task {task!r}")
        self.task = task
        self.pair_chunk = pair_chunk
        self.device = torch.device(device)
        self.dtype = dtype
        self.acc_dtype = acc_dtype
        self.ops = ops
        self.mvn_inv = mvn_inv
        self.unary_doubling = unary_doubling
        self.Y = torch.tensor(np.asarray(Y), dtype=dtype, device=device)
        self.flat = FlatPDTree(tree)
        self.tree_arrays = self.flat.device_arrays(device, dtype)
        self.depth = self.flat.depth
        B = self.flat.n_blocks
        self.n_blocks = B
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.edges = torch.as_tensor(edges, device=device)
        counts = np.zeros(B, dtype=np.int64)
        np.add.at(counts, edges.reshape(-1), 1)
        self.unary_weights = torch.as_tensor(1.0 - counts, dtype=dtype, device=device)
        self.pair_weights = torch.ones(len(edges), dtype=dtype, device=device)
        self.prior_means = torch.tensor(np.asarray(prior_means), dtype=dtype, device=device)
        self.prior_std = torch.tensor(np.asarray(prior_std), dtype=dtype, device=device)
        self.cov = cov.to(device=device, dtype=dtype)
        self.noise_var = float(noise_var)
        self.depth_scale = float(depth_scale)
        self.shape = np.asarray(X0).shape
        if m is None:
            sizes = [len(ix) for ix in tree.leaf_idx()]
            m = (max(sizes) + 7) // 8 * 8
        self.m = m

    # ---- theta packing -----------------------------------------------------

    def theta0(self, X0, C0):
        parts = []
        if self.task in ("x", "xcov"):
            Xs = np.asarray(X0, dtype=np.float64).copy()
            Xs[:, 2] /= self.depth_scale
            parts.append(Xs.reshape(-1))
        if self.task in ("cov", "xcov"):
            c = np.log(np.asarray(C0, dtype=np.float64).reshape(-1))
            # the loss and ncov assume the 4-slot packing (nv, sv, l_h, l_z)
            if c.size != self.ncov:
                raise ValueError("seismic C0 must pack %d params, got %d" % (self.ncov, c.size))
            parts.append(c)
        return np.concatenate(parts)

    @property
    def ncov(self) -> int:
        """Length of the packed-cov tail of theta (0 for task x): the
        seismic packing is always (noise_var, sv, l_h, l_z)."""
        return 0 if self.task == "x" else 4

    def unpack_host(self, theta):
        """(X, FC) on the host from a flat theta, with the loss's clamps."""
        theta = np.asarray(theta, dtype=np.float64)
        n = int(np.prod(self.shape))
        X = None
        if self.task in ("x", "xcov"):
            X = theta[:n].reshape(self.shape).copy()
            X[:, 2] *= self.depth_scale
        FC = None
        if self.task in ("cov", "xcov"):
            c = theta[n:] if self.task == "xcov" else theta
            FC = np.exp(c).reshape(1, -1)
            FC[0, 1] = 1.0
            FC[0, 0] = min(FC[0, 0], 10.0)
            FC[0, 2:] = np.clip(FC[0, 2:], 1.0, 999.0)
        return X, FC

    # ---- partition ---------------------------------------------------------

    def _blocks(self, X):
        """PD-tree block labels [..., n] of X [..., n, 3] over the wrapped
        (lon, lat); ``torch.remainder`` takes the divisor's sign, as the
        reference's ``%`` does."""
        lon = torch.remainder(X[..., 0] + 22.0, 360.0) - 22.0
        return assign_blocks_pdtree(torch.stack([lon, X[..., 1]], dim=-1), self.tree_arrays,
                                    self.depth)

    def check_capacity(self, theta) -> bool:
        return self.check_capacity_batch(np.asarray(theta)[None])

    def check_capacity_batch(self, thetas) -> bool:
        """Does the capacity m hold every replica of thetas [R, ntheta]?
        One device call; the host wraps the longitude as the reference's
        host check does."""
        X2s = []
        for t in np.asarray(thetas):
            X, _ = self.unpack_host(t)
            if X is None:
                return True
            X2 = X[:, :2].copy()
            X2[:, 0] = wrap_lon(X2[:, 0])
            X2s.append(X2)
        X2 = torch.as_tensor(np.stack(X2s), dtype=self.dtype, device=self.device)
        blocks = assign_blocks_pdtree(X2, self.tree_arrays, self.depth)
        return int(block_counts(blocks, self.n_blocks).max()) <= self.m

    def grow_capacity(self):
        self.m += 16

    def _locations(self, th):
        """Each replica's X [R, n, 3] (depth in km) from thetas [R, ntheta]."""
        R = th.shape[0]
        if self.task == "cov":
            return self.prior_means.expand(R, *self.shape)
        n = int(np.prod(self.shape))
        scale = torch.tensor([1.0, 1.0, self.depth_scale], dtype=self.dtype, device=self.device)
        return th[:, :n].reshape(R, *self.shape) * scale

    def overflow_fn(self):
        """theta [ntheta] or [R, ntheta] -> bool tensor [] or [R]: does a
        block outgrow m at this point?"""
        B, m = self.n_blocks, self.m

        def f(theta):
            X = self._locations(theta.reshape(-1, theta.shape[-1]))
            counts = block_counts(self._blocks(X.detach()), B)
            return (counts.amax(dim=-1) > m).reshape(theta.shape[:-1])

        return f

    # ---- the fused loss ----------------------------------------------------

    def loss_fn(self):
        """theta -> loss (the negative log-posterior) at the current m, a
        scalar, or [R] for thetas [R, ntheta]."""
        dtype, dev = self.dtype, self.device
        B, m, task = self.n_blocks, self.m, self.task
        n = int(np.prod(self.shape))
        base_cov, noise_var = self.cov, self.noise_var
        prior_means, prior_std = self.prior_means, self.prior_std
        acc_dtype, ops = self.acc_dtype, self.ops
        routes = dict(mvn_inv=self.mvn_inv, unary_doubling=self.unary_doubling,
                      pair_chunk=self.pair_chunk)
        cov_means = torch.tensor(_COV_PRIOR_MEANS, dtype=dtype, device=dev)
        # the location prior's normalization, summed over n // 3 events
        x_norm = 0.5 * (n // 3) * (3 * _LOG2PI + float(torch.sum(torch.log(prior_std**2))))

        def loss(theta):
            th = theta.reshape(-1, theta.shape[-1])
            R = th.shape[0]
            X = self._locations(th)
            if task in ("cov", "xcov"):
                c = th[:, n:] if task == "xcov" else th
                FC = torch.exp(c)
                nv = torch.clamp_max(FC[:, 0], 10.0)
                sv = torch.ones((R, 1), dtype=dtype, device=dev)  # not learned
                ls = torch.clamp(FC[:, 2:], 1.0, 999.0)
            else:
                nv = torch.full((R,), noise_var, dtype=dtype, device=dev)
                sv = base_cov.wfn_params.expand(R, 1)
                ls = base_cov.dfn_params.expand(R, -1)

            # membership is piecewise constant in X: outside the graph
            with span("pdtree_reblock"):
                assignment, mask, _ = stacked_layout(self._blocks(X.detach()), B, m)
            params = GPRFParams(X=X, wfn_params=sv, dfn_params=ls, noise_var=nv)
            ll = gprf_ll_schur(params, self.Y, assignment, mask, self.edges,
                               self.unary_weights, self.pair_weights, dfn_str="lld",
                               wfn_str="matern32", acc_dtype=acc_dtype, ops=ops, **routes)
            with span("prior"):
                if task in ("x", "xcov"):
                    r = (X - prior_means) / prior_std
                    ll = ll - 0.5 * torch.sum(r * r, dim=(-2, -1)) - x_norm
                if task in ("cov", "xcov"):
                    rc = (c - cov_means) / 1.5
                    ll = ll - 0.5 * torch.sum(rc * rc, dim=-1)
                    # the lengthscale explosion penalty
                    ll = ll - torch.where(c[:, 2] > 5.0, torch.exp(70.0 * (c[:, 2] - 5.0)),
                                          torch.zeros_like(c[:, 2]))
            return (-ll).reshape(theta.shape[:-1])

        return loss
