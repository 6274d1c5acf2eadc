"""Fused per-step GPRF evaluation with on-device re-blocking (mirror of
``gprf_tpu/model/fused.py``).

    theta -> [device] nearest-center re-block (argmin + stable argsort +
             scatter into the padded layout), gather, Schur-form objective,
             priors -> loss;  autograd -> gradient

Re-blocking is outside the differentiated graph: block membership is
piecewise constant in X, so gradients flow only through the gathers.  If a
block outgrows the padded slot count m, the extra points are dropped and an
overflow flag (a device tensor, read by the caller when it chooses) says
that the layout must be rebuilt with a larger m.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.objective import GPRFParams, gprf_ll_schur
from gprf_torch.ops.mvn import KERNEL_OPS, Ops


def assemble_layout(blocks, B: int, m: int):
    """Padded [B, m] assignment + mask from per-point block labels [n].

    Stable-sort the labels, find each group's start by binary search, and
    scatter slot positions.  Positions past m go to a spare column m that
    is sliced off (PyTorch has no dropping scatter).  Returns (assignment,
    mask, overflow); ``overflow`` is a 0-d bool tensor, so nothing here
    waits for the device."""
    blocks = blocks.long()
    n = blocks.shape[0]
    dev = blocks.device
    order = torch.argsort(blocks, stable=True)
    sorted_blocks = blocks[order]
    counts = torch.zeros(B, dtype=torch.int64, device=dev).scatter_add_(
        0, blocks, torch.ones_like(blocks))
    starts = torch.searchsorted(
        sorted_blocks, torch.arange(B, dtype=blocks.dtype, device=dev), side="left")
    pos = torch.arange(n, device=dev) - starts[sorted_blocks]
    slots = torch.zeros((B, m + 1), dtype=torch.int64, device=dev)
    slots[sorted_blocks, pos.clamp(max=m)] = order
    assignment = slots[:, :m]
    mask = torch.arange(m, device=dev)[None, :] < counts[:, None]
    return assignment, mask, counts.max() > m


class FusedSyntheticGPRF:
    """Fused synthetic GPRF evaluation for tasks x / cov / xcov over a grid
    partition.

    theta layout: [X.flatten()] (tasks x, xcov) ++ [log(C).flatten() *
    cov_scale] (tasks cov, xcov), with ``cov_scale = 5`` and the
    ``full_cov`` expansion of ``gprf_tpu`` (a 1-parameter C is a shared
    lengthscale with noise and signal variance fixed; a 4-parameter C is
    [nv, sv, l1, l2]).  Priors: an isotropic Gaussian X-prior around X_obs
    and a N(-1, 10^2) prior on the log-scale cov parameters.  For task=cov
    the locations stay at X0.

    ``ops`` picks the leaf primitives: the kernels (default) or their plain
    twins under PyTorch's autograd, for comparison.
    """

    COV_SCALE = 5.0

    def __init__(self, X0, Y, edges, X_obs, obs_std, cov: GPCov, noise_var,
                 task: str = "x", C0=None, centers=None, rpc_tree=None, m=None, *,
                 device: torch.device | str, dtype: torch.dtype, acc_dtype=None,
                 ops: Ops = KERNEL_OPS):
        if task not in ("x", "cov", "xcov"):
            raise ValueError(f"unknown task {task!r}")
        if rpc_tree is not None:
            raise NotImplementedError("RPC partitions are not ported yet")
        if centers is None:
            raise ValueError("centers select the grid partition")
        self.task = task
        self.device = torch.device(device)
        self.dtype = dtype
        self.acc_dtype = acc_dtype
        self.ops = ops
        self.Y = torch.tensor(np.asarray(Y), dtype=dtype, device=device)
        self.X0 = np.asarray(X0, dtype=np.float64)
        self.shape = self.X0.shape
        self.centers = torch.tensor(np.asarray(centers), dtype=dtype, device=device)
        B = len(centers)
        self.n_blocks = B

        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.edges = torch.as_tensor(edges, device=device)
        counts = np.zeros(B, dtype=np.int64)
        np.add.at(counts, edges.reshape(-1), 1)
        self.unary_weights = torch.as_tensor(1.0 - counts, dtype=dtype, device=device)
        self.pair_weights = torch.ones(len(edges), dtype=dtype, device=device)
        self.X_obs_flat = torch.tensor(np.asarray(X_obs).reshape(-1), dtype=dtype,
                                       device=device)
        self.obs_std = float(obs_std)
        self.cov = cov.to(device=device, dtype=dtype)
        self.noise_var = float(noise_var)
        self.C0 = None if C0 is None else np.asarray(C0, dtype=np.float64).reshape(1, -1)
        if task in ("cov", "xcov") and (self.C0 is None or self.C0.shape[1] not in (1, 4)):
            raise ValueError("tasks cov/xcov need C0 with 1 or 4 parameters")

        if m is None:
            sizes = np.bincount(self._assign_host(self.X0), minlength=B)
            m = (int(sizes.max()) + 7) // 8 * 8
        self.m = m

    # ---- partition ---------------------------------------------------------

    def _assign_device(self, X):
        """Per-point nearest-center labels (piecewise constant in X)."""
        c = self.centers
        scores = -2.0 * (X @ c.T) + torch.sum(c * c, dim=1)
        return torch.argmin(scores, dim=1)

    def _assign_host(self, X):
        X = torch.as_tensor(np.asarray(X), dtype=self.dtype, device=self.device)
        return self._assign_device(X).cpu().numpy()

    # ---- theta packing -----------------------------------------------------

    def theta0(self, X0=None, C0=None):
        parts = []
        if self.task in ("x", "xcov"):
            X0 = self.X0 if X0 is None else np.asarray(X0, dtype=np.float64)
            parts.append(X0.reshape(-1))
        if self.task in ("cov", "xcov"):
            C0 = self.C0 if C0 is None else np.asarray(C0, dtype=np.float64)
            parts.append(np.log(C0.reshape(-1)) * self.COV_SCALE)
        return np.concatenate(parts)

    def unpack_host(self, theta):
        """(X, FC) on the host from a flat theta."""
        theta = np.asarray(theta, dtype=np.float64)
        nflat = int(np.prod(self.shape))
        X = theta[:nflat].reshape(self.shape).copy() if self.task in ("x", "xcov") else None
        FC = None
        if self.task in ("cov", "xcov"):
            c = (theta[nflat:] if self.task == "xcov" else theta) / self.COV_SCALE
            C = np.exp(c).reshape(self.C0.shape)
            if C.shape[1] == 1:
                FC = np.array([[self.noise_var, 1.0, C[0, 0], C[0, 0]]], dtype=np.float64)
            else:
                FC = C
        return X, FC

    def check_capacity(self, theta) -> bool:
        X, _ = self.unpack_host(theta)
        if X is None:
            return True
        counts = np.bincount(self._assign_host(X), minlength=self.n_blocks)
        return int(counts.max()) <= self.m

    def grow_capacity(self):
        self.m += 16

    def _unpack(self, theta, X_fixed):
        nflat = int(np.prod(self.shape))
        X = theta[:nflat].reshape(self.shape) if self.task in ("x", "xcov") else X_fixed
        return X, nflat

    def overflow_fn(self):
        """theta -> 0-d bool tensor: does a block outgrow m at this point?
        Matches :meth:`check_capacity` without a host round trip."""
        B, m = self.n_blocks, self.m
        X_fixed = torch.as_tensor(self.X0, dtype=self.dtype, device=self.device)

        def f(theta):
            X, _ = self._unpack(theta, X_fixed)
            blocks = self._assign_device(X.detach())
            counts = torch.zeros(B, dtype=torch.int64, device=blocks.device).scatter_add_(
                0, blocks, torch.ones_like(blocks))
            return counts.max() > m

        return f

    # ---- the fused loss ----------------------------------------------------

    def objective_fn(self):
        """theta -> (loss, overflow) at the current capacity m."""
        dtype, dev = self.dtype, self.device
        B, m, task = self.n_blocks, self.m, self.task
        ncov = None if self.C0 is None else self.C0.shape[1]
        base_cov, noise_var = self.cov, self.noise_var
        cov_scale, obs_std = self.COV_SCALE, self.obs_std
        X_fixed = torch.as_tensor(self.X0, dtype=dtype, device=dev)
        acc_dtype, ops = self.acc_dtype, self.ops

        def objective(theta):
            X, nflat = self._unpack(theta, X_fixed)
            if task in ("cov", "xcov"):
                c = (theta[nflat:] if task == "xcov" else theta) / cov_scale
                C = torch.exp(c)
                if ncov == 1:
                    nv = torch.tensor(noise_var, dtype=dtype, device=dev)
                    sv = torch.ones((), dtype=dtype, device=dev)
                    ls = torch.stack([C[0], C[0]])
                else:
                    nv, sv, ls = C[0], C[1], C[2:]
            else:
                nv = torch.tensor(noise_var, dtype=dtype, device=dev)
                sv = base_cov.wfn_params[0]
                ls = base_cov.dfn_params

            assignment, mask, overflow = assemble_layout(
                self._assign_device(X.detach()), B, m)
            params = GPRFParams(X=X, wfn_params=sv.reshape(1), dfn_params=ls, noise_var=nv)
            ll = gprf_ll_schur(
                params, self.Y, assignment, mask, self.edges, self.unary_weights,
                self.pair_weights, dfn_str=base_cov.dfn_str, wfn_str=base_cov.wfn_str,
                acc_dtype=acc_dtype, ops=ops,
            )
            if task in ("x", "xcov"):
                r = (X.reshape(-1) - self.X_obs_flat) / obs_std
                ll = ll - 0.5 * torch.sum(r * r) - 0.5 * nflat * math.log(
                    2 * math.pi * obs_std**2)
            if task in ("cov", "xcov"):
                rc = (c + 1.0) / 10.0
                ll = ll - 0.5 * torch.sum(rc * rc) - 0.5 * c.shape[0] * math.log(
                    2 * math.pi * 100.0)
            return -ll, overflow

        return objective

    def loss_fn(self):
        """theta -> loss (the negative log-posterior) at the current m."""
        objective = self.objective_fn()
        return lambda theta: objective(theta)[0]


class FusedGridGPRF(FusedSyntheticGPRF):
    """Grid task=x specialization with the scipy-driver bridge
    :meth:`value_and_grad` (objective + gradient + capacity growth)."""

    def __init__(self, X0, Y, centers, edges, X_obs, obs_std, cov: GPCov, noise_var,
                 m=None, *, device: torch.device | str, dtype: torch.dtype,
                 acc_dtype=None, ops: Ops = KERNEL_OPS):
        super().__init__(X0, Y, edges, X_obs, obs_std, cov, noise_var, task="x",
                         centers=centers, m=m, device=device, dtype=dtype,
                         acc_dtype=acc_dtype, ops=ops)

    def value_and_grad(self, x_flat):
        """(nll, ngrad) as a float and a float64 numpy array; grows the
        capacity and re-evaluates on overflow."""
        while True:
            theta = torch.as_tensor(np.asarray(x_flat), dtype=self.dtype,
                                    device=self.device).requires_grad_(True)
            nll, overflow = self.objective_fn()(theta)
            if bool(overflow):
                self.grow_capacity()
                continue
            (g,) = torch.autograd.grad(nll, theta)
            return float(nll.detach()), g.cpu().numpy().astype(np.float64)
