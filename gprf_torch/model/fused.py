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

The losses take one theta [ntheta] and return a scalar, or R replicas'
thetas [R, ntheta] and return [R]: the replicas are re-blocked one by one
and then folded into the objective's kernel batch
(:func:`gprf_torch.model.objective.gprf_ll_schur`), so one gradient of the
sum gives each replica its own gradient.

Past m = 512 the losses chunk the pair pass by 64 edges, recomputing each
chunk's forward in the backward, as the reference does (its chunk sweep
at the 80k shapes chose 64); ``pair_chunk`` sets another chunk.

:func:`fused_grid_objective` and :func:`fused_grid_value_and_grad` are the
reference's functional forms of the grid task-x objective, with
``pair_mode`` "schur" or "joint" (the parity oracle,
:func:`gprf_torch.model.objective.gprf_ll`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.objective import GPRFParams, _value_and_grad, gprf_ll, gprf_ll_schur
from gprf_torch.ops.mvn import KERNEL_OPS, Ops
from gprf_torch.partition.rpc_device import FlatRPCTree, assign_blocks_rpc
from gprf_torch.utils.profiling import span


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


def grid_labels(X, centers):
    """Each point's nearest center, labels [..., n] of X [..., n, dx]."""
    scores = -2.0 * (X @ centers.T) + torch.sum(centers * centers, dim=1)
    return torch.argmin(scores, dim=-1)


def fused_grid_objective(params: GPRFParams, Y, centers, edges, unary_weights, X_obs_flat,
                         obs_std, m: int, dfn_str: str = "euclidean", wfn_str: str = "se",
                         pair_mode: str = "schur", ops: Ops = KERNEL_OPS):
    """(ll + X prior, overflow) of the grid partition with ``centers``
    [B, dx]: the nearest-center re-block outside the graph, then the Schur
    form (``pair_mode="schur"``, over ``ops``) or the joint form
    (``"joint"``, through ``torch.linalg``), and the Gaussian prior of X
    around ``X_obs_flat``."""
    if pair_mode not in ("schur", "joint"):
        raise ValueError(f"unknown pair_mode {pair_mode!r}: 'schur' or 'joint'")
    X = params.X
    assignment, mask, overflow = assemble_layout(grid_labels(X.detach(), centers),
                                                 centers.shape[0], m)
    pair_weights = torch.ones(edges.shape[0], dtype=X.dtype, device=X.device)
    if pair_mode == "schur":
        ll = gprf_ll_schur(params, Y, assignment, mask, edges, unary_weights, pair_weights,
                           dfn_str=dfn_str, wfn_str=wfn_str, ops=ops)
    else:
        ei, ej = edges[:, 0].long(), edges[:, 1].long()
        ll = gprf_ll(params, Y, assignment, mask, torch.cat([assignment[ei], assignment[ej]], 1),
                     torch.cat([mask[ei], mask[ej]], 1), unary_weights, pair_weights,
                     dfn_str=dfn_str, wfn_str=wfn_str)
    r = (X.reshape(-1) - X_obs_flat) / obs_std
    n_flat = X_obs_flat.shape[0]
    prior = -0.5 * torch.sum(r * r) - 0.5 * n_flat * math.log(2 * math.pi * obs_std**2)
    return ll + prior, overflow


def fused_grid_value_and_grad(params: GPRFParams, Y, centers, edges, unary_weights, X_obs_flat,
                              obs_std, m: int, dfn_str: str = "euclidean", wfn_str: str = "se",
                              grad_cov: bool = False, pair_mode: str = "schur",
                              ops: Ops = KERNEL_OPS):
    """(nll, ngrad_flat [n dx], gradCov [2 + k], overflow) of
    :func:`fused_grid_objective`: the loss and its X gradient negated, and
    the hyperparameters' gradient of ll + prior, [d noise_var, d
    signal_var, d lengthscales] (zeros unless ``grad_cov``), as the
    reference returns them."""
    overflow = []

    def objective(p):
        ll, flag = fused_grid_objective(p, Y, centers, edges, unary_weights, X_obs_flat, obs_std,
                                        m, dfn_str=dfn_str, wfn_str=wfn_str, pair_mode=pair_mode,
                                        ops=ops)
        overflow.append(flag)
        return ll

    ll, gX, gC = _value_and_grad(objective, params, True, grad_cov)
    return -ll, -gX.reshape(-1), gC.reshape(-1), overflow[0]


def block_counts(blocks, B: int):
    """Points per block [..., B] from labels [..., n]."""
    blocks = blocks.long()
    counts = torch.zeros((*blocks.shape[:-1], B), dtype=torch.int64, device=blocks.device)
    return counts.scatter_add_(-1, blocks, torch.ones_like(blocks))


def stacked_layout(blocks, B: int, m: int):
    """:func:`assemble_layout` of each replica's labels [R, n], stacked:
    (assignment [R, B, m], mask [R, B, m], overflow [R])."""
    if len(blocks) == 1:  # views: no copy on the single-start path
        return tuple(t[None] for t in assemble_layout(blocks[0], B, m))
    parts = [assemble_layout(b, B, m) for b in blocks]
    return tuple(torch.stack(t) for t in zip(*parts))


class FusedSyntheticGPRF:
    """Fused synthetic GPRF evaluation for tasks x / cov / xcov over a grid
    partition (``centers``) or an RPC partition (``rpc_tree``, the split
    tree of :func:`gprf_torch.partition.rpc.cluster_rpc`, replayed on the
    device with the median recomputed at every node).

    theta layout: [X.flatten()] (tasks x, xcov) ++ [log(C).flatten() *
    cov_scale] (tasks cov, xcov), with ``cov_scale = 5`` and the
    ``full_cov`` expansion of ``gprf_tpu`` (a 1-parameter C is a shared
    lengthscale with noise and signal variance fixed; a 4-parameter C is
    [nv, sv, l1, l2]).  Priors: an isotropic Gaussian X-prior around X_obs
    and a N(-1, 10^2) prior on the log-scale cov parameters.  For task=cov
    the locations stay at X0.

    ``ops`` picks the leaf primitives: the kernels (default) or their plain
    twins under PyTorch's autograd, for comparison.  ``mvn_inv`` and
    ``unary_doubling`` pick a route of the objective
    (:mod:`gprf_torch.model.objective`); both default off.  ``pair_chunk``
    chunks the pair pass (default: 64 edges past m = 512, else none;
    :attr:`loss_pair_chunk`).  Like ``ops``, they are attributes that each
    new loss reads when it is made.
    """

    COV_SCALE = 5.0

    def __init__(self, X0, Y, edges, X_obs, obs_std, cov: GPCov, noise_var,
                 task: str = "x", C0=None, centers=None, rpc_tree=None, m=None, *,
                 device: torch.device | str, dtype: torch.dtype, acc_dtype=None,
                 ops: Ops = KERNEL_OPS, mvn_inv: bool = False, unary_doubling: bool = False,
                 pair_chunk: int | None = None):
        with span("build"):
            if task not in ("x", "cov", "xcov"):
                raise ValueError(f"unknown task {task!r}")
            if (centers is None) == (rpc_tree is None):
                raise ValueError("exactly one of centers / rpc_tree selects the partition")
            self.task = task
            self.device = torch.device(device)
            self.dtype = dtype
            self.acc_dtype = acc_dtype
            self.ops = ops
            self.mvn_inv = mvn_inv
            self.unary_doubling = unary_doubling
            self.pair_chunk = pair_chunk
            self.Y = torch.tensor(np.asarray(Y), dtype=dtype, device=device)
            self.X0 = np.asarray(X0, dtype=np.float64)
            self.shape = self.X0.shape
            if centers is not None:
                self.kind = "grid"
                self.centers = torch.tensor(np.asarray(centers), dtype=dtype, device=device)
                B = len(centers)
            else:
                self.kind = "rpc"
                self.centers = None
                self._rpc = FlatRPCTree(rpc_tree, d=self.shape[1])
                self.rpc_arrays = self._rpc.device_arrays(device=device, dtype=dtype)
                B = self._rpc.n_blocks
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
        """Per-point block labels [..., n] of X [..., n, dx] (piecewise
        constant in X): the nearest center, or the RPC median replay."""
        if self.kind == "rpc":
            return assign_blocks_rpc(X, self.rpc_arrays, self._rpc.depth, self._rpc.n_nodes)
        return grid_labels(X, self.centers)

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

    @property
    def ncov(self) -> int:
        """Length of the packed-cov tail of theta (0 for task x): the
        drivers read just ``theta[-ncov:]`` for the covs.txt trajectory."""
        return 0 if self.task == "x" or self.C0 is None else self.C0.shape[1]

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

    def check_capacity_batch(self, thetas) -> bool:
        """:meth:`check_capacity` of every replica of thetas [R, ntheta], in
        one device call."""
        Xs = [self.unpack_host(t)[0] for t in np.asarray(thetas)]
        if Xs[0] is None:
            return True
        X = torch.as_tensor(np.stack(Xs), dtype=self.dtype, device=self.device)
        return int(block_counts(self._assign_device(X), self.n_blocks).max()) <= self.m

    def grow_capacity(self):
        self.m += 16

    @property
    def loss_pair_chunk(self) -> int | None:
        """The pair chunk of the losses made at the current m: the given
        one, else the reference's wide-m default, 64 edges past m = 512."""
        if self.pair_chunk is None and self.m > 512:
            return 64
        return self.pair_chunk

    def _unpack(self, theta, X_fixed):
        """Each replica's X [R, n, dx] from thetas [R, ntheta]."""
        nflat = int(np.prod(self.shape))
        if self.task in ("x", "xcov"):
            return theta[:, :nflat].reshape(-1, *self.shape), nflat
        return X_fixed.expand(theta.shape[0], *self.shape), nflat

    def overflow_fn(self):
        """theta [ntheta] or [R, ntheta] -> bool tensor [] or [R]: does a
        block outgrow m at this point?  Matches :meth:`check_capacity`
        without a host round trip."""
        B, m = self.n_blocks, self.m
        X_fixed = torch.as_tensor(self.X0, dtype=self.dtype, device=self.device)

        def f(theta):
            X, _ = self._unpack(theta.reshape(-1, theta.shape[-1]), X_fixed)
            counts = block_counts(self._assign_device(X.detach()), B)
            return (counts.amax(dim=-1) > m).reshape(theta.shape[:-1])

        return f

    # ---- the fused loss ----------------------------------------------------

    def objective_fn(self):
        """theta -> (loss, overflow) at the current capacity m; theta [ntheta]
        gives scalars, thetas [R, ntheta] give [R] each."""
        dtype, dev = self.dtype, self.device
        B, m, task = self.n_blocks, self.m, self.task
        ncov = None if self.C0 is None else self.C0.shape[1]
        base_cov, noise_var = self.cov, self.noise_var
        cov_scale, obs_std = self.COV_SCALE, self.obs_std
        X_fixed = torch.as_tensor(self.X0, dtype=dtype, device=dev)
        acc_dtype, ops = self.acc_dtype, self.ops
        routes = dict(mvn_inv=self.mvn_inv, unary_doubling=self.unary_doubling,
                      pair_chunk=self.loss_pair_chunk)

        def objective(theta):
            th = theta.reshape(-1, theta.shape[-1])
            R = th.shape[0]
            X, nflat = self._unpack(th, X_fixed)
            if task in ("cov", "xcov"):
                c = (th[:, nflat:] if task == "xcov" else th) / cov_scale
                C = torch.exp(c)
                if ncov == 1:
                    nv = torch.full((R,), noise_var, dtype=dtype, device=dev)
                    sv = torch.ones((R, 1), dtype=dtype, device=dev)
                    ls = torch.cat([C[:, :1], C[:, :1]], dim=1)
                else:
                    nv, sv, ls = C[:, 0], C[:, 1:2], C[:, 2:]
            else:
                nv = torch.full((R,), noise_var, dtype=dtype, device=dev)
                sv = base_cov.wfn_params.expand(R, 1)
                ls = base_cov.dfn_params.expand(R, -1)

            with span("reblock"):
                assignment, mask, overflow = stacked_layout(self._assign_device(X.detach()), B, m)
            params = GPRFParams(X=X, wfn_params=sv, dfn_params=ls, noise_var=nv)
            ll = gprf_ll_schur(
                params, self.Y, assignment, mask, self.edges, self.unary_weights,
                self.pair_weights, dfn_str=base_cov.dfn_str, wfn_str=base_cov.wfn_str,
                acc_dtype=acc_dtype, ops=ops, **routes,
            )
            with span("prior"):
                if task in ("x", "xcov"):
                    r = (X.reshape(R, -1) - self.X_obs_flat) / obs_std
                    ll = ll - 0.5 * torch.sum(r * r, dim=-1) - 0.5 * nflat * math.log(
                        2 * math.pi * obs_std**2)
                if task in ("cov", "xcov"):
                    rc = (c + 1.0) / 10.0
                    ll = ll - 0.5 * torch.sum(rc * rc, dim=-1) - 0.5 * c.shape[-1] * math.log(
                        2 * math.pi * 100.0)
            shape = theta.shape[:-1]
            return (-ll).reshape(shape), overflow.reshape(shape)

        return objective

    def loss_fn(self):
        """theta -> loss (the negative log-posterior) at the current m, a
        scalar, or [R] for thetas [R, ntheta]."""
        objective = self.objective_fn()
        return lambda theta: objective(theta)[0]


class FusedGridGPRF(FusedSyntheticGPRF):
    """Grid task=x specialization with the scipy-driver bridge
    :meth:`value_and_grad` (objective + gradient + capacity growth).  It
    carries the Schur form only; the joint form is
    :func:`fused_grid_objective`'s ``pair_mode="joint"``."""

    def __init__(self, X0, Y, centers, edges, X_obs, obs_std, cov: GPCov, noise_var,
                 m=None, pair_mode: str | None = None, *, device: torch.device | str,
                 dtype: torch.dtype, acc_dtype=None, ops: Ops = KERNEL_OPS,
                 mvn_inv: bool = False, unary_doubling: bool = False):
        if pair_mode not in (None, "schur"):
            raise ValueError(f"unsupported pair_mode {pair_mode!r}: use 'schur' (the joint "
                             "form is fused_grid_objective's pair_mode='joint')")
        super().__init__(X0, Y, edges, X_obs, obs_std, cov, noise_var, task="x",
                         centers=centers, m=m, device=device, dtype=dtype,
                         acc_dtype=acc_dtype, ops=ops, mvn_inv=mvn_inv,
                         unary_doubling=unary_doubling)

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
