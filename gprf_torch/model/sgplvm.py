"""Inducing-point GPLVM baselines (mirror of ``gprf_tpu/model/sgplvm.py``).

The paper compares GPRF against GPy's GPLVM family; the reference
implements that family itself, and this module is its counterpart, function
by function, on ``torch.linalg`` (the reference runs ``jax.scipy.linalg``;
neither reaches a hand-written kernel):

  * ``gplvm_type="sparse"``   -- the FITC collapsed marginal likelihood
    (Snelson & Ghahramani 2006) over ``num_inducing`` inducing inputs;
  * ``gplvm_type="titsias"``  -- Titsias (2009)'s collapsed variational
    bound with a point estimate for X (VarDTC, the estimator of GPy's
    ``SparseGPLVM`` rows of the paper);
  * ``gplvm_type="bayesian"`` -- the Titsias & Lawrence (2010) variational
    GP-LVM: q(X) = prod_n N(mu_n, diag(s_n)), the collapsed bound through
    the SE kernel's closed-form psi statistics, minus KL(q(X) || N(0, I));
    the observation prior enters on the means, and runs are scored on them;
  * ``gplvm_type="basic"``    -- the exact full-GP marginal likelihood.

Every bound is computed with Cholesky / Woodbury identities (no n x n
inverse for the sparse variants), with gradients with respect to X, Z and
the log-lengthscale (and log S) from autograd; float32 products run at
full precision, since ``gprf_torch`` pins TF32 off.  :func:`do_sgplvm` is
the reference's driver with its file protocol (``step_%05d_X.npy`` and
``step_%05d_IX.npy`` at every evaluation, ``log.txt`` rows, the time limit).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import scipy.optimize
import torch
from torch.utils.checkpoint import checkpoint

from gprf_torch.kernels.covfn import cross_kernel_matrix
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.linalg.masked import cholesky_nan
from gprf_torch.optim.driver import OutOfTimeError
from gprf_torch.utils.io import save_step

_LOG_2PI = math.log(2.0 * math.pi)

GPLVM_TYPES = ("sparse", "titsias", "bayesian", "basic")


def _rel_jitter(dtype):
    """Relative diagonal jitter for chol(Kmm): 1e-6 in float64, 1e-4 in
    float32, where 2,000 inducing points under an SE kernel are numerically
    low-rank and 1e-6 gives a NaN factor (the reference's measurement)."""
    return 1e-6 if torch.finfo(dtype).bits >= 64 else 1e-4


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _common_sparse_terms(X, Z, Y, cov: GPCov, noise_var):
    """The Woodbury pieces FITC and Titsias share: (n, dy, Kdiag, Qdiag, A)
    with A = Lm^-1 Kmn, Kmm = k(Z, Z) + jitter."""
    n = X.shape[0]
    dy = Y.shape[1]
    Kmm = cross_kernel_matrix(cov, Z, Z)
    Kmm = Kmm + _rel_jitter(Kmm.dtype) * cov.signal_var * _eye(Z.shape[0], Kmm)
    Knm = cross_kernel_matrix(cov, X, Z)
    Lm = cholesky_nan(Kmm)
    A = _solve_lower(Lm, Knm.mT)  # [k, n]
    Qdiag = torch.sum(A * A, dim=0)  # diag of Knm Kmm^-1 Kmn
    Kdiag = cov.signal_var.expand(n)  # stationary: k(x, x) = sv
    return n, dy, Kdiag, Qdiag, A


def _woodbury_mll(A, g, Y, dy, n):
    """log N(Y | 0, A^T A + diag(g)), summed over Y's columns, by Woodbury."""
    k = A.shape[0]
    Ag = A / g[None, :]
    B = _eye(k, A) + Ag @ A.mT
    LB = cholesky_nan(B)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(LB))) + torch.sum(torch.log(g))
    Yg = Y / g[:, None]
    c = _solve_lower(LB, A @ Yg)  # [k, dy]
    quad = torch.sum(Y * Yg) - torch.sum(c * c)
    return -0.5 * quad - 0.5 * dy * logdet - 0.5 * dy * n * _LOG_2PI


def fitc_mll(X, Z, Y, cov: GPCov, noise_var):
    """FITC collapsed marginal likelihood."""
    n, dy, Kdiag, Qdiag, A = _common_sparse_terms(X, Z, Y, cov, noise_var)
    g = Kdiag - Qdiag + noise_var
    return _woodbury_mll(A, g, Y, dy, n)


def titsias_bound(X, Z, Y, cov: GPCov, noise_var):
    """Titsias (2009)'s collapsed variational lower bound: the DTC marginal
    likelihood minus the trace correction dy / (2 sigma^2) tr(Knn - Qnn)."""
    n, dy, Kdiag, Qdiag, A = _common_sparse_terms(X, Z, Y, cov, noise_var)
    g = torch.full((n,), noise_var, dtype=A.dtype, device=A.device)
    mll = _woodbury_mll(A, g, Y, dy, n)
    trace_term = torch.sum(Kdiag - Qdiag)
    return mll - 0.5 * dy * trace_term / noise_var


def psi_statistics(mu, S, Z, sv, ls, chunk: int = 0):
    """The closed-form psi statistics of the SE kernel ``sv exp(-sum_q
    (x_q - z_q)^2 / l_q^2)`` under q(x_n) = N(mu_n, diag(S_n)): (psi0, a
    scalar; Psi1 [n, k]; Psi2 [k, k]).

    Psi2's per-point [k, k] matrices are summed over chunks of ``chunk``
    points (default: about 2^24 / k^2, at least 8; the last chunk padded
    with zero-weight rows), each chunk's forward computed again in the
    backward (``torch.utils.checkpoint``), so that memory stays at
    ``chunk * k^2``: the z-bar coupling makes Psi2 O(n k^2 d), with no
    einsum factorization."""
    n, d = mu.shape
    k = Z.shape[0]
    l2 = ls**2  # [d]

    # Psi1[n, k] = sv prod_q (1 + 2 S/l^2)^{-1/2} exp(-(mu - z)^2 / (l^2 + 2S))
    f1 = 1.0 + 2.0 * S / l2
    e1 = (mu[:, None, :] - Z[None, :, :]) ** 2 / (l2 + 2.0 * S)[:, None, :]
    Psi1 = sv * torch.exp(-0.5 * torch.sum(torch.log(f1), dim=1)[:, None] - torch.sum(e1, dim=2))

    # Psi2[k, k'] = sv^2 sum_n prod_q (1 + 4 S/l^2)^{-1/2}
    #     exp(-(z_k - z_k')^2 / (2 l^2) - (mu - zbar)^2 / (l^2/2 + 2 S))
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])  # [k, k, d]
    dz2 = (Z[:, None, :] - Z[None, :, :]) ** 2
    base = -torch.sum(dz2 / (2.0 * l2), dim=2)  # [k, k]
    if chunk <= 0:
        chunk = max(8, min(n, (1 << 24) // max(k * k, 1)))

    pad = (-n) % chunk
    mu_p = torch.cat([mu, mu.new_zeros((pad, d))])
    S_p = torch.cat([S, S.new_ones((pad, d))])
    w_p = torch.cat([mu.new_ones((n,)), mu.new_zeros((pad,))])

    def body(mu_c, S_c, w_c):
        f2 = 1.0 + 4.0 * S_c / l2
        logpref = -0.5 * torch.sum(torch.log(f2), dim=1)  # [c]
        denom = 0.5 * l2 + 2.0 * S_c  # [c, d]
        expo = mu.new_zeros((mu_c.shape[0], k, k))
        for q in range(d):  # d is 2 or 3: accumulate without a d axis
            expo = expo + ((mu_c[:, q, None, None] - zbar[None, :, :, q]) ** 2
                           / denom[:, q, None, None])
        return torch.sum(w_c[:, None, None] * torch.exp(logpref[:, None, None] - expo), dim=0)

    parts = []
    for s in range(0, n + pad, chunk):
        args = (mu_p[s:s + chunk], S_p[s:s + chunk], w_p[s:s + chunk])
        parts.append(checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
                     if torch.is_grad_enabled() else body(*args))
    Psi2 = sv**2 * torch.exp(base) * torch.sum(torch.stack(parts), dim=0)
    psi0 = n * sv
    return psi0, Psi1, Psi2


def bgplvm_collapsed_F(mu, S, Z, Y, cov: GPCov, noise_var):
    """The collapsed expected log-likelihood of the Titsias & Lawrence
    (2010) bound, everything but the KL over X.  With beta = 1/noise_var,
    A = beta Lm^-1 Psi2 Lm^-T and B = I + A:

        F = dy [-n/2 log 2pi + n/2 log beta - 1/2 logdet B - beta/2 psi0
                + 1/2 tr(A)] - beta/2 |Y|_F^2 + beta^2/2 |LB^-1 Lm^-1 Psi1^T Y|_F^2

    At S -> 0 it is :func:`titsias_bound`."""
    n, dy = Y.shape
    kz = Z.shape[0]
    sv = cov.signal_var
    psi0, Psi1, Psi2 = psi_statistics(mu, S, Z, sv, cov.dfn_params)
    Kmm = cross_kernel_matrix(cov, Z, Z)
    Kmm = Kmm + _rel_jitter(Kmm.dtype) * sv * _eye(kz, Kmm)
    Lm = cholesky_nan(Kmm)
    beta = 1.0 / noise_var
    T1 = _solve_lower(Lm, Psi2)
    A = beta * _solve_lower(Lm, T1.mT).mT
    LB = cholesky_nan(_eye(kz, A) + A)
    logdetB = 2.0 * torch.sum(torch.log(torch.diagonal(LB)))
    P = _solve_lower(Lm, Psi1.mT @ Y)  # [k, dy]
    c = _solve_lower(LB, P)
    F = dy * (
        -0.5 * n * _LOG_2PI
        + 0.5 * n * math.log(beta)
        - 0.5 * logdetB
        - 0.5 * beta * psi0
        + 0.5 * torch.trace(A)
    ) - 0.5 * beta * torch.sum(Y * Y) + 0.5 * beta**2 * torch.sum(c * c)
    return F


def bgplvm_bound(mu, S, Z, Y, cov: GPCov, noise_var, prior_mean=0.0, prior_var=1.0):
    """The variational GP-LVM lower bound: :func:`bgplvm_collapsed_F` minus
    KL(q(X) || N(prior_mean, prior_var)).  As GPy's BayesianGPLVM (and the
    reference), the internal prior is N(0, I) and the observation prior on
    the means is added by the driver."""
    F = bgplvm_collapsed_F(mu, S, Z, Y, cov, noise_var)
    kl = 0.5 * torch.sum((S + (mu - prior_mean) ** 2) / prior_var - 1.0 + math.log(prior_var)
                         - torch.log(S))
    return F - kl


def full_gplvm_mll(X, Y, cov: GPCov, noise_var):
    """The exact GP marginal likelihood (the 'basic' GPLVM objective)."""
    n = X.shape[0]
    dy = Y.shape[1]
    K = cross_kernel_matrix(cov, X, X) + noise_var * _eye(n, X)
    L = cholesky_nan(K)
    alpha = torch.cholesky_solve(Y, L)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return -0.5 * torch.sum(Y * alpha) - 0.5 * dy * logdet - 0.5 * dy * n * _LOG_2PI


def _cov(log_lscale, sv, like):
    ls = torch.exp(log_lscale) * like.new_ones((like.shape[1],))
    return GPCov(wfn_params=like.new_tensor([sv]), dfn_params=ls)


def _grads(ll, inputs):
    grads = torch.autograd.grad(ll, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


def _objective_and_grads(X, Z, log_lscale, Y, sv, noise_var, gplvm_type, learn_lscale):
    """(ll, dX, dZ, d log-lengthscale) of a point-estimate baseline; the last
    is zero unless ``learn_lscale``."""
    inputs = [t.detach().requires_grad_(True) for t in (X, Z, log_lscale)]
    X, Z, log_l = inputs
    with torch.enable_grad():
        cov = _cov(log_l, sv, X)
        if gplvm_type == "sparse":
            ll = fitc_mll(X, Z, Y, cov, noise_var)
        elif gplvm_type == "titsias":
            ll = titsias_bound(X, Z, Y, cov, noise_var)
        elif gplvm_type == "basic":
            ll = full_gplvm_mll(X, Y, cov, noise_var)
        else:
            raise ValueError(gplvm_type)
        gX, gZ, gl = _grads(ll, inputs)
    if not learn_lscale:
        gl = torch.zeros_like(gl)
    return ll.detach(), gX, gZ, gl


def _bgplvm_objective_and_grads(mu, logS, Z, log_lscale, Y, sv, noise_var, learn_lscale):
    """(bound, dmu, dlogS, dZ, d log-lengthscale) of the Bayesian GPLVM."""
    inputs = [t.detach().requires_grad_(True) for t in (mu, logS, Z, log_lscale)]
    mu, logS, Z, log_l = inputs
    with torch.enable_grad():
        ll = bgplvm_bound(mu, torch.exp(logS), Z, Y, _cov(log_l, sv, mu), noise_var,
                          prior_mean=0.0, prior_var=1.0)
        gmu, glogS, gZ, gl = _grads(ll, inputs)
    if not learn_lscale:
        gl = torch.zeros_like(gl)
    return ll.detach(), gmu, glogS, gZ, gl


def do_sgplvm(d, X0, C0, sdata, method="l-bfgs-b", maxsec=3600, gplvm_type="sparse",
              num_inducing=100, max_iters=None, *, device: torch.device | str,
              dtype: torch.dtype = torch.float32):
    """The baseline GPLVM driver with the reference's file protocol, its
    objective on ``device`` at ``dtype`` (float32 by default, as the
    reference's command line runs its baselines with 64-bit mode off).

    ``max_iters=None`` keeps the reference's scipy budget (ftol 1e-6,
    maxiter 200).  An explicit ``max_iters`` asks for a converged baseline:
    ftol 1e-10, and L-BFGS-B restarted from the current point while budget
    remains (a float32 gradient can abort a line search long before the
    budget), a ``scipy: nit=...`` line in log.txt per run, stopping after
    three restarts in a row that make no iteration."""
    X0 = np.asarray(X0, dtype=np.float64)
    n, xd = X0.shape
    Y = torch.as_tensor(np.asarray(sdata.SY), dtype=dtype, device=device)
    sv = 1.0
    noise_var = sdata.noise_var
    learn_lscale = C0 is not None
    log_lscale0 = math.log(float(sdata.cov.dfn_params[0]) if C0 is None
                           else float(np.asarray(C0).reshape(-1)[0]))

    if gplvm_type == "basic":
        num_inducing = 0
    if num_inducing > 0:
        rng = np.random.default_rng(0)
        Z0 = X0[rng.choice(n, size=min(num_inducing, n), replace=False)].copy()
    else:
        Z0 = np.zeros((0, xd))

    variational = gplvm_type == "bayesian"
    # q(X)'s variances start at the observation noise, the reference's
    # X_variance = obs_std^2
    logS0 = (np.full(X0.shape, 2.0 * math.log(max(float(sdata.obs_std), 1e-8)))
             if variational else np.zeros((0, xd)))

    nmeans = X0.size
    n_ls = logS0.size
    n_ix = Z0.size

    def pack(X, logS, Z, log_l):
        return np.concatenate([X.flatten(), logS.flatten(), Z.flatten(),
                               [log_l] if learn_lscale else []])

    def unpack(xx):
        X = xx[:nmeans].reshape(X0.shape)
        logS = xx[nmeans:nmeans + n_ls].reshape(logS0.shape)
        Z = xx[nmeans + n_ls:nmeans + n_ls + n_ix].reshape(Z0.shape)
        log_l = xx[-1] if learn_lscale else log_lscale0
        return X, logS, Z, log_l

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    sstep = [0]
    best = [np.inf, None]  # the best finite (nll, xx) of any evaluation
    f_log = open(os.path.join(d, "log.txt"), "w")
    t0 = time.time()

    def llgrad_wrapper(xx):
        X, logS, Z, log_l = unpack(xx)
        save_step(d, sstep[0], X=X)
        if n_ix:
            np.save(os.path.join(d, "step_%05d_IX.npy" % sstep[0]), Z)

        if variational:
            ll, gX, glogS, gZ, gl = _bgplvm_objective_and_grads(
                dev(X), dev(logS), dev(Z), dev(log_l), Y, sv, noise_var, learn_lscale)
            grad_parts = [gX, glogS, gZ]
        else:
            ll, gX, gZ, gl = _objective_and_grads(dev(X), dev(Z), dev(log_l), Y, sv, noise_var,
                                                  gplvm_type, learn_lscale)
            grad_parts = [gX, gZ]
        # one copy to the host per evaluation
        flat = torch.cat([ll.reshape(1)] + [g.reshape(-1) for g in grad_parts]
                         + [gl.reshape(1)]).double().cpu().numpy()
        nll = -float(flat[0])
        grad = -np.concatenate([flat[1:-1]] + ([flat[-1:]] if learn_lscale else []))

        prior_ll, prior_grad = sdata.x_prior(xx[:nmeans])
        nll -= prior_ll
        grad[:nmeans] -= prior_grad

        f_log.write("%d %.2f %.2f\n" % (sstep[0], time.time() - t0, -nll))
        f_log.flush()
        if np.isfinite(nll) and nll < best[0]:
            best[0], best[1] = nll, np.array(xx, dtype=np.float64)
        sstep[0] += 1
        if time.time() - t0 > maxsec:
            raise OutOfTimeError
        return nll, grad

    ftol = 1e-6 if max_iters is None else 1e-10
    budget = max_iters or 200
    x_cur = pack(X0, logS0, Z0, log_lscale0)
    zero_progress = 0
    try:
        while budget > 0:
            res = scipy.optimize.minimize(llgrad_wrapper, x_cur, jac=True, method=method,
                                          options={"ftol": ftol, "maxiter": budget})
            f_log.write("scipy: nit=%d success=%s %s\n" % (res.nit, res.success, str(res.message)))
            f_log.flush()
            budget -= max(int(res.nit), 1)
            if max_iters is None or res.success or not np.all(np.isfinite(res.x)):
                break
            # a restart that fails its first line search is at a point where
            # the gradient no longer descends; allow a couple, then stop
            zero_progress = zero_progress + 1 if res.nit == 0 else 0
            if zero_progress >= 3:
                f_log.write("scipy: stopping after 3 zero-progress restarts\n")
                break
            x_cur = res.x
    except OutOfTimeError:
        print("terminated optimization for time")

    # the last checkpoint can be a diverged line-search probe (every
    # evaluation is saved): save the best finite iterate again as the final
    # step, so that the analysis never ends on a probe
    if best[1] is not None:
        Xb, _, Zb, _ = unpack(best[1])
        save_step(d, sstep[0], X=Xb)
        if n_ix:
            np.save(os.path.join(d, "step_%05d_IX.npy" % sstep[0]), Zb)
        f_log.write("%d %.2f %.2f\n" % (sstep[0], time.time() - t0, -best[0]))
    f_log.write("optimization finished after %.fs\n" % (time.time() - t0))
    f_log.close()
    with open(os.path.join(d, "finished"), "w") as f:
        f.write("")
