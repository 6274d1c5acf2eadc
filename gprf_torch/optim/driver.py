"""The scipy L-BFGS-B optimization drivers with checkpointing, logging and
a time limit (mirror of ``gprf_tpu/optim/driver.py``).

:func:`do_optimization` (synthetic) optimizes [flat X, log-cov *
cov_scale]; :func:`do_optimization_seismic` optimizes [flat X with depth /
100, log-cov] with the seismic clamps and cov-gradient clip.  Both write
per evaluation a ``step_%05d_X.npy`` / ``step_%05d_cov.npy`` checkpoint and
a ``log.txt`` row ``step time ll``, abort on the wall clock through
:class:`OutOfTimeError`, and leave a ``finished`` marker.  The inner
objective is ``GPRF.llgrad`` on the model's device; these are thin host
loops around it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import scipy.optimize

from gprf_torch.optim.priors import synthetic_cov_prior
from gprf_torch.utils.io import save_step


class OutOfTimeError(Exception):
    pass


def _full_cov(C, C0, sdata_dx, noise_var):
    """Expand the optimized cov block to a full [nv, sv, l...] row: one
    parameter is a shared lengthscale under fixed noise and unit signal
    variance; four are the row itself."""
    C = np.asarray(C)
    if C.shape[1] == 1:
        FC = np.empty((C.shape[0], 2 + sdata_dx))
        FC[:, 0] = noise_var
        FC[:, 1] = 1.0
        FC[:, 2:3] = C
        FC[:, 3:4] = C
    elif C.shape[1] == 4:
        FC = C
    else:
        raise ValueError("unrecognized cov param shape")
    return FC


def _collapse_cov_grad(grad_FC, C0):
    if C0.shape[1] == 1:
        return grad_FC[:, 2:3] + grad_FC[:, 3:4]
    elif C0.shape[1] == 4:
        return grad_FC
    raise ValueError("unrecognized cov param shape")


def do_optimization(d, gprf, X0, C0, sdata, method="l-bfgs-b", maxsec=3600, parallel=False):
    """Synthetic-experiment optimization loop.  Optimizes X (task=x), cov
    (task=cov), or both (task=xcov) depending on which of X0 / C0 is not
    None."""
    gradX = X0 is not None
    gradC = C0 is not None

    x0 = X0.flatten() if gradX else np.array(())
    cov_scale = 5.0  # preconditions the log-cov coordinates against X's
    c0 = np.log(C0.flatten()) * cov_scale if gradC else np.array(())
    full0 = np.concatenate([x0, c0])

    sstep = [0]
    f_log = open(os.path.join(d, "log.txt"), "w")
    t0 = time.time()

    def lgpllgrad(x):
        if time.time() - t0 > maxsec:
            raise OutOfTimeError
        xx = x[: len(x0)]
        xc = x[len(x0):] / cov_scale

        if gradX:
            XX = xx.reshape(X0.shape)
            gprf.update_X(XX)
            save_step(d, sstep[0], X=XX)
        if gradC:
            C = np.exp(xc.reshape(C0.shape))
            FC = _full_cov(C, C0, sdata.X_obs.shape[1], sdata.noise_var)
            gprf.update_covs(FC)
            save_step(d, sstep[0], FC=FC)

        ll, gX, gC = gprf.llgrad(local=True, grad_X=gradX, grad_cov=gradC, parallel=parallel)

        if gradX:
            prior_ll, prior_grad = sdata.x_prior(xx)
            ll += prior_ll
            gX = gX.flatten() + prior_grad
        else:
            gX = np.array(())
        if gradC:
            prior_ll, prior_grad = synthetic_cov_prior(xc.flatten())
            ll += prior_ll
            # chain rule of the log-scale parameterization: dll/dlogc = dll/dc * c
            gC = (np.asarray(_collapse_cov_grad(gC, C0)) * C).flatten() + prior_grad
            gC /= cov_scale
        else:
            gC = np.array(())

        grad = np.concatenate([np.asarray(gX).flatten(), np.asarray(gC).flatten()])

        f_log.write("%d %.2f %.2f\n" % (sstep[0], time.time() - t0, ll))
        f_log.flush()
        sstep[0] += 1
        return -ll, -grad

    try:
        scipy.optimize.minimize(lgpllgrad, full0, jac=True, method=method,
                                options={"ftol": 1e-6, "maxiter": 200})
    except OutOfTimeError:
        print("terminated optimization for time")

    f_log.write("optimization finished after %.fs\n" % (time.time() - t0))
    f_log.close()
    with open(os.path.join(d, "finished"), "w") as f:
        f.write("")


def do_optimization_seismic(d, gprf, X0, C0, cov_prior, x_prior, maxsec=3600, parallel=False,
                            sparse=False, depth_scale=100.0, rng=None):
    """Seismic optimization loop: X (task x), cov (task cov) or both,
    depending on which of X0 / C0 is not None.

    The depth column is optimized divided by ``depth_scale``; the cov row
    [nv, sv, l_h, l_z] in log space with sv pinned at 1, nv <= 10 and
    1 <= l <= 999; the cov gradient's lengthscale part is scaled down when
    its largest entry passes 10.  An evaluation whose objective or X
    gradient is not finite answers 1e10 and a random gradient drawn from
    ``rng`` (default ``default_rng(0)``), which keeps L-BFGS-B going; any
    other failure raises.  ``covs.txt`` gets the cov row of every
    evaluation."""
    rng = rng or np.random.default_rng(0)
    gradX = X0 is not None
    gradC = C0 is not None

    X0 = None if X0 is None else np.asarray(X0, dtype=np.float64).copy()
    if gradX:
        X0[:, 2] /= depth_scale
        x0 = X0.flatten()
    else:
        x0 = np.array(())
    c0 = np.log(C0.flatten()) if gradC else np.array(())
    full0 = np.concatenate([x0, c0])

    sstep = [0]
    f_log = open(os.path.join(d, "log.txt"), "w")
    covf = open(os.path.join(d, "covs.txt"), "w")
    t0 = time.time()

    def lgpllgrad(x):
        xx = x[: len(x0)]
        xc = x[len(x0):]

        FC = None
        if gradX:
            XX = xx.reshape(X0.shape).copy()
            XX[:, 2] *= depth_scale
            gprf.update_X(XX)
            save_step(d, sstep[0], X=XX)
        else:
            XX = gprf.X
        if gradC:
            FC = np.exp(xc.reshape(C0.shape))
            FC[0, 1] = 1.0  # the signal variance is not learned
            FC[0, 0] = min(FC[0, 0], 10.0)
            FC[0, 2] = np.clip(FC[0, 2], 1.0, 999.0)
            FC[0, 3] = np.clip(FC[0, 3], 1.0, 999.0)
            gprf.update_covs(FC)
            save_step(d, sstep[0], FC=FC)

        ll, gX, gC = gprf.llgrad(local=True, grad_X=gradX, grad_cov=gradC, parallel=parallel,
                                 sparse=sparse)
        if not np.isfinite(ll) or not np.all(np.isfinite(gX)):
            print("fail: non-finite objective")
            return 1e10, rng.standard_normal(x.shape)

        if gradX:
            gX = np.asarray(gX)
            gX[:, 2] *= depth_scale
            prior_ll, prior_grad = x_prior(XX)
            prior_grad = np.asarray(prior_grad).copy()
            prior_grad[:, 2] *= depth_scale
            ll += prior_ll
            gX = gX.flatten() + prior_grad.flatten()
        else:
            gX = np.array(())
        if gradC:
            prior_ll, prior_grad = cov_prior(xc)
            ll += prior_ll
            gC = (np.asarray(gC) * FC).flatten() + prior_grad
            gC[1] = 0.0  # sv is not learned
            max_grad = np.max(np.abs(gC[2:]))
            if max_grad > 10:
                gC[2:] *= 2.0 / (1 + max_grad / 10.0)
        else:
            gC = np.array(())

        grad = np.concatenate([np.asarray(gX).flatten(), np.asarray(gC).flatten()])

        f_log.write("%d %.2f %.2f\n" % (sstep[0], time.time() - t0, ll))
        f_log.flush()
        if gradC:
            covf.write("%d %s\n" % (sstep[0], FC))
            covf.flush()
        sstep[0] += 1
        if time.time() - t0 > maxsec:
            raise OutOfTimeError
        return -ll, -grad

    try:
        scipy.optimize.minimize(lgpllgrad, full0, jac=True, method="l-bfgs-b")
    except OutOfTimeError:
        print("terminated optimization for time")

    f_log.write("optimization finished after %.fs\n" % (time.time() - t0))
    f_log.close()
    covf.close()
    with open(os.path.join(d, "finished"), "w") as f:
        f.write("")


def load_log(d):
    """Parse log.txt into (steps, times, lls) arrays."""
    steps, times, lls = [], [], []
    with open(os.path.join(d, "log.txt"), "r") as lf:
        for line in lf:
            try:
                step, t, ll = line.split(" ")
                steps.append(int(step))
                times.append(float(t))
                lls.append(float(ll))
            except ValueError:
                continue
    return np.asarray(steps), np.asarray(times), np.asarray(lls)
