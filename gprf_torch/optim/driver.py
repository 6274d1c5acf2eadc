"""The scipy L-BFGS-B optimization driver with checkpointing, logging and a
time limit (mirror of ``gprf_tpu/optim/driver.py``).

:func:`do_optimization` optimizes [flat X, log-cov * cov_scale] with scipy,
writing per evaluation a ``step_%05d_X.npy`` / ``step_%05d_cov.npy``
checkpoint and a ``log.txt`` row ``step time ll``, aborting on the wall
clock through :class:`OutOfTimeError`, and leaving a ``finished`` marker.
The inner objective is ``GPRF.llgrad`` on the model's device; this is a
thin host loop around it.
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


def do_optimization_seismic(*args, **kwargs):
    raise NotImplementedError("the seismic driver is not ported yet (ROADMAP, still to port: "
                              "the seismic experiment)")


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
