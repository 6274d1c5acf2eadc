"""Synthetic experiment CLI (mirror of ``gprf_tpu/cli/gprfopt.py``).

    python -m gprf_torch.cli.gprfopt --ntrain 10000 --ntest 500 --nblocks 100 \\
        --lscale 0.06 --obs_std 0.02 --local_dist 0.1 --task x --engine device

The reference's flags, run-directory naming (``build_run_name``: the name
encodes the configuration and doubles as the cache key) and ``do_run``
orchestration, plus ``--device`` (default ``cuda``; without a CUDA device
the default raises, and only ``--device cpu`` runs on the CPU).  Served:
both engines, tasks x / cov / xcov, grid partitions (``--nblocks``) and RPC
partitions (``--rpc_blocksize``: the host engine replays the splits on the
host, the device engine on the card), ``--init_x``, ``--init_true``,
``--init_seed``, ``--analyze``, ``--analyze_full`` (the predictive columns
of results.txt; under an RPC partition it raises IndexError, as the
reference's does), ``--multistart`` (device engine; the host engine ignores
it, as the reference's does), ``--refine_iters`` (device engine: the
float64 tail of :func:`~gprf_torch.optim.lbfgs.refine_f64`, on the run's
device, from the loop's last accepted point) and the GPLVM baselines
``--gplvm_type sparse|titsias|bayesian|basic`` with ``--num_inducing`` (host
engine, :mod:`gprf_torch.model.sgplvm`).
:func:`check_options` refuses what no engine serves.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time

import numpy as np
import torch

from gprf_torch.analysis.results import analyze_run
from gprf_torch.data.sampled import exp_base_dir, sample_data
from gprf_torch.data.synthetic import sampler_suffix
from gprf_torch.model.fused import FusedSyntheticGPRF
from gprf_torch.model.sgplvm import GPLVM_TYPES, do_sgplvm
from gprf_torch.ops.mvn import KERNEL_OPS, LINALG_OPS
from gprf_torch.optim.driver import do_optimization, load_log
from gprf_torch.optim.lbfgs import (do_optimization_fused, do_optimization_fused_theta,
                                    do_optimization_multistart,
                                    do_optimization_multistart_theta, last_accepted,
                                    refine_f64)
from gprf_torch.partition.grid import grid_centers
from gprf_torch.utils.device import resolve_device
from gprf_torch.utils.io import mkdir_p


def check_options(gplvm_type="gprf", engine="host", schur_precision=""):
    """Raise ValueError, before anything runs, for options that no engine
    serves: an unknown ``--gplvm_type``, a GPLVM baseline on the device
    engine (as the reference's ``do_run`` does), ``--schur_precision high``."""
    if gplvm_type != "gprf" and gplvm_type not in GPLVM_TYPES:
        raise ValueError(f"--gplvm_type {gplvm_type}: one of gprf, {', '.join(GPLVM_TYPES)}")
    if engine == "device" and gplvm_type != "gprf":
        raise ValueError("--engine=device serves GPRF runs; GPLVM baselines use the host engine")
    if schur_precision not in ("", "highest"):
        raise ValueError(f"--schur_precision {schur_precision}: gprf_torch computes every float32 "
                         "product at full precision (TF32 off) and has no faster, coarser mode")


def do_run(d, lscale, n, ntrain, nblocks, yd, seed=0, method="l-bfgs-b", obs_std=None,
           local_dist=1.0, maxsec=3600, max_iters=None, task="x", analyze_only=False,
           analyze_full=False, init_seed=-1, parallel=False, noise_var=0.01, rpc_blocksize=-1,
           gplvm_type="gprf", num_inducing=-1, init_true=False, init_x="", engine="host",
           refine_iters=0, multistart=1, ftol=1e-6, stall_patience=4, *,
           device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32,
           mvn_inv: bool = False, unary_doubling: bool = False):
    """One experiment in run directory ``d``: sample (or load) the data,
    optimize with the chosen engine, analyze.  ``device`` and ``dtype`` are
    where and at which width the objective runs; ``mvn_inv`` and
    ``unary_doubling`` pick a route of the device engine's objective; the
    float64 tail of ``refine_iters`` runs on ``device`` over
    :data:`~gprf_torch.ops.mvn.LINALG_OPS`.  Returns the seconds spent
    sampling, fitting and analyzing."""
    check_options(gplvm_type, engine)
    device = resolve_device(device)
    if rpc_blocksize == -1:
        centers = grid_centers(nblocks)
        print("gprf with %d blocks" % len(centers))
    else:
        centers = None
        print("gprf with rpc blocksize %d" % rpc_blocksize)
    if obs_std is None:
        obs_std = lscale / 10

    t0 = time.time()
    data = sample_data(n=n, ntrain=ntrain, lscale=lscale, obs_std=obs_std, yd=yd, seed=seed,
                       centers=centers, noise_var=noise_var, rpc_blocksize=rpc_blocksize)
    seconds = {"sample_s": time.time() - t0}
    gprf = data.build_gprf(local_dist=local_dist, device=device, dtype=dtype)

    # continuation: warm-start X from a previous run's step_%05d_X.npy
    X_init = None
    if init_x:
        if task == "cov":
            raise ValueError("--init_x has no effect on task=cov (X is fixed at the true latents)")
        X_init = np.load(init_x)
        if X_init.shape != data.X_obs.shape:
            raise ValueError("--init_x shape %s != expected %s"
                             % (X_init.shape, data.X_obs.shape))

    if task == "x":
        if X_init is not None:
            X0 = X_init
        elif init_true:
            X0 = data.SX
            gprf.update_X(X0)
        else:
            X0 = data.X_obs
        C0 = None
    elif task == "cov":
        X0 = None
        gprf.update_X(data.SX)
        if init_seed >= 0:
            C0 = np.exp(np.random.RandomState(init_seed).randn(1, 4) - 1)
        else:
            C0 = np.array((0.01, 1.0, 0.05, 0.05)).reshape(1, -1)
    elif task == "xcov":
        X0 = X_init if X_init is not None else data.X_obs
        if init_seed >= 0:
            rng = np.random.RandomState(init_seed)
            C0 = np.exp(rng.randn(1, 1) - 1)
            X0 = X0 + rng.randn(*X0.shape) * 0.005
        else:
            C0 = np.array((float(gprf.cov.dfn_params[0]),)).reshape(1, 1)
    else:
        raise ValueError("unrecognized task " + task)

    t0 = time.time()
    if not analyze_only:
        if engine == "device":
            # float64 accumulation of the objective's scalar tails (the
            # factorizations stay at dtype), as the reference's CLI runs it;
            # the partition the host path built: the grid centers, or the
            # RPC split tree, replayed on the device
            part = (dict(centers=np.asarray(centers)) if centers is not None
                    else dict(rpc_tree=data.rpc_splits))

            def make_fused(dt, ops=KERNEL_OPS, m=None):
                return FusedSyntheticGPRF(
                    data.SX if task == "cov" else X0, data.SY, gprf.neighbors, data.X_obs,
                    data.obs_std, data.cov, data.noise_var, task=task, C0=C0, m=m,
                    device=device, dtype=dt, acc_dtype=torch.float64, ops=ops,
                    mvn_inv=mvn_inv, unary_doubling=unary_doubling, **part)

            fused = make_fused(dtype)
            if max_iters is None:
                max_iters = 400 if task == "x" else 600
            loop = dict(maxsec=maxsec, max_iters=max_iters, ftol=ftol,
                        stall_patience=stall_patience)
            if multistart > 1:
                ms_rng = np.random.default_rng(seed + 1000)
                if task == "x":
                    # replica 0 is the standard start, the others
                    # perturbations of it at the observation prior's scale
                    X0s = np.stack([X0] + [X0 + ms_rng.standard_normal(X0.shape) * data.obs_std
                                           for _ in range(multistart - 1)])
                    x_final, _, final_v = do_optimization_multistart(d, fused, X0s, **loop)
                else:
                    theta0 = fused.theta0()
                    thetas = [theta0]
                    for _ in range(multistart - 1):
                        t = theta0.copy()
                        if task == "xcov":  # the X segment at the prior's scale
                            t[:X0.size] += ms_rng.standard_normal(X0.size) * data.obs_std
                        t[len(t) - C0.size:] += (ms_rng.standard_normal(C0.size) * 0.3
                                                 * FusedSyntheticGPRF.COV_SCALE)
                        thetas.append(t)
                    x_final, _, final_v = do_optimization_multistart_theta(
                        d, fused, np.stack(thetas), **loop)
                print("multistart: best replica %d of %d (final objectives %s)"
                      % (int(np.argmin(final_v)), multistart, final_v))
            else:
                if task == "x":
                    do_optimization_fused(d, fused, X0, **loop)
                else:
                    do_optimization_fused_theta(d, fused, fused.theta0(), **loop)
                # the last accepted point, where the multistart winner's is
                # x_final already: the driver returns its pending proposal
                x_final = last_accepted(d)
            print("device engine: B = %d blocks, E = %d edges, final block capacity m = %d"
                  % (fused.n_blocks, len(gprf.neighbors), fused.m))
            if refine_iters > 0:
                # the float64 tail over the same partition, edges and task,
                # from the loop's last accepted point, at the capacity the
                # float32 loop ended at
                it0 = int(load_log(d)[0][-1]) + 1
                refine_f64(d, lambda dt: make_fused(dt, LINALG_OPS, fused.m), x_final, it0,
                           iters=refine_iters)
        elif gplvm_type != "gprf":
            do_sgplvm(d, X0, C0, data, method=method, maxsec=maxsec, gplvm_type=gplvm_type,
                      num_inducing=num_inducing, max_iters=max_iters, device=device,
                      dtype=dtype)
        else:
            do_optimization(d, gprf, X0, C0, data, method=method, maxsec=maxsec,
                            parallel=parallel)
    seconds["fit_s"] = time.time() - t0

    t0 = time.time()
    analyze_run(d, data, local_dist=local_dist, predict=analyze_full,
                X0=(data.SX if task == "cov" else X0), device=device, dtype=dtype)
    seconds["analyze_s"] = time.time() - t0
    print("seconds: sampling %(sample_s).2f, fitting %(fit_s).2f, analysis %(analyze_s).2f"
          % seconds)
    return seconds


def build_run_name(args):
    """Self-describing experiment directory name, from parsed arguments or
    a dict of them."""
    defaults = {
        "yd": 50, "seed": 0, "local_dist": 0.05, "method": "l-bfgs-b", "task": "x",
        "init_seed": -1, "noise_var": 0.01, "rpc_blocksize": -1, "gplvm_type": "gprf",
        "num_inducing": -1, "init_true": False,
    }
    a = dict(defaults, **args) if isinstance(args, dict) else vars(args)
    obs_std = a["obs_std"]
    if obs_std is None:
        # the default the sampler applies: the name must not depend on
        # whether the value was passed or left to default
        obs_std = a["lscale"] / 10
    return "%d_%d_%s_%.6f_%.6f_%.4f_%d_%s_%s_%d_%s_s%s_%s%d" % (
        a["ntrain"],
        a["ntrain"] + a["ntest"],
        "%d" % a["nblocks"] if a["rpc_blocksize"] == -1 else "%06d" % a["rpc_blocksize"],
        a["lscale"],
        obs_std,
        a["local_dist"],
        a["yd"],
        a["method"],
        a["task"],
        -9999 if a["init_true"] else a["init_seed"],
        "%.4f" % a["noise_var"],
        "%d" % a["seed"],
        a["gplvm_type"],
        a["num_inducing"],
    )


def exp_dir(args):
    name = build_run_name(args)
    # continuation runs get a directory of their own, keyed on the init
    # checkpoint, so they do not overwrite the fresh run's
    init_x = getattr(args, "init_x", "")
    if init_x:
        name += "_i%s" % hashlib.md5(init_x.encode()).hexdigest()[:8]
    # runs on other prior-sampler draws (GPRF_SAMPLER) are other data
    name += sampler_suffix(args.ntrain + args.ntest)
    d = os.path.join(exp_base_dir(), name)
    mkdir_p(d)
    return d


def build_parser():
    parser = argparse.ArgumentParser(description="gprf_opt")
    add = parser.add_argument
    add("--ntrain", dest="ntrain", type=int, help="number of points to locate")
    add("--ntest", dest="ntest", type=int, default=500, help="sample additional test points to evaluate predictive accuracy")
    add("--nblocks", dest="nblocks", default=1, type=int, help="divide sampled points into a grid of this many blocks (mutually exclusive with rpc_blocksize)")
    add("--rpc_blocksize", dest="rpc_blocksize", default=-1, type=int, help="recursive projection clustering with this target blocksize (mutually exclusive with nblocks)")
    add("--lscale", dest="lscale", type=float, help="SE kernel lengthscale for the sampled functions")
    add("--obs_std", dest="obs_std", type=float, default=None, help="std of Gaussian noise corrupting the X locations")
    add("--local_dist", dest="local_dist", default=1.0, type=float, help="minimum kernel value to connect blocks in a GPRF (1.0 = local GPs)")
    add("--method", dest="method", default="l-bfgs-b", type=str, help="scipy.optimize method")
    add("--seed", dest="seed", default=0, type=int, help="seed for generating synthetic data")
    add("--yd", dest="yd", default=50, type=int, help="number of output dimensions to sample")
    add("--maxsec", dest="maxsec", default=3600, type=int, help="maximum seconds to run the optimization")
    add("--max_iters", dest="max_iters", default=None, type=int, help="device engine: max scan-L-BFGS iterations (default 400 for task=x, 600 for cov/xcov). With --gplvm_type baselines it instead switches scipy from the reference protocol (ftol 1e-6, maxiter 200) to a converged protocol: this total eval budget at ftol 1e-10 with L-BFGS-B restarts on line-search aborts")
    add("--task", dest="task", default="x", type=str, help="'x', 'cov', or 'xcov'")
    add("--analyze", dest="analyze", default=False, action="store_true", help="only analyze existing saved results")
    add("--analyze_full", dest="analyze_full", default=False, action="store_true", help="fuller analysis incl. predictive accuracy")
    add("--parallel", dest="parallel", default=False, action="store_true", help="accepted for reference parity; the blocks are always batched")
    add("--init_seed", dest="init_seed", default=-1, type=int, help="if >=0, randomized init from this seed")
    add("--init_true", dest="init_true", default=False, action="store_true", help="initialize at true X locations")
    add("--init_x", dest="init_x", default="", type=str, help="initialize X locations from a .npy checkpoint (continuation runs; task=x)")
    add("--noise_var", dest="noise_var", default=0.01, type=float, help="variance of iid noise in synthetic Y")
    add("--gplvm_type", dest="gplvm_type", default="gprf", type=str, help="'gprf', or 'sparse' (FITC) / 'titsias' / 'bayesian' / 'basic' for the inducing-point GPLVM baseline (host engine)")
    add("--num_inducing", dest="num_inducing", default=0, type=int, help="number of inducing points for sparse baselines")
    add("--engine", dest="engine", default="host", choices=["host", "device"], help="host: scipy L-BFGS-B, one objective dispatch per evaluation (reference semantics); device: scan-L-BFGS loop on the device")
    add("--refine_iters", dest="refine_iters", default=0, type=int, help="device engine: follow the float32 loop with this many float64 iterations, on the run's device")
    add("--ftol", dest="ftol", default=1e-6, type=float, help="device engine: relative per-dispatch improvement threshold for stall detection")
    add("--stall_patience", dest="stall_patience", default=4, type=int, help="device engine: consecutive stalled dispatches before stopping")
    add("--multistart", dest="multistart", default=1, type=int, help="device engine: optimize this many replicas at once and keep the best final objective")
    add("--schur_precision", dest="schur_precision", default="", choices=["", "highest", "high"], help="forward Schur-algebra product precision; only 'highest' (full float32) exists here, 'high' is refused")
    add("--device", dest="device", default="cuda", type=str, help="torch device of the objective; 'cuda' (default) raises without a GPU, 'cpu' runs on the CPU")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_options(args.gplvm_type, args.engine, args.schur_precision)
    device = resolve_device(args.device)
    mkdir_p(exp_base_dir())
    d = exp_dir(args)
    print("experiment dir:", d)
    return do_run(
        d=d, lscale=args.lscale, obs_std=args.obs_std, local_dist=args.local_dist,
        n=args.ntrain + args.ntest, ntrain=args.ntrain, nblocks=args.nblocks, yd=args.yd,
        method=args.method, rpc_blocksize=args.rpc_blocksize, seed=args.seed,
        maxsec=args.maxsec, max_iters=args.max_iters, analyze_only=args.analyze,
        analyze_full=args.analyze_full, task=args.task, init_seed=args.init_seed,
        noise_var=args.noise_var, parallel=args.parallel, gplvm_type=args.gplvm_type,
        num_inducing=args.num_inducing, init_true=args.init_true, init_x=args.init_x,
        engine=args.engine, refine_iters=args.refine_iters, multistart=args.multistart,
        ftol=args.ftol, stall_patience=args.stall_patience, device=device)


if __name__ == "__main__":
    main()
