"""Seismic event-relocation CLI (mirror of ``gprf_tpu/cli/run_seismic.py``).

    python -m gprf_torch.cli.run_seismic --npts=-1 --obs_std=20 --threshold=0.6 \\
        --rpc_blocksize=210 --task=xcov [--engine device --multistart 4]

PD-tree partitioning with the longitude wrap, the neighbor-list cache
(``neighbors_*.npy`` in ``--data_dir``), the GPRF over the Matern-3/2
great-circle kernel, the seismic optimization drivers (``--engine host``:
scipy over ``GPRF.llgrad``; ``--engine device``: scan-L-BFGS over
:class:`~gprf_torch.model.fused_seismic.FusedSeismicGPRF`, with
``--multistart`` replicas), and the per-step location error against the
catalog ("true") locations in ``results.txt``.  The flags are the
reference's, plus ``--device`` (default ``cuda``; without a CUDA device the
default raises, and only ``--device cpu`` runs on the CPU).
``--refine_iters`` follows the device engine with the float64 tail of
:func:`~gprf_torch.optim.lbfgs.refine_f64` on the run's device, from the
loop's last accepted point.
``--sparse`` runs the host engine over the truncated-support sparse llgrad
(host float64, :mod:`gprf_torch.model.sparse_llgrad`); with ``--engine
device``, which has no sparse path, it raises before anything runs (the
reference ignores it there).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time

import numpy as np
import torch

from gprf_torch.data.seismic import COL_DEPTH, COL_LAT, COL_LON, load_data, mad, make_x_prior
from gprf_torch.model.fused_seismic import FusedSeismicGPRF
from gprf_torch.model.gprf import GPRF
from gprf_torch.optim.driver import do_optimization_seismic, load_log
from gprf_torch.ops.mvn import KERNEL_OPS, LINALG_OPS
from gprf_torch.optim.lbfgs import (do_optimization_fused_theta,
                                    do_optimization_multistart_theta, last_accepted,
                                    refine_f64)
from gprf_torch.optim.priors import seismic_cov_prior
from gprf_torch.partition.pdtree import PDTree, pdtree_cluster, wrap_lon
from gprf_torch.utils.device import resolve_device
from gprf_torch.utils.io import mkdir_p, step_cov_path, step_x_path


def seismic_exp_dir(args):
    """Self-describing experiment directory under ``$SEISMIC_EXPERIMENTS``
    (default ``~/seismic_experiments``)."""
    base_dir = os.environ.get("SEISMIC_EXPERIMENTS",
                              os.path.join(os.path.expanduser("~"), "seismic_experiments"))
    init_str = "default"
    if args.init_cov or args.init_x:
        init_str = "_%s" % hashlib.md5((args.init_cov + args.init_x).encode()).hexdigest()[:8]
    run_name = "%d_%d_%.4f_%s_%s_%.0f_%.1f" % (args.npts, args.rpc_blocksize, args.threshold,
                                               init_str, args.task, args.synth_lscale,
                                               args.obs_std)
    d = os.path.join(base_dir, run_name)
    mkdir_p(d)
    return d


def analyze_run_result(args, gprf, x_prior, X_true, cov_true, lscale_true, X0=None):
    """results.txt: per logged step the mean / median km error against the
    catalog locations, then the objective at the true X and covs."""
    d = seismic_exp_dir(args)
    steps, times, lls = load_log(d)
    rfname = os.path.join(d, "results.txt")
    results = open(rfname, "w")
    print("writing results to", rfname)

    # rows between checkpoints carry the last checkpointed state forward;
    # before the first one the observed locations X0 stand in (never
    # X_true, which would report zero error for steps that never reached it)
    prev_X, prev_FC = None, None
    for i, step in enumerate(steps):
        try:
            X = np.load(step_x_path(d, step))
        except (IOError, OSError):
            X = prev_X if prev_X is not None else (X0 if X0 is not None else X_true)
        try:
            FC = np.load(step_cov_path(d, step))
        except (IOError, OSError):
            FC = prev_FC
        prev_X, prev_FC = X, FC
        c1 = FC[0, 2] / lscale_true if FC is not None else 1.0
        l1, l2 = mad(X_true, X)
        s = "%d %.2f %.2f %.8f %.8f %.8f" % (step, times[i], lls[i], c1, l1, l2)
        print(s)
        results.write(s + "\n")

    gprf.update_X(X_true)
    gprf.update_covs(cov_true)
    lltrue = gprf.llgrad(grad_X=False, grad_cov=False)[0]
    priortrue = x_prior(X_true)[0]
    s = "true X ll %.2f" % (lltrue + priortrue)
    print(s)
    results.write(s + "\n")
    results.close()


def build_parser():
    parser = argparse.ArgumentParser(description="seismic")
    add = parser.add_argument
    add("--npts", dest="npts", default=-1, type=int, help="do inference on a subset of data, for debugging")
    add("--obs_std", dest="obs_std", default=-1, type=float, help="stddev for sampling observed X values")
    add("--threshold", dest="threshold", default=1.0, type=float, help="covariance threshold for adding a GPRF edge; 1.0 is local GPs, 0.6 approx one lengthscale")
    add("--synth_lscale", dest="synth_lscale", default=40.0, type=float, help="Matern lengthscale (km) for generating Y values")
    add("--seed", dest="seed", default=0, type=int, help="seed for sampling")
    add("--maxsec", dest="maxsec", default=3600, type=int, help="maximum seconds of inference")
    add("--sparse", dest="sparse", default=False, action="store_true", help="host engine: truncated-support sparse per-block linear algebra (native sparse Cholesky + selected inverse); NOT inducing-point sparsity; refused by the device engine")
    add("--analyze", dest="analyze", default=False, action="store_true", help="only generate results from saved state")
    add("--rpc_blocksize", dest="rpc_blocksize", default=300, type=int, help="max points per PD-tree block")
    add("--init_cov", dest="init_cov", default="", type=str, help="initialize cov params from .npy")
    add("--init_x", dest="init_x", default="", type=str, help="initialize X locations from .npy")
    add("--task", dest="task", default="xcov", type=str, help="'x', 'cov', or 'xcov'")
    add("--parallel", dest="parallel", default=False, action="store_true", help="accepted for reference parity; the blocks are always batched")
    add("--data_dir", dest="data_dir", default=".", type=str, help="directory holding sorted_isc.npy / cached Y")
    add("--engine", dest="engine", default="host", choices=["host", "device"], help="host: scipy L-BFGS-B, one objective dispatch per evaluation (reference semantics); device: scan-L-BFGS loop on the device")
    add("--multistart", dest="multistart", default=1, type=int, help="device engine: optimize this many replicas at once and keep the best final objective")
    add("--refine_iters", dest="refine_iters", default=0, type=int, help="device engine: float64 refinement iterations after the float32 loop, on the run's device")
    add("--max_iters", dest="max_iters", default=600, type=int, help="device engine: max scan-L-BFGS iterations")
    add("--ftol", dest="ftol", default=1e-6, type=float, help="device engine: relative per-dispatch improvement threshold for stall detection")
    add("--stall_patience", dest="stall_patience", default=4, type=int, help="device engine: consecutive stalled dispatches before stopping")
    add("--device", dest="device", default="cuda", type=str, help="torch device of the objective; 'cuda' (default) raises without a GPU, 'cpu' runs on the CPU")
    return parser


def refuse_unported(args):
    """Raise for an option that the chosen engine does not serve."""
    if args.sparse and args.engine == "device":
        raise ValueError("--sparse runs on the host engine only (--engine host): the device "
                         "engine has no sparse path")


def multistart_thetas(theta0, task, nx, count, seed):
    """The starts of ``--multistart``: theta0 and count - 1 perturbations of
    it, the (lon, lat, depth-scaled) segment by N(0, 0.05^2) and the log-cov
    tail by N(0, 0.3^2), from ``default_rng(seed + 1000)``."""
    ms_rng = np.random.default_rng(seed + 1000)
    thetas = [theta0]
    for _ in range(count - 1):
        t = theta0.copy()
        if task in ("x", "xcov"):
            t[:nx] += ms_rng.standard_normal(nx) * 0.05
        if len(t) > nx or task == "cov":
            ncov = len(t) - (nx if task == "xcov" else 0)
            if ncov > 0:
                t[len(t) - ncov:] += ms_rng.standard_normal(ncov) * 0.3
        thetas.append(t)
    return np.stack(thetas)


def build_problem(args, *, device: torch.device | str, dtype: torch.dtype = torch.float32):
    """The experiment's pieces from parsed arguments, as the run uses them:
    the data (sampled into ``--data_dir`` at the first run, read back
    after), the observed locations ``means`` and their prior, the start
    X0 / C0 (None where the task does not optimize it), and the GPRF of
    the host engine and the analysis on ``device`` at ``dtype``, with its
    neighbor list cached in ``--data_dir``.  Adds ``sample_s``, the seconds
    of loading or sampling the data."""
    seed = args.seed
    threshold = args.threshold
    t0 = time.time()
    sorted_isc, SY, cov = load_data(args.synth_lscale, seed, data_dir=args.data_dir)
    sample_s = time.time() - t0

    cov_true = np.array([0.1, float(cov.wfn_params[0])] + cov.dfn_params.tolist()).reshape((1, -1))
    if args.synth_lscale < 0:
        cov_true[0, 0] = 1.0
        cov_true[0, 1] = 0.1

    if args.npts > 0:
        npts = args.npts
        base = min(60000, max(len(SY) - npts, 0))
        sorted_isc = sorted_isc[base: base + npts, :]
        SY = SY[base: base + npts, :]

    X_true = sorted_isc[:, (COL_LON, COL_LAT, COL_DEPTH)]
    prior_std = args.obs_std * np.array([0.01, 0.01, 1.0])
    # the reference draws the observation noise after np.random.seed(seed)
    noise = np.random.RandomState(seed).randn(*X_true.shape) * prior_std
    means = X_true + noise
    X0 = means.copy()

    n = X0.shape[0]
    cluster_idxs, reblock = pdtree_cluster(X0, blocksize=args.rpc_blocksize)

    neighbor_fname = os.path.join(
        args.data_dir,
        "neighbors_%d_%d_%.3f_%.3f.npy" % (n, args.rpc_blocksize, threshold, args.obs_std))
    if threshold == 1.0:
        neighbors = []
    else:
        try:
            neighbors = np.load(neighbor_fname)
        except (IOError, OSError):
            neighbors = None

    C0 = cov_true.copy() if args.init_cov == "" else np.load(args.init_cov)
    if args.init_x != "":
        X0 = np.load(args.init_x)

    gprf = GPRF(X0, SY, reblock, cov, cov_true[0, 0], neighbor_threshold=threshold,
                block_idxs=cluster_idxs, neighbors=neighbors, device=device, dtype=dtype)
    if neighbors is None:
        np.save(neighbor_fname, np.asarray(gprf.neighbors, dtype=np.int32).reshape(-1, 2))

    if args.task == "x":
        C0 = None
    elif args.task == "cov":
        X0 = None
    return dict(SY=SY, cov=cov, cov_true=cov_true, X_true=X_true, means=means,
                prior_std=prior_std, x_prior=make_x_prior(means, prior_std), X0=X0, C0=C0,
                gprf=gprf, sample_s=sample_s)


def build_engine(args, p, *, device: torch.device | str, dtype: torch.dtype = torch.float32,
                 ops=KERNEL_OPS, m: int | None = None):
    """The device engine over the problem ``p`` of :func:`build_problem`: a
    PD-tree over the observed locations, float64 scalar tails, the leaves
    ``ops`` and the capacity ``m`` (default: the tree's widest leaf)."""
    X2 = p["means"][:, :2].copy()
    X2[:, 0] = wrap_lon(X2[:, 0])
    tree = PDTree(X2, minsize=args.rpc_blocksize)
    return FusedSeismicGPRF(p["means"], p["SY"], tree, p["gprf"].neighbors, p["means"],
                            p["prior_std"], p["cov"], p["cov_true"][0, 0], task=args.task,
                            m=m, device=device, dtype=dtype, acc_dtype=torch.float64, ops=ops)


def do_run(args, *, device: torch.device | str, dtype: torch.dtype = torch.float32):
    """One seismic experiment from parsed arguments.  The objective runs on
    ``device`` at ``dtype`` (the device engine with float64 scalar tails).
    Returns the seconds of sampling, fitting and analysis, and the
    partition the run started from: blocks, edges and the padded width m
    (and, on the device engine, the m it ended at)."""
    refuse_unported(args)
    d = seismic_exp_dir(args)
    print("experiment dir:", d)
    p = build_problem(args, device=device, dtype=dtype)
    gprf, X0, C0, means = p["gprf"], p["X0"], p["C0"], p["means"]
    info = dict(sample_s=p["sample_s"], blocks=gprf.n_blocks, edges=len(gprf.neighbors),
                m=gprf.layout.block_pad)

    t0 = time.time()
    if not args.analyze:
        if args.engine == "device":
            fused = build_engine(args, p, device=device, dtype=dtype)
            info.update(blocks=fused.n_blocks, edges=int(fused.edges.shape[0]), m=fused.m)
            theta0 = fused.theta0(X0 if X0 is not None else means, C0)
            loop = dict(maxsec=args.maxsec, max_iters=args.max_iters, ftol=args.ftol,
                        stall_patience=args.stall_patience)
            if args.multistart > 1:
                theta0s = multistart_thetas(theta0, args.task, means.size, args.multistart,
                                            args.seed)
                theta_final, _, final_v = do_optimization_multistart_theta(d, fused, theta0s,
                                                                           **loop)
                print("multistart: best replica %d of %d (final objectives %s)"
                      % (int(np.argmin(final_v)), args.multistart, final_v))
            else:
                do_optimization_fused_theta(d, fused, theta0, **loop)
                # the last accepted point, not the driver's pending proposal
                theta_final = last_accepted(d)
            info["m_end"] = fused.m
            print("device engine: B = %d blocks, E = %d edges, block capacity m = %d -> %d"
                  % (info["blocks"], info["edges"], info["m"], fused.m))
            if args.refine_iters > 0:
                it0 = int(load_log(d)[0][-1]) + 1
                refine_f64(d, lambda dt: build_engine(args, p, device=device, dtype=dt,
                                                      ops=LINALG_OPS, m=fused.m),
                           theta_final, it0, iters=args.refine_iters)
        else:
            do_optimization_seismic(d, gprf, X0, C0, seismic_cov_prior, p["x_prior"],
                                    maxsec=args.maxsec, parallel=args.parallel,
                                    sparse=args.sparse)
    info["fit_s"] = time.time() - t0

    t0 = time.time()
    if args.task in ("x", "xcov"):
        analyze_run_result(args, gprf, p["x_prior"], p["X_true"], p["cov_true"],
                           args.synth_lscale, X0=means)
    info["analyze_s"] = time.time() - t0
    print("seconds: sampling %(sample_s).2f, fitting %(fit_s).2f, analysis %(analyze_s).2f"
          % info)
    return info


def main(argv=None):
    args = build_parser().parse_args(argv)
    return do_run(args, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
