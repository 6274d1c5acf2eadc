#!/usr/bin/env python3
"""The paper's n = 80,000 synthetic experiment on the card, whole fits.

    python3 scripts/torch_80k_fit.py [--sampler vecchia|exact] [--local_dist 0.1 1.0]
                                     [--max_iters N] [--ftol F] [--host_seconds S]
                                     [--plain float32 float64] [--keep DIR]
                                     [--refine_iters N] [--experiments DIR]

Runs the 80k command (``--ntrain 80000 --ntest 500 --nblocks 100 --lscale
0.021213 --obs_std 0.007071 --yd 50 --task x``, seed 0) through
``gprf_torch.cli.gprfopt.main`` on the device engine, once per
``--local_dist`` (0.1: GPRF-100; 1.0: Local-100), into a temporary
GPRF_EXPERIMENTS, all fits on one draw: ``--sampler vecchia`` is the
Vecchia draw (GPRF_SAMPLER=vecchia, the draw of the JAX package's
docs/runs/gprf80k_device and local80k_100_device), ``exact`` the exact
banded draw (GPRF_SAMPLER unset, its docs/runs/gprf80k_100_yexact).

``--host_seconds`` ends with the host engine (scipy over
``GPRF.llgrad``) on the same data for that many seconds.  ``--plain`` adds
GPRF-100 on the device engine on the plain twins at each width given
(the kernels are float32 only), the same loop and stall rule, to tell
the kernels' share of a fit's result from float32's; its mad is computed
at every checkpointed X.  ``--ftol`` passes the device engine's stall
threshold on (0: never stall).  ``--keep DIR`` copies each fit's log.txt
and results.txt into DIR.  ``--refine_iters N`` passes the command line's
float64 tail on (on the card, over LINALG_OPS; at m = 888 it runs only
under GPRF_REFINE_MAX_M >= 888), and the fit's line then also gives the
mad at the float32 loop's end and the tail's seconds.  ``--experiments DIR``
keeps the data and run directories there (default: a temporary directory),
so that a draw made by another script is read back, not drawn again.

Prints one JSON line per fit (the seconds of the draw,
the fit and the analysis, the iterations, ms per iteration, the capacity m
at the end, the first and final mad, the objective at the start, the end
and the true latents) with the card's name and power limit.  Needs one
CUDA device.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAGS = ["--ntrain", "80000", "--ntest", "500", "--nblocks", "100", "--lscale", "0.021213",
         "--obs_std", "0.007071", "--yd", "50", "--task", "x"]
DATA = dict(n=80500, ntrain=80000, lscale=0.021213, obs_std=0.007071, yd=50, seed=0,
            noise_var=0.01)


def emit(record, card):
    print(json.dumps(dict(record, card=card)), flush=True)


def keep_files(d, keep, tag):
    if keep:
        os.makedirs(os.path.join(keep, tag), exist_ok=True)
        for name in ("log.txt", "results.txt"):
            if os.path.exists(os.path.join(d, name)):
                shutil.copy(os.path.join(d, name), os.path.join(keep, tag, name))


def fit(local_dist, max_iters, ftol, card, keep, refine_iters=0):
    from gprf_torch.analysis.results import load_final_results, load_results
    from gprf_torch.cli import gprfopt
    from gprf_torch.ops import mvn

    argv = FLAGS + ["--local_dist", str(local_dist), "--engine", "device"]
    if max_iters is not None:
        argv += ["--max_iters", str(max_iters)]
    if ftol is not None:
        argv += ["--ftol", str(ftol)]
    if refine_iters:
        argv += ["--refine_iters", str(refine_iters)]
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    out = io.StringIO()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        seconds = gprfopt.main(argv)
    sys.stderr.write(out.getvalue())
    reported = next(line for line in out.getvalue().splitlines()
                    if line.startswith("device engine: B = "))
    B, E, m_end = (int(w) for w in reported.replace(",", " ").split() if w.isdigit())
    results = load_results(d)
    final, true_row = load_final_results(d)
    iterations = int(final["step"]) + 1
    emit({"what": "fit", "local_dist": local_dist,
          "sampler": os.environ.get("GPRF_SAMPLER", "") or "exact", "blocks": B, "edges": E,
          "m_end": m_end, "iterations": iterations,
          "ms_per_iteration": seconds["fit_s"] / iterations * 1e3,
          "mad_first": float(results[0, 4]), "mad_final": float(final["mad"]),
          "objective_first": float(results[0, 2]), "objective_final": float(final["mll"]),
          "objective_true_x": float(true_row["mll"]), "seconds": seconds,
          "launches": dict(mvn.launch_counts), "ftol": ftol, **refined(d, results)}, card)
    keep_files(d, keep, "%s_%s_%s" % (os.environ.get("GPRF_SAMPLER", "") or "exact", local_dist,
                                       "default" if ftol is None else "ftol%g" % ftol))


def refined(d, results):
    """Where log.txt holds a float64 tail: the float32 loop's iterations, its
    last row's objective and mad, the tail's iterations and seconds."""
    with open(os.path.join(d, "log.txt")) as f:
        lines = f.read().splitlines()
    tail = [ln for ln in lines if ln.startswith("f64 refinement finished after")]
    if not tail:
        return {}
    end = next(i for i, ln in enumerate(lines) if ln.startswith("optimization finished"))
    n32 = sum(1 for ln in lines[:end] if ln[:1].isdigit())
    return {"float32_iterations": n32, "float64_iterations": len(results) - n32,
            "objective_float32_end": float(results[n32 - 1, 2]),
            "mad_float32_end": float(results[n32 - 1, 4]),
            "float64_seconds": float(tail[0].split()[-1].rstrip("s"))}


def fit_plain(dtype_name, max_iters, ftol, card, keep):
    """GPRF-100 on the device engine on the plain twins at one width."""
    import numpy as np
    import torch

    from gprf_torch.data.sampled import sample_data
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.ops import mvn
    from gprf_torch.optim.driver import load_log
    from gprf_torch.optim.lbfgs import do_optimization_fused
    from gprf_torch.partition.grid import grid_centers

    data = sample_data(centers=grid_centers(100), **DATA)
    fused = FusedSyntheticGPRF(data.X_obs, data.SY, data.neighbors, data.X_obs, data.obs_std,
                               data.cov, data.noise_var, task="x",
                               centers=np.asarray(data.centers), device="cuda",
                               dtype=getattr(torch, dtype_name), acc_dtype=torch.float64,
                               ops=mvn.PLAIN_OPS)
    d = os.path.join(os.environ["GPRF_EXPERIMENTS"], "plain_" + dtype_name)
    os.makedirs(d)
    loop = dict(max_iters=400 if max_iters is None else max_iters)
    if ftol is not None:
        loop["ftol"] = ftol
    t0 = time.perf_counter()
    do_optimization_fused(d, fused, data.X_obs, **loop)
    fit_s = time.perf_counter() - t0
    steps, _, values = load_log(d)
    mads = {}
    for name in sorted(f for f in os.listdir(d) if f.startswith("step_") and f.endswith("_X.npy")):
        mads[int(name[5:10])] = data.mean_distance(np.load(os.path.join(d, name)).reshape(-1))
    with open(os.path.join(d, "results.txt"), "w") as f:
        f.writelines("%d %.2f %.8f\n" % (step, values[i], mads.get(step, np.nan))
                     for i, step in enumerate(steps))
    last = max(mads)
    emit({"what": "fit_plain_" + dtype_name,
          "sampler": os.environ.get("GPRF_SAMPLER", "") or "exact",
          "iterations": len(steps), "ms_per_iteration": fit_s / len(steps) * 1e3,
          "objective_first": float(values[0]), "objective_final": float(values[-1]),
          "mad_final": mads[last], "mad_at": {str(k): v for k, v in mads.items()},
          "m_end": fused.m, "ftol": ftol}, card)
    keep_files(d, keep, "%s_0.1_plain_%s_%s" % (os.environ.get("GPRF_SAMPLER", "") or "exact",
                                                 dtype_name,
                                                 "default" if ftol is None else "ftol%g" % ftol))


def host(seconds_, card):
    from gprf_torch.cli import gprfopt
    from gprf_torch.optim.driver import load_log

    argv = FLAGS + ["--local_dist", "0.1", "--engine", "host", "--maxsec", str(seconds_)]
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    with contextlib.redirect_stdout(sys.stderr):
        seconds = gprfopt.main(argv)
    steps, _, values = load_log(d)
    emit({"what": "host_engine", "evaluations": len(steps),
          "ms_per_evaluation": seconds["fit_s"] / len(steps) * 1e3,
          "objective": [float(values[0]), float(values.max())], "seconds": seconds}, card)


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sampler", choices=["vecchia", "exact"], default="vecchia")
    parser.add_argument("--local_dist", type=float, nargs="*", default=[0.1, 1.0])
    parser.add_argument("--max_iters", type=int, default=None)
    parser.add_argument("--host_seconds", type=int, default=0)
    parser.add_argument("--ftol", type=float, default=None)
    parser.add_argument("--plain", nargs="*", default=[], choices=["float32", "float64"])
    parser.add_argument("--keep", default="")
    parser.add_argument("--refine_iters", type=int, default=0)
    parser.add_argument("--experiments", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_80k_fit.py: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.sampler == "vecchia":
        os.environ["GPRF_SAMPLER"] = "vecchia"
    else:
        os.environ.pop("GPRF_SAMPLER", None)
    with contextlib.ExitStack() as stack:
        base = args.experiments or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(base, exist_ok=True)
        os.environ["GPRF_EXPERIMENTS"] = base
        for local_dist in args.local_dist:
            fit(local_dist, args.max_iters, args.ftol, card, args.keep, args.refine_iters)
        for dtype_name in args.plain:
            fit_plain(dtype_name, args.max_iters, args.ftol, card, args.keep)
        if args.host_seconds:
            host(args.host_seconds, card)


if __name__ == "__main__":
    main()
