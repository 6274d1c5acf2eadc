#!/usr/bin/env python3
"""Quality of result of gprf_torch on the card: the whole flagship fit, once
per route of the device engine's objective.

    python3 scripts/torch_full_fit.py [--routes default mvn_inv] [--repeats 3]

The command line's flagship (n = 10,000 + 500 test points, 100 grid blocks,
lengthscale 0.06, obs_std 0.02, local_dist 0.1, task x, seed 0, device
engine, the default 400 iterations and stall rule) through
``gprf_torch.cli.gprfopt.do_run``, on one dataset, into a temporary
GPRF_EXPERIMENTS.  ``--repeats`` fits each route that many times in turns, to
show whether two fits of one route differ (on an H100 four repeats of each
route ended at the same mad to the last printed digit).  Prints one JSON
line per fit: the final mad (mean
latent error), the iterations run, the objective at the start, at the end
and at the true latents, the seconds, and the card's name and power limit.
Needs one CUDA device.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROUTES = {"default": {}, "mvn_inv": {"mvn_inv": True}, "unary_doubling": {"unary_doubling": True}}


def main(argv=None):
    import torch

    from gprf_torch.analysis.results import load_final_results, load_results
    from gprf_torch.cli.gprfopt import do_run
    from gprf_torch.ops import mvn

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--routes", nargs="+", default=["default", "mvn_inv"], choices=list(ROUTES))
    parser.add_argument("--max_iters", type=int, default=None)
    parser.add_argument("--repeats", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_full_fit.py: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as base:
        os.environ["GPRF_EXPERIMENTS"] = base
        for repeat, route in ((r, route) for r in range(args.repeats) for route in args.routes):
            d = os.path.join(base, f"{route}_{repeat}")
            os.makedirs(d)
            mvn.reset_launch_counts()
            with contextlib.redirect_stdout(sys.stderr):
                seconds = do_run(d, lscale=0.06, n=10500, ntrain=10000, nblocks=100, yd=50,
                                 seed=0, obs_std=0.02, local_dist=0.1, task="x", engine="device",
                                 max_iters=args.max_iters, device="cuda", **ROUTES[route])
            results = load_results(d)
            final, true_row = load_final_results(d)
            record = {"route": route, "repeat": repeat, "iterations": int(final["step"]) + 1,
                      "mad_first": float(results[0, 4]), "mad_final": float(final["mad"]),
                      "objective_first": float(results[0, 2]),
                      "objective_final": float(final["mll"]),
                      "objective_true_x": float(true_row["mll"]),
                      "x_prior_final": float(final["xprior"]), "seconds": seconds,
                      "launches": dict(mvn.launch_counts), "card": card}
            print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
