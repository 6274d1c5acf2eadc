#!/usr/bin/env python3
"""Where a host-engine evaluation of gprf_torch spends its time on the card.

    python3 scripts/torch_host_profile.py [--maxsec 5] [--seismic]

Runs the command line's flagship (n = 10,000 + 500, 100 blocks, task x),
or with ``--seismic`` the seismic command (12,000 events, 64 PD-tree
blocks, task xcov), with ``--engine host`` for ``--maxsec`` seconds under
cProfile, into a temporary experiment directory, and prints the functions
with the largest cumulative time, with the number of evaluations logged.
Needs one CUDA device.
"""

import argparse
import cProfile
import contextlib
import io
import os
import pstats
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    import torch

    from gprf_torch.cli import gprfopt
    from gprf_torch.data.sampled import sample_data
    from gprf_torch.optim.driver import load_log
    from gprf_torch.partition.grid import grid_centers

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--maxsec", type=int, default=5)
    parser.add_argument("--rows", type=int, default=30)
    parser.add_argument("--seismic", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_host_profile.py: no CUDA device")
    if args.seismic:
        return profile_seismic(args)
    flags = ["--ntrain", "10000", "--ntest", "500", "--nblocks", "100", "--lscale", "0.06",
             "--obs_std", "0.02", "--local_dist", "0.1", "--task", "x", "--engine", "host",
             "--maxsec", str(args.maxsec)]
    with tempfile.TemporaryDirectory() as base:
        os.environ["GPRF_EXPERIMENTS"] = base
        # sample, build the kernels and start the device outside the
        # profile: the run below finds the dataset cached and the library built
        data = sample_data(n=10500, ntrain=10000, lscale=0.06, obs_std=0.02, yd=50, seed=0,
                           centers=grid_centers(100), noise_var=0.01)
        data.build_gprf(local_dist=0.1, device="cuda", dtype=torch.float32).llgrad(grad_X=True)
        profile = cProfile.Profile()
        with contextlib.redirect_stdout(sys.stderr):
            profile.runcall(gprfopt.main, flags)
        d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(flags))
        evaluations = len(load_log(d)[0])
    out = io.StringIO()
    pstats.Stats(profile, stream=out).sort_stats("cumulative").print_stats(args.rows)
    print(f"{evaluations} evaluations in {args.maxsec} s; cumulative seconds by function:")
    print(out.getvalue())


def profile_seismic(args):
    from gprf_torch.cli import run_seismic
    from gprf_torch.optim.driver import load_log

    with tempfile.TemporaryDirectory() as base:
        os.environ["SEISMIC_EXPERIMENTS"] = os.path.join(base, "exp")
        flags = ["--npts=-1", "--obs_std=20", "--threshold=0.6", "--rpc_blocksize=210",
                 "--task=xcov", "--engine", "host", "--data_dir", base]
        # sample, build the kernels and start the device outside the profile
        with contextlib.redirect_stdout(sys.stderr):
            run_seismic.main(flags + ["--maxsec", "1"])
        flags += ["--maxsec", str(args.maxsec)]
        profile = cProfile.Profile()
        with contextlib.redirect_stdout(sys.stderr):
            profile.runcall(run_seismic.main, flags)
        d = run_seismic.seismic_exp_dir(run_seismic.build_parser().parse_args(flags))
        evaluations = len(load_log(d)[0])
    out = io.StringIO()
    pstats.Stats(profile, stream=out).sort_stats("cumulative").print_stats(args.rows)
    print(f"seismic: {evaluations} evaluations in {args.maxsec} s; cumulative seconds by "
          "function:")
    print(out.getvalue())


if __name__ == "__main__":
    main()
