#!/usr/bin/env python3
"""Quality of result of gprf_torch's seismic experiment on the card: the
documented command run to its end, on each engine asked for.

    python3 scripts/torch_seismic_fit.py [--runs device4 device1 host] [--host_seconds 120]

The command of README.md and docs/RESULTS.md (Seismic): ``--npts=-1
--obs_std=20 --threshold=0.6 --rpc_blocksize=210 --task=xcov``, through
``gprf_torch.cli.run_seismic.main``, on one synthetic 12,000-event catalog
sampled into a temporary data directory.  ``device4`` is the device engine
with ``--multistart 4`` and ``device1`` a single start, both with the
default 600 iterations and stall rule; ``host`` is scipy's L-BFGS-B over
``GPRF.llgrad`` for ``--host_seconds``.  Prints one JSON line per run: the
final mean and median location error in km (from 33 km at the observed
locations), the learned lengthscale over the true 40 km, the iterations
logged, the objective at the start, at the end and at the true locations,
the partition and capacity, the seconds, and the card's name and power
limit.  Needs one CUDA device.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAGS = ["--npts=-1", "--obs_std=20", "--threshold=0.6", "--rpc_blocksize=210", "--task=xcov"]


def main(argv=None):
    import torch

    from gprf_torch.cli import run_seismic

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", nargs="+", default=["device4", "host"],
                        choices=["device4", "device1", "host"])
    parser.add_argument("--host_seconds", type=int, default=120)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_seismic_fit.py: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    engines = {"device4": ["--engine", "device", "--multistart", "4"],
               "device1": ["--engine", "device"],
               "host": ["--engine", "host", "--maxsec", str(args.host_seconds)]}
    with tempfile.TemporaryDirectory() as base:
        for run in args.runs:
            os.environ["SEISMIC_EXPERIMENTS"] = os.path.join(base, run)
            argv = FLAGS + ["--data_dir", base] + engines[run]
            with contextlib.redirect_stdout(sys.stderr):
                info = run_seismic.main(argv)
            d = run_seismic.seismic_exp_dir(run_seismic.build_parser().parse_args(argv))
            with open(os.path.join(d, "results.txt")) as f:
                rows = [line.split() for line in f.read().splitlines()]
            first, last = rows[0], rows[-2]
            print(json.dumps(dict(
                run=run, iterations=len(rows) - 1, mean_km=[float(first[4]), float(last[4])],
                median_km=[float(first[5]), float(last[5])], lengthscale_ratio=float(last[3]),
                objective=[float(first[2]), float(last[2])], true_x_objective=float(rows[-1][-1]),
                card=card, **info)), flush=True)


if __name__ == "__main__":
    main()
