"""The readings that the limits of ``limits/<workload>.json`` are set from,
on the card, at the cell's own size: for each seed, a window of the cell's
own traffic, then the compared numbers of the program and of the control
(the reference in TF32 in the program's place) at the same points; with
``--fault``, the program's numbers with that fault (``faults.py``) planted
underneath the window instead.

    python3 -m gprfbench.calibrate --workload synth10k.device_fit --seconds 10 --seeds 11 12 13
    python3 -m gprfbench.calibrate --workload synth10k.device_fit --seconds 10 --seeds 11 \\
        --fault half_the_batch

Prints one JSON line per seed (and fault).  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
import time

import torch

from gprfbench import check, faults, jobs, spec
from gprfbench import data as bdata
from gprfbench.trace import Tracer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", nargs="*", default=[], choices=sorted(faults.FAULTS),
                        help="read the program with each of these faults planted, no control")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        problem = bdata.make_problem(cell, seed, device)
        for fault in args.fault or [None]:
            tmp = tempfile.mkdtemp(prefix="gprfbench-cal-")
            try:
                engine = jobs.make_engine(cell, problem, device)
                engine.warm_up(tmp)
                with faults.planted(fault) if fault else contextlib.nullcontext():
                    window = jobs.run_window(engine, problem, args.seconds,
                                             Tracer(False, 0, device), tmp)
                t0 = time.perf_counter()
                per_job = []
                program = check.readings(problem, engine, window, per_job=per_job)
                t_ref = time.perf_counter() - t0
                control = (None if fault else
                           check.readings(problem, engine, window, control=True))
                print(json.dumps({
                    "workload": args.workload, "seed": seed, "fault": fault,
                    "program": program, "control": control, "per_job": per_job,
                    "jobs": len(window.jobs), "evals": window.evals, "reference_s": t_ref,
                    "eval_ms": window.seconds / max(window.evals, 1) * 1e3,
                    "m": [j.m_end for j in window.jobs],
                    "mads": [problem.mad(j.x_final) for j in window.jobs if j.completed],
                    "failed": [j.error for j in window.jobs if j.error]}), flush=True)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
