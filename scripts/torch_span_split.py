#!/usr/bin/env python3
"""Where an evaluation's host time goes with no profiler running: one
window of a benchmark cell (``gprfbench``) with the program's spans
recorded but no ``torch.profiler`` tracing, so that no profiler's cost on
the host moves the split.

    python3 scripts/torch_span_split.py --workload synth80k.device_fit --seed 7 [--seconds 20]

``gprf_torch.utils.profiling.span`` records while torch's flag
``torch.autograd.profiler._is_profiler_enabled`` is set; this script sets
the flag for the window alone, without starting a profiler.  Prints one
JSON line: the window's ms an evaluation, the ms an evaluation inside each
span name (a span counts whole, and a child's time is inside its parent's),
the spans an evaluation, and the card's name and power limit.  Needs one
CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    import torch
    import torch.autograd.profiler as autograd_profiler

    from gprf_torch.utils import profiling
    from gprfbench import data as bdata
    from gprfbench import jobs, spec
    from gprfbench.trace import Tracer

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_span_split: needs a CUDA device")
    device = torch.device("cuda", 0)

    cell = spec.load_cell(args.workload)
    with tempfile.TemporaryDirectory() as tmp:
        problem = bdata.make_problem(cell, args.seed, device)
        engine = jobs.make_engine(cell, problem, device)
        engine.warm_up(tmp)
        first = profiling.mark()
        autograd_profiler._set_is_profiler_enabled(True)
        try:
            window = jobs.run_window(engine, problem, args.seconds,
                                     Tracer(False, 0.0, device), tmp)
        finally:
            autograd_profiler._set_is_profiler_enabled(False)
    spans = [s for s in profiling.recorded(first) if s.end_ns is not None]
    ms = defaultdict(float)
    for s in spans:
        ms[s.name] += (s.end_ns - s.start_ns) / 1e6
    evals = max(window.evals, 1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"workload": args.workload, "seed": args.seed, "evals": window.evals,
                      "window_ms_per_eval": window.seconds / evals * 1e3,
                      "ms_per_eval": {k: v / evals for k, v in sorted(ms.items(),
                                                                       key=lambda kv: -kv[1])},
                      "spans_per_eval": len(spans) / evals, "card": card}))


if __name__ == "__main__":
    main()
