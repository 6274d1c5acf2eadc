#!/usr/bin/env python3
"""How far the replica-batched L-BFGS runner strays from single starts.

    python3 scripts/torch_multistart_divergence.py [--steps 10]

On chip_smoke.py's flagship problem (``chip_smoke.build_problem``: n =
10,000, 100 grid blocks, m = 136, Y iid noise), three starts (the observed X and two
perturbations at the observation prior's scale) advance together in one
batch (the replicas folded into the kernels' batch) and each alone, with
float32 and with float64 scalar tails.  Prints, per replica and step, the
relative difference of the batched run's value to the single run's, and
of a second single run to the first.  Needs one CUDA device.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    import torch

    import gprf_torch  # noqa: F401  (float32 precision pins)
    from chip_smoke import build_problem
    from gprf_torch.optim.lbfgs import make_multistart_runner, make_scan_lbfgs_runner

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_multistart_divergence.py: no CUDA device")
    np.set_printoptions(precision=3)
    for acc in (None, torch.float64):
        fused, X_obs = build_problem(torch, "cuda", acc_dtype=acc)
        x = X_obs.reshape(-1)
        rng = np.random.default_rng(2)
        x0s = np.stack([x] + [x + rng.standard_normal(x.shape) * 0.02 for _ in range(2)])
        x0s = torch.as_tensor(x0s, dtype=torch.float32, device="cuda")
        init, run = make_multistart_runner(fused.loss_fn(), args.steps)
        _, (batched, _, _) = run(init(x0s))
        init1, run1 = make_scan_lbfgs_runner(fused.loss_fn(), args.steps)
        for r in range(len(x0s)):
            singles = [run1(init1(x0s[r]))[1][0].double() for _ in range(2)]

            def rel(a, b):
                return ((a.double() - b).abs() / b.abs()).cpu().numpy()

            print(f"scalar tails {acc or torch.float32}, replica {r}: batched vs single "
                  f"{rel(batched[r], singles[0])}; single vs single {rel(singles[1], singles[0])}")


if __name__ == "__main__":
    main()
