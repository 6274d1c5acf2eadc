"""Benchmark of the objective+gradient evaluation on the flagship-sized
problem (the measurement of the reference's ``bench.py``, on this package).

    python -m gprf_torch.bench [--device cpu]

The problem is ``bench.py``'s: synthetic n = 10,000 latent points, 100 grid
blocks, 180 axis-only edges, dy = 50, Y iid noise, task x.  Two times are
taken, each window between two ``torch.cuda.synchronize()`` calls:

- ``dispatch_eval_ms``: one ``FusedGridGPRF.value_and_grad`` call, the
  granularity of the scipy driver (mean of 10 calls after 2 warm ones);
- ``lbfgs_eval_ms``: one scan-L-BFGS iteration, which is exactly one
  objective+gradient evaluation (4 timed dispatches of 25 steps after a
  warm one).

The iid-noise Y lets blocks outgrow the starting capacity m = 136 within
the 125 steps, so the loop runs under the drivers' capacity-growth policy
(:class:`gprf_torch.optim.lbfgs.GrowingRunner`); the line reports the m the
run ends at and which compositions split there.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gprf_torch.model.fused import FusedGridGPRF
from gprf_torch.ops import mvn, split_mvn
from gprf_torch.optim.lbfgs import GrowingRunner, value_and_grad
from gprf_torch.partition.grid import Blocker, grid_centers
from gprf_torch.utils.convert import cov_from_numpy
from gprf_torch.utils.device import resolve_device
from gprf_torch.utils.flops import PEAK_F32_FLOPS, model_flops_per_eval

STEPS_PER_DISPATCH = 25
TIMED_DISPATCHES = 4


def build_problem(device, dtype=torch.float32, n=10000, nblocks=100, yd=50, lscale=0.06,
                  obs_std=0.02, seed=0, **fused_options):
    """(fused evaluator, X_obs): the timed problem, from NumPy's
    ``default_rng(seed)``.  Y is iid noise (the time of an evaluation does
    not depend on Y's distribution) and the edges are axis-only."""
    rng = np.random.default_rng(seed)
    SX = rng.uniform(size=(n, 2))
    X_obs = SX + rng.standard_normal(SX.shape) * obs_std
    Y = rng.standard_normal((n, yd))
    b = Blocker(grid_centers(nblocks))
    cov = cov_from_numpy([1.0], [lscale, lscale], device=device, dtype=dtype)
    fused = FusedGridGPRF(X_obs, Y, b.block_centers, b.neighbors(diag_connections=False), X_obs,
                          obs_std, cov, 0.01, device=device, dtype=dtype, **fused_options)
    return fused, X_obs


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_events(loss, x0, calls=5):
    """(name, device us) of every kernel a ``torch.profiler`` trace records
    over ``calls`` calls of one loss+gradient on a CUDA device, after one
    warm call (copies and memsets left out)."""
    from torch.profiler import ProfilerActivity, profile

    value_and_grad(loss, x0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            value_and_grad(loss, x0)
        torch.cuda.synchronize()
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no kernel on the device")
    return kernels


def device_busy(loss, x0, calls=5):
    """(device-busy ms, kernel launches) of one loss+gradient on a CUDA
    device: :func:`kernel_events` summed, per call."""
    kernels = kernel_events(loss, x0, calls)
    return sum(us for _, us in kernels) / 1e3 / calls, len(kernels) / calls


def splits_at(m: int, dy: int) -> list[str]:
    """The compositions of :mod:`gprf_torch.ops.split_mvn` that split at
    block width m (their leaves run the kernels on halves)."""
    caps = {"chol_inv": split_mvn.LEAF_CHOL, "mvn_ll": mvn.mvn_max_m(dy),
            "tri_inv": split_mvn.LEAF_TRI}
    return [name for name, cap in caps.items() if m > cap]


def run(device, dtype=torch.float32, log=lambda msg: print(msg, file=sys.stderr), **problem):
    """The measurement; returns the record that :func:`main` prints."""
    device = resolve_device(device)
    fused, X_obs = build_problem(device, dtype, **problem)
    flat_obs = X_obs.reshape(-1)
    m0, E, dy = fused.m, int(fused.edges.shape[0]), fused.Y.shape[1]

    # one dispatch per evaluation, the scipy driver's granularity
    for _ in range(2):
        fused.value_and_grad(flat_obs)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(10):
        fused.value_and_grad(flat_obs)
    _sync(device)
    dispatch_eval_ms = (time.perf_counter() - t0) / 10 * 1e3

    # the optimization loop on the device: one evaluation per iteration
    runner = GrowingRunner(fused, STEPS_PER_DISPATCH)
    carry = runner.init_fn(torch.as_tensor(flat_obs, dtype=dtype, device=device))
    v_first, grown = None, []

    def dispatch(carry):
        carry, (values, _, _, overflow) = runner.run_fn(carry)
        if bool(overflow):
            carry = runner.grow(carry)
            grown.append(fused.m)
        return carry, values

    carry, values = dispatch(carry)  # warm
    v_first = float(values[0])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(TIMED_DISPATCHES):
        carry, values = dispatch(carry)
    _sync(device)
    wall = time.perf_counter() - t0
    total_evals = TIMED_DISPATCHES * STEPS_PER_DISPATCH
    v_last = float(values[-1])
    if not (np.isfinite(v_last) and v_last <= v_first):
        raise RuntimeError(f"optimization not progressing: {v_first} -> {v_last}")
    lbfgs_eval_ms = wall / total_evals * 1e3

    busy_ms = launches = None
    if device.type == "cuda":
        x_last = carry["x_prev"]
        busy_ms, launches = device_busy(fused.loss_fn(), x_last)

    # the FLOP model at the width the run ended at
    flops = model_flops_per_eval(B=fused.n_blocks, m=fused.m, E=E, dy=dy, dx=X_obs.shape[1])
    rate = flops / (lbfgs_eval_ms / 1e3)
    card = None
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"single-dispatch eval {dispatch_eval_ms:.3f} ms; device loop: {total_evals} evals in "
        f"{wall:.3f} s -> {lbfgs_eval_ms:.3f} ms/eval; obj {v_first:.1f} -> {v_last:.1f}; "
        f"m {m0} -> {fused.m} (grown at {grown or 'none'}); model {flops / 1e9:.1f} GFLOP/eval")
    return {
        "metric": "gprf_torch_obj_grad_eval_n10k_100blocks",
        "device": str(device), "dtype": str(dtype).replace("torch.", ""),
        "dispatch_eval_ms": dispatch_eval_ms, "lbfgs_eval_ms": lbfgs_eval_ms,
        "lbfgs_evals": total_evals, "edges": E, "m_start": m0, "m_final": fused.m,
        "capacity_growths": grown, "splits_at_m_final": splits_at(fused.m, dy),
        "model_gflop_per_eval": flops / 1e9, "gflops": rate / 1e9,
        "share_of_f32_peak": rate / PEAK_F32_FLOPS if device.type == "cuda" else None,
        "device_busy_ms_per_eval": busy_ms, "device_launches_per_eval": launches,
        "card": card,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; 'cuda' (default) raises without a GPU")
    args = parser.parse_args(argv)
    record = run(args.device)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
