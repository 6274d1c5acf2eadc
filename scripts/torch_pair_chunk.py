#!/usr/bin/env python3
"""One loss+grad of the 80k device engine under each pair chunk: the rule's
(:func:`gprf_torch.model.objective.auto_pair_chunk`), 64 edges (the
reference's), and the whole pass.

    python3 scripts/torch_pair_chunk.py [--m 896] [--replicas 1 4] [--out FILE]

The problem has the 80k benchmark's shapes: 80,000 points uniform on the
unit square, 100 grid blocks with the diagonal edges (342), dy 50, the SE
kernel at lengthscale 0.021213 and noise 0.01, capacity ``--m``; Y is iid
normal, since the work does not depend on it.  For the float32 engine on
the kernels at each R of ``--replicas`` (R folded replicas, as
``--multistart R`` runs them), for the float64 tail's engine
(``LINALG_OPS``, as ``refine_f64`` builds it) at R = 1, and for the float32
engine at R = 1 under a Matern-3/2 covariance, whose kernel matrices are
composed eagerly as the seismic covariance's are (the SE kernel serves only
the SE covariance): the chunk, the pair
counters of one call, the peak memory (``torch.cuda.max_memory_allocated``)
and the part of it above the resident, the host-clock ms of one loss+grad
(median of 3 after a warm call), the device-busy ms and launches of one
(``torch.profiler``, float32 only), and the loss and gradient against the
rule's.  A measurement that runs out of memory is recorded as such.

One JSON line each on standard output, and into ``--out`` when given, with
the card's name and power limit.  Needs one CUDA device.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAIR_COUNTERS = ("pair_passes", "pair_chunks", "pair_dummy_edges", "pair_schur_blocked")


def measure(fused, theta, chunk, reference, busy):
    """The record of one loss+grad under ``chunk`` ("rule", 64 or
    "whole"); ``reference`` (value, gradient) or None."""
    import torch

    from gprf_torch.model.objective import PAIR_BUFFERS
    from gprf_torch.optim.lbfgs import value_and_grad
    from gprf_torch.utils import profiling

    R = theta.shape[0] if theta.dim() == 2 else 1
    E = int(fused.edges.shape[0])
    fused.pair_chunk = {"rule": None, "whole": E}.get(chunk, chunk)  # a chunk of all edges: none
    record = {"replicas": R, "chunk": chunk, "pair_chunk": fused.loss_pair_chunk(R),
              "m": fused.m, "edges": E, "dtype": str(fused.dtype)}
    loss = fused.loss_fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    try:
        profiling.fit_counts.update(dict.fromkeys(PAIR_COUNTERS, 0))
        v, g = value_and_grad(loss, theta)
        torch.cuda.synchronize()
        record.update({k: profiling.fit_counts[k] for k in PAIR_COUNTERS})
        peak = torch.cuda.max_memory_allocated()
        estimate = R * E * PAIR_BUFFERS * fused.m ** 2 * fused.Y.element_size()
        record.update(peak_gb=peak / 1e9, above_resident_gb=(peak - resident) / 1e9,
                      estimate_gb=estimate / 1e9)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            value_and_grad(loss, theta)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        record.update(ms=statistics.median(times))
        if busy:
            record["device_busy_ms"], record["launches"] = profiling.device_busy(loss, theta,
                                                                                 calls=2)
        if reference is not None:
            v0, g0 = reference
            g64, g064 = g.double().flatten(), g0.double().flatten()
            record.update(value_rel=float(((v.double() - v0.double()).abs()
                                           / v0.double().abs()).max()),
                          grad_cosine=float(g64 @ g064 / (g64.norm() * g064.norm())))
        out = (v.detach(), g.detach())
    except torch.cuda.OutOfMemoryError as e:
        record.update(out_of_memory=str(e).splitlines()[0])
        out = None
    fused.pair_chunk = None
    return record, out


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--m", type=int, default=896)
    parser.add_argument("--replicas", type=int, nargs="*", default=[1, 4])
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_pair_chunk.py: no CUDA device")
    from gprf_torch.model.objective import pair_budget_bytes

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None

        def emit(record):
            line = json.dumps(dict(record, card=card, budget_gb=pair_budget_bytes("cuda") / 1e9))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        run(args, emit)


def run(args, emit):
    """Every measurement of the module docstring, each given to ``emit``."""
    import numpy as np
    import torch

    from gprf_torch.kernels.gpcov import GPCov
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.ops import mvn
    from gprf_torch.partition.grid import Blocker, grid_centers

    rng = np.random.default_rng(0)
    n, dy, obs_std = 80000, 50, 0.007071
    X_obs = rng.uniform(size=(n, 2)) + obs_std * rng.standard_normal((n, 2))
    Y = rng.standard_normal((n, dy))
    centers = np.asarray(grid_centers(100))
    edges = Blocker(centers).neighbors(diag_connections=True)

    def engine(dtype, ops, wfn="se"):
        cov = GPCov.create([1.0], [0.021213, 0.021213], "euclidean", wfn, device="cuda",
                           dtype=dtype)
        return FusedSyntheticGPRF(X_obs, Y, edges, X_obs, obs_std, cov, 0.01, task="x",
                                  centers=centers, m=args.m, device="cuda", dtype=dtype,
                                  acc_dtype=torch.float64, ops=ops)

    x = X_obs.reshape(-1)
    fused = engine(torch.float32, mvn.KERNEL_OPS)
    for R in args.replicas:
        xs = x if R == 1 else np.stack([x] + [x + rng.standard_normal(x.shape) * obs_std
                                              for _ in range(R - 1)])
        theta = torch.as_tensor(xs, dtype=torch.float32, device="cuda")
        record, ref = measure(fused, theta, "rule", None, busy=True)
        emit(record)
        for chunk in (64, "whole"):
            emit(measure(fused, theta, chunk, ref, busy=True)[0])
        del ref, theta
    del fused
    fused = engine(torch.float64, mvn.LINALG_OPS)
    theta = torch.as_tensor(x, dtype=torch.float64, device="cuda")
    record, ref = measure(fused, theta, "rule", None, busy=False)
    emit(record)
    emit(measure(fused, theta, 64, ref, busy=False)[0])
    del fused, ref
    fused = engine(torch.float32, mvn.KERNEL_OPS, wfn="matern32")
    emit(dict(measure(fused, torch.as_tensor(x, dtype=torch.float32, device="cuda"), "rule",
                      None, busy=True)[0], covariance="matern32"))


if __name__ == "__main__":
    main()
