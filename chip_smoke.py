#!/usr/bin/env python3
"""GPU smoke run of gprf_torch: the flagship fused-Schur L-BFGS path on one card.

    python3 chip_smoke.py        (from the repository root; needs one CUDA device)

Phases, each of which raises on failure (exit code 1, no result line):

1. device  - require CUDA; print the card's name and power limit (nvidia-smi).
2. build   - compile K1 chol_inv, K2 mvn_ll and K3 tri_inv from
             gprf_torch/csrc with nvcc for sm_90a.
3. kernels - each kernel against its plain PyTorch twin on the card, at the
             flagship shapes, forward and backward; median times of both.
4. slice   - the flagship problem (synthetic n=10,000, 100 grid blocks
             padded to m=136, 180 axis-only edges, dy=50, task=x): one
             loss+grad with the kernels against the twins, then 2 dispatches
             of 25 scan-L-BFGS steps; every launch counter must grow.

Output: a JSON line describing each kernel, the nvidia-smi line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Flagship problem (the workload bench.py times for the JAX package).
N, NBLOCKS, DY = 10_000, 100, 50
LSCALE, OBS_STD, NOISE_VAR = 0.06, 0.02, 0.01
STEPS, DISPATCHES = 25, 2
MAX_GROWTHS = 16  # capacity growths of 16 slots each before giving up

# Tolerances, card against card in float32.  The pair Schur complements
# carry kappa(K) up to ~1e4 (set by the 0.01 noise jitter under unit signal
# variance), so two correct float32 factorizations that round in another
# order differ by up to ~kappa * eps relative; the backward passes chain
# two more factor products, hence the looser bound.
RTOL_FWD = 1e-4
RTOL_BWD = 1e-3
RTOL_LOSS = 1e-5
MIN_GRAD_COSINE = 0.9999


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def rel_err(a, b):
    """max |a - b| / max |b| (normwise, so tiny entries do not dominate)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def median_ms(fn, torch, reps=20, launches=10):
    """Median over reps of the device time of one call, each rep timing
    `launches` back-to-back calls between two CUDA events, so that the
    host's launch overhead hides behind the device's work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def build_problem(torch, dev):
    """The flagship problem from numpy, seed 0, as bench.py builds it."""
    from gprf_torch.model.fused import FusedGridGPRF
    from gprf_torch.partition.grid import Blocker, grid_centers
    from gprf_torch.utils.convert import cov_from_numpy

    rng = np.random.default_rng(0)
    SX = rng.uniform(size=(N, 2))
    X_obs = SX + rng.standard_normal(SX.shape) * OBS_STD
    Y = rng.standard_normal((N, DY))
    b = Blocker(grid_centers(NBLOCKS))
    edges = b.neighbors(diag_connections=False)
    cov = cov_from_numpy([1.0], [LSCALE, LSCALE], device=dev, dtype=torch.float32)
    fused = FusedGridGPRF(X_obs, Y, b.block_centers, edges, X_obs, OBS_STD, cov,
                          NOISE_VAR, device=dev, dtype=torch.float32)
    if (fused.m, len(edges)) != (136, 180):
        raise AssertionError(f"flagship layout is m={fused.m}, E={len(edges)}; want 136, 180")
    return fused, X_obs


def flagship_inputs(fused, x_flat, torch):
    """Each kernel's inputs as the main path gives them at the flagship
    point, recorded from one loss on the twins: K1 the padded unary blocks
    [100, 136, 136]; K2 the pair Schur complements [180, 136, 136], their
    right-hand sides [180, 136, 50] and active counts [180]; K3 the pair
    factors [180, 136, 136] that K2's backward inverts."""
    from gprf_torch.ops import mvn

    seen = {}

    def recorded(name, fn):
        def f(*args):
            seen[name] = tuple(a.detach().contiguous() for a in args)
            return fn(*args)
        return f

    fused.ops = mvn.Ops(*(recorded(n, f) for n, f in zip(mvn.Ops._fields, mvn.PLAIN_OPS)))
    x0 = torch.as_tensor(x_flat, dtype=fused.dtype, device=fused.device)
    with torch.no_grad():
        fused.loss_fn()(x0)
    fused.ops = mvn.KERNEL_OPS
    seen["tri_inv"] = (mvn.mvn_ll_plain(*seen["mvn_ll"])[1],)
    return seen


def check_kernels(fused, x_flat, torch):
    from gprf_torch.ops import mvn

    inputs = flagship_inputs(fused, x_flat, torch)
    gen = torch.Generator(device=fused.device).manual_seed(1)

    def randn_like(t):
        return torch.randn(t.shape, generator=gen, device=t.device, dtype=t.dtype)

    cases = {
        "chol_inv": dict(
            source="gprf_torch/csrc/chol_inv.cu", replaces="gprf_tpu/ops/pallas_mvn.py:411",
            args=inputs["chol_inv"], kernel=mvn.chol_inv, plain=mvn.chol_inv_plain,
            fn=mvn.CholInv.apply, cot=lambda out: [randn_like(o) for o in out]),
        "mvn_ll": dict(
            source="gprf_torch/csrc/mvn.cu", replaces="gprf_tpu/ops/pallas_mvn.py:592",
            args=inputs["mvn_ll"], kernel=mvn.mvn_ll, plain=mvn.mvn_ll_plain,
            fn=mvn.MvnLL.apply, cot=lambda out: [randn_like(out[0])]),
        "tri_inv": dict(
            source="gprf_torch/csrc/tri_inv.cu", replaces="gprf_tpu/ops/pallas_mvn.py:259",
            args=inputs["tri_inv"], kernel=mvn.tri_inv, plain=mvn.tri_inv_plain,
            fn=mvn.TriInv.apply, cot=lambda out: [randn_like(out[0])]),
    }
    report = {}
    for name, c in cases.items():
        shapes = [tuple(a.shape) for a in c["args"]]
        out_k = c["kernel"](*c["args"])
        out_p = c["plain"](*c["args"])
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        torch.cuda.synchronize()
        fwd = max(rel_err(a, b) for a, b in zip(out_k, out_p))
        abs_err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))

        # backward: the Function's analytic pullback against PyTorch's
        # autograd through the twin, under the same cotangents; only the
        # matrix inputs are differentiated (n_active is a count)
        cots = c["cot"](out_p)
        grads = []
        for f in (c["fn"], c["plain"]):
            ins = [a.clone().requires_grad_(a.dim() == 3) for a in c["args"]]
            out = f(*ins)
            out = out if isinstance(out, tuple) else (out,)
            out = out[:len(cots)]
            diff = [t for t in ins if t.requires_grad]
            grads.append(torch.autograd.grad(out, diff, cots))
        bwd = max(rel_err(a, b) for a, b in zip(*grads))

        ms = median_ms(lambda: c["kernel"](*c["args"]), torch)
        plain_ms = median_ms(lambda: c["plain"](*c["args"]), torch)
        log(f"kernel {name} {shapes}: fwd rel err {fwd:.3e}, bwd rel err {bwd:.3e}, "
            f"{ms:.4f} ms vs twin {plain_ms:.4f} ms")
        if not (fwd <= RTOL_FWD and bwd <= RTOL_BWD):
            raise AssertionError(f"{name} disagrees with its twin: fwd {fwd:.3e} "
                                 f"(limit {RTOL_FWD}), bwd {bwd:.3e} (limit {RTOL_BWD})")
        report[name] = dict(name=name, route="cuda", source=c["source"],
                            replaces=c["replaces"], launches=0, max_abs_err=abs_err,
                            ms=ms, plain_ms=plain_ms)
    return report


def eval_ms(losses, x0, torch, reps=20):
    """Median host-clock ms of one loss+grad for each loss, taken in turns
    (a, b, b, a, ...) so that drift of the shared host hits both alike."""
    from gprf_torch.optim.lbfgs import value_and_grad

    times = [[] for _ in losses]
    for rep in range(reps + 1):
        order = range(len(losses)) if rep % 2 else reversed(range(len(losses)))
        for i in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value_and_grad(losses[i], x0)
            torch.cuda.synchronize()
            if rep:  # the first round warms up
                times[i].append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in times]


def run_slice(fused, x_flat, torch):
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import value_and_grad, make_scan_lbfgs_runner

    x0 = torch.as_tensor(x_flat, dtype=fused.dtype, device=fused.device)

    # one loss+grad with the kernels against the same call on the twins
    fused.ops = mvn.PLAIN_OPS
    loss_plain = fused.loss_fn()
    v_p, g_p = value_and_grad(loss_plain, x0)
    fused.ops = mvn.KERNEL_OPS
    loss = fused.loss_fn()
    v_k, g_k = value_and_grad(loss, x0)
    loss_rel = abs(float(v_k) - float(v_p)) / abs(float(v_p))
    cosine = float(torch.dot(g_k.double(), g_p.double())
                   / (g_k.double().norm() * g_p.double().norm()))
    log(f"slice loss+grad kernels vs twins: loss {float(v_k):.6f} vs {float(v_p):.6f} "
        f"(rel {loss_rel:.3e}), gradient cosine {cosine:.8f}")
    if not (loss_rel <= RTOL_LOSS and cosine > MIN_GRAD_COSINE):
        raise AssertionError(f"slice disagrees with the twin path: loss rel {loss_rel:.3e}, "
                             f"cosine {cosine:.8f}")
    ms_kernel, ms_plain = eval_ms([loss, loss_plain], x0, torch)
    log(f"slice ms/eval (loss + grad, median of 20 in turns): kernels {ms_kernel:.3f}, "
        f"twins {ms_plain:.3f}")

    # the main path: scan-L-BFGS over the fused loss, counted.  A dispatch
    # whose end points overflow the capacity m (a block outgrew its slots,
    # so some steps dropped points) is run again at a grown capacity, as
    # FusedGridGPRF.value_and_grad re-evaluates a single step: the kept
    # trajectory never dropped a point.
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    t0 = time.perf_counter()
    init_fn, run_fn = make_scan_lbfgs_runner(loss, num_steps=STEPS,
                                             aux_fn=fused.overflow_fn())
    carry = init_fn(x0)
    values, capacities, first_dispatch_s = [], [], None
    for _ in range(DISPATCHES):
        while True:
            t_d = time.perf_counter()
            out, (v, _, _, overflow) = run_fn(carry)
            if not bool(overflow):
                break
            if len(capacities) >= MAX_GROWTHS:
                raise AssertionError(f"capacity still overflows at m={fused.m}")
            fused.grow_capacity()
            capacities.append(fused.m)
            init_fn, run_fn = make_scan_lbfgs_runner(fused.loss_fn(), num_steps=STEPS,
                                                     aux_fn=fused.overflow_fn())
        if first_dispatch_s is None:
            torch.cuda.synchronize()
            first_dispatch_s = time.perf_counter() - t_d
        carry = out
        values.append(v)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mvn.launch_counts)
    values = torch.cat(values).double().cpu().numpy()
    v0 = float(values[0])
    ms_iter = first_dispatch_s / STEPS * 1e3
    log(f"scan-L-BFGS: {DISPATCHES} x {STEPS} steps kept, {wall:.3f} s in all; first "
        f"dispatch (m=136) {ms_iter:.3f} ms/iter; capacity grown to {capacities or 'none'}; "
        f"objective {v0:.4f} -> {float(values[-1]):.4f}; launches {launches}")
    if not np.isfinite(values).all():
        raise AssertionError(f"non-finite L-BFGS values: {values}")
    if not values[-1] < v0:
        raise AssertionError(f"objective did not decrease: {v0} -> {values[-1]}")
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path skipped a kernel: launches {launches}")
    return launches, dict(ms_per_eval=ms_kernel, plain_ms_per_eval=ms_plain,
                          lbfgs_ms_per_iter=ms_iter, lbfgs_values=[v0, float(values[-1])],
                          capacity_growths=capacities)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
                         "False); this check runs only on a GPU")
    import gprf_torch  # noqa: F401  (float32 precision pins)
    from gprf_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    built = _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s) -> {built.path}")
    for line in built.log.splitlines():
        if "Used" in line:
            log(f"  ptxas: {line.strip()}")

    fused, X_obs = build_problem(torch, dev)
    x_flat = X_obs.reshape(-1)
    report = check_kernels(fused, x_flat, torch)
    launches, slice_report = run_slice(fused, x_flat, torch)
    for name, n in launches.items():
        report[name]["launches"] = n

    print(json.dumps({
        "kernels": list(report.values()),
        "slice": {"n": N, "blocks": NBLOCKS, "m": 136, "edges": int(fused.edges.shape[0]),
                  "dy": DY, **slice_report},
    }))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
