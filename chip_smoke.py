#!/usr/bin/env python3
"""GPU smoke run of gprf_torch: the flagship fused-Schur L-BFGS path on one card,
on each of the objective's three routes.

    python3 chip_smoke.py        (from the repository root; needs one CUDA device)

Phases, each of which raises on failure (exit code 1, no result line):

1. device  - require CUDA; print the card's name and power limit (nvidia-smi).
2. build   - compile K1 chol_inv, K2 mvn_ll, K3 tri_inv, K4 mvn_ll_inv and
             K5 cholesky from gprf_torch/csrc for sm_90a, one nvcc per
             source, all at once.
3. kernels - each kernel against its plain PyTorch twin on the card, at the
             flagship shapes, forward and backward; median times of both,
             of the one PyTorch call that computes the same function where
             there is one (K3, K5), and the kernel's bound from its FLOPs
             and bytes.  K5 takes K1's unary inputs and K4 takes K2's pair
             inputs.  Each also at m=152 (the first capacity growth) and at
             its cap on seeded inputs, with its CTAs per SM: K1 and K5 at
             m=240, K2 and K4 at m=208 (dy=50), K3 at m=224; K1, K2, K4 and
             K5 must fit 2 CTAs an SM at m=136.  cholesky_split at
             [4,248,248] (past K5's cap: K5 leaves and K3) against the
             twin's Cholesky.
4. routes  - the flagship problem (synthetic n=10,000, 100 grid blocks
             padded to m=136, 180 axis-only edges, dy=50, task=x) on each
             route of the objective (ROUTES): one loss+grad with the
             kernels against the same route on the twins, and each other
             route against the default one; ms/eval of all six in turns;
             device-busy ms of one loss+grad of each (torch.profiler,
             kernel events only).
5. lbfgs   - per route, with the launch counters reset just before and read
             just after: the default route runs 2 dispatches of 25
             scan-L-BFGS steps, the other two one dispatch each from the
             same start at m=136; each run must launch its route's kernels
             and none that the route does not run.

Output: a JSON line describing each kernel (its launches on the main path,
its max abs error against its twin, its ms, its twin's, its library call's
and its bound), the nvidia-smi line, and last
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
M0 = 136  # the flagship's padded block width
STEPS = 25
MAX_GROWTHS = 16  # capacity growths of 16 slots each before giving up

# route -> (FusedGridGPRF options, L-BFGS dispatches, kernels its run must
# launch, kernels it must not launch at m = 136)
ROUTES = {
    "default": (dict(mvn_inv=False, unary_doubling=False), 2,
                ("chol_inv", "mvn_ll", "tri_inv"), ("mvn_ll_inv", "cholesky")),
    "mvn_inv": (dict(mvn_inv=True, unary_doubling=False), 1,
                ("chol_inv", "mvn_ll_inv"), ("tri_inv", "cholesky")),
    "unary_doubling": (dict(mvn_inv=False, unary_doubling=True), 1,
                       ("cholesky", "mvn_ll", "tri_inv"), ("chol_inv", "mvn_ll_inv")),
}
# K1 and K5 (K1's kernel) widths checked beyond the flagship's: the first
# capacity growth and the cap
CHOL_INV_WIDTHS = (152, 240)
# K3 widths checked beyond the flagship's: the first capacity growth and the cap
TRI_INV_WIDTHS = (152, 224)
# K2 and K4 (K2's working set) widths checked beyond the flagship's: the first
# capacity growth and the cap at dy = 50 (mvn_max_m, mvn_inv_supported)
MVN_WIDTHS = (152, 208)
# cholesky_split's check: wider than K5's cap (240), so it splits
CHOL_SPLIT_SHAPE = (4, 248)
# the route whose L-BFGS run gives each kernel's launch count
KERNEL_ROUTE = {"chol_inv": "default", "mvn_ll": "default", "tri_inv": "default",
                "mvn_ll_inv": "mvn_inv", "cholesky": "unary_doubling"}

# Tolerances, card against card in float32.  The pair Schur complements
# carry kappa(K) up to ~1e4 (set by the 0.01 noise jitter under unit signal
# variance), so two correct float32 factorizations that round in another
# order differ by up to ~kappa * eps relative; the backward passes chain
# two more factor products, hence the looser bound.
RTOL_FWD = 1e-4
RTOL_BWD = 1e-3
RTOL_LOSS = 1e-5
MIN_GRAD_COSINE = 0.9999

# Published peaks of one H100 SXM at 700 W: float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


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


def work(name, args):
    """(FLOPs, bytes) of one call of kernel `name` on `args`: each input read
    once, the [B, m, m] matrix (K or L) only in its lower triangle, the one
    part that each kernel's function depends on, and each output written
    once, whole; a Cholesky or a triangular inverse m^3/3 FLOPs a matrix, a
    substitution of dy right-hand sides m^2 dy and the quadratic form
    2 m dy."""
    B, m = args[0].shape[:2]
    dy = args[1].shape[-1] if len(args) > 1 else 0
    chol, rhs = m ** 3 / 3, m * m * dy + 2 * m * dy
    flops = {"chol_inv": 2 * chol, "mvn_ll": chol + rhs, "tri_inv": chol,
             "mvn_ll_inv": 2 * chol + rhs, "cholesky": chol}[name]
    out_floats = {"chol_inv": 2 * m * m, "mvn_ll": m * m + 1, "tri_inv": m * m,
                  "mvn_ll_inv": m * m + m * dy + 1, "cholesky": m * m}[name]
    in_bytes = (B * m * (m + 1) // 2 * args[0].element_size()
                + sum(a.numel() * a.element_size() for a in args[1:]))
    return B * flops, in_bytes + B * out_floats * 4


def bound(name, args):
    """(ms, "operations" or "bytes"): the least time the card could take
    for the work, at the published peaks."""
    flops, nbytes = work(name, args)
    ops_ms, bytes_ms = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


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
    if (fused.m, len(edges)) != (M0, 180):
        raise AssertionError(f"flagship layout is m={fused.m}, E={len(edges)}; want 136, 180")
    return fused, X_obs


def flagship_inputs(fused, x_flat, torch):
    """Each kernel's inputs as the main path gives them at the flagship
    point, recorded from one loss of the default route on the twins: K1 the
    padded unary blocks [100, 136, 136]; K2 the pair Schur complements
    [180, 136, 136], their right-hand sides [180, 136, 50] and active counts
    [180]; K3 the pair factors [180, 136, 136] that K2's backward inverts.
    K5 factors K1's blocks on its route and K4 takes K2's inputs on its."""
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
    seen["mvn_ll_inv"] = seen["mvn_ll"]
    seen["cholesky"] = seen["chol_inv"]
    return seen


def compare(c, args, torch):
    """One kernel against its twin on the same inputs: forward normwise rel
    err, backward rel err, forward max abs err, kernel ms, twin ms, the
    library call's ms (None where there is none), the bound, and the
    kernel's ms on the first matrix alone.  The
    backward is the Function's analytic pullback against PyTorch's autograd
    through the twin, under the same cotangents; only the matrix inputs are
    differentiated (n_active is a count)."""
    out_k = c["kernel"](*args)
    out_p = c["plain"](*args)
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    torch.cuda.synchronize()
    fwd = max(rel_err(a, b) for a, b in zip(out_k, out_p))
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    cots = c["cot"](out_p)
    grads = []
    for f in (c["fn"], c["plain"]):
        ins = [a.clone().requires_grad_(a.dim() == 3) for a in args]
        out = f(*ins)
        out = out if isinstance(out, tuple) else (out,)
        out = out[:len(cots)]
        diff = [t for t in ins if t.requires_grad]
        grads.append(torch.autograd.grad(out, diff, cots))
    bwd = max(rel_err(a, b) for a, b in zip(*grads))
    ms = median_ms(lambda: c["kernel"](*args), torch)
    one = tuple(a[:1] for a in args)  # one CTA with the card to itself: the chain's length
    one_matrix_ms = median_ms(lambda: c["kernel"](*one), torch)
    plain_ms = median_ms(lambda: c["plain"](*args), torch)
    library_ms = median_ms(lambda: c["library"](*args), torch) if c.get("library") else None
    if not (fwd <= RTOL_FWD and bwd <= RTOL_BWD):
        raise AssertionError(f"{c['name']} {[tuple(a.shape) for a in args]} disagrees with its "
                             f"twin: fwd {fwd:.3e} (limit {RTOL_FWD}), bwd {bwd:.3e} "
                             f"(limit {RTOL_BWD})")
    bound_ms, bound_by = bound(c["name"], args)
    r = dict(fwd_rel_err=fwd, bwd_rel_err=bwd, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
             one_matrix_ms=one_matrix_ms)
    log(f"kernel {c['name']} {[tuple(a.shape) for a in args]}: fwd rel err {fwd:.3e}, "
        f"bwd rel err {bwd:.3e}, {ms:.4f} ms vs twin {plain_ms:.4f} ms, library "
        f"{'-' if library_ms is None else f'{library_ms:.4f} ms'}, bound {bound_ms:.4f} ms "
        f"({bound_by}); one matrix alone {one_matrix_ms:.4f} ms")
    return r


def seeded_factors(B, m, gen, torch, dev):
    """Lower Cholesky factors [B, m, m] in float32 of A A^T / m + I, A
    seeded normal (kappa(K) <= ~5), factored in float64 by the twin."""
    from gprf_torch.ops import mvn

    A = torch.randn(B, m, m, generator=gen, device=dev, dtype=torch.float64)
    K = A @ A.mT / m + torch.eye(m, device=dev, dtype=torch.float64)
    return K, mvn.cholesky_plain(K).float().contiguous()


def check_cholesky_split(gen, torch, dev):
    """cholesky_split past K5's cap against the twin's Cholesky: it must
    run on K5 leaves and K3, and agree in float32."""
    from gprf_torch.ops import mvn
    from gprf_torch.ops.split_mvn import cholesky_split

    B, m = CHOL_SPLIT_SHAPE
    K, _ = seeded_factors(B, m, gen, torch, dev)
    K = K.float().contiguous()
    mvn.reset_launch_counts()
    L = cholesky_split(K)
    torch.cuda.synchronize()
    launches = {k: mvn.launch_counts[k] for k in ("cholesky", "tri_inv")}
    fwd = rel_err(L, mvn.cholesky_plain(K))
    log(f"cholesky_split [{B},{m},{m}]: rel err {fwd:.3e} vs cholesky_plain, launches {launches}")
    if launches["cholesky"] < 2 or launches["tri_inv"] < 1 or not fwd <= RTOL_FWD:
        raise AssertionError(f"cholesky_split at m={m}: launches {launches}, rel err {fwd:.3e}")
    return dict(shape=[B, m, m], rel_err=fwd, check_launches=launches)


def seeded_mvn_inputs(B, m, gen, torch, dev):
    """K2's inputs at width m: Kp = A A^T / m + I in float32, Y [B, m, DY]
    seeded normal, every row active."""
    K, _ = seeded_factors(B, m, gen, torch, dev)
    Y = torch.randn(B, m, DY, generator=gen, device=dev)
    return K.float().contiguous(), Y, torch.full((B,), float(m), device=dev)


def check_kernels(fused, x_flat, torch):
    from gprf_torch.ops import _build, mvn

    inputs = flagship_inputs(fused, x_flat, torch)
    gen = torch.Generator(device=fused.device).manual_seed(1)

    def randn_like(t):
        return torch.randn(t.shape, generator=gen, device=t.device, dtype=t.dtype)

    dev = fused.device
    eyes = {m: torch.eye(m, device=dev) for m in (M0, *TRI_INV_WIDTHS)}
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
            fn=mvn.TriInv.apply, cot=lambda out: [randn_like(out[0])],
            library=lambda L: torch.linalg.solve_triangular(L, eyes[L.shape[-1]].expand(L.shape),
                                                            upper=False)),
        "mvn_ll_inv": dict(
            source="gprf_torch/csrc/mvn_inv.cu", replaces="gprf_tpu/ops/pallas_mvn.py:771",
            args=inputs["mvn_ll_inv"], kernel=mvn.mvn_ll_inv, plain=mvn.mvn_ll_inv_plain,
            fn=mvn.MvnLLInv.apply, cot=lambda out: [randn_like(out[0])]),
        "cholesky": dict(
            source="gprf_torch/csrc/chol_inv.cu", replaces="gprf_tpu/ops/pallas_mvn.py:144",
            args=inputs["cholesky"], kernel=mvn.cholesky, plain=mvn.cholesky_plain,
            fn=mvn.Cholesky.apply, cot=lambda out: [randn_like(out[0])],
            library=lambda K: torch.linalg.cholesky_ex(K)),
    }
    report = {}
    for name, c in cases.items():
        c["name"] = name
        report[name] = dict(name=name, route="cuda", source=c["source"], replaces=c["replaces"],
                            launches=0, **compare(c, c["args"], torch))

    # Every kernel past the flagship width, on as many matrices as the
    # flagship has unary blocks (K1, K5) or pairs (K2, K3, K4):
    # name -> (widths, the cap, CTAs per SM at width m, inputs at width m)
    lib = _build.load().lib
    n_unary, n_pair = inputs["chol_inv"][0].shape[0], inputs["mvn_ll"][0].shape[0]

    def unary_blocks(m):
        return (seeded_factors(n_unary, m, gen, torch, dev)[0].float().contiguous(),)

    def pair_inputs(m):
        return seeded_mvn_inputs(n_pair, m, gen, torch, dev)

    wide = {
        "chol_inv": (CHOL_INV_WIDTHS, mvn.MAX_M_CHOL_INV, lib.gprf_chol_inv_ctas_per_sm,
                     unary_blocks),
        "mvn_ll": (MVN_WIDTHS, mvn.mvn_max_m(DY), lambda m: lib.gprf_mvn_ctas_per_sm(m, DY),
                   pair_inputs),
        "tri_inv": (TRI_INV_WIDTHS, mvn.MAX_M_TRI_INV, lib.gprf_tri_inv_ctas_per_sm,
                    lambda m: (seeded_factors(n_pair, m, gen, torch, dev)[1],)),
        "mvn_ll_inv": (MVN_WIDTHS, max(m for m in range(512) if mvn.mvn_inv_supported(m, DY)),
                       lambda m: lib.gprf_mvn_inv_ctas_per_sm(m, DY), pair_inputs),
        # K5 runs K1's kernel, so K1's query answers for it
        "cholesky": (CHOL_INV_WIDTHS, mvn.MAX_M_CHOL, lib.gprf_chol_inv_ctas_per_sm,
                     unary_blocks),
    }
    for name, (widths, cap, ctas_per_sm, make_inputs) in wide.items():
        if cap != widths[-1]:
            raise AssertionError(f"{name}'s cap is {cap}, not {widths[-1]}")
        report[name]["ctas_per_sm"] = ctas_per_sm(M0)
        report[name]["widths"] = []
        for m in widths:
            args = make_inputs(m)
            report[name]["widths"].append(dict(
                shape=list(args[0].shape) + [a.shape[-1] for a in args[1:2]],
                ctas_per_sm=ctas_per_sm(m), **compare(cases[name], args, torch)))
        log(f"CTAs per SM, {name}: {report[name]['ctas_per_sm']} at m={M0}, "
            f"{[w['ctas_per_sm'] for w in report[name]['widths']]} at {widths}")
    # the blocked designs that keep one working set need two CTAs an SM at the flagship
    for name in ("chol_inv", "mvn_ll", "mvn_ll_inv", "cholesky"):
        if report[name]["ctas_per_sm"] < 2:
            raise AssertionError(f"{name} fits {report[name]['ctas_per_sm']} CTAs an SM at "
                                 f"m={M0}; its design needs 2")
    report["cholesky"]["split"] = check_cholesky_split(gen, torch, dev)
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


def device_busy(loss, x0, torch, calls=5):
    """(device-busy ms, kernel launches) of one loss+grad: the kernel events
    of a torch.profiler trace over `calls` calls, summed, per call."""
    from torch.profiler import ProfilerActivity, profile

    from gprf_torch.optim.lbfgs import value_and_grad

    value_and_grad(loss, x0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            value_and_grad(loss, x0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("torch.profiler recorded no kernel on the device")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return busy_us / 1e3 / calls, len(kernels) / calls


def use_route(fused, route, ops):
    """Point the fused engine at a route and at the kernels or the twins;
    each loss made afterwards runs them."""
    for k, v in ROUTES[route][0].items():
        setattr(fused, k, v)
    fused.ops = ops


def agreement(vg, vg_ref):
    """(loss rel, gradient cosine) of one loss+grad against another."""
    (v, g), (v_ref, g_ref) = vg, vg_ref
    loss_rel = abs(float(v) - float(v_ref)) / abs(float(v_ref))
    g, g_ref = g.double(), g_ref.double()
    return loss_rel, float(g @ g_ref / (g.norm() * g_ref.norm()))


def check_routes(fused, x0, torch):
    """Per route: one loss+grad on the kernels against the same route on the
    twins, and against the default route on the kernels; then ms/eval of
    every route on both, in turns."""
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import value_and_grad

    fused.m = M0
    losses, evals, report = [], {}, {}
    for route in ROUTES:
        for ops in (mvn.KERNEL_OPS, mvn.PLAIN_OPS):
            use_route(fused, route, ops)
            losses.append(fused.loss_fn())
            evals[route, ops is mvn.KERNEL_OPS] = value_and_grad(losses[-1], x0)
        report[route] = {"vs_twins": agreement(evals[route, True], evals[route, False])}
        if route != "default":
            report[route]["vs_default"] = agreement(evals[route, True], evals["default", True])
        for against, (loss_rel, cosine) in report[route].items():
            log(f"route {route}, kernels {against}: loss {float(evals[route, True][0]):.6f}, "
                f"rel {loss_rel:.3e}, gradient cosine {cosine:.8f}")
            if not (loss_rel <= RTOL_LOSS and cosine > MIN_GRAD_COSINE):
                raise AssertionError(f"route {route} disagrees, {against}: loss rel "
                                     f"{loss_rel:.3e}, cosine {cosine:.8f}")
    ms = eval_ms(losses, x0, torch)
    for i, route in enumerate(ROUTES):
        report[route].update(ms_per_eval=ms[2 * i], plain_ms_per_eval=ms[2 * i + 1])
        log(f"route {route} ms/eval (loss + grad, median of 20 in turns): kernels "
            f"{ms[2 * i]:.3f}, twins {ms[2 * i + 1]:.3f}")
    for i, route in enumerate(ROUTES):
        (busy, n), (plain_busy, plain_n) = (device_busy(losses[2 * i + t], x0, torch)
                                            for t in (0, 1))
        report[route].update(device_busy_ms=busy, device_launches=n,
                             plain_device_busy_ms=plain_busy, plain_device_launches=plain_n)
        log(f"route {route} device busy per loss+grad (profiler, kernel events): kernels "
            f"{busy:.3f} ms ({n:.0f} launches), twins {plain_busy:.3f} ms ({plain_n:.0f})")
    return report


def run_lbfgs(fused, x0, route, torch):
    """The main path on one route: scan-L-BFGS over the fused loss from x0
    at m = 136, counted.  A dispatch whose end points overflow the capacity
    m (a block outgrew its slots, so some steps dropped points) is run again
    at a grown capacity, as FusedGridGPRF.value_and_grad re-evaluates a
    single step: the kept trajectory never dropped a point."""
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import make_scan_lbfgs_runner

    _, dispatches, must, must_not = ROUTES[route]
    use_route(fused, route, mvn.KERNEL_OPS)
    fused.m = M0
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    t0 = time.perf_counter()
    init_fn, run_fn = make_scan_lbfgs_runner(fused.loss_fn(), num_steps=STEPS,
                                             aux_fn=fused.overflow_fn())
    carry = init_fn(x0)
    values, capacities, first_dispatch_s = [], [], None
    for _ in range(dispatches):
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
    log(f"scan-L-BFGS, route {route}: {dispatches} x {STEPS} steps kept, {wall:.3f} s in all; "
        f"first dispatch (m={M0}) {ms_iter:.3f} ms/iter; capacity grown to "
        f"{capacities or 'none'}; objective {v0:.4f} -> {float(values[-1]):.4f}; "
        f"launches {launches}")
    if not np.isfinite(values).all():
        raise AssertionError(f"non-finite L-BFGS values on route {route}: {values}")
    if not values[-1] < v0:
        raise AssertionError(f"objective did not decrease on route {route}: {v0} -> {values[-1]}")
    skipped = [k for k in must if launches[k] < 1]
    stray = [k for k in must_not if launches[k] != 0]
    if skipped or stray:
        raise AssertionError(f"route {route} skipped {skipped} or launched {stray}: "
                             f"launches {launches}")
    return dict(lbfgs_dispatches=dispatches, lbfgs_ms_per_iter=ms_iter,
                lbfgs_values=[v0, float(values[-1])], capacity_growths=capacities,
                launches=launches)


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
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            log(f"  ptxas: {line.strip()}")

    fused, X_obs = build_problem(torch, dev)
    x_flat = X_obs.reshape(-1)
    report = check_kernels(fused, x_flat, torch)
    x0 = torch.as_tensor(x_flat, dtype=fused.dtype, device=fused.device)
    routes = check_routes(fused, x0, torch)
    for route in ROUTES:
        routes[route].update(run_lbfgs(fused, x0, route, torch))
    for name, route in KERNEL_ROUTE.items():
        report[name]["launches"] = routes[route]["launches"][name]

    print(json.dumps({
        "kernels": list(report.values()),
        "slice": {"n": N, "blocks": NBLOCKS, "m": M0, "edges": int(fused.edges.shape[0]),
                  "dy": DY, "routes": routes},
    }))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
