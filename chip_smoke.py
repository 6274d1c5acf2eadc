#!/usr/bin/env python3
"""GPU smoke run of gprf_torch on one card: the kernels, the flagship
fused-Schur L-BFGS path on each of the objective's three routes, multistart,
the synthetic and seismic experiments end to end through their command
lines, the kernelized and sparse llgrads and the analysis tools.

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
             twin's Cholesky, and chol_inv_split, tri_inv_split and
             mvn_ll_split one notch past their leaves' caps (m=248, 232,
             216), forward and backward, with their leaves' launches.
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
             same start at m=136, all under the drivers' capacity-growth
             policy (GrowingRunner); each run must launch its route's
             kernels and none that the route does not run.
6. cli     - ``gprf_torch.cli.gprfopt.main`` at the command line's flagship
             (n=10,000 + 500 test points, 100 blocks, 342 edges with the
             diagonal ones, Y a GP draw, dy=50, task x, device engine, 100
             iterations) into a temporary GPRF_EXPERIMENTS, counters reset
             before and read after: log.txt, step_*_X.npy,
             optimizer_state.npz, results.txt and finished must exist, the
             logged objective must be finite and end above where it began,
             the last row's mad below the first's, the trueX row finite,
             K1-K3 and the SE kernel launched and K4, K5 not.  Seconds of
             sampling, fitting and analysis apart; device-busy ms of one
             loss+grad at these shapes; K1, K2 and K3 each against its twin,
             timed, on the inputs this path gives them ([100,136,136],
             [342,136,136] + [342,136,50]); the SE kernel against its twin
             on this path's unary and pair points, forward and backward,
             timed beside the twin and its bound (``check_se_kernel``).
7. predict - ``--analyze --analyze_full`` on the cli phase's run directory
             (no new fit), counters reset before and read after: the six
             predictive columns of results.txt finite and non-zero on every
             row and on trueX (logged beside the JAX package's artifact,
             docs/runs/gprf10k_device/results.txt), K5 launched for the
             predictor's block caches, K1 and K2 for the trueX objective, K3
             and K4 not.  At the fit's final X: K5 against its twin on the
             block caches the predictor gives it ([100,136,136]); the
             float32 predictor on the kernels against the float64 one on the
             twins (SMSE and MSLL within PREDICT_RTOL_SMSE,
             PREDICT_ATOL_MSLL); prediction_error_gp once, float64 on the
             card; one prediction_error in parts (GPRF build, block caches,
             combination, host loop).
8. rpc     - the command line's flagship with ``--rpc_blocksize 200`` in
             place of ``--nblocks 100`` (device engine, 100 iterations),
             counters reset before and read after: the files, a rising
             objective, a falling mad, a finite trueX row, K1-K3 and the SE
             kernel launched and K4, K5 not; B, E and m as the engine reports them against
             the host's cluster_rpc (64 blocks, m = 160); the float32 median
             replay on the card against the float64 host replay at X_obs and
             the final X (points in another block counted, at most
             RPC_MAX_MOVED); K1-K3 against their twins on this path's inputs
             ([64,160,160], [E,160,160] + [E,160,50]); one folded loss at
             R = 2 against the two single ones, labels and values; the
             device-busy ms and launches of one loss+grad.
9. host    - the same data with ``--engine host`` for a few seconds:
             GPRF.llgrad under scipy launches K1-K3 and the objective
             rises; then GPRF.update_X across a change of the padded width
             m, the kernels against the twins on both sides of it, the whole
             llgrad and then K1, K2 and K3 each on the re-blocked model's
             inputs ([342,176,176]).
10. resume - a device-engine run stopped after two dispatches and resumed
             from optimizer_state.npz: no step index twice in log.txt.
11. multistart - the flagship problem from 3 starts: the replica-batched
             runner (the replicas folded into one kernel batch) against the
             single-start runner from each start over 4 steps, values within
             the routes' tolerance.
12. seismic - ``gprf_torch.cli.run_seismic.main`` on the seismic command
             (the 12,000-event catalog sampled into a temporary data_dir,
             64 PD-tree blocks, 108 edges at threshold 0.6, m = 192, dy =
             50, Matern-3/2 over the great-circle distance, task xcov)
             with ``--engine device --multistart 4``, 100 iterations,
             counters reset before and read after: the files with
             multistart.txt, a rising objective, a falling mean location
             error, K1-K3 launched and K4, K5 and the SE kernel (the
             Matern-3/2 great-circle kernel is not its) not, and B, E and m as the
             engine reports them.  Seconds of sampling, fitting and
             analysis.  Then K1, K2 and K3 against their twins on the
             inputs the seismic loss gives them at R = 1 and R = 4
             ([64|256,192,192], [108|432,192,192] + [.,192,50]), the
             device-busy ms of one loss+grad at each, and the three routes
             of FusedSeismicGPRF against their twins and each other.
13. seismic_host - the same data with ``--engine host`` for a few seconds:
             the files and a rising objective.
14. eighty - ``gprf_torch.cli.gprfopt.main`` on the paper's 80k command
             (n = 80,000 + 500, 100 blocks, 342 edges, m ~ 872-888, lengthscale
             0.021213, obs_std 0.007071, task x) on the Vecchia draw
             (GPRF_SAMPLER=vecchia), device engine, EIGHTY_ITERS iterations,
             counters reset before and read after: the cli phase's checks,
             K1-K3 and the SE kernel launched and K4, K5 not, row 0's and the trueX row's
             objective beside the JAX package's artifact
             (docs/runs/gprf80k_device/results.txt); the launches of one
             forward and one loss+grad (the pair pass in chunks of 64, each
             chunk's forward again in its backward).  At the fit's final X:
             the kernels against the twins in float32; the float64 joint form
             (torch.linalg, chunked by GPRF's budget) against the float64
             Schur split on the twins (RTOL_JOINT); float32 on the kernels
             against that (EIGHTY_F32_RTOL, EIGHTY_F32_MIN_COSINE); one
             GPRF.llgrad of the host engine against the device engine's loss
             less its X prior; K1, K2 and K3 against their twins on every leaf
             shape of this path, and the SE kernel on its unary and pair
             points as at the cli phase; peak memory, device-busy ms and launches of one
             loss+grad chunked by 64 and unchunked.
15. baselines - the GPLVM baselines through ``gprf_torch.cli.gprfopt.main``
             on the host engine: the truegp suite's data (the cli phase's
             10,000 + 500 points in one block, local GPs) with
             ``--gplvm_type titsias`` and ``sparse`` (FITC) at 2,000
             inducing points for BASELINE_SECONDS each: row 0's mad is
             X_obs's (0.02482123) and row 0's objective the JAX package's
             artifacts' (docs/runs/truegp_suite/*_titsias2000,
             docs/runs/fitc2000_10k) within BASELINE_RTOL, beside the same
             objective in float64 on the card; the objective rises and the
             mad falls; ms per evaluation.  Then ``bayesian`` and ``basic``
             at n = 2,000 (100 inducing points): finite and rising.
16. refine - ``--refine_iters``: the command line's flagship on the device
             engine, 40 float32 iterations and 20 of the float64 tail on
             LINALG_OPS (task x, then xcov for covs.txt), and the seismic
             command with 10: the log's numbering goes on, the tail's rows
             end no lower than the float32 loop's last (REFINE_RTOL), no
             K1-K5 launch inside the tail, ms per float64 iteration.  On the
             80k phase's data (m = 888): the default cap skips the tail with
             its message, GPRF_REFINE_MAX_M=1024 runs it 2 steps a dispatch.
17. kernelized - GPRF(kernelized=True) on the cli phase's data, YY =
             SY SY^T [10,000, 10,000] formed once on the card (B = 100, E =
             342, m = 136; each pair a 272-wide term, split into K1 leaves
             of 136): one loss+grad on the kernels against the twins in
             float32 (RTOL_LOSS, MIN_GRAD_COSINE), counted: K1 and no other
             kernel; the float64 objective (LINALG_OPS) against the float64
             Schur form on SY (RTOL_JOINT); K1 against its twin on this
             path's inputs ([100,136,136], [342,136,136]); the device-busy
             ms, launches and host-clock ms of one loss+grad; the scipy
             driver for KERNELIZED_EVALS evaluations, counters reset before
             and read after: the objective rises, K1 launched and no other.
18. tools  - ``python -m gprf_torch.cli.analyze gen-runs``: three scripts
             of ``gprf_torch.cli.gprfopt`` commands; the paper's figure
             series (``analysis/paper_figures.py``) of the cli phase's run,
             found under the truegp suite's GPRF-100 name; ``device_trace``
             around one flagship loss+grad: a trace that names K1-K3.
19. sparse - ``run_seismic.main --engine host --sparse`` on the seismic
             phase's data at SPARSE_FLAGS (2,000 events) for
             SPARSE_SECONDS: the files, at least 3 rows, a rising
             objective, seconds an evaluation; then on the whole catalog's
             first 8 PD-tree blocks ``llgrad(sparse=True)`` at a support
             radius of 1e3 lengthscales against the dense float64 llgrad
             (LINALG_OPS), and the gap at the default radius 5; the seconds
             of one sparse llgrad of the whole catalog.

The smoke's total seconds are logged before the result lines.

Output: a JSON line describing each kernel (its launches on the main path
and in the cli, rpc, predict, seismic, eighty and kernelized phases, its max abs error against
its twin, its ms, its twin's, its library call's and its bound), the
nvidia-smi line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Flagship problem (the workload bench.py times for the JAX package).
N, NBLOCKS, DY = 10_000, 100, 50
LSCALE, OBS_STD, NOISE_VAR = 0.06, 0.02, 0.01
M0 = 136  # the flagship's padded block width
STEPS = 25
# The command line's flagship (the README's), at 100 iterations
CLI_FLAGS = ["--ntrain", "10000", "--ntest", "500", "--nblocks", "100", "--lscale", "0.06",
             "--obs_std", "0.02", "--local_dist", "0.1", "--task", "x"]
CLI_ITERS = 100
CLI_EDGES = 342  # axis and diagonal neighbors of the 10 x 10 grid
# The predictive columns of the JAX package's committed flagship artifact,
# docs/runs/gprf10k_device/results.txt, last line (the trueX row):
# SMSE local / GPRF, MSLL block local / GPRF, MSLL diagonal local / GPRF.
# Logged beside the port's; the datasets may differ (the reference draws
# its data at the process's float width, ROADMAP.md section 3).
JAX_TRUEX_PREDICTIVE = (0.0122, 0.0125, 2.2083, 1.9625, 2.2054, 1.9916)
PREDICTIVE_COLS = ("smse_local", "smse", "msll_local_block", "msll_block", "msll_local_diag",
                   "msll_diag")
# The float32 predictor on the kernels against the float64 one on the twins,
# both on the card, at the fit's final X: relative on SMSE, absolute on MSLL
# (nats).  Measured 1.7e-6 and 9.2e-8 on an H100 80GB HBM3 at 700 W
# (PERF.md section 6): the limits leave ~60x and ~1000x for another
# summation order, not for a lost digit
PREDICT_RTOL_SMSE = 1e-4
PREDICT_ATOL_MSLL = 1e-4
# The RPC flagship: the command line's, with --rpc_blocksize 200 in place of
# --nblocks 100 (the reference publishes no synthetic RPC command; 200 gives
# blocks as wide as the grid flagship's: 64 blocks of 156-157 points at
# uniform X, m = 160)
RPC_BLOCKSIZE = 200
RPC_FLAGS = CLI_FLAGS[:4] + ["--rpc_blocksize", str(RPC_BLOCKSIZE)] + CLI_FLAGS[6:]
RPC_SHAPE = {"blocks": 64, "m": 160}
# points the float32 median replay on the card may place in another block
# than the float64 host replay, of 10,000.  Where a node's two middle
# projections lie closer than float32's spacing, a point takes the other
# side; each node below whose membership that changes moves its own middle
# point, so one such tie at the root of the 6-level tree moves at most
# 1 + 2 + ... + 32 = 63 points.  Measured 0 at X_obs and 7 at the fit's
# final X, from one tie at level 2 (scripts/torch_rpc_replay_float32.py)
RPC_MAX_MOVED = 63
HOST_SECONDS = 5
# The seismic experiment: the command of README.md:47 and docs/RESULTS.md
# (Seismic), on its recommended device engine with 4 replicas
SEISMIC_FLAGS = ["--npts=-1", "--obs_std=20", "--threshold=0.6", "--rpc_blocksize=210",
                 "--task=xcov"]
SEISMIC_ITERS = 100
SEISMIC_REPLICAS = 4
SEISMIC_R = ("R1", f"R{SEISMIC_REPLICAS}")  # the replica counts its kernels are held at
# its partition at the observed locations (docs/RESULTS.md:247)
SEISMIC_SHAPE = {"blocks": 64, "edges": 108, "m": 192}
# The paper's largest synthetic configuration, its 80k rows (docs/runs/README.md):
# n = 80,000 + 500 in 100 grid blocks, m ~ 872-888, 342 edges with the diagonal
# ones, on the Vecchia prior draw (GPRF_SAMPLER=vecchia), the draw of the JAX
# package's docs/runs/gprf80k_device artifact; cut to EIGHTY_ITERS iterations
EIGHTY_FLAGS = ["--ntrain", "80000", "--ntest", "500", "--nblocks", "100", "--lscale",
                "0.021213", "--obs_std", "0.007071", "--yd", "50", "--local_dist", "0.1",
                "--task", "x"]
EIGHTY_DATA = dict(n=80500, ntrain=80000, lscale=0.021213, obs_std=0.007071, yd=50, seed=0,
                   noise_var=0.01)
EIGHTY_SAMPLER = "vecchia"
EIGHTY_ITERS = 40
EIGHTY_CHUNK = 64  # the reference's pair chunk past m = 512; on the card the rule runs it whole
OUR_KERNELS = ("chol_inv_kernel", "mvn_kernel", "tri_inv_kernel")  # K1-K3 in a profiler trace
# The kernelized objective (phase 17): the scipy driver's evaluations over it
KERNELIZED_EVALS = 20
# --sparse on the seismic host engine (phase 19): the seismic command on the
# last 2,000 events of the catalog (the reference's --npts), for
# SPARSE_SECONDS, since one evaluation of all 12,000 events takes tens of
# seconds (the phase times one).
# Then the sparse llgrad on the whole catalog's first SPARSE_SUB_BLOCKS blocks,
# at a support radius that keeps every pair, against the dense float64 llgrad:
# the same function by two algebras (RTOL_JOINT on the objective, gprf_tpu's
# own tests' 1e-7 on the gradients)
SPARSE_FLAGS = ["--npts=2000"] + SEISMIC_FLAGS[1:]
SPARSE_SECONDS = 12
SPARSE_SUB_BLOCKS = 8
SPARSE_EXACT_DISTANCE = 1e3
SPARSE_GRAD_RTOL = 1e-7
# docs/runs/gprf80k_device/results.txt: row 0's objective and the trueX row's
JAX_EIGHTY_LL = (-52381247.52, 2765341.28)
# the float64 joint form (torch.linalg) against the float64 Schur split (the
# twins): one algebra against another, both in float64
RTOL_JOINT = 1e-9
# the float32 Schur loss on the kernels against the float64 joint form, at
# X_obs and at the fit's final X: 10x the largest gaps measured on an H100
# 80GB HBM3 at 700 W (loss rel 3.467e-5 at X_obs, 1 - cosine 7.27e-5 at the
# final X; PERF.md section 6): float32's own floor at wide m, as far from
# float64 as the twins in float32 are
EIGHTY_F32_RTOL = 3.5e-4
EIGHTY_F32_MIN_COSINE = 0.99927
# The GPLVM baselines (phase 15): the truegp suite's data, the cli flagship's
# 10,000 + 500 points in one block with local GPs (docs/runs/truegp_suite), at
# 2,000 inducing points, each for BASELINE_SECONDS of the host engine
BASELINE_FLAGS = ["--ntrain", "10000", "--ntest", "500", "--nblocks", "1", "--lscale", "0.06",
                  "--obs_std", "0.02", "--local_dist", "1.0", "--yd", "50", "--task", "x",
                  "--engine", "host"]
BASELINE_INDUCING = 2000
BASELINE_SECONDS = 15
# row 0 of the JAX package's artifacts: X_obs's mad, and the objective of
# docs/runs/truegp_suite/*_titsias2000/results.txt and docs/runs/fitc2000_10k/results.txt
JAX_BASELINE_MAD0 = 0.02482123
JAX_BASELINE_ROW0 = {"titsias": -6354405.31, "sparse": -6169868.81}
# float32 against float32 on another chip: kappa(Kmm) ~ 1 / jitter = 1e4 at
# 2,000 inducing points under an SE kernel, so A = Lm^-1 Knm carries ~1e4 x
# float32's 6e-8 relative, and the bound's quadratic forms cancel ~10x
BASELINE_RTOL = 1e-3
# the small Bayesian and full-GP runs
SMALL_BASELINE_FLAGS = ["--ntrain", "2000", "--ntest", "100", "--nblocks", "1", "--lscale",
                        "0.06", "--obs_std", "0.02", "--local_dist", "1.0", "--yd", "50",
                        "--task", "x", "--engine", "host", "--num_inducing", "100",
                        "--maxsec", "10"]
# The float64 tail (phase 16): float32 iterations, then float64 ones
REFINE_F32_ITERS, REFINE_ITERS, SEISMIC_REFINE_ITERS = 40, 20, 10
# the tail's last row against the float32 loop's last: the tail computes in
# float64 what the loop computed in float32 (1e-5 is the routes' float32
# loss agreement, RTOL_LOSS), and it starts at the loop's last accepted point
REFINE_RTOL = 1e-5
# the multistart check: replicas and steps on the flagship problem.  Two float32
# runs whose reductions reassociate part by ~1e-7 at the first steps, and this
# ill-conditioned problem (Y iid noise) grows that ~3x a step, past 1e-5 at
# step 5-6 (scripts/torch_multistart_divergence.py); a single start run twice
# is bitwise equal.
MULTISTART_REPLICAS, MULTISTART_STEPS = 3, 4

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
# the other compositions' checks, each one notch (8) past its leaf kernel's cap
SPLIT_WIDTHS = {"chol_inv": 248, "tri_inv": 232, "mvn_ll": 216}
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


def bound(name, args):
    """(ms, "operations" or "bytes"): the least time the card could take
    for one call of kernel `name` on `args` at the published peaks, by the
    benchmark's cost model (``gprfbench.work``)."""
    from gprfbench.work import PEAKS, kernel_bound_s, kernel_work

    B, m = args[0].shape[:2]
    dy = args[1].shape[-1] if len(args) > 1 else 0
    flops, nbytes = kernel_work(name, B, m, dy)
    ops_bound = flops / PEAKS["f32_flops"] > nbytes / PEAKS["hbm_bytes_per_s"]
    return kernel_bound_s(name, B, m, dy) * 1e3, "operations" if ops_bound else "bytes"


def build_problem(torch, dev, **fused_options):
    """The flagship problem (a FusedGridGPRF in float32, task x) from
    NumPy's ``default_rng(0)``: N latent points in the unit square observed
    with OBS_STD noise, NBLOCKS grid blocks with their 180 axis-only edges,
    Y iid noise [N, DY] (the time of an evaluation does not depend on Y's
    distribution).  ``fused_options`` go to FusedGridGPRF."""
    from gprf_torch.model.fused import FusedGridGPRF
    from gprf_torch.partition.grid import Blocker, grid_centers
    from gprf_torch.utils.convert import cov_from_numpy

    rng = np.random.default_rng(0)
    SX = rng.uniform(size=(N, 2))
    X_obs = SX + rng.standard_normal(SX.shape) * OBS_STD
    Y = rng.standard_normal((N, DY))
    b = Blocker(grid_centers(NBLOCKS))
    cov = cov_from_numpy([1.0], [LSCALE, LSCALE], device=dev, dtype=torch.float32)
    fused = FusedGridGPRF(X_obs, Y, b.block_centers, b.neighbors(diag_connections=False), X_obs,
                          OBS_STD, cov, NOISE_VAR, device=dev, dtype=torch.float32,
                          **fused_options)
    if (fused.m, int(fused.edges.shape[0])) != (M0, 180):
        raise AssertionError(f"flagship layout is m={fused.m}, E={fused.edges.shape[0]}; "
                             "want 136, 180")
    return fused, X_obs


def recorded_inputs(holder, evaluate, every_shape=False):
    """Each kernel's inputs as a path gives them, recorded from one
    evaluation of the default route on the twins (``holder.ops`` is pointed
    at recording twins for the call of ``evaluate`` and back at the kernels
    after it): K1 the padded unary blocks [B, m, m]; K2 the pair Schur
    complements [E, m, m], their right-hand sides [E, m, dy] and active
    counts [E]; K3 the pair factors [E, m, m] that K2's backward inverts.
    K5 factors K1's blocks on its route and K4 takes K2's inputs on its.
    The SE kernel (``se_kernel``) its points, masks and hyperparameters,
    block mode in the unary pass and pair mode in the pair pass.
    name -> the inputs of the kernel's last call, or with ``every_shape``
    name -> the inputs of its first call at each distinct shape (a split
    path runs its leaves at several)."""
    import torch

    from gprf_torch.ops import mvn

    seen = {}

    def recorded(name, fn):
        def f(*args):
            shapes = tuple(None if a is None else tuple(a.shape) for a in args)
            calls = seen.setdefault(name, {})
            if shapes not in calls or not every_shape:
                calls.pop(shapes, None)  # last call last
                calls[shapes] = tuple(None if a is None else a.detach().contiguous()
                                      for a in args)
            return fn(*args)
        return f

    holder.ops = mvn.PLAIN_OPS.map_leaves(recorded)
    with torch.no_grad():
        evaluate()
    holder.ops = mvn.KERNEL_OPS
    seen = {name: list(calls.values()) for name, calls in seen.items()}
    if "mvn_ll" in seen:
        seen["tri_inv"] = [(mvn.mvn_ll_plain(*args)[1],) for args in seen["mvn_ll"]]
        seen["mvn_ll_inv"] = seen["mvn_ll"]
    if "chol_inv" in seen:
        seen.setdefault("cholesky", seen["chol_inv"])
    return seen if every_shape else {name: calls[-1] for name, calls in seen.items()}


def flagship_inputs(fused, x_flat, torch):
    """The inputs of one loss of a fused engine at the point x_flat: at the
    flagship [100, 136, 136], [180, 136, 136] and [180, 136, 50]."""
    x0 = torch.as_tensor(x_flat, dtype=fused.dtype, device=fused.device)
    return recorded_inputs(fused, lambda: fused.loss_fn()(x0))


def compare(c, args, torch, what=""):
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
    log(f"{what}kernel {c['name']} {[tuple(a.shape) for a in args]}: fwd rel err {fwd:.3e}, "
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


def check_splits(gen, torch, dev):
    """chol_inv_split, tri_inv_split and mvn_ll_split just past their leaf
    kernels' caps (K1 240, K3 224, K2 208 at dy = 50), as a fit whose blocks
    grow that wide runs them: each over the kernels against its twin on the
    whole matrix, forward and backward, and it must launch its leaves."""
    from gprf_torch.ops import mvn
    from gprf_torch.ops.split_mvn import chol_inv_split, mvn_ll_split, tri_inv_split

    B = CHOL_SPLIT_SHAPE[0]
    caps = {"chol_inv": mvn.MAX_M_CHOL_INV, "tri_inv": mvn.MAX_M_TRI_INV,
            "mvn_ll": mvn.mvn_max_m(DY)}
    K, _ = seeded_factors(B, SPLIT_WIDTHS["chol_inv"], gen, torch, dev)
    pair = seeded_mvn_inputs(B, SPLIT_WIDTHS["mvn_ll"], gen, torch, dev)
    # A split reads K's lower blocks only and the twin both halves, so the
    # two gradients agree on symmetric changes of K: their symmetric parts
    # are compared (of L, the lower triangles).
    def sym(g):
        return (g + g.mT) / 2

    checks = {
        # name -> (composition, twin, inputs, leaves it must launch, part of d/d matrix)
        "chol_inv": (chol_inv_split, mvn.chol_inv_plain, (K.float().contiguous(),),
                     {"chol_inv": 2}, sym),
        "tri_inv": (tri_inv_split, mvn.tri_inv_plain,
                    (seeded_factors(B, SPLIT_WIDTHS["tri_inv"], gen, torch, dev)[1],),
                    {"tri_inv": 2}, torch.tril),
        "mvn_ll": (mvn_ll_split, lambda *a: mvn.mvn_ll_plain(*a)[0], pair,
                   {"chol_inv": 1, "mvn_ll": 1}, sym),
    }
    out = {}
    for name, (split, plain, args, leaves, part) in checks.items():
        if not args[0].shape[-1] > caps[name]:
            raise AssertionError(f"{name}_split's check at m={args[0].shape[-1]} does not split")
        grads, outs = [], []
        mvn.reset_launch_counts()
        for f in (split, plain):
            ins = [a.clone().requires_grad_(a.dim() == 3) for a in args]
            res = f(*ins)
            res = res if isinstance(res, tuple) else (res,)
            if f is split:  # the same cotangents for both
                cots = [torch.randn(r.shape, generator=gen, device=dev) for r in res]
            g = torch.autograd.grad(res, [t for t in ins if t.requires_grad], cots)
            grads.append((part(g[0]), *g[1:]))
            outs.append([r.detach() for r in res])
            if f is split:
                torch.cuda.synchronize()
                launches = {k: mvn.launch_counts[k] for k in leaves}
        fwd = max(rel_err(a, b) for a, b in zip(*outs))
        bwd = max(rel_err(a, b) for a, b in zip(*grads))
        log(f"{name}_split {[tuple(a.shape) for a in args]}: fwd rel err {fwd:.3e}, bwd rel err "
            f"{bwd:.3e} vs its twin, launches (forward and backward) {launches}")
        if any(launches[k] < n for k, n in leaves.items()) or not (fwd <= RTOL_FWD
                                                                   and bwd <= RTOL_BWD):
            raise AssertionError(f"{name}_split at m={args[0].shape[-1]}: launches {launches}, "
                                 f"fwd {fwd:.3e}, bwd {bwd:.3e}")
        out[name] = dict(shape=[list(a.shape) for a in args], fwd_rel_err=fwd, bwd_rel_err=bwd,
                         check_launches=launches)
    return out


def seeded_mvn_inputs(B, m, gen, torch, dev):
    """K2's inputs at width m: Kp = A A^T / m + I in float32, Y [B, m, DY]
    seeded normal, every row active."""
    K, _ = seeded_factors(B, m, gen, torch, dev)
    Y = torch.randn(B, m, DY, generator=gen, device=dev)
    return K.float().contiguous(), Y, torch.full((B,), float(m), device=dev)


def kernel_cases(gen, torch, dev):
    """name -> how to hold that kernel against its twin (compare's ``c``)."""
    from gprf_torch.ops import mvn

    def randn_like(t):
        return torch.randn(t.shape, generator=gen, device=t.device, dtype=t.dtype)

    eyes = {}

    def eye_like(L):
        m = L.shape[-1]
        if m not in eyes:
            eyes[m] = torch.eye(m, device=dev)
        return eyes[m].expand(L.shape)

    cases = {
        "chol_inv": dict(
            source="gprf_torch/csrc/chol_inv.cu", replaces="gprf_tpu/ops/pallas_mvn.py:411",
            kernel=mvn.chol_inv, plain=mvn.chol_inv_plain,
            fn=mvn.CholInv.apply, cot=lambda out: [randn_like(o) for o in out]),
        "mvn_ll": dict(
            source="gprf_torch/csrc/mvn.cu", replaces="gprf_tpu/ops/pallas_mvn.py:592",
            kernel=mvn.mvn_ll, plain=mvn.mvn_ll_plain,
            fn=mvn.MvnLL.apply, cot=lambda out: [randn_like(out[0])]),
        "tri_inv": dict(
            source="gprf_torch/csrc/tri_inv.cu", replaces="gprf_tpu/ops/pallas_mvn.py:259",
            kernel=mvn.tri_inv, plain=mvn.tri_inv_plain,
            fn=mvn.TriInv.apply, cot=lambda out: [randn_like(out[0])],
            library=lambda L: torch.linalg.solve_triangular(L, eye_like(L), upper=False)),
        "mvn_ll_inv": dict(
            source="gprf_torch/csrc/mvn_inv.cu", replaces="gprf_tpu/ops/pallas_mvn.py:771",
            kernel=mvn.mvn_ll_inv, plain=mvn.mvn_ll_inv_plain,
            fn=mvn.MvnLLInv.apply, cot=lambda out: [randn_like(out[0])]),
        "cholesky": dict(
            source="gprf_torch/csrc/chol_inv.cu", replaces="gprf_tpu/ops/pallas_mvn.py:144",
            kernel=mvn.cholesky, plain=mvn.cholesky_plain,
            fn=mvn.Cholesky.apply, cot=lambda out: [randn_like(out[0])],
            library=lambda K: torch.linalg.cholesky_ex(K)),
    }
    for name, c in cases.items():
        c["name"] = name
    return cases


def check_path_kernels(what, inputs, cases, torch):
    """K1, K2 and K3 (the default route's kernels) against their twins on
    the inputs a main path gave them: name -> compare's record and shape."""
    out = {}
    for name in ("chol_inv", "mvn_ll", "tri_inv"):
        args = inputs[name]
        out[name] = dict(shape=list(args[0].shape) + [a.shape[-1] for a in args[1:2]],
                         **compare(cases[name], args, torch, what=f"{what}: "))
    return out


def se_kernel_bytes(args, grads=False):
    """The bytes one call of the SE kernel must move: the points, masks and
    hyperparameters read once (block mode's one point set once), and K
    written once (the forward) or G read once and the points' gradients
    written once (the backward)."""
    Xi, Xj, mi, mj, sv, ls, nv = args
    ins = [Xi, mi, sv, ls] + ([nv] if nv is not None else [Xj, mj])
    R, N, m, dx = Xi.shape
    points = sum(a.numel() * a.element_size() for a in ins)
    grad_points = (1 if nv is not None else 2) * Xi.numel() * Xi.element_size()
    return points + R * N * m * m * Xi.element_size() + (grad_points if grads else 0)


def check_se_kernel(what, calls, gen, torch):
    """The SE kernel against its twin on each call a path recorded
    (``recorded_inputs(..., every_shape=True)["se_kernel"]``), float32 on
    both: the forward's normwise rel err and each gradient's under a seeded
    cotangent that is not symmetric; the device ms of the kernel's forward
    and of its backward (the backward kernel and the sum of its partials),
    the twin's of each, and each one's bound, the bytes it must move over
    3.35 TB/s."""
    from gprf_torch.ops import se_kernel
    from gprfbench.work import PEAKS

    out = []
    for args in calls:
        shape = list(args[0].shape[:2]) + [args[0].shape[2]] * 2
        mode = "pair" if args[6] is None else "block"
        K = se_kernel.se_matrix(*args)
        K_twin = se_kernel.se_matrix_plain(*args)
        G = torch.randn(K.shape, generator=gen, device=K.device)
        grads = se_kernel.se_grads(G, *args)
        grads_twin = se_kernel.se_grads_plain(G, *args)
        torch.cuda.synchronize()
        fwd = rel_err(K, K_twin)
        bwd = max(rel_err(a, b) for a, b in zip(grads, grads_twin) if a is not None)
        del K, K_twin, grads, grads_twin
        r = dict(mode=mode, shape=shape, fwd_rel_err=fwd, bwd_rel_err=bwd,
                 ms=median_ms(lambda: se_kernel.se_matrix(*args), torch),
                 plain_ms=median_ms(lambda: se_kernel.se_matrix_plain(*args), torch, reps=5),
                 bwd_ms=median_ms(lambda: se_kernel.se_grads(G, *args), torch),
                 bwd_plain_ms=median_ms(lambda: se_kernel.se_grads_plain(G, *args), torch,
                                        reps=5),
                 bound_ms=se_kernel_bytes(args) / PEAKS["hbm_bytes_per_s"] * 1e3,
                 bwd_bound_ms=(se_kernel_bytes(args, grads=True) / PEAKS["hbm_bytes_per_s"]
                               * 1e3))
        r.update(share=r["bound_ms"] / r["ms"], bwd_share=r["bwd_bound_ms"] / r["bwd_ms"])
        log(f"{what}: se_kernel {mode} {shape}: fwd rel err {fwd:.3e}, bwd rel err {bwd:.3e}; "
            f"forward {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, {100 * r['share']:.1f}%) vs "
            f"twin {r['plain_ms']:.4f}; backward {r['bwd_ms']:.4f} ms (bound "
            f"{r['bwd_bound_ms']:.4f}, {100 * r['bwd_share']:.1f}%) vs twin "
            f"{r['bwd_plain_ms']:.4f}")
        if not (fwd <= RTOL_FWD and bwd <= RTOL_BWD):
            raise AssertionError(f"se_kernel {mode} {shape} disagrees with its twin: fwd "
                                 f"{fwd:.3e} (limit {RTOL_FWD}), bwd {bwd:.3e} (limit {RTOL_BWD})")
        out.append(r)
        del G
    if sorted(r["mode"] for r in out) != ["block", "pair"]:
        raise AssertionError(f"{what}: se_kernel recorded {[r['mode'] for r in out]}; want one "
                             "block call (the unary pass) and one pair call")
    return out


def check_kernels(fused, x_flat, cases, gen, torch):
    from gprf_torch.ops import _build, mvn

    inputs = flagship_inputs(fused, x_flat, torch)
    dev = fused.device
    report = {}
    for name, c in cases.items():
        report[name] = dict(name=name, route="cuda", source=c["source"], replaces=c["replaces"],
                            launches=0, **compare(c, inputs[name], torch))

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
    for name, record in check_splits(gen, torch, dev).items():
        report[name]["split"] = record
    return report


def eval_ms_in_turns(losses, x0, torch, reps=20):
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


def check_routes(fused, x0, torch, m=M0, what="route"):
    """Per route: one loss+grad on the kernels against the same route on the
    twins, and against the default route on the kernels; then ms/eval of
    every route on both, in turns, at the capacity m."""
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import value_and_grad
    from gprf_torch.utils.profiling import device_busy

    fused.m = m
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
            log(f"{what} {route}, kernels {against}: loss {float(evals[route, True][0]):.6f}, "
                f"rel {loss_rel:.3e}, gradient cosine {cosine:.8f}")
            if not (loss_rel <= RTOL_LOSS and cosine > MIN_GRAD_COSINE):
                raise AssertionError(f"{what} {route} disagrees, {against}: loss rel "
                                     f"{loss_rel:.3e}, cosine {cosine:.8f}")
    ms = eval_ms_in_turns(losses, x0, torch)
    for i, route in enumerate(ROUTES):
        report[route].update(ms_per_eval=ms[2 * i], plain_ms_per_eval=ms[2 * i + 1])
        log(f"{what} {route} ms/eval (loss + grad, median of 20 in turns): kernels "
            f"{ms[2 * i]:.3f}, twins {ms[2 * i + 1]:.3f}")
    for i, route in enumerate(ROUTES):
        (busy, n), (plain_busy, plain_n) = (device_busy(losses[2 * i + t], x0)
                                            for t in (0, 1))
        report[route].update(device_busy_ms=busy, device_launches=n,
                             plain_device_busy_ms=plain_busy, plain_device_launches=plain_n)
        log(f"{what} {route} device busy per loss+grad (profiler, kernel events): kernels "
            f"{busy:.3f} ms ({n:.0f} launches), twins {plain_busy:.3f} ms ({plain_n:.0f})")
    use_route(fused, "default", mvn.KERNEL_OPS)
    return report


def run_lbfgs(fused, x0, route, torch):
    """The main path on one route: scan-L-BFGS over the fused loss from x0
    at m = 136, counted, under the drivers' capacity-growth policy: after a
    dispatch whose end points overflow the capacity m, the capacity grows
    and the run goes on from the current point with its curvature memory."""
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import GrowingRunner

    _, dispatches, must, must_not = ROUTES[route]
    use_route(fused, route, mvn.KERNEL_OPS)
    fused.m = M0
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    t0 = time.perf_counter()
    runner = GrowingRunner(fused, STEPS)
    carry = runner.init_fn(x0)
    values, capacities, first_dispatch_s = [], [], None
    for _ in range(dispatches):
        t_d = time.perf_counter()
        carry, (v, _, _, overflow) = runner.run_fn(carry)
        overflowed = bool(overflow)
        if first_dispatch_s is None:
            first_dispatch_s = time.perf_counter() - t_d
        if overflowed:
            carry = runner.grow(carry)
            capacities.append(fused.m)
        values.append(v)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mvn.launch_counts)
    values = torch.cat(values).double().cpu().numpy()
    v0 = float(values[0])
    ms_iter = first_dispatch_s / STEPS * 1e3
    log(f"scan-L-BFGS, route {route}: {dispatches} x {STEPS} steps, {wall:.3f} s in all; "
        f"first dispatch (m={M0}) {ms_iter:.3f} ms/iter; capacity grown to "
        f"{capacities or 'none'}; objective {v0:.4f} -> {float(values[-1]):.4f}; "
        f"launches {launches}")
    if not np.isfinite(values).all():
        raise AssertionError(f"non-finite L-BFGS values on route {route}: {values}")
    if not values[-1] < v0:
        raise AssertionError(f"objective did not decrease on route {route}: {v0} -> {values[-1]}")
    check_launches(f"route {route}", launches, must, must_not)
    return dict(lbfgs_dispatches=dispatches, lbfgs_ms_per_iter=ms_iter,
                lbfgs_values=[v0, float(values[-1])], capacity_growths=capacities,
                launches=launches)


def check_launches(what, launches, must, must_not):
    skipped = [k for k in must if launches[k] < 1]
    stray = [k for k in must_not if launches[k] != 0]
    if skipped or stray:
        raise AssertionError(f"{what} skipped {skipped} or launched {stray}: launches {launches}")


def read_log(d):
    """(step indices, objective values) of a run directory's log.txt."""
    from gprf_torch.optim.driver import load_log

    steps, _, values = load_log(d)
    if not len(steps) or not np.isfinite(values).all():
        raise AssertionError(f"{d}: log.txt holds {len(steps)} rows, values {values}")
    return steps, values


def cli_engine(data, torch, X0=None):
    """The device engine as the command line builds it for task x (its
    capacity m from the data at X0, by default X_obs)."""
    from gprf_torch.model.fused import FusedSyntheticGPRF

    return FusedSyntheticGPRF(data.X_obs if X0 is None else X0, data.SY, data.neighbors,
                              data.X_obs, data.obs_std,
                              data.cov, data.noise_var, task="x",
                              centers=np.asarray(data.centers), device="cuda",
                              dtype=torch.float32, acc_dtype=torch.float64)


def run_cli(base, cases, torch):
    """Phase 6: the command line's flagship on the device engine."""
    from gprf_torch.analysis.results import load_final_results, load_results
    from gprf_torch.cli import gprfopt
    from gprf_torch.data.sampled import sample_data
    from gprf_torch.ops import mvn
    from gprf_torch.partition.grid import grid_centers
    from gprf_torch.utils.profiling import device_busy

    os.environ["GPRF_EXPERIMENTS"] = base
    argv = CLI_FLAGS + ["--engine", "device", "--max_iters", str(CLI_ITERS)]
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        seconds = gprfopt.main(argv)
    torch.cuda.synchronize()
    launches = dict(mvn.launch_counts)
    files = sorted(os.listdir(d))
    wanted = ["log.txt", "optimizer_state.npz", "results.txt", "finished",
              "step_%05d_X.npy" % (CLI_ITERS - 1)]
    if [f for f in wanted if f not in files]:
        raise AssertionError(f"cli run left {files}; want {wanted}")
    steps, values = read_log(d)
    results = load_results(d)
    final, true_row = load_final_results(d)
    mad_first, mad_last = float(results[0, 4]), float(final["mad"])
    log(f"cli (device engine): {len(steps)} iterations; objective {values[0]:.2f} -> "
        f"{values[-1]:.2f}, at the true X {true_row['mll']:.2f} (without the X prior); mad "
        f"{mad_first:.8f} -> {mad_last:.8f}; seconds: sampling {seconds['sample_s']:.2f} (the "
        f"10,500-point float64 Cholesky, on the host), fitting {seconds['fit_s']:.2f}, analysis "
        f"{seconds['analyze_s']:.2f}; launches {launches}")
    if list(steps) != list(range(CLI_ITERS)):
        raise AssertionError(f"cli run logged steps {steps[0]}..{steps[-1]} ({len(steps)})")
    if not (values[-1] > values[0] and mad_last < mad_first and np.isfinite(true_row["mll"])):
        raise AssertionError(f"cli run: objective {values[0]} -> {values[-1]}, mad {mad_first} "
                             f"-> {mad_last}, trueX objective {true_row['mll']}")
    check_launches("the cli run", launches, ("chol_inv", "mvn_ll", "tri_inv", "se_kernel",
                                             "se_kernel_bwd"), ("mvn_ll_inv", "cholesky"))

    # the engine the run used, rebuilt on the cached data: its shapes, and
    # the device time of one loss+grad at them
    data = sample_data(n=10500, ntrain=10000, lscale=0.06, obs_std=0.02, yd=DY, seed=0,
                       centers=grid_centers(NBLOCKS), noise_var=NOISE_VAR)
    fused = cli_engine(data, torch)
    E, m = int(fused.edges.shape[0]), fused.m
    if E != CLI_EDGES:
        raise AssertionError(f"the cli flagship has {E} edges; want {CLI_EDGES}")
    x0 = torch.as_tensor(data.X_obs.reshape(-1), dtype=torch.float32, device="cuda")
    loss = fused.loss_fn()
    busy, n_launch = device_busy(loss, x0)
    (eval_ms,) = eval_ms_in_turns([loss], x0, torch)
    log(f"cli flagship shapes: E={E}, m={m} at X_obs (data-driven); one loss+grad: device busy "
        f"{busy:.3f} ms ({n_launch:.0f} launches), host clock {eval_ms:.3f} ms (median of 20)")
    # each kernel of this path against its twin on the inputs this path gives it
    kernels = check_path_kernels(f"cli path, E={E}, m={m}",
                                 flagship_inputs(fused, data.X_obs.reshape(-1), torch), cases, torch)
    if kernels["mvn_ll"]["shape"] != [E, m, m, DY] or kernels["tri_inv"]["shape"] != [E, m, m]:
        raise AssertionError(f"cli path kernels were held at {kernels['mvn_ll']['shape']}")
    gen = torch.Generator(device="cuda").manual_seed(10)
    se = check_se_kernel(f"cli path, E={E}, m={m}", recorded_inputs(
        fused, lambda: fused.loss_fn()(x0), every_shape=True)["se_kernel"], gen, torch)
    return dict(kernels=kernels, se_kernel=se, dir=d, dir_files=files, iterations=len(steps), objective=[float(values[0]),
                float(values[-1])], true_x_objective=float(true_row["mll"]),
                mad=[mad_first, mad_last], seconds=seconds, launches=launches, edges=E, m=m,
                device_busy_ms=busy, device_launches=n_launch, eval_ms=eval_ms), data


def run_predict(d, data, cases, torch):
    """Phase 7: --analyze --analyze_full on the cli phase's run directory
    (the reference's re-analysis workflow: no new fit)."""
    from gprf_torch.analysis.results import load_final_results, load_results
    from gprf_torch.cli import gprfopt
    from gprf_torch.model.predict import train_block_predictor
    from gprf_torch.ops import mvn

    argv = CLI_FLAGS + ["--engine", "device", "--analyze", "--analyze_full"]
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        seconds = gprfopt.main(argv)
    torch.cuda.synchronize()
    launches = dict(mvn.launch_counts)
    rows = load_results(d)[:, 6:]
    true_row = load_final_results(d)[1]
    true_cols = [true_row[k] for k in PREDICTIVE_COLS]
    log(f"predict (--analyze --analyze_full, {len(rows)} rows): final row "
        f"{dict(zip(PREDICTIVE_COLS, rows[-1].tolist()))}; trueX row "
        f"{dict(zip(PREDICTIVE_COLS, true_cols))}, the JAX package's artifact's trueX row "
        f"(docs/runs/gprf10k_device/results.txt) {dict(zip(PREDICTIVE_COLS, JAX_TRUEX_PREDICTIVE))}"
        f"; analysis {seconds['analyze_s']:.2f} s; launches {launches}")
    table = np.vstack([rows, [true_cols]])
    if not (np.isfinite(table).all() and (table != 0).all()):
        raise AssertionError(f"predictive columns not finite and non-zero: {table}")
    # K5 for the block caches, K1 and K2 for the trueX objective (no gradient: no K3)
    check_launches("the predictive analysis", launches, ("cholesky", "chol_inv", "mvn_ll"),
                   ("mvn_ll_inv", "tri_inv"))

    # the final X of the fit: K5 on the block caches it gives the predictor,
    # the float32 predictor against the float64 twins, the exact GP, and the
    # parts of one prediction_error
    last = max(f for f in os.listdir(d) if f.startswith("step_") and f.endswith("_X.npy"))
    X_final = np.load(os.path.join(d, last))
    gprf = data.build_gprf(X=X_final, local_dist=0.1, device="cuda", dtype=torch.float32)
    inputs = recorded_inputs(gprf, lambda: train_block_predictor(gprf))
    k5 = dict(shape=list(inputs["cholesky"][0].shape),
              **compare(cases["cholesky"], inputs["cholesky"], torch,
                        what="predictor block caches: "))
    if k5["shape"] != [NBLOCKS, M0, M0]:
        raise AssertionError(f"the predictor's block caches are {k5['shape']}")
    scores = {}
    for name, dtype, ops in (("float32", torch.float32, mvn.KERNEL_OPS),
                             ("float64", torch.float64, mvn.PLAIN_OPS)):
        scores[name] = data.prediction_error(X=X_final, local_dist=0.1, device="cuda",
                                             dtype=dtype, ops=ops)
    scores = {k: [float(v) for v in scores[k]] for k in scores}
    (s32, b32, d32), (s64, b64, d64) = scores["float32"], scores["float64"]
    smse_rel = abs(s32 - s64) / abs(s64)
    msll_abs = max(abs(b32 - b64), abs(d32 - d64))
    log(f"predictor at the final X ({last}): float32 on the kernels (SMSE, MSLL block, MSLL "
        f"diagonal) {scores['float32']}, float64 on the twins {scores['float64']}; SMSE rel "
        f"{smse_rel:.3e} (limit {PREDICT_RTOL_SMSE}), MSLL abs {msll_abs:.3e} (limit "
        f"{PREDICT_ATOL_MSLL})")
    if not (smse_rel <= PREDICT_RTOL_SMSE and msll_abs <= PREDICT_ATOL_MSLL):
        raise AssertionError(f"float32 predictor disagrees with float64: {scores}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp_ll = data.prediction_error_gp(X_final.reshape(-1), device="cuda", dtype=torch.float64)
    gp_s = time.perf_counter() - t0
    log(f"prediction_error_gp at the final X: {gp_ll:.4f} in {gp_s:.2f} s (float64 on the card)")
    if not np.isfinite(gp_ll):
        raise AssertionError(f"prediction_error_gp is {gp_ll}")

    parts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gprf = data.build_gprf(X=X_final, local_dist=0.1, device="cuda", dtype=torch.float32)
    test_blocks = data.reblock(data.Xtest)
    torch.cuda.synchronize()
    parts["build_gprf_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    predict_blocks = train_block_predictor(gprf)
    torch.cuda.synchronize()
    parts["block_caches_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = predict_blocks(test_blocks, data.Xtest, test_noise_var=data.noise_var)
    parts["combination_s"] = time.perf_counter() - t0  # ends in the copy to the host
    t0 = time.perf_counter()
    data.score_predictions(test_blocks, results)
    parts["host_loop_s"] = time.perf_counter() - t0
    log(f"one prediction_error, float32 on the card, in parts (s): {parts}")
    return dict(rows=len(rows), final=rows[-1].tolist(), true_x=true_cols,
                jax_artifact_true_x=list(JAX_TRUEX_PREDICTIVE), seconds=seconds,
                launches=launches, block_caches_kernel=k5, float32=scores["float32"],
                float64=scores["float64"], smse_rel=smse_rel, msll_abs=msll_abs,
                gp_ll=gp_ll, gp_s=gp_s, parts=parts)


def run_kernelized(data, cli, cases, torch):
    """Phase 17: the kernelized (second-moment) objective on the cli phase's
    data, YY = SY SY^T formed once on the card."""
    from gprf_torch.model.gprf import GPRF
    from gprf_torch.model.kernelized import kernelized_ll
    from gprf_torch.model.objective import GPRFParams
    from gprf_torch.ops import mvn, split_mvn
    from gprf_torch.optim.driver import OutOfTimeError, do_optimization
    from gprf_torch.utils.profiling import kernel_events

    schur = data.build_gprf(local_dist=0.1, device="cuda", dtype=torch.float32)
    B, E, m = schur.n_blocks, len(schur.neighbors), schur.layout.block_pad
    if (E, m) != (CLI_EDGES, M0):
        raise AssertionError(f"the kernelized phase's layout is E={E}, m={m}")
    SY = torch.as_tensor(data.SY, dtype=torch.float64, device="cuda")
    YY64 = SY @ SY.T
    layout = dict(block_idxs=schur.block_idxs, neighbors=schur.neighbors)
    kw = dict(kernelized=True, dy=DY, device="cuda", **layout)
    k32 = GPRF(data.X_obs, YY64.float(), data.reblock, data.cov, data.noise_var,
               dtype=torch.float32, **kw)

    # one loss+grad on the kernels (counted) against the twins, float32
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    ll_k, gX_k, _ = k32.llgrad(grad_X=True)
    torch.cuda.synchronize()
    one_eval = dict(mvn.launch_counts)
    k32.ops = mvn.PLAIN_OPS
    ll_p, gX_p, _ = k32.llgrad(grad_X=True)
    k32.ops = mvn.KERNEL_OPS
    loss_rel = abs(ll_k - ll_p) / abs(ll_p)
    cosine = float(np.sum(gX_k * gX_p) / (np.linalg.norm(gX_k) * np.linalg.norm(gX_p)))
    log(f"kernelized (YY = SY SY^T [{len(data.SY)}, {len(data.SY)}] on the card; B={B}, E={E}, "
        f"m={m}, pairs at 2m={2 * m}): float32 kernels {ll_k:.4f} against the twins {ll_p:.4f}, "
        f"rel {loss_rel:.3e} (limit {RTOL_LOSS}), gradient cosine {cosine:.8f}; launches of one "
        f"loss+grad {one_eval}")
    if not (loss_rel <= RTOL_LOSS and cosine > MIN_GRAD_COSINE):
        raise AssertionError(f"kernelized: kernels against twins, rel {loss_rel}, cos {cosine}")
    check_launches("one kernelized loss+grad", one_eval, ("chol_inv",),
                   ("mvn_ll", "tri_inv", "mvn_ll_inv", "cholesky"))

    # float64: the kernelized objective against the Schur form on SY, both on LINALG_OPS
    f64 = dict(dtype=torch.float64, ops=mvn.LINALG_OPS)
    k64 = GPRF(data.X_obs, YY64, data.reblock, data.cov, data.noise_var, **f64, **kw)
    s64 = GPRF(data.X_obs, data.SY, data.reblock, data.cov, data.noise_var, device="cuda",
               **f64, **layout)
    (lk, gk, _), (ls, gs, _) = k64.llgrad(grad_X=True), s64.llgrad(grad_X=True)
    f64_rel = abs(lk - ls) / abs(ls)
    f64_grad = float(np.abs(gk - gs).max() / np.abs(gs).max())
    f32_rel = abs(ll_k - lk) / abs(lk)
    log(f"kernelized float64 (LINALG_OPS) {lk:.6f} against the float64 Schur form on SY "
        f"{ls:.6f}: rel {f64_rel:.3e} (limit {RTOL_JOINT}), gradient rel {f64_grad:.3e}; the "
        f"float32 kernels from float64: rel {f32_rel:.3e}")
    if not f64_rel <= RTOL_JOINT:
        raise AssertionError(f"kernelized float64 against the Schur form: rel {f64_rel}")
    del k64, s64, YY64

    # K1 against its twin on the inputs this path gives it: the unary blocks
    # and the pairs' first leaves (the 2m-wide pairs split into leaves of m)
    inputs = recorded_inputs(k32, lambda: k32.llgrad(), every_shape=True)["chol_inv"]
    kernels = [dict(shape=list(args[0].shape),
                    **compare(cases["chol_inv"], args, torch, what="kernelized path: "))
               for args in inputs]
    leaf = 2 * m if 2 * m <= split_mvn.LEAF_CHOL else split_mvn.split_point(2 * m)
    if [k["shape"] for k in kernels] != [[B, m, m], [E, leaf, leaf]]:
        raise AssertionError(f"kernelized path: K1 held at {[k['shape'] for k in kernels]}")

    # one loss+grad of the objective alone: device time, launches, host clock
    arrays = k32._device_arrays()
    names = ("assignment", "mask", "pair_assignment", "pair_mask", "unary_weights",
             "pair_weights")
    nv = torch.tensor(data.noise_var, dtype=torch.float32, device="cuda")

    def loss(x):
        p = GPRFParams(X=x.reshape(-1, 2), wfn_params=k32.cov.wfn_params,
                       dfn_params=k32.cov.dfn_params, noise_var=nv)
        return -kernelized_ll(p, k32._Y_dev, *(arrays[k] for k in names), DY)

    x0 = torch.as_tensor(data.X_obs.reshape(-1), dtype=torch.float32, device="cuda")
    events = kernel_events(loss, x0)
    busy, n_launch = sum(us for _, us in events) / 5e3, len(events) / 5
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us / 5e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    (eval_ms,) = eval_ms_in_turns([loss], x0, torch)
    log(f"kernelized loss+grad: device busy {busy:.3f} ms ({n_launch:.0f} launches), host clock "
        f"{eval_ms:.3f} ms (median of 20); the Schur route's on this data (cli phase): "
        f"{cli['device_busy_ms']:.3f} ms ({cli['device_launches']:.0f} launches), "
        f"{cli['eval_ms']:.3f} ms; the costliest kernels (ms a loss+grad): "
        + "; ".join(f"{name[:90]} {ms:.3f}" for name, ms in top))

    # the main path: the scipy driver over the kernelized model, 20 evaluations
    class Stopping:
        """The model, ending do_optimization's loop after `limit`
        evaluations, as its time limit does."""

        def __init__(self, gprf, limit):
            self.gprf, self.limit, self.calls = gprf, limit, 0

        def llgrad(self, **kw):
            if self.calls == self.limit:
                raise OutOfTimeError
            self.calls += 1
            return self.gprf.llgrad(**kw)

        def __getattr__(self, name):
            return getattr(self.gprf, name)

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        mvn.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            do_optimization(d, Stopping(k32, KERNELIZED_EVALS), data.X_obs, None, data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(mvn.launch_counts)
        steps, values = read_log(d)
    log(f"kernelized scipy driver: {len(steps)} evaluations in {fit_s:.2f} s "
        f"({fit_s / len(steps) * 1e3:.1f} ms each with re-blocking, upload and checkpoint); "
        f"objective {values[0]:.2f} -> {values.max():.2f}; launches {launches}")
    if not (len(steps) == KERNELIZED_EVALS and values.max() > values[0]):
        raise AssertionError(f"kernelized driver: {len(steps)} evaluations, objective {values}")
    check_launches("the kernelized driver", launches, ("chol_inv",),
                   ("mvn_ll", "tri_inv", "mvn_ll_inv", "cholesky"))
    return dict(blocks=B, edges=E, m=m, loss=[ll_k, ll_p], loss_rel=loss_rel, cosine=cosine,
                one_eval_launches=one_eval, f64=[lk, ls], f64_rel=f64_rel,
                f64_grad_rel=f64_grad, f32_from_f64_rel=f32_rel, kernels=kernels,
                device_busy_ms=busy, device_launches=n_launch, eval_ms=eval_ms,
                costliest_kernels_ms=dict(top), evaluations=len(steps), objective=[float(values[0]), float(values.max())],
                ms_per_evaluation=fit_s / len(steps) * 1e3, launches=launches)


def run_tools(base, cli, data, torch):
    """Phase 18: the analysis command line, the paper's figure series of
    the cli phase's run and a device trace."""
    from gprf_torch.analysis import fleet, paper_figures
    from gprf_torch.cli import analyze, gprfopt
    from gprf_torch.optim.lbfgs import value_and_grad
    from gprf_torch.utils.profiling import device_trace

    out = os.path.join(base, "fleet")
    os.makedirs(out)
    with contextlib.redirect_stdout(sys.stderr):
        analyze.main(["gen-runs", "--out_dir", out])
    scripts = {}
    for name in ("run_eighty.sh", "run_truegp.sh", "run_fitc.sh"):
        with open(os.path.join(out, name)) as f:
            lines = f.read().splitlines()
        if not lines or any("python -m gprf_torch.cli.gprfopt " not in r for r in lines):
            raise AssertionError(f"{name}: {lines[:2]}")
        scripts[name] = len(lines)

    # the truegp suite's GPRF-100 row is the cli phase's run
    cli_dir = cli["dir"]
    by_key = {"GPRF-100": fleet.truegp_run_params()[1]["GPRF-100"]}
    if gprfopt.build_run_name(by_key["GPRF-100"][0]) != os.path.basename(cli_dir):
        raise AssertionError(f"{gprfopt.build_run_name(by_key['GPRF-100'][0])} is not the cli "
                             f"run's directory {cli_dir}")
    times, envelope = paper_figures.suite_series(os.path.dirname(cli_dir), by_key,
                                                 gprfopt.build_run_name)["GPRF-100"]
    final = paper_figures.final_error_vs_time(os.path.dirname(cli_dir), by_key,
                                              gprfopt.build_run_name)["GPRF-100"]
    if not (len(times) == cli["iterations"] and np.all(np.diff(envelope) <= 0)
            and np.isclose(envelope[-1], min(envelope))):
        raise AssertionError(f"figure series: {len(times)} points, envelope {envelope[:3]}...")
    log(f"tools: gen-runs wrote {scripts}; the cli run's figure series: {len(times)} points, "
        f"best mad x sqrt(n) {envelope[0]:.5f} -> {envelope[-1]:.5f}; final (time, mad) {final}")

    fused = cli_engine(data, torch)
    x0 = torch.as_tensor(data.X_obs.reshape(-1), dtype=torch.float32, device="cuda")
    loss = fused.loss_fn()
    value_and_grad(loss, x0)
    log_dir = os.path.join(base, "trace")
    with device_trace(log_dir):
        value_and_grad(loss, x0)
        torch.cuda.synchronize()
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        trace = f.read()
    found = {k: trace.count(k) for k in OUR_KERNELS}
    log(f"device_trace of one flagship loss+grad: {name}, {len(trace)} bytes, kernel names "
        f"{found}")
    if not all(found.values()):
        raise AssertionError(f"the trace lacks K1-K3: {found}")
    return dict(scripts=scripts, series_points=len(times),
                envelope=[float(envelope[0]), float(envelope[-1])], final=list(final),
                trace_bytes=len(trace), trace_kernels=found)


def run_rpc(base, cases, torch):
    """Phase 8: the command line's flagship over an RPC partition
    (--rpc_blocksize 200) on the device engine."""
    import io

    from gprf_torch.analysis.results import load_final_results, load_results
    from gprf_torch.cli import gprfopt
    from gprf_torch.data.sampled import sample_data
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.ops import mvn
    from gprf_torch.utils.profiling import device_busy

    argv = RPC_FLAGS + ["--engine", "device", "--max_iters", str(CLI_ITERS)]
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    out = io.StringIO()
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        seconds = gprfopt.main(argv)
    torch.cuda.synchronize()
    launches = dict(mvn.launch_counts)
    sys.stderr.write(out.getvalue())
    reported = next(line for line in out.getvalue().splitlines()
                    if line.startswith("device engine: B = "))
    B, E, m_end = (int(w) for w in reported.replace(",", " ").split() if w.isdigit())
    files = sorted(os.listdir(d))
    wanted = ["log.txt", "optimizer_state.npz", "results.txt", "finished",
              "step_%05d_X.npy" % (CLI_ITERS - 1)]
    if [f for f in wanted if f not in files]:
        raise AssertionError(f"rpc run left {files}; want {wanted}")
    steps, values = read_log(d)
    results = load_results(d)
    final, true_row = load_final_results(d)
    mad_first, mad_last = float(results[0, 4]), float(final["mad"])
    log(f"rpc (device engine, block size {RPC_BLOCKSIZE}): engine reports B={B}, E={E}, final "
        f"m={m_end}; {len(steps)} iterations; objective {values[0]:.2f} -> {values[-1]:.2f}, at "
        f"the true X {true_row['mll']:.2f}; mad {mad_first:.8f} -> {mad_last:.8f}; seconds: "
        f"sampling {seconds['sample_s']:.2f}, fitting {seconds['fit_s']:.2f}, analysis "
        f"{seconds['analyze_s']:.2f}; launches {launches}")
    if list(steps) != list(range(CLI_ITERS)):
        raise AssertionError(f"rpc run logged steps {steps[0]}..{steps[-1]} ({len(steps)})")
    if not (values[-1] > values[0] and mad_last < mad_first and np.isfinite(true_row["mll"])):
        raise AssertionError(f"rpc run: objective {values[0]} -> {values[-1]}, mad {mad_first} "
                             f"-> {mad_last}, trueX objective {true_row['mll']}")
    check_launches("the rpc run", launches, ("chol_inv", "mvn_ll", "tri_inv", "se_kernel",
                                             "se_kernel_bwd"), ("mvn_ll_inv", "cholesky"))

    # the host's partition of the same data: B, E and m against the engine's
    data = sample_data(n=10500, ntrain=10000, lscale=0.06, obs_std=0.02, yd=DY, seed=0,
                       centers=None, noise_var=NOISE_VAR, rpc_blocksize=RPC_BLOCKSIZE)
    gprf = data.build_gprf(local_dist=0.1, device="cuda", dtype=torch.float32)
    fused = FusedSyntheticGPRF(data.X_obs, data.SY, gprf.neighbors, data.X_obs, data.obs_std,
                               data.cov, data.noise_var, task="x", rpc_tree=data.rpc_splits,
                               device="cuda", dtype=torch.float32, acc_dtype=torch.float64)
    host_m = (max(len(b) for b in data.block_idxs) + 7) // 8 * 8
    shape = {"blocks": len(data.block_idxs), "m": host_m}
    if shape != RPC_SHAPE or (B, E) != (shape["blocks"], len(gprf.neighbors)) or not (
            fused.m == host_m <= m_end):
        raise AssertionError(f"rpc partition: engine B={B}, E={E}, m {fused.m} -> {m_end}; host "
                             f"{shape}, E={len(gprf.neighbors)}; want {RPC_SHAPE}")

    # the median replay on the card against the float64 host replay
    def labels(blocks):
        lab = np.empty(len(data.X_obs), dtype=np.int64)
        for b, ix in enumerate(blocks):
            lab[ix] = b
        return lab

    X_final = np.load(os.path.join(d, "step_%05d_X.npy" % (CLI_ITERS - 1)))
    moved = {}
    for name, X in (("X_obs", data.X_obs), ("X_final", X_final)):
        moved[name] = int(np.sum(fused._assign_host(X) != labels(data.reblock(X))))
    log(f"rpc median replay, float32 on the card against float64 on the host: points in another "
        f"block {moved} of {len(data.X_obs)} (limit {RPC_MAX_MOVED})")
    if max(moved.values()) > RPC_MAX_MOVED:
        raise AssertionError(f"rpc replay moved {moved} points")

    # K1-K3 on this path's own inputs
    x_obs = data.X_obs.reshape(-1)
    kernels = check_path_kernels(f"rpc path, B={B}, E={E}, m={fused.m}",
                                 flagship_inputs(fused, x_obs, torch), cases, torch)
    if kernels["chol_inv"]["shape"] != [B, fused.m, fused.m] or \
            kernels["mvn_ll"]["shape"] != [E, fused.m, fused.m, DY]:
        raise AssertionError(f"rpc path kernels were held at {kernels}")

    # one folded loss at R = 2 against the two single-replica losses
    rng = np.random.default_rng(3)
    thetas = torch.as_tensor(np.stack([x_obs, x_obs + rng.standard_normal(x_obs.shape) * OBS_STD]),
                             dtype=torch.float32, device="cuda")
    loss = fused.loss_fn()
    with torch.no_grad():
        folded = loss(thetas).double()
        single = torch.stack([loss(t) for t in thetas]).double()
        both = fused._assign_device(thetas.reshape(2, -1, 2))
        alone = torch.stack([fused._assign_device(t.reshape(-1, 2)) for t in thetas])
    fold_rel = float(((folded - single).abs() / single.abs()).max())
    same_labels = bool(torch.equal(both, alone))
    log(f"rpc folded loss, R=2: rel {fold_rel:.3e} to the single losses, labels equal "
        f"{same_labels}")
    if not (fold_rel <= RTOL_LOSS and same_labels):
        raise AssertionError(f"rpc folded loss: rel {fold_rel}, labels equal {same_labels}")

    x0 = thetas[0]
    busy, n_launch = device_busy(loss, x0)
    (eval_ms,) = eval_ms_in_turns([loss], x0, torch)
    log(f"rpc shapes: one loss+grad: device busy {busy:.3f} ms ({n_launch:.0f} launches), host "
        f"clock {eval_ms:.3f} ms (median of 20)")
    return dict(kernels=kernels, blocks=B, edges=E, m=fused.m, m_end=m_end, dir_files=files,
                iterations=len(steps), objective=[float(values[0]), float(values[-1])],
                true_x_objective=float(true_row["mll"]), mad=[mad_first, mad_last],
                seconds=seconds, ms_per_iteration=seconds["fit_s"] / len(steps) * 1e3,
                launches=launches, replay_moved=moved, folded_rel=fold_rel,
                device_busy_ms=busy, device_launches=n_launch, eval_ms=eval_ms)


def run_host(base, data, cases, torch):
    """Phase 9: the host engine on the same data (its cache copied into a
    base of its own: the run directory's name does not tell the engine), and
    GPRF.update_X across a change of m."""
    from gprf_torch.cli import gprfopt
    from gprf_torch.ops import mvn

    shutil.copytree(os.path.join(os.environ["GPRF_EXPERIMENTS"], "synthetic_datasets"),
                    os.path.join(base, "synthetic_datasets"))
    os.environ["GPRF_EXPERIMENTS"] = base
    argv = CLI_FLAGS + ["--engine", "host", "--maxsec", str(HOST_SECONDS)]
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        seconds = gprfopt.main(argv)
    torch.cuda.synchronize()
    launches = dict(mvn.launch_counts)
    steps, values = read_log(d)
    log(f"host engine (scipy over GPRF.llgrad, {HOST_SECONDS} s): {len(steps)} evaluations, "
        f"{seconds['fit_s'] / len(steps) * 1e3:.2f} ms each with re-blocking, upload and "
        f"checkpoint; objective {values[0]:.2f} -> {values.max():.2f}; launches {launches}")
    if not (len(steps) >= 3 and values.max() > values[0]):
        raise AssertionError(f"host engine: {len(steps)} evaluations, objective {values}")
    check_launches("the host run", launches, ("chol_inv", "mvn_ll", "tri_inv"),
                   ("mvn_ll_inv", "cholesky"))

    # update_X across a change of m: pull points toward one block's center
    # until it outgrows the padded width; kernels against twins at both widths
    pair = [data.build_gprf(local_dist=0.1, device="cuda", dtype=torch.float32, ops=ops)
            for ops in (mvn.KERNEL_OPS, mvn.PLAIN_OPS)]
    widths, upload_ms, kernels = [], [], {}
    X = data.X_obs.copy()
    near = np.argsort(np.linalg.norm(X - data.centers[45], axis=1))[:pair[0].layout.block_pad + 40]
    X_pulled = X.copy()
    X_pulled[near] = data.centers[45] + (X[near] - data.centers[45]) * 0.5
    for X_new in (X, X_pulled):
        out = []
        for g in pair:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.update_X(X_new)
            g._device_arrays()
            torch.cuda.synchronize()
            upload_ms.append((time.perf_counter() - t0) * 1e3)
            ll, gX, _ = g.llgrad(grad_X=True)
            out.append((ll, torch.as_tensor(gX.reshape(-1))))
        widths.append(pair[0].layout.block_pad)
        loss_rel, cosine = agreement(out[0], out[1])
        log(f"GPRF.llgrad at m={widths[-1]}: ll {out[0][0]:.4f}, kernels vs twins rel "
            f"{loss_rel:.3e}, gradient cosine {cosine:.8f}")
        if not (loss_rel <= RTOL_LOSS and cosine > MIN_GRAD_COSINE):
            raise AssertionError(f"GPRF.llgrad at m={widths[-1]} disagrees with the twins: rel "
                                 f"{loss_rel:.3e}, cosine {cosine:.8f}")
        if X_new is X_pulled:  # each kernel alone on the re-blocked model's inputs
            kernels = check_path_kernels(
                f"GPRF.llgrad after update_X, m={widths[-1]}",
                recorded_inputs(pair[0], lambda: pair[0].llgrad(grad_X=False)), cases, torch)
    if not widths[1] > widths[0]:
        raise AssertionError(f"update_X did not cross a change of m: widths {widths}")
    llgrad_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        pair[0].llgrad(grad_X=True)  # ends in the copy of ll and gradX to the host
        llgrad_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"GPRF.update_X crossed m {widths[0]} -> {widths[1]}; re-block on the host and upload of "
        f"the layout: median {statistics.median(upload_ms):.2f} ms; GPRF.llgrad(grad_X=True) at "
        f"m={widths[1]}: median {statistics.median(llgrad_ms):.2f} ms")
    return dict(evaluations=len(steps), objective=[float(values[0]), float(values.max())],
                seconds=seconds, launches=launches, widths=widths, kernels_after_update_x=kernels,
                reblock_upload_ms=statistics.median(upload_ms),
                llgrad_ms=statistics.median(llgrad_ms))


def run_resume(base, data, torch):
    """Phase 10: stop a device-engine run after two dispatches, resume it
    from optimizer_state.npz, and read log.txt's step indices."""
    from gprf_torch.optim.lbfgs import do_optimization_fused

    d = os.path.join(base, "resumed")
    os.makedirs(d)

    do_optimization_fused(d, cli_engine(data, torch), data.X_obs, max_iters=40,
                          steps_per_dispatch=20)
    before, _ = read_log(d)
    do_optimization_fused(d, cli_engine(data, torch), data.X_obs, max_iters=80,
                          steps_per_dispatch=20, resume=True)
    steps, values = read_log(d)
    log(f"resume: {len(before)} rows, then resumed to {len(steps)}; objective "
        f"{values[0]:.2f} -> {values[-1]:.2f}")
    if list(before) != list(range(40)) or list(steps) != list(range(80)):
        raise AssertionError(f"resumed log.txt has step indices {list(steps)}")
    if not values[-1] > values[39] > values[0]:
        raise AssertionError(f"resumed run did not go on rising: {values[0]}, {values[39]}, "
                             f"{values[-1]}")
    return dict(rows_before=len(before), rows_after=len(steps))


def check_multistart(fused, x_flat, torch):
    """Phase 11: the flagship problem from MULTISTART_REPLICAS starts (the
    observed X and perturbations at the observation prior's scale), the
    replica-batched runner against the single-start runner from each start."""
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import make_multistart_runner, make_scan_lbfgs_runner

    fused.m = M0
    use_route(fused, "default", mvn.KERNEL_OPS)
    rng = np.random.default_rng(2)
    x0s = np.stack([x_flat] + [x_flat + rng.standard_normal(x_flat.shape) * OBS_STD
                               for _ in range(MULTISTART_REPLICAS - 1)])
    x0s = torch.as_tensor(x0s, dtype=fused.dtype, device=fused.device)
    init, run = make_multistart_runner(fused.loss_fn(), MULTISTART_STEPS)
    mvn.reset_launch_counts()
    _, (values, _, _) = run(init(x0s))
    torch.cuda.synchronize()
    launches = dict(mvn.launch_counts)
    init1, run1 = make_scan_lbfgs_runner(fused.loss_fn(), MULTISTART_STEPS)
    rels = []
    for r in range(MULTISTART_REPLICAS):
        _, (single, _, _) = run1(init1(x0s[r]))
        ref = single.double()
        rels.append(float((values[r].double() - ref).abs().max() / ref.abs().max()))
    log(f"multistart, flagship problem, R={MULTISTART_REPLICAS}, {MULTISTART_STEPS} steps: "
        f"max rel value difference to the single starts per replica {rels}; launches of the "
        f"batched run {launches} (K1 on [{MULTISTART_REPLICAS * NBLOCKS},{M0},{M0}])")
    if not max(rels) <= RTOL_LOSS or launches["chol_inv"] != MULTISTART_STEPS + 1:
        raise AssertionError(f"multistart disagrees with the single starts: rel {rels}, "
                             f"launches {launches}")
    return dict(replicas=MULTISTART_REPLICAS, steps=MULTISTART_STEPS, max_rel_value_diff=rels,
                launches=launches)


def read_seismic_results(d):
    """(first row's mean km error, last row's, the true-X objective) of a
    seismic run directory's results.txt."""
    with open(os.path.join(d, "results.txt")) as f:
        rows = f.read().splitlines()
    if not rows[-1].startswith("true X ll"):
        raise AssertionError(f"{d}/results.txt ends with {rows[-1]!r}")
    return float(rows[0].split()[4]), float(rows[-2].split()[4]), float(rows[-1].split()[-1])


def run_seismic_device(base, cases, torch):
    """Phase 12: the seismic command on the device engine with replicas."""
    from gprf_torch.cli import run_seismic
    from gprf_torch.ops import mvn
    from gprf_torch.utils.profiling import device_busy, splits_at

    data = os.path.join(base, "data")
    os.makedirs(data)
    os.environ["SEISMIC_EXPERIMENTS"] = os.path.join(base, "device")
    argv = SEISMIC_FLAGS + ["--data_dir", data, "--engine", "device", "--multistart",
                            str(SEISMIC_REPLICAS), "--max_iters", str(SEISMIC_ITERS)]
    args = run_seismic.build_parser().parse_args(argv)
    d = run_seismic.seismic_exp_dir(args)
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        info = run_seismic.main(argv)
    torch.cuda.synchronize()
    launches = dict(mvn.launch_counts)
    files = sorted(os.listdir(d))
    steps, values = read_log(d)
    wanted = ["log.txt", "multistart.txt", "covs.txt", "results.txt", "finished",
              "step_%05d_X.npy" % steps[-1], "step_%05d_cov.npy" % steps[-1]]
    if [f for f in wanted if f not in files]:
        raise AssertionError(f"seismic run left {files}; want {wanted}")
    with open(os.path.join(d, "multistart.txt")) as f:
        columns = {len(line.split()) for line in f}
    mad_first, mad_last, true_ll = read_seismic_results(d)
    shape = {k: info[k] for k in SEISMIC_SHAPE}
    log(f"seismic (device engine, {SEISMIC_REPLICAS} replicas): partition {shape}, capacity m "
        f"{info['m']} -> {info['m_end']} (splitting there: {splits_at(info['m_end'], DY) or 'none'})"
        f"; {len(steps)} iterations; winner's objective {values[0]:.2f} -> {values[-1]:.2f}, at "
        f"the true X {true_ll:.2f}; mean location error {mad_first:.4f} -> {mad_last:.4f} km; "
        f"seconds: sampling {info['sample_s']:.2f} (the catalog and the 12,000-point sparse "
        f"prior draw, on the host), fitting {info['fit_s']:.2f}, analysis "
        f"{info['analyze_s']:.2f}; launches {launches}")
    if shape != SEISMIC_SHAPE:
        raise AssertionError(f"the seismic partition is {shape}; want {SEISMIC_SHAPE}")
    if columns != {2 + SEISMIC_REPLICAS}:
        raise AssertionError(f"multistart.txt rows have {columns} columns")
    if not (list(steps) == list(range(len(steps))) and values[-1] > values[0]
            and mad_last < mad_first and np.isfinite(true_ll)):
        raise AssertionError(f"seismic run: steps {steps[0]}..{steps[-1]}, objective "
                             f"{values[0]} -> {values[-1]}, mean error {mad_first} -> {mad_last}")
    check_launches("the seismic run", launches, ("chol_inv", "mvn_ll", "tri_inv"),
                   ("mvn_ll_inv", "cholesky", "se_kernel", "se_kernel_bwd"))

    # the engine the run used, rebuilt on the cached data: K1-K3 against
    # their twins on the seismic loss's inputs at one replica and at all
    p = run_seismic.build_problem(args, device="cuda")
    fused = run_seismic.build_engine(args, p, device="cuda")
    theta0 = fused.theta0(p["means"], p["C0"])
    thetas = run_seismic.multistart_thetas(theta0, args.task, p["means"].size,
                                           SEISMIC_REPLICAS, args.seed)
    per_r = {}
    for R in (1, SEISMIC_REPLICAS):
        x = torch.as_tensor(thetas[0] if R == 1 else thetas, dtype=torch.float32, device="cuda")
        kernels = check_path_kernels(f"seismic path, R={R}", recorded_inputs(
            fused, lambda: fused.loss_fn()(x)), cases, torch)
        want = {"chol_inv": [R * info["blocks"], info["m"], info["m"]],
                "mvn_ll": [R * info["edges"], info["m"], info["m"], DY]}
        if any(kernels[k]["shape"] != v for k, v in want.items()):
            raise AssertionError(f"seismic kernels were held at {kernels}")
        loss = fused.loss_fn()
        busy, n_launch = device_busy(loss, x)
        (eval_ms,) = eval_ms_in_turns([loss], x, torch)
        log(f"seismic shapes, R={R}: one loss+grad: device busy {busy:.3f} ms ({n_launch:.0f} "
            f"launches), host clock {eval_ms:.3f} ms (median of 20)")
        per_r[f"R{R}"] = dict(kernels=kernels, device_busy_ms=busy, device_launches=n_launch,
                              eval_ms=eval_ms)
    routes = check_routes(fused, torch.as_tensor(theta0, dtype=torch.float32, device="cuda"),
                          torch, m=info["m"], what="seismic route")
    return dict(info, iterations=len(steps), objective=[float(values[0]), float(values[-1])],
                true_x_objective=true_ll, mean_km=[mad_first, mad_last],
                ms_per_iteration=info["fit_s"] / len(steps) * 1e3, launches=launches,
                dir_files=len(files), routes=routes, **per_r), data


def run_seismic_host(base, data, torch):
    """Phase 13: the seismic command on the host engine, on the same data."""
    from gprf_torch.cli import run_seismic
    from gprf_torch.ops import mvn

    os.environ["SEISMIC_EXPERIMENTS"] = os.path.join(base, "host")
    argv = SEISMIC_FLAGS + ["--data_dir", data, "--engine", "host", "--maxsec",
                            str(HOST_SECONDS)]
    d = run_seismic.seismic_exp_dir(run_seismic.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        info = run_seismic.main(argv)
    torch.cuda.synchronize()
    launches = dict(mvn.launch_counts)
    files = sorted(os.listdir(d))
    steps, values = read_log(d)
    mad_first, mad_last, _ = read_seismic_results(d)
    ms = info["fit_s"] / len(steps) * 1e3
    log(f"seismic host engine (scipy over GPRF.llgrad, {HOST_SECONDS} s): {len(steps)} "
        f"evaluations, {ms:.2f} ms each with re-blocking, upload and checkpoint; objective "
        f"{values[0]:.2f} -> {values.max():.2f}; mean location error {mad_first:.4f} -> "
        f"{mad_last:.4f} km; launches {launches}")
    wanted = ["log.txt", "covs.txt", "results.txt", "finished", "step_00000_X.npy"]
    if [f for f in wanted if f not in files] or not (len(steps) >= 3
                                                      and values.max() > values[0]):
        raise AssertionError(f"seismic host engine: files {files}, objective {values}")
    check_launches("the seismic host run", launches, ("chol_inv", "mvn_ll", "tri_inv"),
                   ("mvn_ll_inv", "cholesky", "se_kernel", "se_kernel_bwd"))
    return dict(evaluations=len(steps), ms_per_evaluation=ms,
                objective=[float(values[0]), float(values.max())], launches=launches,
                seconds={k: info[k] for k in ("sample_s", "fit_s", "analyze_s")})


def run_sparse(base, seismic_data, torch):
    """Phase 19: ``--sparse`` on the seismic host engine, and the sparse
    llgrad against the dense one on an 8-block sub-model."""
    from gprf_torch.cli import run_seismic
    from gprf_torch.model.gprf import GPRF
    from gprf_torch.ops import mvn

    os.environ["SEISMIC_EXPERIMENTS"] = os.path.join(base, "sparse")
    argv = SPARSE_FLAGS + ["--data_dir", seismic_data, "--engine", "host", "--sparse",
                           "--maxsec", str(SPARSE_SECONDS)]
    d = run_seismic.seismic_exp_dir(run_seismic.build_parser().parse_args(argv))
    with contextlib.redirect_stdout(sys.stderr):
        info = run_seismic.main(argv)
    files = sorted(os.listdir(d))
    steps, values = read_log(d)
    s_per_eval = info["fit_s"] / len(steps)
    log(f"seismic --sparse (host engine, {SPARSE_FLAGS[0]}, the 12,000-event command shrunk): "
        f"{info['blocks']} blocks, {info['edges']} edges; {len(steps)} evaluations in "
        f"{info['fit_s']:.2f} s, {s_per_eval:.3f} s each; objective {values[0]:.2f} -> "
        f"{values.max():.2f}")
    wanted = ["log.txt", "covs.txt", "results.txt", "finished", "step_00000_X.npy"]
    if [f for f in wanted if f not in files] or not (len(steps) >= 3
                                                      and values.max() > values[0]):
        raise AssertionError(f"seismic --sparse: files {files}, objective {values}")

    # the full catalog's first 8 PD-tree blocks and their edges, float64
    args = run_seismic.build_parser().parse_args(SEISMIC_FLAGS + ["--data_dir", seismic_data])
    p = run_seismic.build_problem(args, device="cuda", dtype=torch.float64)
    g = p["gprf"]
    blocks = g.block_idxs[:SPARSE_SUB_BLOCKS]
    idx = np.concatenate(blocks)
    local = np.empty(len(g.X), dtype=np.int64)
    local[idx] = np.arange(len(idx))
    edges = [(i, j) for i, j in g.neighbors if i < SPARSE_SUB_BLOCKS and j < SPARSE_SUB_BLOCKS]
    sub = GPRF(p["means"][idx], p["SY"][idx], None, g.cov, g.noise_var,
               block_idxs=[local[b] for b in blocks], neighbors=edges, device="cuda",
               dtype=torch.float64, ops=mvn.LINALG_OPS)
    dense = sub.llgrad(grad_X=True, grad_cov=True)
    gaps = {}
    for md in (SPARSE_EXACT_DISTANCE, 5.0):
        t0 = time.perf_counter()
        sparse = sub.llgrad(grad_X=True, grad_cov=True, sparse=True, max_distance=md)
        gaps[md] = dict(
            seconds=time.perf_counter() - t0, ll_rel=abs(sparse[0] - dense[0]) / abs(dense[0]),
            gradX_rel=float(np.abs(sparse[1] - dense[1]).max() / np.abs(dense[1]).max()),
            gradC_rel=float(np.abs(sparse[2] - dense[2]).max() / np.abs(dense[2]).max()))
        log(f"sparse llgrad on {SPARSE_SUB_BLOCKS} blocks ({len(idx)} events, {len(edges)} "
            f"edges) at max_distance {md:g} against the dense float64 llgrad (LINALG_OPS): "
            f"{gaps[md]}")
    # one sparse evaluation of the whole catalog, the one --npts spared
    t0 = time.perf_counter()
    g.llgrad(grad_X=True, grad_cov=True, sparse=True)
    whole_s = time.perf_counter() - t0
    log(f"one sparse llgrad of the whole catalog ({len(g.X)} events, {g.n_blocks} blocks, "
        f"{len(g.neighbors)} edges): {whole_s:.2f} s on the host")
    exact = gaps[SPARSE_EXACT_DISTANCE]
    if not (exact["ll_rel"] <= RTOL_JOINT and exact["gradX_rel"] <= SPARSE_GRAD_RTOL
            and exact["gradC_rel"] <= SPARSE_GRAD_RTOL):
        raise AssertionError(f"the sparse llgrad at max_distance {SPARSE_EXACT_DISTANCE:g} "
                             f"is not the dense one: {exact}")
    return dict(blocks=info["blocks"], edges=info["edges"], evaluations=len(steps),
                s_per_evaluation=s_per_eval, whole_catalog_s=whole_s,
                objective=[float(values[0]), float(values.max())],
                seconds={k: info[k] for k in ("sample_s", "fit_s", "analyze_s")},
                sub_model=dict(blocks=SPARSE_SUB_BLOCKS, events=len(idx), edges=len(edges),
                               gaps={str(k): v for k, v in gaps.items()}))


def check_remat_launches(fwd, both, nch):
    """A chunked pair pass launches K2 once a chunk in the forward; a
    loss+grad runs each chunk's forward again in its backward, so K2 twice
    and K3 (K2's backward) once a chunk, and K1 again for the pair leaves."""
    if not (fwd["mvn_ll"] == nch and both["mvn_ll"] == 2 * nch and both["tri_inv"] == nch
            and both["chol_inv"] > fwd["chol_inv"]):
        raise AssertionError(f"80k launches: forward {fwd}, loss+grad {both}, chunks {nch}")


def float32_held(got, twins):
    """A float32 result no farther from float64 than 4x the float32 twins
    (each a gap() record against the twins in float64), or within the
    routes' limits of it: the rule of the card tests at noise 0.01 (PR 8),
    for points where float32's own floor exceeds those limits."""
    return (got["rel"] <= max(4 * twins["rel"], RTOL_LOSS)
            and 1 - got["cosine"] <= max(4 * (1 - twins["cosine"]), 1 - MIN_GRAD_COSINE))


def run_eighty(base, cases, torch):
    """Phase 14: the paper's 80k command on the device engine at wide m, and
    at its final X the kernels against the twins, the float64 joint form
    against the float64 Schur split, float32 against that, and the host
    engine's objective against the device engine's."""
    import io

    from gprf_torch.analysis.results import load_final_results, load_results
    from gprf_torch.cli import gprfopt
    from gprf_torch.data.sampled import sample_data
    from gprf_torch.model.fused import assemble_layout, grid_labels
    from gprf_torch.model.gprf import _auto_chunk
    from gprf_torch.model.objective import (GPRFParams, gprf_value_and_grad,
                                            gprf_value_and_grad_schur)
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import value_and_grad
    from gprf_torch.partition.grid import grid_centers
    from gprf_torch.utils.profiling import kernel_events

    os.environ["GPRF_EXPERIMENTS"] = base
    os.environ["GPRF_SAMPLER"] = EIGHTY_SAMPLER
    argv = EIGHTY_FLAGS + ["--engine", "device", "--max_iters", str(EIGHTY_ITERS)]
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    out = io.StringIO()
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        seconds = gprfopt.main(argv)
    torch.cuda.synchronize()
    launches = dict(mvn.launch_counts)
    sys.stderr.write(out.getvalue())
    reported = next(line for line in out.getvalue().splitlines()
                    if line.startswith("device engine: B = "))
    B, E, m_end = (int(w) for w in reported.replace(",", " ").split() if w.isdigit())
    files = sorted(os.listdir(d))
    wanted = ["log.txt", "optimizer_state.npz", "results.txt", "finished",
              "step_%05d_X.npy" % (EIGHTY_ITERS - 1)]
    if [f for f in wanted if f not in files]:
        raise AssertionError(f"80k run left {files}; want {wanted}")
    steps, values = read_log(d)
    results = load_results(d)
    final, true_row = load_final_results(d)
    mad_first, mad_last = float(results[0, 4]), float(final["mad"])
    data = sample_data(centers=grid_centers(NBLOCKS), **EIGHTY_DATA)  # the run's, from its cache
    m_start = cli_engine(data, torch).m
    ms_iter = seconds["fit_s"] / len(steps) * 1e3
    log(f"80k (device engine, GPRF_SAMPLER={EIGHTY_SAMPLER}): B={B}, E={E}, m {m_start} -> "
        f"{m_end}; {len(steps)} iterations, {ms_iter:.1f} ms each; objective {values[0]:.2f} -> "
        f"{values[-1]:.2f}, at the true X {true_row['mll']:.2f}; the JAX package's artifact "
        f"(docs/runs/gprf80k_device/results.txt): row 0 {JAX_EIGHTY_LL[0]:.2f}, trueX "
        f"{JAX_EIGHTY_LL[1]:.2f}; mad {mad_first:.8f} -> {mad_last:.8f}; seconds: sampling "
        f"{seconds['sample_s']:.2f} (the 80,500-point Vecchia draw, on the host), fitting "
        f"{seconds['fit_s']:.2f}, analysis {seconds['analyze_s']:.2f}; launches {launches}")
    if list(steps) != list(range(EIGHTY_ITERS)):
        raise AssertionError(f"80k run logged steps {steps[0]}..{steps[-1]} ({len(steps)})")
    if not (values[-1] > values[0] and mad_last < mad_first and np.isfinite(true_row["mll"])):
        raise AssertionError(f"80k run: objective {values[0]} -> {values[-1]}, mad {mad_first} "
                             f"-> {mad_last}, trueX objective {true_row['mll']}")
    check_launches("the 80k run", launches, ("chol_inv", "mvn_ll", "tri_inv", "se_kernel",
                                             "se_kernel_bwd"), ("mvn_ll_inv", "cholesky"))

    # the engine at the fit's final X (its capacity from the data there)
    X_final = np.load(os.path.join(d, "step_%05d_X.npy" % (EIGHTY_ITERS - 1)))
    fused = cli_engine(data, torch, X0=X_final)
    m = fused.m
    x = torch.as_tensor(X_final.reshape(-1), dtype=torch.float32, device="cuda")
    if fused.loss_pair_chunk() is not None:
        raise AssertionError(f"80k engine at m={m} chunks the pairs by {fused.loss_pair_chunk()}")

    # one loss+grad: the rule's whole pass launches K2 once and K3 once (K2's
    # backward); in chunks of 64 each chunk's forward runs again in its backward
    nch = -(-E // EIGHTY_CHUNK)
    counts = {}
    for chunk in (None, EIGHTY_CHUNK):
        fused.pair_chunk = chunk
        loss = fused.loss_fn()
        for what, run in (("forward", lambda: loss(x)),
                          ("loss+grad", lambda: value_and_grad(loss, x))):
            mvn.reset_launch_counts()
            with torch.set_grad_enabled(what != "forward"):
                run()
            torch.cuda.synchronize()
            counts[chunk, what] = dict(mvn.launch_counts)
    fused.pair_chunk = None
    loss = fused.loss_fn()
    fwd, both = counts[None, "forward"], counts[None, "loss+grad"]
    fwd64, both64 = counts[EIGHTY_CHUNK, "forward"], counts[EIGHTY_CHUNK, "loss+grad"]
    log(f"80k, m={m}, the whole pair pass: launches of one forward {fwd}, of one loss+grad "
        f"{both}; {nch} pair chunks of {EIGHTY_CHUNK}: {fwd64}, {both64}")
    if not (fwd["mvn_ll"] == both["mvn_ll"] == both["tri_inv"] == 1):
        raise AssertionError(f"80k launches of the whole pass: forward {fwd}, loss+grad {both}")
    check_remat_launches(fwd64, both64, nch)

    # at X_obs and at the final X, on the float64 partition of each: the
    # default route's Schur form on the kernels and on the twins in float32,
    # on the twins in float64, and the joint form in float64 (no X prior)
    f32, f64 = torch.float32, torch.float64
    centers = torch.as_tensor(np.asarray(data.centers), dtype=f64, device="cuda")
    edges = fused.edges
    ei, ej = edges[:, 0], edges[:, 1]
    Y = {f32: fused.Y, f64: fused.Y.double()}
    uw = {f32: fused.unary_weights, f64: fused.unary_weights.double()}
    pw = {f32: fused.pair_weights, f64: fused.pair_weights.double()}

    def objectives(X_np):
        p = {dt: GPRFParams(X=torch.as_tensor(X_np, dtype=dt, device="cuda"),
                            wfn_params=fused.cov.wfn_params.to(dt),
                            dfn_params=fused.cov.dfn_params.to(dt),
                            noise_var=torch.tensor(data.noise_var, dtype=dt, device="cuda"))
             for dt in (f32, f64)}
        labels = grid_labels(p[f64].X, centers)
        mX = (int(torch.bincount(labels, minlength=B).max()) + 7) // 8 * 8
        assignment, mask, _ = assemble_layout(labels, B, mX)
        out = {}
        for key, dt, ops in (("kernels", f32, mvn.KERNEL_OPS), ("twins", f32, mvn.PLAIN_OPS),
                             ("twins64", f64, mvn.PLAIN_OPS)):
            ll, gX, _ = gprf_value_and_grad_schur(p[dt], Y[dt], assignment, mask, edges, uw[dt],
                                                  pw[dt], acc_dtype=f64, ops=ops,
                                                  pair_chunk=EIGHTY_CHUNK)
            out[key] = (ll, gX.reshape(-1))
        chunks = dict(unary_chunk=_auto_chunk(B, mX), pair_chunk=_auto_chunk(E, 2 * mX))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ll, gX, _ = gprf_value_and_grad(
            p[f64], Y[f64], assignment, mask, torch.cat([assignment[ei], assignment[ej]], 1),
            torch.cat([mask[ei], mask[ej]], 1), uw[f64], pw[f64], **chunks)
        torch.cuda.synchronize()
        out["joint64"] = (ll, gX.reshape(-1))
        return out, dict(m=mX, joint_chunks=chunks, joint_s=time.perf_counter() - t0)

    def gap(a, b):
        rel, cosine = agreement(a, b)
        return dict(rel=rel, cosine=cosine)

    agree = {}
    for where, X_np in (("X_obs", data.X_obs), ("final", X_final)):
        out, info = objectives(X_np)
        pairs = {"kernels_twins": gap(out["kernels"], out["twins"]),
                 "kernels_twins64": gap(out["kernels"], out["twins64"]),
                 "twins_twins64": gap(out["twins"], out["twins64"]),
                 "joint64_twins64": gap(out["joint64"], out["twins64"]),
                 "kernels_joint64": gap(out["kernels"], out["joint64"])}
        agree[where] = dict(info, values={k: float(v[0]) for k, v in out.items()}, **pairs)
        log(f"80k at {where} (m={info['m']}; the joint form [E, {2 * info['m']}, "
            f"{2 * info['m']}] in chunks {info['joint_chunks']}, {info['joint_s']:.2f} s with its "
            f"gradient): values {agree[where]['values']}; (loss rel, gradient cosine) "
            + ", ".join(f"{k} ({v['rel']:.3e}, {v['cosine']:.10f})" for k, v in pairs.items()))
        k_t, k_64, t_64 = (pairs[k] for k in ("kernels_twins", "kernels_twins64",
                                               "twins_twins64"))
        if not pairs["joint64_twins64"]["rel"] <= RTOL_JOINT:
            raise AssertionError(f"80k at {where}: the joint form against the Schur split, "
                                 f"{pairs['joint64_twins64']}")
        # the kernels against the twins; at the final X, where float32's
        # floor in the gradient is ~7e-5, both against float64 instead
        held = k_t["rel"] <= RTOL_LOSS and k_t["cosine"] > MIN_GRAD_COSINE
        if where == "final" and not held:
            held = float32_held(k_64, t_64)
        if not held:
            raise AssertionError(f"80k at {where}: the kernels disagree: {pairs}")
        f32_joint = pairs["kernels_joint64"]
        if not (f32_joint["rel"] <= EIGHTY_F32_RTOL and f32_joint["cosine"] > EIGHTY_F32_MIN_COSINE):
            raise AssertionError(f"80k at {where}: float32 against the float64 joint form "
                                 f"{f32_joint}")
        final64 = (out["twins64"][0], out["twins64"][1].cpu())
    vg = value_and_grad(loss, x)  # the device engine's loss at the final X

    # the host engine's objective: GPRF.llgrad over the host's re-blocking
    gprf = data.build_gprf(local_dist=0.1, device="cuda", dtype=torch.float32)
    gprf.update_X(X_final)
    host_chunk = gprf._pair_chunk_for(gprf._device_arrays())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_ll, host_gX, _ = gprf.llgrad(grad_X=True)
    host_s = time.perf_counter() - t0
    r = (X_final - data.X_obs) / data.obs_std
    prior = -0.5 * float(np.sum(r * r)) - 0.5 * r.size * np.log(2 * np.pi * data.obs_std ** 2)
    fused_ll = -float(vg[0]) - prior
    fused_gX = -vg[1].double().cpu().numpy() + r.reshape(-1) / data.obs_std
    host_rel = abs(host_ll - fused_ll) / abs(fused_ll)
    host_cos = float(host_gX.reshape(-1) @ fused_gX
                     / (np.linalg.norm(host_gX) * np.linalg.norm(fused_gX)))
    host_64 = gap((torch.tensor(host_ll), torch.as_tensor(host_gX.reshape(-1))), final64)
    log(f"80k at the final X: GPRF(form='schur').llgrad(grad_X=True) (host engine's objective, "
        f"m={gprf.layout.block_pad}, pair chunk {host_chunk}, {host_s:.2f} s) {host_ll:.4f} "
        f"against the device engine's loss less its X prior {fused_ll:.4f}: rel {host_rel:.3e}, "
        f"gradient cosine {host_cos:.8f}; against the twins in float64: {host_64}")
    if not (host_rel <= RTOL_LOSS and float32_held(host_64, agree["final"]["twins_twins64"])):
        raise AssertionError(f"80k host objective disagrees: rel {host_rel:.3e}, cosine "
                             f"{host_cos}, against float64 {host_64}")
    del gprf

    # K1-K3 against their twins on every leaf shape this path gives them
    inputs = recorded_inputs(fused, lambda: fused.loss_fn()(x), every_shape=True)
    kernels = {}
    for name in ("chol_inv", "mvn_ll", "tri_inv"):
        kernels[name] = [dict(shape=list(args[0].shape) + [a.shape[-1] for a in args[1:2]],
                              **compare(cases[name], args, torch, what=f"80k path, m={m}: "))
                         for args in inputs[name]]
    se = check_se_kernel(f"80k path, m={m}", inputs["se_kernel"],
                         torch.Generator(device="cuda").manual_seed(80), torch)
    del inputs

    # one loss+grad chunked by 64 and whole (the rule's): peak memory, device busy
    memory = {}
    for chunk in (EIGHTY_CHUNK, None):
        fused.pair_chunk = E if chunk is None else chunk  # a chunk of all edges: none
        loss = fused.loss_fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        value_and_grad(loss, x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        events = kernel_events(loss, x, calls=3)
        busy, n_launch = sum(us for _, us in events) / 3e3, len(events) / 3
        ours = sum(us for name, us in events if any(k in name for k in OUR_KERNELS)) / 3e3
        (eval_ms,) = eval_ms_in_turns([loss], x, torch, reps=4)
        key = "chunk_%d" % chunk if chunk else "unchunked"
        memory[key] = dict(peak_gb=peak / 1e9, above_resident_gb=(peak - resident) / 1e9,
                           device_busy_ms=busy, device_launches=n_launch, k1_k3_ms=ours,
                           eval_ms=eval_ms)
        log(f"80k one loss+grad, {key}: peak memory {peak / 1e9:.2f} GB ({(peak - resident) / 1e9:.2f}"
            f" above the resident), device busy {busy:.3f} ms ({n_launch:.0f} launches, of them "
            f"K1-K3 {ours:.3f} ms), host clock {eval_ms:.3f} ms (median of 4)")
    fused.pair_chunk = None
    return dict(kernels=kernels, se_kernel=se, dir=d, blocks=B, edges=E, m_start=m_start, m_end=m_end, m_final=m,
                iterations=len(steps), ms_per_iteration=ms_iter,
                objective=[float(values[0]), float(values[-1])],
                true_x_objective=float(true_row["mll"]), jax_artifact=list(JAX_EIGHTY_LL),
                mad=[mad_first, mad_last], seconds=seconds, launches=launches,
                launches_one_forward=fwd, launches_one_loss_grad=both,
                launches_chunk_64=dict(forward=fwd64, loss_grad=both64),
                agreement=agree,
                host=dict(value=host_ll, rel=host_rel, cosine=host_cos, pair_chunk=host_chunk,
                          seconds=host_s),
                memory=memory)


def baseline_row0(data, gplvm_type, torch):
    """Row 0's objective of a baseline run as its driver computes it (the
    bound at X_obs over the driver's inducing points, plus the X prior), in
    float64 on the card at float32's jitter (the driver's jitter follows the
    width, 1e-4 in float32 and 1e-6 in float64): float32's rounding alone."""
    from gprf_torch.model import sgplvm

    X0 = np.asarray(data.X_obs, dtype=np.float64)
    Z0 = X0[np.random.default_rng(0).choice(len(X0), size=BASELINE_INDUCING, replace=False)]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device="cuda")

    jitter = sgplvm._rel_jitter
    sgplvm._rel_jitter = lambda dtype: jitter(torch.float32)
    try:
        ll = sgplvm._objective_and_grads(t(X0), t(Z0), t(np.log(float(data.cov.dfn_params[0]))),
                                         t(data.SY), 1.0, data.noise_var, gplvm_type, False)[0]
    finally:
        sgplvm._rel_jitter = jitter
    return float(ll) + data.x_prior(X0.reshape(-1))[0]


def run_baseline(flags, torch):
    """One baseline run through the command line: its log and results, the
    seconds, the launches (the fit runs on torch.linalg; the analysis's
    trueX objective on the kernels)."""
    from gprf_torch.analysis.results import load_final_results, load_results
    from gprf_torch.cli import gprfopt
    from gprf_torch.ops import mvn
    from gprf_torch.optim.driver import load_log

    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(flags))
    torch.cuda.synchronize()
    mvn.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        seconds = gprfopt.main(flags)
    torch.cuda.synchronize()
    steps, _, values = load_log(d)
    results = load_results(d)
    final, true_row = load_final_results(d)
    wanted = {"log.txt", "results.txt", "finished", "step_00000_X.npy"}
    if not wanted <= set(os.listdir(d)) or len(steps) < 3 or len(results) != len(steps):
        raise AssertionError(f"baseline run {flags}: {len(steps)} rows, files "
                             f"{sorted(os.listdir(d))[:8]}...")
    return dict(dir=d, evaluations=len(steps), ms_per_evaluation=seconds["fit_s"] / len(steps)
                * 1e3, objective=[float(values[0]), float(values[-1])],
                non_finite_rows=int((~np.isfinite(values)).sum()),
                mad=[float(results[0, 4]), float(final["mad"])],
                true_x_objective=float(true_row["mll"]), seconds=seconds,
                launches=dict(mvn.launch_counts))


def run_baselines(base, smi, torch):
    """Phase 15: the GPLVM baselines through the command line."""
    from gprf_torch.data.sampled import sample_data
    from gprf_torch.partition.grid import grid_centers

    os.environ["GPRF_EXPERIMENTS"] = base
    data = sample_data(n=10500, ntrain=10000, lscale=0.06, obs_std=0.02, yd=DY, seed=0,
                       centers=grid_centers(1), noise_var=NOISE_VAR)  # the cli phase's cache
    out = {}
    for gplvm_type, jax_row0 in JAX_BASELINE_ROW0.items():
        flags = BASELINE_FLAGS + ["--gplvm_type", gplvm_type, "--num_inducing",
                                  str(BASELINE_INDUCING), "--maxsec", str(BASELINE_SECONDS)]
        r = run_baseline(flags, torch)
        row0_64 = baseline_row0(data, gplvm_type, torch)
        rel = abs(r["objective"][0] - jax_row0) / abs(jax_row0)
        r.update(jax_row0=jax_row0, rel_to_jax=rel, row0_float64=row0_64,
                 rel_float32_to_float64=abs(r["objective"][0] - row0_64) / abs(row0_64),
                 rel_float64_to_jax=abs(row0_64 - jax_row0) / abs(jax_row0))
        log(f"baseline {gplvm_type}-{BASELINE_INDUCING} (truegp data, host engine, "
            f"{BASELINE_SECONDS} s): {r['evaluations']} evaluations, {r['ms_per_evaluation']:.2f} "
            f"ms each ({smi}); objective {r['objective'][0]:.2f} -> {r['objective'][1]:.2f} "
            f"({r['non_finite_rows']} non-finite rows); row 0 against the JAX artifact "
            f"{jax_row0:.2f}: rel {rel:.3e} (limit {BASELINE_RTOL}); row 0 in float64 on the "
            f"card at float32's jitter {row0_64:.2f} (float32 rel "
            f"{r['rel_float32_to_float64']:.3e}, float64 against the artifact "
            f"{r['rel_float64_to_jax']:.3e}); mad {r['mad'][0]:.8f} -> "
            f"{r['mad'][1]:.8f}; trueX objective {r['true_x_objective']:.2f}; seconds "
            f"{r['seconds']}; launches {r['launches']}")
        if abs(r["mad"][0] - JAX_BASELINE_MAD0) > 5e-9:
            raise AssertionError(f"baseline {gplvm_type}: row 0's mad {r['mad'][0]}, want "
                                 f"{JAX_BASELINE_MAD0}")
        if not rel <= BASELINE_RTOL:
            raise AssertionError(f"baseline {gplvm_type}: row 0's objective {r['objective'][0]} "
                                 f"against the JAX artifact's {jax_row0}: rel {rel:.3e}")
        if not (np.isfinite(r["objective"]).all() and r["objective"][1] > r["objective"][0]
                and r["mad"][1] < r["mad"][0] and np.isfinite(r["true_x_objective"])):
            raise AssertionError(f"baseline {gplvm_type}: objective {r['objective']}, mad "
                                 f"{r['mad']}, trueX {r['true_x_objective']}")
        out[gplvm_type] = r
    for gplvm_type in ("bayesian", "basic"):
        r = run_baseline(SMALL_BASELINE_FLAGS + ["--gplvm_type", gplvm_type], torch)
        log(f"baseline {gplvm_type} (n = 2,000, 100 inducing points, host engine): "
            f"{r['evaluations']} evaluations, {r['ms_per_evaluation']:.2f} ms each ({smi}); "
            f"objective {r['objective'][0]:.2f} -> {r['objective'][1]:.2f} "
            f"({r['non_finite_rows']} non-finite rows); mad {r['mad'][0]:.8f} -> "
            f"{r['mad'][1]:.8f}")
        if not (np.isfinite(r["objective"]).all() and r["objective"][1] > r["objective"][0]):
            raise AssertionError(f"baseline {gplvm_type}: objective {r['objective']}")
        out[gplvm_type] = r
    for r in out.values():
        del r["dir"]
    return out


@contextlib.contextmanager
def counting_refine(module, torch):
    """Patch ``module.refine_f64`` to record its seconds and the kernel
    launches made inside it."""
    from gprf_torch.ops import mvn

    real = module.refine_f64
    tail = {}

    def counted(*args, **kw):
        torch.cuda.synchronize()
        before = dict(mvn.launch_counts)
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        tail.update(seconds=time.perf_counter() - t0,
                    launches={k: mvn.launch_counts[k] - before[k] for k in before})
        return out

    module.refine_f64 = counted
    try:
        yield tail
    finally:
        module.refine_f64 = real


def check_refined_log(what, d, iters, tail, smi):
    """The log of a run with a float64 tail: the tail's rows go on from the
    loop's, end no lower than its last, and the tail launched no kernel."""
    from gprf_torch.optim.driver import load_log

    with open(os.path.join(d, "log.txt")) as f:
        lines = f.read().splitlines()
    ends = [i for i, ln in enumerate(lines) if ln.startswith("optimization finished")]
    if len(ends) != 1 or not lines[-1].startswith("f64 refinement finished after"):
        raise AssertionError(f"{what}: log.txt ends {lines[-3:]}")
    steps, _, values = load_log(d)
    n32 = sum(1 for ln in lines[:ends[0]] if ln[:1].isdigit())
    ms = tail["seconds"] / iters * 1e3
    log(f"{what}: {n32} float32 iterations, objective {values[0]:.2f} -> {values[n32 - 1]:.2f}; "
        f"{len(steps) - n32} float64 iterations, {values[n32]:.2f} -> {values[-1]:.2f} (best "
        f"{values[n32:].max():.2f}); the tail {tail['seconds']:.2f} s, {ms:.2f} ms a float64 "
        f"iteration ({smi}); launches inside the tail {tail['launches']}")
    if list(steps) != list(range(n32 + iters)) or not np.isfinite(values).all():
        raise AssertionError(f"{what}: steps {list(steps)}, values {values}")
    if values[-1] < values[n32 - 1] - REFINE_RTOL * abs(values[n32 - 1]):
        raise AssertionError(f"{what}: the float64 tail ends at {values[-1]}, below the float32 "
                             f"loop's {values[n32 - 1]}")
    if any(tail["launches"].values()):
        raise AssertionError(f"{what}: the float64 tail launched kernels {tail['launches']}")
    return dict(float32_iterations=n32, float64_iterations=len(steps) - n32,
                objective=[float(values[0]), float(values[n32 - 1]), float(values[-1])],
                tail_seconds=tail["seconds"], ms_per_float64_iteration=ms,
                tail_launches=tail["launches"])


def run_refine(base, smi, torch):
    """Phase 16, the command line: the flagship with a float64 tail, task x
    and xcov, on the cli phase's cached data."""
    from gprf_torch.cli import gprfopt

    rbase = os.path.join(base, "refine")
    shutil.copytree(os.path.join(base, "synthetic_datasets"),
                    os.path.join(rbase, "synthetic_datasets"))
    os.environ["GPRF_EXPERIMENTS"] = rbase
    out = {}
    for task in ("x", "xcov"):
        argv = CLI_FLAGS[:-1] + [task, "--engine", "device", "--max_iters",
                                 str(REFINE_F32_ITERS), "--refine_iters", str(REFINE_ITERS)]
        d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
        with counting_refine(gprfopt, torch) as tail, contextlib.redirect_stdout(sys.stderr):
            gprfopt.main(argv)
        out[task] = check_refined_log(f"refine, cli flagship task {task}", d, REFINE_ITERS, tail,
                                      smi)
        if task == "xcov":
            with open(os.path.join(d, "covs.txt")) as f:
                cov_steps = [int(r.split()[0]) for r in f.read().replace("\n ", " ").splitlines()]
            last = REFINE_F32_ITERS + REFINE_ITERS - 1
            if cov_steps[-1] != last or cov_steps != sorted(cov_steps):
                raise AssertionError(f"refine, xcov: covs.txt rows at {cov_steps}")
            out[task]["covs_rows"] = len(cov_steps)
    return out


def run_refine_seismic(base, data, smi, torch):
    """Phase 16, the seismic command with a float64 tail, on phase 12's data."""
    from gprf_torch.cli import run_seismic

    os.environ["SEISMIC_EXPERIMENTS"] = os.path.join(base, "refine")
    argv = SEISMIC_FLAGS + ["--data_dir", data, "--engine", "device", "--max_iters", "20",
                            "--refine_iters", str(SEISMIC_REFINE_ITERS)]
    d = run_seismic.seismic_exp_dir(run_seismic.build_parser().parse_args(argv))
    with counting_refine(run_seismic, torch) as tail, contextlib.redirect_stdout(sys.stderr):
        run_seismic.main(argv)
    return check_refined_log("refine, seismic xcov", d, SEISMIC_REFINE_ITERS, tail, smi)


def run_refine_wide(base, eighty_dir, smi, torch):
    """Phase 16 at m = 888, from the 80k phase's final X: the default cap
    skips the tail, GPRF_REFINE_MAX_M=1024 runs it 2 steps a dispatch."""
    import io

    from gprf_torch.data.sampled import sample_data
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.ops import mvn
    from gprf_torch.optim.driver import load_log
    from gprf_torch.optim.lbfgs import refine_f64
    from gprf_torch.partition.grid import grid_centers

    os.environ["GPRF_EXPERIMENTS"] = base
    os.environ["GPRF_SAMPLER"] = EIGHTY_SAMPLER
    data = sample_data(centers=grid_centers(NBLOCKS), **EIGHTY_DATA)  # from the 80k phase's cache
    x = np.load(os.path.join(eighty_dir, "step_%05d_X.npy" % (EIGHTY_ITERS - 1))).reshape(-1)

    def make_fused(dtype):
        return FusedSyntheticGPRF(data.X_obs, data.SY, data.neighbors, data.X_obs, data.obs_std,
                                  data.cov, data.noise_var, task="x",
                                  centers=np.asarray(data.centers), device="cuda", dtype=dtype,
                                  acc_dtype=torch.float64, ops=mvn.LINALG_OPS)

    m = make_fused(torch.float64).m
    d = os.path.join(base, "refine_wide")
    os.makedirs(d)
    saved = os.environ.pop("GPRF_REFINE_MAX_M", None)
    try:
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            skipped = refine_f64(d, make_fused, x, EIGHTY_ITERS, iters=4)
        if not ("exceeds the cap 512; skipping the f64 phase" in said.getvalue()
                and np.array_equal(skipped, x) and os.listdir(d) == []):
            raise AssertionError(f"80k refine under the default cap: {said.getvalue()!r}")
        os.environ["GPRF_REFINE_MAX_M"] = "1024"
        torch.cuda.synchronize()
        mvn.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            refine_f64(d, make_fused, x, EIGHTY_ITERS, iters=4)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.environ.pop("GPRF_REFINE_MAX_M", None)
        if saved is not None:
            os.environ["GPRF_REFINE_MAX_M"] = saved
    launches = dict(mvn.launch_counts)
    steps, _, values = load_log(d)
    ckpts = sorted(f for f in os.listdir(d) if f.endswith("_X.npy"))
    want = ["step_%05d_X.npy" % (EIGHTY_ITERS + k) for k in (1, 3)]
    log(f"refine at 80k (m = {m}): skipped under the default cap with "
        f"its message; with GPRF_REFINE_MAX_M=1024 steps {list(steps)}, checkpoints {ckpts}, "
        f"objective {values[0]:.2f} -> {values[-1]:.2f}; {seconds:.2f} s, "
        f"{seconds / 4 * 1e3:.1f} ms a float64 iteration with its first evaluation ({smi}); "
        f"launches {launches}")
    if list(steps) != list(range(EIGHTY_ITERS, EIGHTY_ITERS + 4)) or ckpts != want:
        raise AssertionError(f"80k refine: steps {list(steps)}, checkpoints {ckpts}")
    if any(launches.values()) or not np.isfinite(values).all():
        raise AssertionError(f"80k refine: launches {launches}, values {values}")
    return dict(m=m, steps=len(steps), seconds=seconds, ms_per_float64_iteration=seconds / 4 * 1e3,
                objective=[float(values[0]), float(values[-1])])


def main():
    import torch

    t_start = time.perf_counter()
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
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = kernel_cases(gen, torch, dev)
    report = check_kernels(fused, x_flat, cases, gen, torch)
    x0 = torch.as_tensor(x_flat, dtype=fused.dtype, device=fused.device)
    routes = check_routes(fused, x0, torch)
    for route in ROUTES:
        routes[route].update(run_lbfgs(fused, x0, route, torch))
    for name, route in KERNEL_ROUTE.items():
        report[name]["launches"] = routes[route]["launches"][name]
    multistart = check_multistart(fused, x_flat, torch)
    flagship_edges = int(fused.edges.shape[0])
    del fused

    experiments = {k: os.environ.get(k) for k in ("GPRF_EXPERIMENTS", "SEISMIC_EXPERIMENTS",
                                                  "GPRF_SAMPLER")}
    try:
        with tempfile.TemporaryDirectory() as base, tempfile.TemporaryDirectory() as host_base:
            cli, data = run_cli(base, cases, torch)
            predict = run_predict(cli["dir"], data, cases, torch)
            kernelized = run_kernelized(data, cli, cases, torch)
            tools = run_tools(base, cli, data, torch)
            rpc = run_rpc(base, cases, torch)
            host = run_host(host_base, data, cases, torch)
            resume = run_resume(host_base, data, torch)
            baselines = run_baselines(base, smi, torch)
            refine = run_refine(base, smi, torch)
        with tempfile.TemporaryDirectory() as base:
            seismic, seismic_data = run_seismic_device(base, cases, torch)
            seismic_host = run_seismic_host(base, seismic_data, torch)
            sparse = run_sparse(base, seismic_data, torch)
            refine["seismic"] = run_refine_seismic(base, seismic_data, smi, torch)
        with tempfile.TemporaryDirectory() as base:
            eighty = run_eighty(base, cases, torch)
            refine["eighty"] = run_refine_wide(base, eighty.pop("dir"), smi, torch)
    finally:  # the phases pointed them at directories that are gone now
        for k, v in experiments.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name in report:
        report[name]["cli_launches"] = cli["launches"][name]
        report[name]["seismic_launches"] = seismic["launches"][name]
        report[name]["rpc_launches"] = rpc["launches"][name]
        report[name]["predict_launches"] = predict["launches"][name]
        report[name]["eighty_launches"] = eighty["launches"][name]
        report[name]["kernelized_launches"] = kernelized["launches"][name]
        if name in cli["kernels"]:  # the same kernel at the command line's, RPC, seismic and 80k shapes
            report[name]["cli"] = cli["kernels"][name]
            report[name]["rpc"] = rpc["kernels"][name]
            report[name]["seismic"] = {r: seismic[r]["kernels"][name] for r in SEISMIC_R}
            report[name]["eighty"] = eighty["kernels"][name]
    report["cholesky"]["predict"] = predict.pop("block_caches_kernel")
    report["chol_inv"]["kernelized"] = kernelized.pop("kernels")
    del rpc["kernels"], eighty["kernels"]
    for r in SEISMIC_R:
        del seismic[r]["kernels"]

    log(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({
        "kernels": list(report.values()),
        "slice": {"n": N, "blocks": NBLOCKS, "m": M0, "edges": flagship_edges, "dy": DY,
                  "routes": routes,
                  "cli": cli, "predict": predict, "rpc": rpc, "host": host, "resume": resume,
                  "multistart": multistart, "seismic": seismic, "seismic_host": seismic_host,
                  "eighty": eighty, "baselines": baselines, "refine": refine,
                  "kernelized": kernelized, "tools": tools, "sparse": sparse},
    }))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
