"""The benchmark's exact-GP cell (``gprfbench/configs/fullgp10k.py``, loaded
by path): its plain reference against gprf_torch's device engine in one
block with no edges, float64 on the CPU at 1,000 points, where the unary
pass runs ``chol_inv_split`` three levels deep at the kernels' caps
(1000 -> 504 -> 256 -> 128); the same reference against the joint form of
``gprfbench/reference.py``; the split's leaf count, as ``counters.json``
reads K1's launches; and the cell's check against the TF32 control and the
planted faults (no JAX)."""

import contextlib
import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.fused import FusedSyntheticGPRF
from gprf_torch.ops._build import launch_counts
from gprf_torch.ops.mvn import PLAIN_OPS
from gprf_torch.optim import lbfgs

from gprfbench import check, faults, jobs, spec
from gprfbench import data as bdata
from gprfbench import reference as joint
from gprfbench.trace import Tracer

torch.set_num_threads(1)
CELL = "fullgp10k.device_fit"
REF = spec.load_module(spec.HERE / "configs" / "fullgp10k.py", "fullgp10k_reference")
CPU = torch.device("cpu")
SEED = 2**31 + 91
N, DY = 1000, 5
LEAVES = 8  # 1000 -> 504 + 496 -> four of 256 or 248 -> eight of 120-128


def small_config(n=N, dy=DY):
    config = copy.deepcopy(spec.load_cell(CELL).config)
    config.update(ntrain=n, yd=dy)
    return config


@pytest.fixture(scope="module")
def problem():
    return REF.make_problem(small_config(), 1.0, SEED, CPU)


def _counting(ops=PLAIN_OPS):
    """``ops`` whose chol_inv counts its calls among the launches, as K1's
    wrapper counts its launches on the card."""
    def chol_inv(K):
        launch_counts["chol_inv"] += 1
        return ops.chol_inv(K)
    return ops._replace(chol_inv=chol_inv)


def _engine(problem, X_obs, dtype=torch.float64, ops=PLAIN_OPS):
    cfg = problem.config
    cov = GPCov.create([cfg["signal_var"]], [cfg["lscale"]] * cfg["dx"], "euclidean", "se",
                       device="cpu", dtype=torch.float64)
    return FusedSyntheticGPRF(X_obs, problem.Y, problem.edges, X_obs, cfg["obs_std"], cov,
                              cfg["noise_var"], task="x", centers=problem.centers,
                              device="cpu", dtype=dtype, acc_dtype=torch.float64, ops=ops)


def _point(X_obs):
    return X_obs + np.random.default_rng(1).normal(size=X_obs.shape) * 0.005


def test_loss_and_gradient_match_the_reference(problem):
    X_obs = problem.x_obs(bdata.JOB, 0)
    fused = _engine(problem, X_obs, ops=_counting())
    assert fused.n_blocks == 1 and fused.m == N and len(problem.edges) == 0
    X = _point(X_obs)
    theta = torch.as_tensor(X.reshape(-1)).requires_grad_(True)
    leaves = launch_counts["chol_inv"]
    v = fused.loss_fn()(theta)
    assert launch_counts["chol_inv"] - leaves == LEAVES
    (g,) = torch.autograd.grad(v, theta)
    ref = problem.ref_loss(X, X_obs, grad=True)
    # both in float64: the split's products against one dense factor
    np.testing.assert_allclose(float(v.detach()), ref.value, rtol=1e-10)
    gap = float(torch.linalg.vector_norm(g - ref.grad) / torch.linalg.vector_norm(ref.grad))
    assert gap < 1e-8, gap


def test_the_reference_matches_the_joint_form(problem):
    """One term of weight 1 in ``reference.py``'s loop, its gradient in
    closed form, against the exact GP's autograd."""
    X_obs = problem.x_obs(bdata.JOB, 1)
    X = _point(X_obs)
    cfg = problem.config
    ref = problem.ref_loss(X, X_obs, grad=True)
    one = joint.loss(torch.as_tensor(X), problem.Y_dev, X_obs, cfg["obs_std"],
                     torch.as_tensor(problem.centers), torch.as_tensor(problem.edges),
                     joint.Kernel(cfg["lscale"], cfg["signal_var"], cfg["noise_var"]),
                     grad=True)
    assert abs(one.value - ref.value) <= 1e-12 * abs(ref.value)
    assert float(torch.linalg.vector_norm(one.grad - ref.grad)) <= 1e-12 * float(
        torch.linalg.vector_norm(ref.grad))
    assert abs(one.ll_grad_norm - ref.ll_grad_norm) <= 1e-12 * ref.ll_grad_norm


def test_split_leaves_of_a_short_fit(problem, tmp_path):
    """Every evaluation of a fit factors the one block once: the recursion's
    8 leaves each, one K1 launch a leaf in ``counters.json``."""
    X_obs = problem.x_obs(bdata.JOB, 2)
    lbfgs.do_optimization_fused(str(tmp_path), _engine(problem, X_obs, ops=_counting()), X_obs,
                                max_iters=4, steps_per_dispatch=2)
    c = _counters(tmp_path)
    assert c["evaluations"] == 5 and c["m_start"] == c["m_end"] == N
    assert c["launches"]["chol_inv"] == LEAVES * c["evaluations"]


def _counters(d):
    with open(os.path.join(d, "counters.json")) as f:
        return json.load(f)


def test_the_control_factors_with_tf32_products(problem):
    """The control's factor: the float32 factor where one leaf takes the
    block, and within TF32's reach of it past the leaf."""
    X = torch.as_tensor(problem.x_obs(bdata.JOB, 3), dtype=torch.float32)
    r2 = sum((X[:, None, k] - X[None, :, k]) ** 2 for k in range(2))
    K = torch.exp(-r2 / problem.config["lscale"] ** 2) + 0.01 * torch.eye(N)
    L = torch.linalg.cholesky(K)
    Lt = REF.cholesky_tf32(K)
    assert torch.equal(torch.triu(Lt, 1), torch.zeros_like(Lt))
    A = K[:REF.TF32_LEAF, :REF.TF32_LEAF]
    assert torch.equal(REF.cholesky_tf32(A), torch.linalg.cholesky(A))
    err = float((Lt - L).abs().max() / L.abs().max())
    assert 1e-6 < err < 1e-2, err


# ---- the check of the cell ------------------------------------------------------

CHECK_N = 600  # two levels: 600 -> 304 + 296 -> four leaves of 144-152


@pytest.fixture(scope="module")
def cell_problem():
    """The cell at 600 points, its lengthscale and observation noise scaled
    by sqrt(10,000 / 600) so that as many points fall within a lengthscale
    as at 10,000, and K is as ill-conditioned."""
    cell = spec.load_cell(CELL)
    config = small_config(CHECK_N, 50)
    scale = (cell.config["ntrain"] / CHECK_N) ** 0.5
    config.update(lscale=config["lscale"] * scale, obs_std=config["obs_std"] * scale)
    cell = dataclasses.replace(cell, config=config)
    return cell, REF.make_problem(cell.config, 1.0, SEED, CPU)


def _fit_window(cell, problem, root, fault=None):
    """One whole fit of 40 steps on the cell's engine (float32), with
    ``fault`` planted underneath: no wall-clock window."""
    engine = jobs.make_engine(cell, problem, CPU)
    job = jobs.Job(0, problem.x_obs(bdata.JOB, 0), os.path.join(root, "job000"))
    os.makedirs(job.dir)
    loop = dict(cell.traffic["loop"], max_iters=40)
    with faults.planted(fault) if fault else contextlib.nullcontext():
        engine.fit(job, maxsec=1e9, tracer=Tracer(False, 0, CPU), loop=loop)
    job.completed = True
    return engine, jobs.Window(0.0, 1.0, [job], [])


@pytest.mark.parametrize("fault", [None, "control", "state_unchanged", "answer_altered",
                                   "half_the_batch"])
def test_the_check_fails_the_control_and_each_fault(cell_problem, tmp_path, fault):
    """The program passes the cell's limits; the TF32 control and each fault
    fail them (``half_the_batch`` doubles the one block's unary term)."""
    cell, problem = cell_problem
    planted = None if fault in (None, "control") else fault
    engine, window = _fit_window(cell, problem, str(tmp_path), planted)
    values = check.readings(problem, engine, window, control=fault == "control")
    # the cell's own limits; the control reads no progress and is judged on
    # the gaps
    limits = dict(cell.limits)
    if fault == "control":
        del limits["progress"]
    ok, checks = check.judge(values, limits)
    assert ok == (fault is None), checks


# ---- the cell's two new per-layer metrics ------------------------------------------

class _Event:
    """A kineto event's reader methods over fixed values."""

    def __init__(self, name, start, dur, device=False, corr=0, linked=0):
        self._v = dict(name=name, start_ns=start, duration_ns=dur, correlation_id=corr,
                       linked_correlation_id=linked,
                       device_type=torch.autograd.DeviceType.CUDA if device
                       else torch.autograd.DeviceType.CPU)

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_factor_busy_places_kernels_by_their_launch():
    """A kernel counts where its launch (the runtime call of its correlation
    id, else its operator's start) lies inside a span, whenever it runs."""
    reader = spec.load_module(spec.HERE / "metrics" / "factor_busy_ms.py", "factor_busy_ms")
    events = [
        _Event("aten::mm", 100, 50, corr=7),
        _Event("cudaLaunchKernel", 110, 5, corr=1001, linked=7),
        _Event("gemm", 400, 30, device=True, corr=1001, linked=7),  # launched inside, runs after
        _Event("aten::cat", 150, 20, corr=8),
        _Event("cat_kernel", 430, 4, device=True, corr=1002, linked=8),  # no runtime call seen
        _Event("cudaLaunchKernel", 300, 5, corr=1003, linked=9),
        _Event("other", 310, 9, device=True, corr=1003, linked=9),  # launched outside
        _Event("Memset (Device)", 120, 2, device=True, corr=1004, linked=7),  # not a kernel
    ]
    assert reader.factor_device_ns(events, [(90, 200)]) == 34
    assert reader.factor_device_ns(events, [(250, 320), (90, 105)]) == 9
    assert reader.factor_device_ns(events, []) == 0


def test_split_leaves_per_eval_reads_the_fits_counters(tmp_path):
    reader = spec.load_module(spec.HERE / "metrics" / "split_leaves_per_eval.py",
                              "split_leaves_per_eval")
    jobs_ = []
    for k, counters in enumerate([{"evaluations": 10, "launches": {"chol_inv": 640}},
                                  {"evaluations": 5, "launches": {"chol_inv": 320}}, None]):
        d = tmp_path / str(k)
        d.mkdir()
        if counters is not None:
            (d / "counters.json").write_text(json.dumps(counters))
        jobs_.append(jobs.Job(k, None, str(d)))
    ctx = type("Ctx", (), {"window": jobs.Window(0.0, 1.0, jobs_, [])})
    assert reader.read(ctx) == 64.0
    ctx.window = jobs.Window(0.0, 1.0, jobs_[2:], [])
    assert reader.read(ctx) is None
