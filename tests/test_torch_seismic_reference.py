"""The plain reference of the benchmark's seismic cell
(``gprfbench/configs/seismic12k.py``, loaded by path) against gprf_torch's
seismic engine, float64 on the CPU at about 300 events and 8 PD-tree
blocks, and the cell's correctness check against a planted triple and the
planted faults (no JAX)."""

import contextlib
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from gprf_torch.cli import run_seismic
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.fused_seismic import FusedSeismicGPRF
from gprf_torch.model.gprf import GPRF
from gprf_torch.ops.mvn import KERNEL_OPS, PLAIN_OPS
from gprf_torch.partition.pdtree import PDTree, wrap_lon

from gprfbench import check, faults, jobs, spec
from gprfbench import data as bdata
from gprfbench.trace import Tracer

torch.set_num_threads(1)
CELL = "seismic12k.multistart4"
REF = spec.load_module(spec.HERE / "configs" / "seismic12k.py", "seismic12k_reference")
MIX = spec.load_module(spec.HERE / "traffic" / "multistart4.py", "multistart4_mix")
CPU = torch.device("cpu")
N, BLOCKSIZE, LSCALE, DY = 300, 40, 150.0, 5  # 8 blocks; a wide lengthscale for edges
SEED = 2**31 + 77


def tiny_config(catalog_seed=0):
    config = copy.deepcopy(spec.load_cell(CELL).config)
    config.update(n=N, rpc_blocksize=BLOCKSIZE, synth_lscale=LSCALE, dy=DY)
    config["assumed"] = dict(config["assumed"], catalog_seed=catalog_seed)
    return config


def _setup(catalog_seed=3, seed=5):
    """A seeded catalog, Y, the observed locations, the reference's fit and
    the program's engine over the same tree, in float64."""
    config = tiny_config(catalog_seed)
    X_true = REF.make_catalog(N, catalog_seed)[:, [REF.COL_LON, REF.COL_LAT, REF.COL_DEPTH]]
    g = torch.Generator().manual_seed(seed)
    Y = REF.draw_y(X_true, LSCALE, config["noise_var"], DY, g)
    X_obs = X_true + np.random.default_rng(seed).standard_normal(X_true.shape) * REF.prior_std(
        config)
    fit = REF.make_fit(X_obs, config, CPU)
    tree = PDTree(np.stack([wrap_lon(X_obs[:, 0]), X_obs[:, 1]], axis=1), BLOCKSIZE)
    cov = GPCov.create([1.0], [LSCALE, LSCALE], "lld", "matern32", device="cpu",
                       dtype=torch.float64)
    return config, Y, fit, tree, cov


def _engine(config, Y, fit, tree, cov, task, ops=PLAIN_OPS, dtype=torch.float64):
    return FusedSeismicGPRF(fit.X_obs, Y.numpy(), tree, fit.edges, fit.X_obs,
                            REF.prior_std(config), cov, config["noise_var"], task=task,
                            device="cpu", dtype=dtype, acc_dtype=torch.float64, ops=ops)


def _theta(fused, fit, config, rng, cov_log=None):
    theta = fused.theta0(fit.X_obs, np.array([[0.1, 1.0, LSCALE, LSCALE]]))
    theta = theta + rng.normal(size=theta.shape) * 0.02
    if cov_log is not None:
        theta[-4:] = cov_log
    return theta


def _program(fused, theta):
    th = torch.as_tensor(theta).requires_grad_(True)
    v = fused.loss_fn()(th)
    (g,) = torch.autograd.grad(v.sum(), th)
    return v.detach().numpy(), g.numpy()


def _assert_matches(v, g, ref):
    # both in float64: the program's Schur algebra against dense Cholesky
    # factors differs by roundoff, ~1e-14 of the value and ~1e-12 of the
    # gradient; the tolerances leave two orders above that
    np.testing.assert_allclose(v, ref.value, rtol=1e-10)
    gap = np.linalg.norm(g - ref.grad.numpy()) / np.linalg.norm(ref.grad.numpy())
    assert gap < 1e-8, gap


@pytest.mark.parametrize("ops", [PLAIN_OPS, KERNEL_OPS], ids=["twins", "kernel_ops"])
@pytest.mark.parametrize("task", ["x", "xcov"])
def test_loss_and_gradient_match_the_reference(task, ops):
    config, Y, fit, tree, cov = _setup()
    fused = _engine(config, Y, fit, tree, cov, task, ops)
    assert fused.n_blocks == len(fit.tree.leaves) == 8 and len(fit.edges) > 0
    theta = _theta(fused, fit, config, np.random.default_rng(1))
    v, g = _program(fused, theta)
    _assert_matches(v, g, REF.loss(theta, Y, fit, config, task=task, grad=True))


def test_clamps_and_the_penalty_match_the_reference():
    """nv past its clamp at 10, l_z below 1 km, log l_h past 5 (the
    penalty): the clamped parameters take no likelihood gradient."""
    config, Y, fit, tree, cov = _setup()
    fused = _engine(config, Y, fit, tree, cov, "xcov")
    cov_log = np.log([20.0, 1.0, 160.0, 0.5])
    theta = _theta(fused, fit, config, np.random.default_rng(2), cov_log=cov_log)
    v, g = _program(fused, theta)
    ref = REF.loss(theta, Y, fit, config, task="xcov", grad=True)
    _assert_matches(v, g, ref)
    assert ref.value > REF.loss(theta, Y, fit, config, task="xcov", grad=False).value - 1e-9
    rc = (cov_log - np.array(REF.COV_PRIOR_MEANS)) / REF.COV_PRIOR_STD**2
    # only the prior pulls on the clamped nv and l_z
    np.testing.assert_allclose(g[[-4, -1]], rc[[0, 3]], rtol=1e-12)


def test_replicas_each_match_their_own_reference():
    config, Y, fit, tree, cov = _setup(catalog_seed=4, seed=6)
    fused = _engine(config, Y, fit, tree, cov, "xcov")
    rng = np.random.default_rng(3)
    thetas = np.stack([_theta(fused, fit, config, rng), _theta(fused, fit, config, rng)])
    v, g = _program(fused, thetas)
    assert v.shape == (2,)
    for r in range(2):
        _assert_matches(v[r], g[r], REF.loss(thetas[r], Y, fit, config, task="xcov", grad=True))


def test_the_edges_are_the_programs():
    """The reference's edge rule against the program's GPRF at float32 (the
    command line's build)."""
    for seed in (5, 8):
        config, Y, fit, tree, cov = _setup(seed=seed)
        cov32 = GPCov.create([1.0], [LSCALE, LSCALE], "lld", "matern32", device="cpu",
                             dtype=torch.float32)
        gprf = GPRF(fit.X_obs, Y.numpy(), None, cov32, config["noise_var"],
                    neighbor_threshold=config["threshold"], block_idxs=tree.leaf_idx(),
                    device="cpu", dtype=torch.float32)
        assert sorted(map(tuple, gprf.neighbors)) == sorted(fit.edges) and fit.edges
        for a, b in zip(tree.leaf_idx(), fit.tree.leaves):
            np.testing.assert_array_equal(a, b)


def test_a_point_on_a_split_plane_takes_the_programs_side():
    """One point moved across the root's split plane in float32 steps of its
    longitude: at each step the reference's float32 traversal puts it in the
    program's block, and the steps cover both sides."""
    config, Y, fit, tree, cov = _setup()
    fused = _engine(config, Y, fit, tree, cov, "xcov", dtype=torch.float32)
    vec, center, split = fit.tree.table[0, 0:2], fit.tree.table[0, 2:4], fit.tree.table[0, 4]
    # the point of the plane nearest event 0, at float32
    x2 = np.array([wrap_lon(fit.X_obs[0, 0]), fit.X_obs[0, 1]])
    on = x2 - ((x2 - center) @ vec - split) * vec
    lon0 = np.float32(on[0])
    sides = set()
    for k in range(-40, 41):
        lon = np.float32(lon0 + np.float32(k) * np.spacing(lon0))
        X = fit.X_obs.copy()
        X[0, :2] = [lon, on[1]]
        prog = fused._blocks(torch.as_tensor(X, dtype=torch.float32)[None])[0]
        ref = REF.traverse(fit.tree, torch.as_tensor(X))
        assert torch.equal(prog, ref), k
        sides.add(int(ref[0]) < len(fit.tree.leaves) // 2)
    assert sides == {True, False}


# ---- the check of the cell --------------------------------------------------------

def tiny_cell(max_iters=40):
    """The cell at the tiny configuration, fits of two dispatches."""
    cell = spec.load_cell(CELL)
    traffic = copy.deepcopy(cell.traffic)
    traffic["loop"]["max_iters"] = max_iters
    return dataclasses.replace(cell, config=tiny_config(), traffic=traffic)


@pytest.fixture(scope="module")
def cell_problem():
    cell = tiny_cell()
    return cell, bdata.make_problem(cell, SEED, CPU)


def test_the_check_fails_a_triple_from_two_replicas(cell_problem, tmp_path):
    """theta and gradient of replica 0 with the value of replica 1, at the
    starts of a fit: the honest triple's gaps pass, the planted one fails."""
    cell, problem = cell_problem
    job = jobs.Job(0, problem.x_obs(bdata.JOB, 0), str(tmp_path))
    js = problem.job_seed(bdata.JOB, 0)
    engine = MIX.make_engine(problem, cell.traffic, CPU)
    args = engine._args(js, problem.data_dir(str(tmp_path), js))
    p = run_seismic.build_problem(args, device="cpu", dtype=torch.float32)
    fused = run_seismic.build_engine(args, p, device="cpu", dtype=torch.float32)
    thetas = run_seismic.multistart_thetas(fused.theta0(p["X0"], p["C0"]), "xcov",
                                           p["means"].size, 2, js)
    v, g = _program(fused, torch.as_tensor(thetas, dtype=torch.float32))
    x = thetas[0].astype(np.float32).astype(np.float64)
    window = jobs.Window(0.0, 1.0, [job], [])

    class Planted:
        def __init__(self, value):
            self.value = value

        def last_state(self, _job):
            return x, self.value, g[0].astype(np.float64)

    _, checks = check.judge(check.readings(problem, Planted(float(v[0])), window), cell.limits)
    assert all(checks[k]["value"] <= cell.limits[k] for k in ("loss_gap", "grad_gap")), checks
    ok, checks = check.judge(check.readings(problem, Planted(float(v[1])), window), cell.limits)
    assert not ok and checks["loss_gap"]["value"] > cell.limits["loss_gap"]


FAULTS = dict(faults.FAULTS, half_the_batch_seismic=(
    "gprf_torch.model.fused_seismic", "gprf_ll_schur", faults._half_the_terms))


@pytest.mark.parametrize("fault", [None, "state_unchanged", "answer_altered",
                                   "half_the_batch_seismic"])
def test_the_check_fails_each_fault(cell_problem, tmp_path, monkeypatch, fault):
    """A short window of the cell's engine at this size, with each fault
    planted underneath: the program passes the limits, each fault fails
    them."""
    monkeypatch.setattr(faults, "FAULTS", FAULTS)
    cell, problem = cell_problem
    engine = MIX.make_engine(problem, cell.traffic, CPU)
    engine.warm_up(str(tmp_path))
    with faults.planted(fault) if fault else contextlib.nullcontext():
        window = jobs.run_window(engine, problem, 3.0, Tracer(False, 0, CPU), str(tmp_path))
    assert window.jobs and all(j.error is None for j in window.jobs)
    for j in window.jobs:
        assert os.path.exists(os.path.join(j.dir, "counters.json"))
    # progress is nats an observed value: a 40-iteration fit of 300 events
    # gains ~0.09 (0.55 at the cell's 12,000), so at this size it is held
    # at 0.05; the gaps at the cell's own limits
    limits = dict(cell.limits, progress=0.05)
    ok, checks = check.judge(check.readings(problem, engine, window), limits)
    assert ok == (fault is None), checks
