"""gprf_torch's multistart against gprf_tpu's, float64 on the CPU: the
replica-batched runner against the reference's vmapped one, on a quartic
and on the fused losses (the replicas folded into one kernel batch), the
multistart drivers and their ``multistart.txt``, the restart of a diverged
replica, a capacity growth across a dispatch with per-replica flags, the
batched capacity checks and ``--multistart`` on the synthetic command
line."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.cli import gprfopt as jcli
from gprf_tpu.data.sampled import SampledData as JSampled
from gprf_tpu.data.seismic import make_synthetic_catalog
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model import fused as jfused
from gprf_tpu.model.fused_seismic import FusedSeismicGPRF as JSeismic
from gprf_tpu.optim import device_lbfgs as jlbfgs
from gprf_tpu.partition import pdtree as jpdtree
from gprf_tpu.partition.grid import grid_centers
from gprf_torch.cli import gprfopt as tcli
from gprf_torch.data.sampled import SampledData as TSampled
from gprf_torch.model import fused as tfused
from gprf_torch.model.fused_seismic import FusedSeismicGPRF as TSeismic
from gprf_torch.model.gprf import GPRF as TGPRF
from gprf_torch.optim import lbfgs as tlbfgs
from gprf_torch.partition import pdtree as tpdtree
from gprf_torch.utils.convert import cov_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6
LOG_ATOL = 0.011  # log.txt and multistart.txt keep two decimals
STEPS = 5  # L-BFGS steps per dispatch
R = 3


@pytest.fixture(scope="module")
def data():
    """(port dataset, reference dataset): n 240, 9 grid blocks, dy 3."""
    kw = dict(n=260, ntrain=240, lscale=0.15, obs_std=0.02, yd=3, seed=5, noise_var=0.01)
    t, j = TSampled(**kw), JSampled(**kw)
    t.SY = j.SY.copy()
    for s in (t, j):
        s.set_centers(grid_centers(9))
    return t, j


def _synthetic(data, task="x", m=None):
    t, j = data
    C0 = {"x": None, "xcov": np.array([[0.12]])}[task]
    args = (t.X_obs, j.SY, t.neighbors, t.X_obs, t.obs_std)
    kw = dict(task=task, C0=C0, centers=np.asarray(t.centers), m=m)
    return (tfused.FusedSyntheticGPRF(*args, t.cov, t.noise_var, **kw, **F64),
            jfused.FusedSyntheticGPRF(*args, j.cov, j.noise_var, **kw))


@pytest.fixture(scope="module")
def seismic():
    """(port engine, reference engine, theta0): 200 events, 8 PD-tree
    blocks, task xcov."""
    cat = make_synthetic_catalog(n=200, seed=3)
    X_true = cat[:, (2, 3, 7)]
    prior_std = 20.0 * np.array([0.01, 0.01, 1.0])
    rng = np.random.default_rng(4)
    means = X_true + rng.standard_normal(X_true.shape) * prior_std
    Y = rng.standard_normal((200, 4))
    X2 = means[:, :2].copy()
    X2[:, 0] = jpdtree.wrap_lon(X2[:, 0])
    trees = tpdtree.PDTree(X2, 30), jpdtree.PDTree(X2, 30)
    tcov = cov_from_numpy([1.0], [40.0, 40.0], "lld", "matern32", **F64)
    jcov = JCov.create([1.0], [40.0, 40.0], "lld", "matern32")
    edges = TGPRF(means, Y, None, tcov, 0.1, block_idxs=trees[0].leaf_idx(),
                  neighbor_threshold=0.3, **F64).neighbors
    rest = (edges, means, prior_std)
    tf = TSeismic(means, Y, trees[0], *rest, tcov, 0.1, task="xcov", **F64)
    jf = JSeismic(means, Y, trees[1], *rest, jcov, 0.1, task="xcov", dtype=jnp.float64)
    return tf, jf, tf.theta0(means, np.array([[0.12, 1.0, 35.0, 50.0]]))


def _starts(theta0, scale, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([theta0] + [theta0 + rng.standard_normal(theta0.shape) * scale
                                for _ in range(R - 1)])


def _quartic_t(x):
    return torch.sum((x - 1.0) ** 2, dim=-1) + 0.5 * torch.sum(x**4, dim=-1)


def _quartic_j(x):
    return jnp.sum((x - 1.0) ** 2) + 0.5 * jnp.sum(x**4)


# ---- the runner -----------------------------------------------------------------


def test_multistart_runner_matches_jax_and_single_runs(rng):
    """The value matrix [R, steps] and the carry against the reference's
    vmapped runner, and each replica against the port's single-start
    runner from the same start."""
    x0s = rng.normal(size=(R, 12))
    init_b, run_b = tlbfgs.make_multistart_runner(_quartic_t, num_steps=8)
    carry, (vals, acc, gn) = run_b(init_b(torch.as_tensor(x0s)))
    j_init, j_run = jlbfgs.make_multistart_runner(_quartic_j, num_steps=8)
    j_carry, (j_vals, j_acc, _) = j_run(j_init(jnp.asarray(x0s)))
    assert vals.shape == acc.shape == gn.shape == (R, 8)
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=RTOL)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    for k in ("x", "x_prev", "S", "Ymem", "rho", "eta"):
        np.testing.assert_allclose(carry[k].numpy(), np.asarray(j_carry[k]), rtol=RTOL,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(carry["head"].numpy(), np.asarray(j_carry["head"]))
    init_s, run_s = tlbfgs.make_scan_lbfgs_runner(_quartic_t, num_steps=8)
    for r in range(R):
        one, (v1, _, _) = run_s(init_s(torch.as_tensor(x0s[r])))
        np.testing.assert_allclose(v1.numpy(), vals[r].numpy(), rtol=1e-12)
        np.testing.assert_allclose(one["x"].numpy(), carry["x"][r].numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("engine", ["synthetic", "seismic"])
def test_multistart_runner_on_a_fused_loss_matches_jax(data, seismic, engine):
    """R replicas of a fused loss, folded into one objective batch, against
    the reference's vmapped runner: the value matrix and the overflow
    flags [R]."""
    if engine == "synthetic":
        tf, jf = _synthetic(data)
        theta0s = _starts(tf.theta0(), 0.02)
    else:
        tf, jf, theta0 = seismic
        theta0s = _starts(theta0, 0.01)
    init_t, run_t = tlbfgs.make_multistart_runner(tf.loss_fn(), STEPS, aux_fn=tf.overflow_fn())
    init_j, run_j = jlbfgs.make_multistart_runner(jf.loss_fn(), STEPS, aux_fn=jf.overflow_fn())
    ct, (vt, _, _, ot) = run_t(init_t(torch.as_tensor(theta0s)))
    cj, (vj, _, _, oj) = run_j(init_j(jnp.asarray(theta0s)))
    assert vt.shape == (R, STEPS) and ot.shape == (R,)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=RTOL)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(ct["x_prev"].numpy(), np.asarray(cj["x_prev"]), rtol=RTOL,
                               atol=1e-9)


# ---- the drivers ----------------------------------------------------------------


def _rows(path):
    with open(path) as f:
        return [[float(v) for v in line.split()] for line in f if line[0].isdigit()]


def _dirs(tmp_path):
    out = []
    for k in ("torch", "jax"):
        d = tmp_path / k
        d.mkdir()
        out.append(str(d))
    return out


def _assert_same_run(dt, dj, iters):
    for name in ("log.txt", "multistart.txt"):
        t, j = np.array(_rows(os.path.join(dt, name))), np.array(_rows(os.path.join(dj, name)))
        assert t.shape == j.shape and t.shape[0] == iters
        np.testing.assert_array_equal(t[:, 0], np.arange(iters))
        np.testing.assert_allclose(t[:, 2:], j[:, 2:], rtol=RTOL, atol=LOG_ATOL)
    # checkpoints between the first and the last dispatch ride a wall-clock
    # cadence, so each run may hold others; the ones both hold agree
    last = "step_%05d_X.npy" % (iters - 1)
    ours, theirs = set(os.listdir(dt)), set(os.listdir(dj))
    assert last in ours & theirs
    # the port's run directory also holds the fit's counters
    assert {f for f in ours ^ theirs if not f.startswith("step_")} == {"counters.json"}
    for name in ours & theirs:
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(os.path.join(dt, name)),
                                       np.load(os.path.join(dj, name)), rtol=RTOL, atol=1e-9)


def test_do_optimization_multistart_matches_jax(tmp_path, data):
    tf, jf = _synthetic(data)
    X0s = _starts(tf.theta0(), 0.02).reshape(R, *tf.shape)
    dt, dj = _dirs(tmp_path)
    kw = dict(max_iters=2 * STEPS, steps_per_dispatch=STEPS)
    bx, bv, fv = tlbfgs.do_optimization_multistart(dt, tf, X0s, **kw)
    jx, jv, jfv = jlbfgs.do_optimization_multistart(dj, jf, X0s, **kw)
    _assert_same_run(dt, dj, 2 * STEPS)
    np.testing.assert_allclose(fv, np.asarray(jfv), rtol=RTOL)
    assert bv == fv.min() and bx.shape == (X0s[0].size,)
    np.testing.assert_allclose(bx, np.asarray(jx).reshape(-1), rtol=RTOL, atol=1e-9)
    assert not os.path.exists(os.path.join(dt, "covs.txt"))
    with open(os.path.join(dt, "multistart.txt")) as f:
        assert all(len(r.split()) == 2 + R for r in f)


@pytest.mark.parametrize("engine", ["synthetic", "seismic"])
def test_do_optimization_multistart_theta_matches_jax(tmp_path, data, seismic, engine):
    if engine == "synthetic":
        tf, jf = _synthetic(data, "xcov")
        theta0s = _starts(tf.theta0(), 0.02)
    else:
        tf, jf, theta0 = seismic
        theta0s = _starts(theta0, 0.01)
    dt, dj = _dirs(tmp_path)
    kw = dict(max_iters=2 * STEPS, steps_per_dispatch=STEPS)
    bt, bv, fv = tlbfgs.do_optimization_multistart_theta(dt, tf, theta0s, **kw)
    jt, _, jfv = jlbfgs.do_optimization_multistart_theta(dj, jf, theta0s, **kw)
    _assert_same_run(dt, dj, 2 * STEPS)
    np.testing.assert_allclose(fv, np.asarray(jfv), rtol=RTOL)
    np.testing.assert_allclose(bt, np.asarray(jt), rtol=RTOL, atol=1e-9)
    with open(os.path.join(dt, "covs.txt")) as f:
        rows = f.read().replace("\n ", " ").splitlines()
    with open(os.path.join(dj, "covs.txt")) as f:
        assert [r.split()[0] for r in rows] == [r.split()[0] for r in f.read().replace(
            "\n ", " ").splitlines()] == [str(STEPS - 1), str(2 * STEPS - 1)]


def test_sanitize_replicas_restarts_a_diverged_replica_as_jax_does(rng):
    init_b, run_b = tlbfgs.make_multistart_runner(_quartic_t, num_steps=3)
    carry, _ = run_b(init_b(torch.as_tensor(rng.normal(size=(2, 6)))))
    poisoned = {k: v.clone() for k, v in carry.items()}
    poisoned["x"][1] = float("nan")
    poisoned["v"][1] = float("nan")
    fixed, n = tlbfgs._sanitize_replicas(poisoned)
    ref, n_ref = jlbfgs._sanitize_replicas({k: jnp.asarray(v.numpy())
                                            for k, v in poisoned.items()})
    assert n == n_ref == 1
    for k in fixed:
        assert fixed[k].dtype == carry[k].dtype, k
        np.testing.assert_array_equal(fixed[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert torch.equal(fixed["x"][0], carry["x"][0]) and torch.equal(fixed["x"][1],
                                                                      carry["x_prev"][1])
    assert bool(fixed["first"][1]) and not fixed["valid"][1].any() and fixed["v"][1] == np.inf
    same, none = tlbfgs._sanitize_replicas(carry)
    assert none == 0 and same is carry
    for k in ("x", "x_prev", "v"):
        poisoned[k][0] = float("nan")
    with pytest.raises(FloatingPointError):
        tlbfgs._sanitize_replicas(poisoned)
    # the restarted replica goes on, and reaches the others' basin
    carry, (vals, _, _) = run_b(fixed)
    assert torch.isfinite(vals[:, -1]).all() and torch.isfinite(carry["x"]).all()


def test_multistart_grows_across_a_dispatch_with_per_replica_flags(tmp_path, data):
    """A capacity one notch too small: the overflow flags are per replica,
    every replica grows together by 16 and keeps its memory, and the run
    goes on as the reference's does."""
    m_fit = _synthetic(data)[0].m
    tf, jf = _synthetic(data, m=m_fit - 8)
    theta0 = tf.theta0()
    far = _starts(theta0, 0.02)
    flags = tf.overflow_fn()(torch.as_tensor(far))
    assert flags.shape == (R,) and flags.any()
    for r in range(R):
        assert bool(flags[r]) == bool(jf.overflow_fn()(jnp.asarray(far[r])))
    assert bool(tf.check_capacity_batch(far)) == bool(jf.check_capacity_batch(far)) is False
    dt, dj = _dirs(tmp_path)
    kw = dict(max_iters=3 * STEPS, steps_per_dispatch=STEPS)
    tlbfgs.do_optimization_multistart_theta(dt, tf, far, **kw)
    jlbfgs.do_optimization_multistart_theta(dj, jf, far, **kw)
    assert tf.m == jf.m == m_fit + 8
    _assert_same_run(dt, dj, 3 * STEPS)
    runner = tlbfgs.GrowingRunner(tf, STEPS)
    carry, _ = runner.run_fn(runner.init_fn(torch.as_tensor(far)))
    grown = runner.grow(carry, at="x_prev")
    for k in tlbfgs.GrowingRunner.KEPT:
        assert torch.equal(grown[k], carry[k]), k
    assert torch.equal(grown["x"], carry["x_prev"]) and grown["first"].all()


def test_check_capacity_all_matches_jax(data):
    tf, jf = _synthetic(data)
    thetas = _starts(tf.theta0(), 0.02)
    assert tlbfgs._check_capacity_all(tf, thetas) == jlbfgs._check_capacity_all(jf, thetas)

    class Single:  # an evaluator without the batched check
        check_capacity = tf.check_capacity

    assert tlbfgs._check_capacity_all(Single(), thetas) == tf.check_capacity_batch(thetas)


# ---- the synthetic command line -------------------------------------------------------


@pytest.mark.parametrize("task", ["x", "xcov"])
def test_gprfopt_multistart_matches_jax(tmp_path, monkeypatch, task):
    """``--multistart 3`` on the device engine: the replicas' starts, the
    winner's log and the multistart matrix match the reference's run in
    float64."""
    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))

    class Float64Fused(jfused.FusedSyntheticGPRF):
        def __init__(self, *args, dtype=None, **kw):
            super().__init__(*args, dtype=jnp.float64, **kw)

    monkeypatch.setattr(jfused, "FusedSyntheticGPRF", Float64Fused)
    dt, dj = _dirs(tmp_path)
    args = dict(lscale=0.1, n=450, ntrain=400, nblocks=9, yd=4, local_dist=0.1, engine="device",
                task=task, max_iters=2 * STEPS * 4, multistart=R)
    tcli.do_run(dt, device="cpu", dtype=torch.float64, **args)
    jcli.do_run(dj, **args)
    iters = len(_rows(os.path.join(dj, "log.txt")))
    _assert_same_run(dt, dj, iters)
