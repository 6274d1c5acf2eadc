"""gprf_torch's optimization drivers against gprf_tpu's on the same seeded
problems, float64 on the CPU: the scipy bridge do_optimization, the
device-loop drivers with a forced capacity growth, the optimizer-state
checkpoint and resuming from it."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.data.sampled import SampledData as JSampled
from gprf_tpu.model import fused as jfused
from gprf_tpu.optim import device_lbfgs as jlbfgs
from gprf_tpu.optim import driver as jdriver
from gprf_tpu.partition.grid import grid_centers
from gprf_torch.data.sampled import SampledData as TSampled
from gprf_torch.model import fused as tfused
from gprf_torch.optim import driver as tdriver
from gprf_torch.optim import lbfgs as tlbfgs
from gprf_torch.utils import convert

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6
# log.txt keeps two decimals, so two logs of values that agree to RTOL may
# differ by a unit of the last printed digit
LOG_ATOL = 0.011
STEPS = 5  # L-BFGS steps per dispatch

TASKS = {"x": None, "cov": [[0.02, 1.2, 0.12, 0.2]], "xcov": [[0.12]]}


@pytest.fixture(scope="module")
def data():
    """(port dataset, reference dataset): n 240, 9 grid blocks, dy 3."""
    kw = dict(n=260, ntrain=240, lscale=0.15, obs_std=0.02, yd=3, seed=5, noise_var=0.01)
    t, j = TSampled(**kw), JSampled(**kw)
    t.SY = j.SY.copy()
    for s in (t, j):
        s.set_centers(grid_centers(9))
    return t, j


@pytest.fixture
def few_scipy_iterations(monkeypatch):
    """Both packages call ``scipy.optimize.minimize`` with maxiter 200; the
    comparison reads the first 10 evaluations, so 12 iterations do."""
    import scipy.optimize

    real = scipy.optimize.minimize

    def minimize(*args, **kw):
        return real(*args, **{**kw, "options": {**kw.get("options", {}), "maxiter": 12}})

    monkeypatch.setattr(scipy.optimize, "minimize", minimize)


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f if line[0].isdigit()]


def _log(d):
    rows = _rows(os.path.join(d, "log.txt"))
    return np.array([int(r[0]) for r in rows]), np.array([float(r[2]) for r in rows])


def _covs(d):
    """covs.txt rows as (step, [nv, sv, l1, l2])."""
    out = []
    with open(os.path.join(d, "covs.txt")) as f:
        for line in f.read().replace("\n ", " ").splitlines():
            step, row = line.split(" ", 1)
            out.append((int(step), np.array(row.replace("[", " ").replace("]", " ").split(),
                                            dtype=float)))
    return out


def _dirs(tmp_path):
    dt, dj = tmp_path / "torch", tmp_path / "jax"
    dt.mkdir()
    dj.mkdir()
    return str(dt), str(dj)


# ---- the scipy bridge --------------------------------------------------------


@pytest.mark.parametrize("task", ["x", "cov", "xcov"])
def test_do_optimization_matches_jax(tmp_path, data, task, few_scipy_iterations):
    """Log rows and checkpoints of the first 10 evaluations (scipy's
    L-BFGS-B sees the same values and gradients to ~1e-12, so it asks for
    the same points)."""
    t, j = data
    dt, dj = _dirs(tmp_path)
    C0 = None if TASKS[task] is None else np.array(TASKS[task])
    tg, jg = t.build_gprf(local_dist=0.1, **F64), j.build_gprf(local_dist=0.1)
    if task == "cov":
        tg.update_X(t.SX)
        jg.update_X(j.SX)
    X0 = None if task == "cov" else t.X_obs
    tdriver.do_optimization(dt, tg, X0, C0, t)
    jdriver.do_optimization(dj, jg, X0, C0, j)
    (ts, tv), (js, jv) = _log(dt), _log(dj)
    assert len(ts) >= 10 and list(ts[:10]) == list(js[:10]) == list(range(10))
    np.testing.assert_allclose(tv[:10], jv[:10], rtol=RTOL, atol=LOG_ATOL)
    assert tv[:10].max() > tv[0]
    for step in range(10):
        for path_of in (tdriver.save_step.__globals__["step_x_path"],
                        tdriver.save_step.__globals__["step_cov_path"]):
            pt, pj = path_of(dt, step), path_of(dj, step)
            assert os.path.exists(pt) == os.path.exists(pj) == (
                task != ("cov" if "_X" in pt else "x"))
            if os.path.exists(pt):
                np.testing.assert_allclose(np.load(pt), np.load(pj), rtol=RTOL, atol=1e-12)
    assert os.path.exists(os.path.join(dt, "finished"))
    for a, b in zip(tdriver.load_log(dt), jdriver.load_log(dt)):
        np.testing.assert_array_equal(a, b)
    with open(os.path.join(dt, "log.txt")) as f:
        assert f.readlines()[-1].startswith("optimization finished after")


def test_do_optimization_stops_at_its_time_limit(tmp_path, data):
    t, _ = data
    tdriver.do_optimization(str(tmp_path), t.build_gprf(local_dist=0.1, **F64), t.X_obs, None, t,
                            maxsec=-1.0)
    assert len(_log(str(tmp_path))[0]) == 0 and os.path.exists(tmp_path / "finished")


def test_cov_row_helpers_match_jax():
    C1, C4 = np.array([[0.3]]), np.array([[0.02, 1.1, 0.2, 0.3]])
    for C in (C1, C4):
        np.testing.assert_array_equal(tdriver._full_cov(C, C, 2, 0.01),
                                      jdriver._full_cov(C, C, 2, 0.01))
        g = np.arange(4.0).reshape(1, 4)
        np.testing.assert_array_equal(tdriver._collapse_cov_grad(g, C),
                                      jdriver._collapse_cov_grad(g, C))
    with pytest.raises(ValueError):
        tdriver._full_cov(np.ones((1, 2)), None, 2, 0.01)


def test_unported_drivers_raise(tmp_path, data, few_scipy_iterations):
    """No driver refuses anything any more: the seismic and multistart
    drivers and the float64 refinement are ported
    (tests/test_torch_seismic.py, tests/test_torch_multistart.py,
    tests/test_torch_refine.py), and the seismic driver's sparse llgrad,
    which it refused until the sparse path was ported, runs: its log
    against the reference's (task cov)."""
    t, j = data
    dt, dj = _dirs(tmp_path)
    C0 = np.array([[0.01, 1.0, 0.15, 0.15]])
    for d, g in ((dt, t.build_gprf(local_dist=0.1, **F64)), (dj, j.build_gprf(local_dist=0.1))):
        driver = tdriver if d == dt else jdriver
        driver.do_optimization_seismic(d, g, None, C0, lambda c: (0.0, np.zeros_like(c)), None,
                                       maxsec=60, sparse=True)
    (ts, tv), (js, jv) = _log(dt), _log(dj)
    assert len(ts) >= 3 and list(ts) == list(js)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=LOG_ATOL)
    assert callable(tlbfgs.refine_f64)


# ---- the device-loop drivers -------------------------------------------------


def _fused_pair(data, task, m=None):
    t, j = data
    C0 = None if TASKS[task] is None else np.array(TASKS[task])
    anchor = t.SX if task == "cov" else t.X_obs
    args = (anchor, j.SY, t.neighbors, t.X_obs, t.obs_std)
    kw = dict(task=task, C0=C0, centers=np.asarray(t.centers), m=m)
    tf = tfused.FusedSyntheticGPRF(*args, t.cov, t.noise_var, **kw, **F64)
    jf = jfused.FusedSyntheticGPRF(*args, j.cov, j.noise_var, **kw)
    return tf, jf


@pytest.mark.parametrize("task", ["x", "cov", "xcov"])
def test_do_optimization_fused_theta_matches_jax_across_a_growth(tmp_path, data, task):
    """Two dispatches from a capacity one notch (8 slots) too small: the
    first dispatch overflows, both drivers grow by 16 and go on from the
    current point.  Logged values, covs.txt rows, checkpoints, the final
    theta and the saved optimizer state agree."""
    dt, dj = _dirs(tmp_path)
    m_fit = _fused_pair(data, task)[0].m
    tf, jf = _fused_pair(data, task, m=m_fit - 8)
    assert jf.m == tf.m == m_fit - 8 and bool(tf.overflow_fn()(torch.as_tensor(tf.theta0())))
    assert tf.ncov == jf.ncov == (0 if task == "x" else np.size(TASKS[task]))
    # a checkpoint every dispatch: the wall-clock cadence would depend on the machine's load
    kw = dict(max_iters=2 * STEPS, steps_per_dispatch=STEPS, ckpt_every_sec=0.0)
    t_theta = tlbfgs.do_optimization_fused_theta(dt, tf, tf.theta0(), **kw)
    j_theta = jlbfgs.do_optimization_fused_theta(dj, jf, jf.theta0(), **kw)
    assert tf.m == jf.m == m_fit + 8
    (ts, tv), (js, jv) = _log(dt), _log(dj)
    assert list(ts) == list(js) == list(range(2 * STEPS))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=LOG_ATOL)
    np.testing.assert_allclose(t_theta, np.asarray(j_theta), rtol=RTOL, atol=1e-9)
    assert t_theta.dtype == np.float64
    # the port's run directory also holds the fit's counters
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj) + ["counters.json"])
    assert (task != "x") == os.path.exists(os.path.join(dt, "covs.txt"))
    if task != "x":
        tc, jc = _covs(dt), _covs(dj)
        assert [s for s, _ in tc] == [s for s, _ in jc] == [STEPS - 1, 2 * STEPS - 1]
        for (_, a), (_, b) in zip(tc, jc):
            assert a.shape == (4,)
            np.testing.assert_allclose(a, b, rtol=1e-5)  # printed with 8 digits
    for name in sorted(os.listdir(dt)):
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(os.path.join(dt, name)),
                                       np.load(os.path.join(dj, name)), rtol=RTOL, atol=1e-9)
    with np.load(os.path.join(dt, "optimizer_state.npz")) as zt, \
            np.load(os.path.join(dj, "optimizer_state.npz")) as zj:
        assert set(zt.files) == set(zj.files) and int(zt["__iter__"]) == 2 * STEPS
        for k in zt.files:
            assert zt[k].dtype.kind == zj[k].dtype.kind, k
            if zt[k].dtype.kind == "f":
                scale = max(np.abs(zj[k]).max(), 1e-300)
                assert np.abs(zt[k] - zj[k]).max() <= 1e-5 * scale, k
            else:
                np.testing.assert_array_equal(zt[k], zj[k])


def test_do_optimization_fused_matches_jax_across_a_growth(tmp_path, data):
    t, j = data
    dt, dj = _dirs(tmp_path)
    m_fit = _fused_pair(data, "x")[0].m
    args = (t.X_obs, j.SY, np.asarray(t.centers), t.neighbors, t.X_obs, t.obs_std)
    tf = tfused.FusedGridGPRF(*args, t.cov, t.noise_var, m=m_fit - 8, **F64)
    jf = jfused.FusedGridGPRF(*args, j.cov, j.noise_var, m=m_fit - 8)
    kw = dict(max_iters=3 * STEPS, steps_per_dispatch=STEPS, ckpt_every_sec=0.0)
    tx = tlbfgs.do_optimization_fused(dt, tf, t.X_obs, **kw)
    jx = jlbfgs.do_optimization_fused(dj, jf, j.X_obs, **kw)
    assert tf.m == jf.m == m_fit + 8
    (ts, tv), (js, jv) = _log(dt), _log(dj)
    assert list(ts) == list(js) == list(range(3 * STEPS))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=LOG_ATOL)
    assert tv[-1] > tv[0]
    np.testing.assert_allclose(tx, np.asarray(jx), rtol=RTOL, atol=1e-9)
    # the port's run directory also holds the fit's counters
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj) + ["counters.json"])
    last = "step_%05d_X.npy" % (3 * STEPS - 1)
    np.testing.assert_allclose(np.load(os.path.join(dt, last)), np.load(os.path.join(dj, last)),
                               rtol=RTOL, atol=1e-9)
    np.testing.assert_array_equal(np.load(os.path.join(dt, last)).reshape(-1), tx)


def test_do_optimization_fused_refuses_a_theta_task(tmp_path, data):
    tf, _ = _fused_pair(data, "xcov")
    with pytest.raises(ValueError):
        tlbfgs.do_optimization_fused(str(tmp_path), tf, tf.X0)


def test_a_growth_keeps_the_curvature_memory(data):
    tf, _ = _fused_pair(data, "x")
    runner = tlbfgs.GrowingRunner(tf, STEPS)
    carry, _ = runner.run_fn(runner.init_fn(torch.as_tensor(tf.theta0())))
    m0 = tf.m
    grown = runner.grow(carry)
    assert tf.m == m0 + 16 and bool(grown["first"]) and bool(carry["valid"].any())
    for k in tlbfgs.GrowingRunner.KEPT:
        assert torch.equal(grown[k], carry[k]), k
    assert torch.equal(grown["x"], carry["x"]) and torch.equal(grown["x_prev"], carry["x"])


def test_optimizer_state_round_trips_with_its_dtypes(tmp_path, data):
    tf, _ = _fused_pair(data, "xcov")
    init_fn, run_fn = tlbfgs.make_scan_lbfgs_runner(tf.loss_fn(), STEPS)
    carry, _ = run_fn(init_fn(torch.as_tensor(tf.theta0())))
    assert tlbfgs.load_optimizer_state(str(tmp_path), "cpu") == (None, 0)
    tlbfgs.save_optimizer_state(str(tmp_path), carry, 17)
    loaded, it = tlbfgs.load_optimizer_state(str(tmp_path), "cpu")
    assert it == 17 and set(loaded) == set(carry)
    for k, v in carry.items():
        assert loaded[k].dtype == v.dtype and loaded[k].device == v.device, k
        assert torch.equal(loaded[k], v), k
    assert loaded["first"].dtype == loaded["valid"].dtype == torch.bool
    assert loaded["head"].dtype == torch.int64


@pytest.mark.parametrize("task", ["x", "xcov"])
def test_a_resumed_run_equals_an_uninterrupted_one(tmp_path, data, task):
    whole, parts = _dirs(tmp_path)
    kw = dict(steps_per_dispatch=STEPS, ftol=0.0)
    tf, _ = _fused_pair(data, task)
    theta_whole = tlbfgs.do_optimization_fused_theta(whole, tf, tf.theta0(), max_iters=4 * STEPS,
                                                     **kw)
    tf, _ = _fused_pair(data, task)
    tlbfgs.do_optimization_fused_theta(parts, tf, tf.theta0(), max_iters=2 * STEPS, **kw)
    assert list(_log(parts)[0]) == list(range(2 * STEPS))
    tf, _ = _fused_pair(data, task)
    theta_parts = tlbfgs.do_optimization_fused_theta(parts, tf, tf.theta0(), resume=True,
                                                     max_iters=4 * STEPS, **kw)
    np.testing.assert_array_equal(theta_parts, theta_whole)
    (ws, wv), (ps, pv) = _log(whole), _log(parts)
    assert list(ps) == list(ws) == list(range(4 * STEPS))  # no step index twice
    np.testing.assert_array_equal(pv, wv)
    if task == "xcov":
        for (sa, a), (sb, b) in zip(_covs(parts), _covs(whole)):
            assert sa == sb
            np.testing.assert_array_equal(a, b)
        assert len(_covs(parts)) == 4
    with open(os.path.join(parts, "log.txt")) as f:
        assert sum(line.startswith("optimization finished") for line in f) == 1


def test_resume_drops_log_rows_past_the_saved_state(tmp_path):
    p = tmp_path / "log.txt"
    p.write_text("0 0.10 1.00\n1 0.10 2.00\n2 0.20 3.00\n3 0.20 4.00\n"
                 "optimization finished after 1s\n")
    ref = tmp_path / "ref.txt"
    ref.write_text(p.read_text())
    tlbfgs._truncate_log_rows(str(p), 2)
    jlbfgs._truncate_log_rows(str(ref), 2)
    assert p.read_text() == ref.read_text() == "0 0.10 1.00\n1 0.10 2.00\n"
    tlbfgs._truncate_log_rows(str(tmp_path / "absent.txt"), 2)  # no file: nothing to do


def test_fc_from_tail_matches_jax(data):
    for task in ("cov", "xcov"):
        tf, jf = _fused_pair(data, task)
        theta = tf.theta0()
        tail = theta[len(theta) - tf.ncov:] + 0.1
        np.testing.assert_array_equal(tlbfgs._fc_from_tail(tf, tail, len(theta)),
                                      jlbfgs._fc_from_tail(jf, tail, len(theta)))


def test_a_carry_crosses_between_the_packages(data):
    """A dispatch in gprf_tpu, its carry as NumPy into the port, a dispatch
    in each: the same values; and the port's carry goes back."""
    tf, jf = _fused_pair(data, "xcov")
    j_init, j_run = jlbfgs.make_scan_lbfgs_runner(jf.loss_fn(), STEPS)
    t_init, t_run = tlbfgs.make_scan_lbfgs_runner(tf.loss_fn(), STEPS)
    jc, _ = j_run(j_init(jnp.asarray(jf.theta0())))
    tc = convert.carry_from_numpy({k: np.asarray(v) for k, v in jc.items()}, device="cpu")
    fresh = t_init(torch.as_tensor(tf.theta0()))
    assert set(tc) == set(fresh)
    for k in fresh:
        assert tc[k].dtype == fresh[k].dtype and tc[k].shape == fresh[k].shape, k
    jc, (jv, jacc, _) = j_run(jc)
    tc, (tv, tacc, _) = t_run(tc)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-7)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    back = convert.carry_to_numpy(tc)
    jc2, (jv2, _, _) = j_run({k: jnp.asarray(v) for k, v in back.items()})
    tc2, (tv2, _, _) = t_run(tc)
    np.testing.assert_allclose(tv2.numpy(), np.asarray(jv2), rtol=1e-7)
