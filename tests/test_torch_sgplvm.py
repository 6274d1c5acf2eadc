"""gprf_torch.model.sgplvm, the GPLVM baselines, against gprf_tpu's on the
same seeded numpy inputs, float64 on the CPU: every bound's value and
gradients at rtol 1e-8, the psi statistics at three chunkings, the
reference's identities held in the port, the driver do_sgplvm for each
of the four baselines (log rows at rtol 1e-6, the same files), and the
baselines through the synthetic command line (``tests/test_torch_cli.py``'s
helpers)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.cli import gprfopt as jcli
from gprf_tpu.data.sampled import SampledData as JSampled
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model import sgplvm as jsg
from gprf_tpu.optim import driver as jdriver
from gprf_tpu.partition.grid import grid_centers
from gprf_torch.analysis import results as tresults
from gprf_torch.cli import gprfopt as tcli
from gprf_torch.data.sampled import SampledData as TSampled
from gprf_torch.kernels.gpcov import GPCov as TCov
from gprf_torch.model import sgplvm as tsg
from gprf_torch.optim import driver as tdriver
from test_torch_cli import SMALL_ARGV, _assert_same_results, _both_runs, exp  # noqa: F401

torch.set_num_threads(1)
RTOL = 1e-8
LOG_RTOL = 1e-6
LOG_ATOL = 0.011  # log.txt keeps two decimals
N, K, DY, D = 60, 8, 3, 2
SV, NV = 1.0, 0.05


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(12)
    X = g.uniform(size=(N, D))
    Z = X[g.choice(N, K, replace=False)] + 0.01 * g.standard_normal((K, D))
    return dict(X=X, Z=Z, Y=g.normal(size=(N, DY)), S=g.uniform(0.005, 0.03, size=(N, D)),
                ls=np.array([0.3, 0.4]))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _tcov(ls):
    return TCov(wfn_params=_t([SV]), dfn_params=ls)


def _jcov(ls):
    return JCov(wfn_params=jnp.asarray([SV]), dfn_params=ls)


def _torch_value_and_grads(fn, arrays):
    ts = [_t(a).requires_grad_(True) for a in arrays]
    v = fn(*ts)
    return float(v.detach()), [g.numpy() for g in torch.autograd.grad(v, ts)]


def _jax_value_and_grads(fn, arrays):
    v, gs = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(len(arrays)))))(
        *(jnp.asarray(a) for a in arrays))
    return float(v), [np.asarray(g) for g in gs]


def _assert_same(t, j):
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL)
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())


# ---- the bounds ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["fitc_mll", "titsias_bound"])
def test_sparse_bounds_match_jax(inputs, name):
    """Value and gradients with respect to X, Z and the lengthscales."""
    arrays = [inputs["X"], inputs["Z"], inputs["ls"]]
    Y = inputs["Y"]
    t = _torch_value_and_grads(
        lambda X, Z, ls: getattr(tsg, name)(X, Z, _t(Y), _tcov(ls), NV), arrays)
    j = _jax_value_and_grads(
        lambda X, Z, ls: getattr(jsg, name)(X, Z, jnp.asarray(Y), _jcov(ls), NV), arrays)
    _assert_same(t, j)


def test_full_gplvm_mll_matches_jax(inputs):
    arrays = [inputs["X"], inputs["ls"]]
    Y = inputs["Y"]
    t = _torch_value_and_grads(lambda X, ls: tsg.full_gplvm_mll(X, _t(Y), _tcov(ls), NV), arrays)
    j = _jax_value_and_grads(lambda X, ls: jsg.full_gplvm_mll(X, jnp.asarray(Y), _jcov(ls), NV),
                             arrays)
    _assert_same(t, j)


@pytest.mark.parametrize("chunk", [1, 7, 0])
def test_psi_statistics_match_jax(inputs, chunk):
    """psi0, Psi1 and Psi2, and the gradients of a fixed linear functional
    of them with respect to mu, S, Z and the lengthscales: chunks of 1,
    chunks of 7 (60 points: the last chunk padded with 3 zero-weight rows),
    and the default chunk."""
    g = np.random.default_rng(3)
    W1, W2 = g.standard_normal((N, K)), g.standard_normal((K, K))
    arrays = [inputs["X"], inputs["S"], inputs["Z"], inputs["ls"]]

    def tfn(mu, S, Z, ls):
        p0, p1, p2 = tsg.psi_statistics(mu, S, Z, 1.3, ls, chunk=chunk)
        return 0.1 * p0 + torch.sum(_t(W1) * p1) + torch.sum(_t(W2) * p2)

    def jfn(mu, S, Z, ls):
        p0, p1, p2 = jsg.psi_statistics(mu, S, Z, 1.3, ls, chunk=chunk)
        return 0.1 * p0 + jnp.sum(W1 * p1) + jnp.sum(W2 * p2)

    _assert_same(_torch_value_and_grads(tfn, arrays), _jax_value_and_grads(jfn, arrays))
    t = tsg.psi_statistics(*(_t(a) for a in arrays[:3]), 1.3, _t(inputs["ls"]), chunk=chunk)
    j = jax.jit(lambda mu, S, Z, ls: jsg.psi_statistics(mu, S, Z, 1.3, ls, chunk=chunk))(
        *(jnp.asarray(a) for a in arrays))
    assert float(t[0]) == float(j[0]) == N * 1.3
    for a, b in zip(t[1:], j[1:]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)


@pytest.mark.parametrize("name", ["bgplvm_collapsed_F", "bgplvm_bound"])
def test_bayesian_bounds_match_jax(inputs, name):
    arrays = [inputs["X"], inputs["S"], inputs["Z"], inputs["ls"]]
    Y = inputs["Y"]
    t = _torch_value_and_grads(
        lambda mu, S, Z, ls: getattr(tsg, name)(mu, S, Z, _t(Y), _tcov(ls), NV), arrays)
    j = _jax_value_and_grads(
        lambda mu, S, Z, ls: getattr(jsg, name)(mu, S, Z, jnp.asarray(Y), _jcov(ls), NV), arrays)
    _assert_same(t, j)


@pytest.mark.parametrize("gplvm_type", ["sparse", "titsias", "basic"])
@pytest.mark.parametrize("learn_lscale", [False, True])
def test_objective_and_grads_match_jax(inputs, gplvm_type, learn_lscale):
    """The drivers' evaluation: (ll, dX, dZ, d log-lengthscale), the last
    zero unless the lengthscale is learnt."""
    args = [inputs["X"], inputs["Z"], np.log(0.35), inputs["Y"]]
    t = tsg._objective_and_grads(*(_t(a) for a in args), SV, NV, gplvm_type, learn_lscale)
    j = jsg._objective_and_grads(*(jnp.asarray(a) for a in args), SV, NV, gplvm_type,
                                 learn_lscale)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=RTOL * max(np.abs(np.asarray(b)).max(), 1e-300))
    assert (float(t[3]) == 0.0) == (not learn_lscale)
    if gplvm_type == "basic":
        assert not t[2].any()


@pytest.mark.parametrize("learn_lscale", [False, True])
def test_bgplvm_objective_and_grads_match_jax(inputs, learn_lscale):
    args = [inputs["X"], np.log(inputs["S"]), inputs["Z"], np.log(0.35), inputs["Y"]]
    t = tsg._bgplvm_objective_and_grads(*(_t(a) for a in args), SV, NV, learn_lscale)
    j = jsg._bgplvm_objective_and_grads(*(jnp.asarray(a) for a in args), SV, NV, learn_lscale)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=RTOL * max(np.abs(np.asarray(b)).max(), 1e-300))
    assert (float(t[4]) == 0.0) == (not learn_lscale)


def test_unknown_baseline_raises(inputs):
    with pytest.raises(ValueError):
        tsg._objective_and_grads(_t(inputs["X"]), _t(inputs["Z"]), _t(0.0), _t(inputs["Y"]),
                                 SV, NV, "fitc", False)


def test_jitter_follows_the_width():
    assert tsg._rel_jitter(torch.float64) == jsg._rel_jitter(jnp.float64) == 1e-6
    assert tsg._rel_jitter(torch.float32) == jsg._rel_jitter(jnp.float32) == 1e-4


# ---- the reference's identities, in the port -----------------------------------


def test_fitc_is_exact_when_the_inducing_points_are_the_data(inputs):
    X, Y, cov = _t(inputs["X"]), _t(inputs["Y"]), _tcov(_t([0.3, 0.3]))
    fitc = float(tsg.fitc_mll(X, X, Y, cov, 0.1))
    exact = float(tsg.full_gplvm_mll(X, Y, cov, 0.1))
    assert np.isclose(fitc, exact, rtol=1e-4)


def test_titsias_bound_lies_below_the_exact_marginal(inputs):
    X, Y, Z, cov = _t(inputs["X"]), _t(inputs["Y"]), _t(inputs["Z"]), _tcov(_t([0.3, 0.3]))
    exact = float(tsg.full_gplvm_mll(X, Y, cov, 0.1))
    assert float(tsg.titsias_bound(X, Z, Y, cov, 0.1)) <= exact + 1e-6
    assert abs(float(tsg.titsias_bound(X, X, Y, cov, 0.1)) - exact) < 1e-3 * abs(exact)


def test_collapsed_F_reduces_to_titsias_as_S_vanishes(inputs):
    X, Y, Z, cov = _t(inputs["X"]), _t(inputs["Y"]), _t(inputs["Z"]), _tcov(_t([0.3, 0.4]))
    F = float(tsg.bgplvm_collapsed_F(X, torch.full((N, D), 1e-14, dtype=torch.float64), Z, Y,
                                     cov, NV))
    assert np.isclose(F, float(tsg.titsias_bound(X, Z, Y, cov, NV)), rtol=1e-6)


def test_bayesian_bound_lies_below_the_exact_marginal(inputs):
    X, Y, Z, cov = _t(inputs["X"]), _t(inputs["Y"]), _t(inputs["Z"]), _tcov(_t([0.3, 0.3]))
    F = float(tsg.bgplvm_collapsed_F(X, torch.full((N, D), 1e-14, dtype=torch.float64), Z, Y,
                                     cov, NV))
    assert F <= float(tsg.full_gplvm_mll(X, Y, cov, NV)) + 1e-6


# ---- the driver ----------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    """(port dataset, reference dataset): 50 training points, dy 3."""
    kw = dict(n=60, ntrain=50, lscale=0.3, obs_std=0.03, yd=3, seed=1)
    t, j = TSampled(**kw), JSampled(**kw)
    t.SY = j.SY.copy()
    for s in (t, j):
        s.set_centers(grid_centers(4))
    return t, j


@pytest.fixture
def few_scipy_iterations(monkeypatch):
    """Both drivers call ``scipy.optimize.minimize``; 12 iterations give
    the 10 evaluations the comparison reads."""
    import scipy.optimize

    real = scipy.optimize.minimize

    def minimize(*args, **kw):
        return real(*args, **{**kw, "options": {**kw["options"],
                                                "maxiter": min(kw["options"]["maxiter"], 12)}})

    monkeypatch.setattr(scipy.optimize, "minimize", minimize)


def _lines(d):
    with open(os.path.join(d, "log.txt")) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("gplvm_type,C0", [("sparse", None), ("titsias", None),
                                           ("bayesian", None), ("basic", None),
                                           ("titsias", [[0.25]])])
def test_do_sgplvm_matches_jax(tmp_path, data, few_scipy_iterations, gplvm_type, C0):
    t, j = data
    assert np.array_equal(t.X_obs, j.X_obs)
    dt, dj = str(tmp_path / "torch"), str(tmp_path / "jax")
    os.makedirs(dt)
    os.makedirs(dj)
    kw = dict(maxsec=60, gplvm_type=gplvm_type, num_inducing=10)
    tsg.do_sgplvm(dt, t.X_obs, C0, t, device="cpu", dtype=torch.float64, **kw)
    jsg.do_sgplvm(dj, j.X_obs, C0, j, **kw)
    (ts, _, tv), (js, _, jv) = tdriver.load_log(dt), jdriver.load_log(dj)
    assert len(ts) >= 10 and list(ts[:10]) == list(js[:10]) == list(range(10))
    np.testing.assert_allclose(tv[:10], jv[:10], rtol=LOG_RTOL, atol=LOG_ATOL)
    assert tv.max() > tv[0]
    files = sorted(os.listdir(dt))
    assert files == sorted(os.listdir(dj)) and "finished" in files
    assert any(f.endswith("_IX.npy") for f in files) == (gplvm_type != "basic")
    for step in range(10):
        for suffix in ("X", "IX"):
            name = "step_%05d_%s.npy" % (step, suffix)
            if os.path.exists(os.path.join(dj, name)):
                np.testing.assert_allclose(np.load(os.path.join(dt, name)),
                                           np.load(os.path.join(dj, name)), rtol=LOG_RTOL,
                                           atol=1e-10)
    # the final step is the best finite iterate, saved again
    last = int(ts[-1])
    np.testing.assert_allclose(tv[-1], tv[:-1].max(), rtol=1e-12, atol=LOG_ATOL)
    assert os.path.exists(os.path.join(dt, "step_%05d_X.npy" % last))
    tail, jtail = _lines(dt)[-1], _lines(dj)[-1]
    assert tail.startswith("optimization finished after") and jtail.startswith(
        "optimization finished after")
    assert [ln for ln in _lines(dt) if ln.startswith("scipy:")][0].split()[:2] == \
        [ln for ln in _lines(dj) if ln.startswith("scipy:")][0].split()[:2]


def test_do_sgplvm_restarts_under_max_iters(tmp_path, data, monkeypatch):
    """The converged protocol: ftol 1e-10 and the budget of max_iters,
    scipy restarted while budget remains, each run's ``scipy:`` line in
    log.txt, as the reference writes them."""
    import scipy.optimize

    t, j = data
    seen = []
    real = scipy.optimize.minimize

    def minimize(*args, **kw):
        seen.append(dict(kw["options"]))
        return real(*args, **kw)

    monkeypatch.setattr(scipy.optimize, "minimize", minimize)
    dt, dj = str(tmp_path / "torch"), str(tmp_path / "jax")
    os.makedirs(dt)
    os.makedirs(dj)
    kw = dict(maxsec=60, gplvm_type="sparse", num_inducing=10, max_iters=15)
    tsg.do_sgplvm(dt, t.X_obs, None, t, device="cpu", dtype=torch.float64, **kw)
    ours = list(seen)
    seen.clear()
    jsg.do_sgplvm(dj, j.X_obs, None, j, **kw)
    assert ours == seen and ours[0] == {"ftol": 1e-10, "maxiter": 15}
    scipy_lines = [ln for ln in _lines(dt) if ln.startswith("scipy:")]
    assert len(scipy_lines) == len(ours) >= 1
    assert scipy_lines == [ln for ln in _lines(dj) if ln.startswith("scipy:")]
    (ts, _, tv), (_, _, jv) = tdriver.load_log(dt), jdriver.load_log(dj)
    np.testing.assert_allclose(tv[:10], jv[:10], rtol=LOG_RTOL, atol=LOG_ATOL)


def test_do_sgplvm_stops_at_its_time_limit(tmp_path, data):
    t, _ = data
    tsg.do_sgplvm(str(tmp_path), t.X_obs, None, t, maxsec=-1.0, gplvm_type="titsias",
                  num_inducing=10, device="cpu", dtype=torch.float64)
    steps, _, _ = tdriver.load_log(str(tmp_path))
    assert list(steps) == [0, 1]  # the one evaluation, and the best iterate saved again
    assert os.path.exists(tmp_path / "finished")


def test_do_sgplvm_runs_in_float32(tmp_path, data):
    """The command line's width: float32 evaluations, float64 on the host."""
    t, _ = data
    tsg.do_sgplvm(str(tmp_path), t.X_obs, None, t, maxsec=60, gplvm_type="sparse",
                  num_inducing=10, max_iters=20, device="cpu")
    steps, _, values = tdriver.load_log(str(tmp_path))
    assert len(steps) >= 5 and np.isfinite(values).all() and values.max() > values[0]


# ---- through the command line --------------------------------------------------


@pytest.mark.parametrize("gplvm_type,extra", [("sparse", {}), ("titsias", {}),
                                              ("bayesian", {}), ("basic", {}),
                                              ("titsias", dict(task="xcov")),
                                              ("sparse", dict(analyze_full=True))])
def test_gplvm_baseline_run_matches_jax(exp, monkeypatch, few_scipy_iterations, gplvm_type,
                                        extra):
    """``do_run`` with a baseline on the host engine, in float64: the log,
    and results.txt scored on every evaluation's X as for a GPRF run."""
    args = dict(dict(task="x"), **extra)
    dt, dj = _both_runs(exp, monkeypatch, "host", args.pop("task"), gplvm_type=gplvm_type,
                        num_inducing=20, **args)
    (ts, _, tv), (js, _, jv) = tdriver.load_log(dt), tdriver.load_log(dj)
    rows = min(10, len(ts))
    assert rows >= 5 and list(ts[:rows]) == list(js[:rows]) == list(range(rows))
    np.testing.assert_allclose(tv[:rows], jv[:rows], rtol=LOG_RTOL, atol=LOG_ATOL)
    _assert_same_results(dt, dj, rows)
    assert (gplvm_type != "basic") == os.path.exists(os.path.join(dt, "step_00000_IX.npy"))
    if extra.get("analyze_full"):  # the six predictive columns, scored as for a GPRF run
        t, j = tresults.load_results(dt), tresults.load_results(dj)
        assert (t[:rows, 6:] != 0).all()
        np.testing.assert_allclose(t[:rows, 6:], j[:rows, 6:], rtol=LOG_RTOL, atol=1.1e-4)


@pytest.mark.parametrize("gplvm_type", ["sparse", "titsias", "bayesian", "basic"])
def test_gplvm_baselines_through_the_command_line_on_the_cpu(exp, capsys, gplvm_type):
    """The command line itself, float32 as on the card: the reference's
    run-directory name, a whole run, a rising objective, a finite mad in
    every row (at 400 points, 20 inducing points need not lower it: the
    falling mad is the card's check, at the paper's 10,000 and 2,000)."""
    argv = SMALL_ARGV + ["--local_dist", "1.0", "--gplvm_type", gplvm_type, "--num_inducing",
                         "20", "--max_iters", "30", "--maxsec", "20"]
    tcli.main(argv)
    name = tcli.build_run_name(tcli.build_parser().parse_args(argv))
    assert name == jcli.build_run_name(jcli.build_parser().parse_args(
        [a for a in argv if a not in ("--device", "cpu")])) and name.endswith("_%s20" % gplvm_type)
    d = str(exp / name)
    assert {"log.txt", "results.txt", "finished"} <= set(os.listdir(d))
    steps, _, values = tdriver.load_log(d)
    assert len(steps) >= 5 and np.isfinite(values).all() and values.max() > values[0]
    results = tresults.load_results(d)
    assert len(results) == len(steps) and np.isfinite(results[:, 4]).all()
    assert np.isfinite(tresults.load_final_results(d)[1]["mll"])
