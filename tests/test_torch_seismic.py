"""gprf_torch's seismic experiment against gprf_tpu's, float64 on the CPU:
the great-circle distance and its guarded gradient, the Morton sort, the
PD-tree (host and device), the catalog and its data, the sparse prior draw,
FusedSeismicGPRF's loss and gradient, the host driver, the results and the
command line."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.analysis import results as jresults
from gprf_tpu.cli import run_seismic as jcli
from gprf_tpu.data import seismic as jseis
from gprf_tpu.data import synthetic as jsynth
from gprf_tpu.kernels import distances as jdist
from gprf_tpu.kernels import hostnp as jhostnp
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model.fused_seismic import FusedSeismicGPRF as JFused
from gprf_tpu.model.gprf import GPRF as JGPRF
from gprf_tpu.optim import device_lbfgs as jlbfgs
from gprf_tpu.optim import driver as jdriver
from gprf_tpu.optim.priors import seismic_cov_prior as j_cov_prior
from gprf_tpu.partition import morton as jmorton
from gprf_tpu.partition import pdtree as jpdtree
from gprf_tpu.partition import pdtree_device as jpdev
from gprf_tpu.sparse import ops as jsparse
from gprf_torch.analysis import results as tresults
from gprf_torch.cli import run_seismic as tcli
from gprf_torch.data import seismic as tseis
from gprf_torch.data import synthetic as tsynth
from gprf_torch.kernels import distances as tdist
from gprf_torch.kernels import hostnp as thostnp
from gprf_torch.model.fused_seismic import FusedSeismicGPRF as TFused
from gprf_torch.model.gprf import GPRF as TGPRF
from gprf_torch.optim import driver as tdriver
from gprf_torch.optim.priors import seismic_cov_prior as t_cov_prior
from gprf_torch.partition import morton as tmorton
from gprf_torch.partition import pdtree as tpdtree
from gprf_torch.partition import pdtree_device as tpdev
from gprf_torch.sparse import ops as tsparse
from gprf_torch.utils.convert import cov_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6
LOG_ATOL = 0.011  # log.txt keeps two decimals
LS = [40.0, 40.0]
N, BLOCKSIZE, THRESHOLD, DY = 200, 30, 0.3, 6  # 8 blocks; 4 edges on the CLI's data


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _covs():
    return (cov_from_numpy([1.0], LS, "lld", "matern32", **F64),
            JCov.create([1.0], LS, "lld", "matern32"))


@pytest.fixture(scope="module")
def problem():
    """A catalog of N events, observed with the command line's noise, Y
    seeded normal, and each package's PD-tree over the wrapped (lon, lat)."""
    cat = jseis.make_synthetic_catalog(n=N, seed=3)
    X_true = cat[:, (jseis.COL_LON, jseis.COL_LAT, jseis.COL_DEPTH)]
    prior_std = 20.0 * np.array([0.01, 0.01, 1.0])
    rng = np.random.default_rng(4)
    means = X_true + rng.standard_normal(X_true.shape) * prior_std
    Y = rng.standard_normal((N, DY))
    X2 = means[:, :2].copy()
    X2[:, 0] = jpdtree.wrap_lon(X2[:, 0])
    trees = tpdtree.PDTree(X2, BLOCKSIZE), jpdtree.PDTree(X2, BLOCKSIZE)
    tcov, jcov = _covs()
    tg = TGPRF(means, Y, None, tcov, 0.1, block_idxs=trees[0].leaf_idx(),
               neighbor_threshold=THRESHOLD, **F64)
    return dict(X_true=X_true, means=means, prior_std=prior_std, Y=Y, trees=trees,
                edges=tg.neighbors, cov=(tcov, jcov))


# ---- the great-circle distance --------------------------------------------------

LLD_POINTS = {
    # every diagonal entry is a coincident pair (hav = 0)
    "scattered": np.array([[140.0, 10.0, 5.0], [141.5, 11.0, 50.0], [120.2, -8.0, 300.0],
                           [140.0, 10.0, 35.0], [155.0, 49.0, 10.0]]),
    # near-antipodal pairs: hav within 1e-9 of 1, past the guard's 1 - 1e-7
    "antipodal": np.array([[10.0, 20.0, 5.0], [-170.0 + 1e-4, -20.0, 7.0],
                           [100.0, 0.0, 1.0], [-80.0, 1e-5, 3.0]]),
}


@pytest.mark.parametrize("case", list(LLD_POINTS))
def test_sq_lld_and_its_gradient_match_jax(case):
    X = LLD_POINTS[case]
    ls = np.array([40.0, 25.0])

    def jloss(X, ls):
        return jnp.sum(jdist.scaled_distance("lld", X, X, ls))

    ref = jdist.sq_lld(jnp.asarray(X), jnp.asarray(X), jnp.asarray(ls))
    jgX, jgl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(X), jnp.asarray(ls))
    Xt, lt = _t(X).requires_grad_(True), _t(ls).requires_grad_(True)
    r2 = tdist.sq_lld(Xt, Xt, lt)
    np.testing.assert_allclose(r2.detach().numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    gX, gl = torch.autograd.grad(tdist.safe_sqrt(r2).sum(), (Xt, lt))
    assert np.isfinite(gX.numpy()).all()
    np.testing.assert_allclose(gX.numpy(), np.asarray(jgX), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), rtol=1e-10, atol=1e-12)


def test_central_angle_backward_is_the_guarded_derivative():
    h = _t([0.0, 1e-320, 0.25, 1.0 - 1e-8, 1.0]).requires_grad_(True)
    (g,) = torch.autograd.grad(tdist._CentralAngle.apply(h).sum(), h)
    jg = jax.grad(lambda h: jnp.sum(jdist._central_angle(h)))(jnp.asarray(h.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert g[0] == g[1] == g[3] == g[4] == 0.0 and g[2] == pytest.approx(1 / np.sqrt(0.1875))


def test_sq_lld_takes_replica_batches_with_their_own_lengthscales(rng):
    X = np.stack([LLD_POINTS["scattered"], LLD_POINTS["scattered"] + 0.3])
    ls = np.array([[40.0, 25.0], [12.0, 70.0]])
    got = tdist.sq_lld(_t(X)[:, None], _t(X)[:, None], _t(ls)[:, None, None, :])
    for r in range(2):
        np.testing.assert_allclose(got[r, 0].numpy(),
                                   tdist.sq_lld(_t(X[r]), _t(X[r]), _t(ls[r])).numpy(),
                                   rtol=1e-15)


def test_host_lld_kernel_matches_jax(problem):
    tcov, jcov = problem["cov"]
    X1, X2 = problem["means"][:30], problem["means"][20:45]
    np.testing.assert_allclose(thostnp.cross_kernel_matrix_np(tcov, X1, X2),
                               jhostnp.cross_kernel_matrix_np(jcov, X1, X2), rtol=1e-13)


# ---- partitions -----------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_sort_morton_matches_jax(rng, dim):
    X = rng.uniform(-50, 50, size=(300, dim))
    extra = rng.normal(size=(300, 4))
    t, j = tmorton.sort_morton(X, extra), jmorton.sort_morton(X, extra)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmorton.morton_codes(X), jmorton.morton_codes(X))


def test_pdtree_blocks_match_jax(problem):
    """Identical index sets, in order, from the tree, the cluster call and
    its replay on moved points."""
    X = problem["means"]
    t_blocks, t_reblock = tpdtree.pdtree_cluster(X, blocksize=BLOCKSIZE)
    j_blocks, j_reblock = jpdtree.pdtree_cluster(X, blocksize=BLOCKSIZE)
    moved = X + np.random.default_rng(1).normal(size=X.shape) * [0.2, 0.2, 5.0]
    for ours, theirs in ((t_blocks, j_blocks), (t_reblock(moved), j_reblock(moved)),
                         (problem["trees"][0].leaf_idx(), problem["trees"][1].leaf_idx())):
        assert len(ours) == len(theirs) == 8
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpdtree.wrap_lon([-30.0, 0.0, 338.0, 400.0]),
                                  jpdtree.wrap_lon([-30.0, 0.0, 338.0, 400.0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_assign_blocks_pdtree_matches_the_host_recluster(problem, dtype):
    """The device traversal against the host replay on moved points: equal
    in float64; in float32 (the card's width) the points near a split
    plane may fall on the other side, and they are counted."""
    ttree, jtree = problem["trees"]
    Xp = problem["means"][:, :2] + np.random.default_rng(2).normal(size=(N, 2)) * 0.05
    Xp[:, 0] = tpdtree.wrap_lon(Xp[:, 0])
    host = np.empty(N, dtype=np.int64)
    for b, ix in enumerate(ttree.recluster(Xp)):
        host[ix] = b
    flat = tpdev.FlatPDTree(ttree)
    jflat = jpdev.FlatPDTree(jtree)
    assert (flat.depth, flat.n_blocks) == (jflat.depth, jflat.n_blocks)
    got = tpdev.assign_blocks_pdtree(torch.as_tensor(Xp, dtype=dtype),
                                     flat.device_arrays("cpu", dtype), flat.depth).numpy()
    ref = np.asarray(jpdev.assign_blocks_pdtree(jnp.asarray(Xp), jflat.device_arrays(jnp.float64),
                                                jflat.depth))
    np.testing.assert_array_equal(ref, host)
    differ = int((got != host).sum())
    assert differ == 0 if dtype == torch.float64 else differ <= 2, differ
    batched = tpdev.assign_blocks_pdtree(torch.as_tensor(np.stack([Xp, Xp[::-1]]), dtype=dtype),
                                         flat.device_arrays("cpu", dtype), flat.depth).numpy()
    np.testing.assert_array_equal(batched[0], got)
    np.testing.assert_array_equal(batched[1], got[::-1])


# ---- data -----------------------------------------------------------------------


def test_catalog_distances_prior_and_mad_match_jax(problem):
    np.testing.assert_array_equal(tseis.make_synthetic_catalog(n=N, seed=3),
                                  jseis.make_synthetic_catalog(n=N, seed=3))
    a, b = problem["X_true"], problem["means"]
    np.testing.assert_allclose(tseis.dist_lld_rows(a, b), jseis.dist_lld_rows(a, b), rtol=1e-14)
    assert tseis.mad(a, b) == jseis.mad(a, b)
    assert tseis.dist_lld(a[0], b[1]) == jseis.dist_lld(a[0], b[1])
    assert tseis.dist_deg((10, 0), (20, 0)) == jseis.dist_deg((10, 0), (20, 0))
    ours = tseis.make_x_prior(b, problem["prior_std"])(a)
    theirs = jseis.make_x_prior(b, problem["prior_std"])(a)
    assert ours[0] == theirs[0]
    np.testing.assert_array_equal(ours[1], theirs[1])


def test_load_data_matches_jax_and_caches(tmp_path, monkeypatch):
    """On a 120-event catalog (the dense draw): the same Y, cached beside
    the catalog under the reference's name, and read back from there."""
    cat = jseis.make_synthetic_catalog(n=120, seed=5)
    dirs = []
    for name in ("torch", "jax"):
        d = tmp_path / name
        d.mkdir()
        np.save(d / "sorted_isc.npy", cat)
        dirs.append(str(d))
    t_isc, t_Y, t_cov = tseis.load_data(40.0, 2, data_dir=dirs[0])
    j_isc, j_Y, j_cov = jseis.load_data(40.0, 2, data_dir=dirs[1])
    np.testing.assert_array_equal(t_isc, j_isc)
    np.testing.assert_allclose(t_Y, j_Y, rtol=1e-9, atol=1e-12)
    assert t_Y.shape == (120, 50) and (t_cov.dfn_str, t_cov.wfn_str) == ("lld", "matern32")
    np.testing.assert_array_equal(t_cov.dfn_params.numpy(), np.asarray(j_cov.dfn_params))
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    monkeypatch.setattr(tseis, "sample_y", None)  # the cache must answer now
    np.testing.assert_array_equal(tseis.load_data(40.0, 2, data_dir=dirs[0])[1], t_Y)


@pytest.mark.parametrize("n,dfn", [(300, "lld"), (600, "lld"), (400, "euclidean")])
def test_sample_y_sparse_matches_jax(n, dfn):
    """The same native factor, permutation and normal draws: the same Y."""
    if dfn == "lld":
        X = jseis.make_synthetic_catalog(n=n, seed=n)[:, (2, 3, 7)]
        ls = LS
    else:
        X = np.random.default_rng(n).uniform(size=(n, 2))
        ls = [0.1, 0.1]
    tcov = cov_from_numpy([1.0], ls, dfn, "matern32", **F64)
    jcov = JCov.create([1.0], ls, dfn, "matern32")
    np.random.seed(7)
    ref = jsparse.sample_y_sparse(X, jcov, 0.1, 5, max_scaled_dist=6.0)
    got = tsparse.sample_y_sparse(X, tcov, 0.1, 5, max_scaled_dist=6.0,
                                  rng=np.random.RandomState(7))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    K = tsparse.sparse_kernel_matrix(X, tcov, max_scaled_dist=6.0, noise_var=0.1)
    Kj = jsparse.sparse_kernel_matrix(X, jcov, max_scaled_dist=6.0, noise_var=0.1)
    assert (K != Kj).nnz == 0
    ft, fj = tsparse.SparseFactor(K), jsparse.SparseFactor(Kj)
    np.testing.assert_array_equal(ft.perm, fj.perm)
    z = np.random.default_rng(0).normal(size=(n, 2))
    np.testing.assert_allclose(ft.lmult_prior_sample(z), fj.lmult_prior_sample(z), rtol=1e-12)
    np.testing.assert_allclose(ft.lmult_prior_sample(z[:, 0]), fj.lmult_prior_sample(z[:, 0]),
                               rtol=1e-12)


def test_sample_y_routes_the_mid_size_draw_to_the_sparse_sampler(monkeypatch):
    """12,000 <= n <= 20,000 with no GPRF_SAMPLER takes the sparse draw, as
    in the reference; past it the exact banded draw, and "vecchia" and
    "hi" the Vecchia draw at any size."""
    calls = []

    def record(name):
        return lambda X, *a, **kw: calls.append((name, len(X), kw.get("max_scaled_dist"))) or name

    monkeypatch.setattr("gprf_torch.sparse.ops.sample_y_sparse", record("sparse"))
    monkeypatch.setattr("gprf_torch.sparse.ops.sample_y_banded", record("banded"))
    monkeypatch.setattr(tsynth, "sample_y_blocked", record("blocked"))
    tcov, _ = _covs()
    monkeypatch.delenv("GPRF_SAMPLER", raising=False)
    rng = np.random.RandomState(0)
    assert tsynth.sample_y(np.zeros((12000, 3)), tcov, 0.1, 2, sparse_lscales=6.0, rng=rng) == "sparse"
    assert tsynth.sample_y(np.zeros((20000, 3)), tcov, 0.1, 2, rng=rng) == "sparse"
    assert calls == [("sparse", 12000, 6.0), ("sparse", 20000, 4.0)]
    assert tsynth.sample_y(np.zeros((20001, 3)), tcov, 0.1, 2, rng=rng) == "banded"
    for sampler in ("vecchia", "hi"):
        monkeypatch.setenv("GPRF_SAMPLER", sampler)
        assert tsynth.sample_y(np.zeros((12000, 3)), tcov, 0.1, 2, rng=rng) == "blocked"
    assert tsynth.DENSE_SAMPLING_LIMIT == jsynth.DENSE_SAMPLING_LIMIT


# ---- the fused engine --------------------------------------------------------------


C0 = np.array([[0.12, 1.0, 35.0, 50.0]])


def _fused_pair(problem, task, m=None):
    p = problem
    tcov, jcov = p["cov"]
    args = (p["means"], p["Y"])
    rest = (p["edges"], p["means"], p["prior_std"])
    tf = TFused(*args, p["trees"][0], *rest, tcov, 0.1, task=task, m=m,
                acc_dtype=torch.float64, **F64)
    jf = JFused(*args, p["trees"][1], *rest, jcov, 0.1, task=task, m=m, dtype=jnp.float64)
    return tf, jf


@pytest.mark.parametrize("task", ["x", "cov", "xcov"])
def test_fused_seismic_loss_and_gradient_match_jax(problem, task):
    tf, jf = _fused_pair(problem, task)
    assert (tf.n_blocks, int(tf.edges.shape[0]), tf.m, tf.depth) == (
        jf.n_blocks, int(jf.edges.shape[0]), jf.m, jf.depth) == (8, len(problem["edges"]), 32, 3)
    assert len(problem["edges"]) > 0
    theta = tf.theta0(problem["means"], C0)
    np.testing.assert_array_equal(theta, jf.theta0(problem["means"], C0))
    theta = theta + np.random.default_rng(3).normal(size=theta.shape) * 0.02
    v, g = jax.value_and_grad(jf.loss_fn())(jnp.asarray(theta))
    th = torch.as_tensor(theta).requires_grad_(True)
    vt = tf.loss_fn()(th)
    (gt,) = torch.autograd.grad(vt, th)
    assert vt.shape == ()
    np.testing.assert_allclose(float(vt), float(v), rtol=RTOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(g), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(g)).max())
    for a, b in zip(tf.unpack_host(theta), jf.unpack_host(theta)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    assert tf.ncov == jf.ncov


def test_fused_seismic_replicas_fold_into_one_batch(problem):
    """Three replicas [3, ntheta] give the three single losses and their
    gradients, and their overflow flags."""
    tf, _ = _fused_pair(problem, "xcov")
    theta = tf.theta0(problem["means"], C0)
    rng = np.random.default_rng(5)
    thetas = np.stack([theta + rng.normal(size=theta.shape) * s for s in (0.0, 0.03, 0.1)])
    th = torch.as_tensor(thetas).requires_grad_(True)
    v = tf.loss_fn()(th)
    (g,) = torch.autograd.grad(v.sum(), th)
    assert v.shape == (3,)
    for r in range(3):
        one = torch.as_tensor(thetas[r]).requires_grad_(True)
        v1 = tf.loss_fn()(one)
        (g1,) = torch.autograd.grad(v1, one)
        np.testing.assert_allclose(float(v[r]), float(v1), rtol=1e-13)
        np.testing.assert_allclose(g[r].numpy(), g1.numpy(), rtol=1e-10, atol=1e-10)
    flags = tf.overflow_fn()(th.detach())
    assert flags.shape == (3,) and not flags.any()


def test_fused_seismic_capacity_checks_match_jax(problem):
    """A capacity one notch too small: every check reports the overflow, in
    both packages, for one theta and for a batch."""
    m_fit = _fused_pair(problem, "x")[0].m
    for m in (m_fit, m_fit - 8):
        tf, jf = _fused_pair(problem, "x", m=m)
        theta = tf.theta0(problem["means"], None)
        thetas = np.stack([theta, theta * 1.0001])
        assert tf.check_capacity(theta) == jf.check_capacity(theta) == (m == m_fit)
        assert tf.check_capacity_batch(thetas) == jf.check_capacity_batch(thetas)
        assert bool(tf.overflow_fn()(torch.as_tensor(theta))) == bool(
            jf.overflow_fn()(jnp.asarray(theta))) == (m != m_fit)
    tf.grow_capacity()
    assert tf.m == m_fit + 8
    tf, jf = _fused_pair(problem, "cov")
    assert tf.check_capacity_batch(np.zeros((2, 4))) == jf.check_capacity_batch(np.zeros((2, 4)))
    with pytest.raises(ValueError):
        tf.theta0(None, np.ones((1, 2)))


# ---- the host driver ------------------------------------------------------------------


@pytest.fixture
def few_scipy_iterations(monkeypatch):
    """The seismic driver calls ``scipy.optimize.minimize`` with no limit on
    iterations; the comparison reads the first 8 evaluations."""
    import scipy.optimize

    real = scipy.optimize.minimize

    def minimize(*args, **kw):
        return real(*args, **{**kw, "options": {"maxiter": 8}})

    monkeypatch.setattr(scipy.optimize, "minimize", minimize)


def _log(d):
    with open(os.path.join(d, "log.txt")) as f:
        rows = [line.split() for line in f if line[0].isdigit()]
    return np.array([int(r[0]) for r in rows]), np.array([float(r[2]) for r in rows])


@pytest.mark.parametrize("task", ["x", "cov", "xcov"])
def test_do_optimization_seismic_matches_jax(tmp_path, problem, task, few_scipy_iterations):
    p = problem
    tcov, jcov = p["cov"]
    blocks = [p["trees"][0].leaf_idx(), p["trees"][1].leaf_idx()]
    reblock = [tpdtree.pdtree_cluster(p["means"], BLOCKSIZE)[1],
               jpdtree.pdtree_cluster(p["means"], BLOCKSIZE)[1]]
    tg = TGPRF(p["means"], p["Y"], reblock[0], tcov, 0.1, block_idxs=blocks[0],
               neighbors=p["edges"], **F64)
    jg = JGPRF(p["means"], p["Y"], reblock[1], jcov, 0.1, block_idxs=blocks[1],
               neighbors=p["edges"])
    X0 = None if task == "cov" else p["means"]
    C = None if task == "x" else C0.copy()
    dirs = [str(tmp_path / k) for k in ("torch", "jax")]
    for d in dirs:
        os.makedirs(d)
    x_prior = jseis.make_x_prior(p["means"], p["prior_std"])
    tdriver.do_optimization_seismic(dirs[0], tg, X0, C, t_cov_prior,
                                    tseis.make_x_prior(p["means"], p["prior_std"]))
    jdriver.do_optimization_seismic(dirs[1], jg, X0, C, j_cov_prior, x_prior)
    (ts, tv), (js, jv) = _log(dirs[0]), _log(dirs[1])
    assert len(ts) >= 8 and list(ts[:8]) == list(js[:8]) == list(range(8))
    np.testing.assert_allclose(tv[:8], jv[:8], rtol=RTOL, atol=LOG_ATOL)
    assert tv[:8].max() > tv[0]
    for step in range(8):
        for suffix in ("X", "cov"):
            name = "step_%05d_%s.npy" % (step, suffix)
            there = [os.path.exists(os.path.join(d, name)) for d in dirs]
            assert there[0] == there[1] == (task != ("cov" if suffix == "X" else "x"))
            if there[0]:
                np.testing.assert_allclose(np.load(os.path.join(dirs[0], name)),
                                           np.load(os.path.join(dirs[1], name)), rtol=RTOL)
    for d in dirs:
        assert os.path.exists(os.path.join(d, "finished"))
    with open(os.path.join(dirs[0], "covs.txt")) as f:
        assert (len(f.readlines()) > 0) == (task != "x")


def test_do_optimization_seismic_answers_a_non_finite_evaluation(tmp_path, problem):
    """1e10 and a gradient drawn from the driver's rng, and the run goes on."""
    p = problem
    tcov, _ = p["cov"]

    class Failing(TGPRF):
        calls = 0

        def llgrad(self, **kw):
            Failing.calls += 1
            ll, gX, gC = super().llgrad(**kw)
            return (np.nan, gX, gC) if Failing.calls == 1 else (ll, gX, gC)

    g = Failing(p["means"], p["Y"], None, tcov, 0.1, block_idxs=p["trees"][0].leaf_idx(),
                neighbors=p["edges"], **F64)
    tdriver.do_optimization_seismic(str(tmp_path), g, p["means"], None, t_cov_prior,
                                    tseis.make_x_prior(p["means"], p["prior_std"]), maxsec=2)
    steps, values = _log(str(tmp_path))
    assert Failing.calls > 2 and steps[0] == 0 and np.isfinite(values).all()


def test_compare_seismic_runs_matches_jax(tmp_path, problem):
    dirs = []
    for k, shift in (("a", 0.0), ("b", 0.01)):
        d = tmp_path / k
        d.mkdir()
        np.save(d / "step_00000_X.npy", problem["X_true"])
        np.save(d / "step_00003_X.npy", problem["means"] + shift)
        dirs.append(str(d))
    assert tresults.compare_seismic_runs(*dirs) == jresults.compare_seismic_runs(*dirs)
    with pytest.raises(FileNotFoundError):
        tresults.compare_seismic_runs(str(tmp_path), dirs[0])


# ---- the command line ---------------------------------------------------------------


ARGV = ["--npts=-1", "--obs_std=20", f"--threshold={THRESHOLD}", f"--rpc_blocksize={BLOCKSIZE}",
        "--task=xcov"]


@pytest.fixture
def seismic_exp(tmp_path, monkeypatch):
    monkeypatch.setenv("SEISMIC_EXPERIMENTS", str(tmp_path / "exp"))
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "sorted_isc.npy", jseis.make_synthetic_catalog(n=N, seed=3))
    return tmp_path, ["--data_dir", str(data)]


def test_run_seismic_flags_and_run_directory_match_jax(seismic_exp):
    t = {a.dest: a.default for a in tcli.build_parser()._actions if a.dest != "help"}
    j = {a.dest: a.default for a in jcli.build_parser()._actions if a.dest != "help"}
    assert t.pop("device") == "cuda" and t == j
    argv = ARGV + seismic_exp[1] + ["--init_x", "x.npy"]
    assert tcli.seismic_exp_dir(tcli.build_parser().parse_args(argv)) == jcli.seismic_exp_dir(
        jcli.build_parser().parse_args(argv))


@pytest.mark.parametrize("engine", [["--engine", "host", "--maxsec", "2"],
                                    ["--engine", "device", "--multistart", "3", "--max_iters",
                                     "40"]])
def test_run_seismic_runs_end_to_end_on_the_cpu(seismic_exp, engine):
    """The acceptance command at a 200-event catalog, float32 on the CPU:
    the run directory's files, a rising objective, a results row per step
    and the true-X row."""
    base, data = seismic_exp
    info = tcli.main(ARGV + data + engine + ["--device", "cpu"])
    assert (info["blocks"], info["edges"], info["m"]) == (8, 4, 32)
    d = tcli.seismic_exp_dir(tcli.build_parser().parse_args(ARGV + data))
    files = set(os.listdir(d))
    assert {"log.txt", "covs.txt", "results.txt", "finished"} <= files
    assert ("multistart.txt" in files) == ("device" in engine)
    steps, values = _log(d)
    assert values.max() > values[0]
    with open(os.path.join(d, "results.txt")) as f:
        rows = f.read().splitlines()
    assert len(rows) == len(steps) + 1 and rows[-1].startswith("true X ll")
    first, last = (float(rows[0].split()[4]), float(rows[-2].split()[4]))
    assert np.isfinite([first, last]).all()
    if "device" in engine:
        with open(os.path.join(d, "multistart.txt")) as f:
            assert all(len(r.split()) == 2 + 3 for r in f)
    # the neighbor list is cached in the data directory and read back
    cached = [f for f in os.listdir(data[1]) if f.startswith("neighbors_")]
    assert cached == ["neighbors_%d_%d_%.3f_%.3f.npy" % (N, BLOCKSIZE, THRESHOLD, 20.0)]


def test_run_seismic_host_engine_matches_jax(seismic_exp, monkeypatch, few_scipy_iterations):
    """The port's run directory against the reference's on the host engine,
    in float64: the log, and results.txt to the printed digit."""
    base, data = seismic_exp
    args = tcli.build_parser().parse_args(ARGV + data + ["--device", "cpu"])
    d = tcli.seismic_exp_dir(args)
    tcli.do_run(args, device="cpu", dtype=torch.float64)
    ours = open(os.path.join(d, "results.txt")).read().splitlines()
    ours_log = _log(d)
    monkeypatch.setenv("SEISMIC_EXPERIMENTS", str(base / "jax"))
    jcli.main(ARGV + data)
    jd = jcli.seismic_exp_dir(jcli.build_parser().parse_args(ARGV + data))
    theirs = open(os.path.join(jd, "results.txt")).read().splitlines()
    np.testing.assert_allclose(ours_log[1], _log(jd)[1], rtol=RTOL, atol=LOG_ATOL)
    assert len(ours) == len(theirs) >= 9
    for a, b in zip(ours[:-1], theirs[:-1]):
        np.testing.assert_allclose([float(v) for v in a.split()[2:]],
                                   [float(v) for v in b.split()[2:]], rtol=RTOL, atol=LOG_ATOL)
    assert ours[-1].startswith("true X ll") and theirs[-1].startswith("true X ll")
    np.testing.assert_allclose(float(ours[-1].split()[-1]), float(theirs[-1].split()[-1]),
                               rtol=RTOL)


def test_run_seismic_refuses_what_is_not_ported_and_wants_a_gpu(seismic_exp):
    base, data = seismic_exp
    # --refine_iters runs (test_run_seismic_refine_matches_jax) and --sparse
    # on the host engine (tests/test_torch_sparse.py); the device engine has
    # no sparse path and refuses --sparse before anything runs
    with pytest.raises(ValueError, match="--engine host"):
        tcli.main(ARGV + data + ["--engine", "device", "--sparse", "--device", "cpu"])
    assert not os.path.exists(base / "exp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(ARGV + data)


def jax_tail_from_the_last_accepted_point(monkeypatch):
    """The reference starts its float64 tail at the loop's pending
    proposal, the port at the loop's last accepted point (``x_prev`` of the
    saved optimizer state): start the reference's there too."""
    real = jlbfgs.refine_f64

    def refine_f64(d, make_fused, x32, it0, **kw):
        with np.load(os.path.join(d, "optimizer_state.npz")) as z:
            return real(d, make_fused, z["x_prev"].astype(np.float64), it0, **kw)

    monkeypatch.setattr(jlbfgs, "refine_f64", refine_f64)


def test_run_seismic_refine_matches_jax(seismic_exp, monkeypatch):
    """The device engine for 20 iterations and the float64 tail for 10, in
    float64 against the reference's: the log goes on from 20, covs.txt too,
    results.txt scores every row."""
    from gprf_tpu.model import fused_seismic as jfs

    class Float64Fused(jfs.FusedSeismicGPRF):
        def __init__(self, *args, dtype=None, **kw):
            super().__init__(*args, dtype=jnp.float64, **kw)

    monkeypatch.setattr(jfs, "FusedSeismicGPRF", Float64Fused)
    jax_tail_from_the_last_accepted_point(monkeypatch)
    base, data = seismic_exp
    argv = ARGV + data + ["--engine", "device", "--max_iters", "20", "--refine_iters", "10"]
    args = tcli.build_parser().parse_args(argv + ["--device", "cpu"])
    d = tcli.seismic_exp_dir(args)
    tcli.do_run(args, device="cpu", dtype=torch.float64)
    monkeypatch.setenv("SEISMIC_EXPERIMENTS", str(base / "jax"))
    jcli.main(argv)
    jd = jcli.seismic_exp_dir(jcli.build_parser().parse_args(argv))
    (ts, tv), (js, jv) = _log(d), _log(jd)
    assert list(ts) == list(js) == list(range(30))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=LOG_ATOL)
    assert abs(tv[20] - tv[19]) <= LOG_ATOL  # the tail starts at the last accepted point
    with open(os.path.join(d, "log.txt")) as f:
        assert f.read().splitlines()[-1].startswith("f64 refinement finished after")
    with open(os.path.join(d, "covs.txt")) as f, open(os.path.join(jd, "covs.txt")) as g:
        steps = [r.split()[0] for r in f.read().replace("\n ", " ").splitlines()]
        assert steps == [r.split()[0] for r in g.read().replace("\n ", " ").splitlines()]
        assert steps[-1] == "29"
    with open(os.path.join(d, "results.txt")) as f:
        assert len(f.read().splitlines()) == 31
