"""gprf_torch's truncated-support sparse path against gprf_tpu's, float64 on
the CPU: the native source and binding (NativeCholesky), SparseFactor,
gaussian_llgrad_sparse, GPRF.llgrad(sparse=True) and the seismic command
line's --sparse on the host engine."""

import os
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.csgraph
import torch

from gprf_tpu.cli import run_seismic as jcli
from gprf_tpu.data import seismic as jseis
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model import sparse_llgrad as jsl
from gprf_tpu.model.gprf import GPRF as JGPRF
from gprf_tpu.partition.grid import Blocker, grid_centers
from gprf_tpu.sparse import native as jnative
from gprf_tpu.sparse import ops as jsparse
from gprf_torch.cli import run_seismic as tcli
from gprf_torch.model import sparse_llgrad as tsl
from gprf_torch.model.gprf import GPRF as TGPRF
from gprf_torch.sparse import native as tnative
from gprf_torch.sparse import ops as tsparse
from gprf_torch.utils.convert import cov_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_NATIVE = 1e-10  # the same machine code on the same inputs
RTOL_LL, RTOL_GRAD = 1e-9, 1e-7
# the cases of gprf_tpu's tests/test_sparse_llgrad.py: (X, lengthscales,
# distance, weight, noise variance, support radius that makes the path exact)
CASES = {
    "euclidean-se": (lambda r: r.uniform(size=(40, 2)), [0.3, 0.25], "euclidean", "se", 0.05,
                     100.0),
    "lld-matern32": (lambda r: np.column_stack([r.uniform(120, 125, 30), r.uniform(-5, 5, 30),
                                                r.uniform(0, 100, 30)]),
                     [40.0, 35.0], "lld", "matern32", 0.1, 1000.0),
}


def _close(a, b, rtol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max(initial=0.0) <= rtol * max(np.abs(b).max(initial=0.0), 1e-300)


def _spd(n, seed):
    A = scipy.sparse.random(n, n, density=0.03, random_state=np.random.RandomState(seed))
    A = (A + A.T) * 0.5
    return (A + scipy.sparse.eye(n) * (abs(A).sum(axis=1).max() + 1.0)).tocsc()


def _kernel(n=120, seed=5):
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    tcov = cov_from_numpy([1.0], [0.08, 0.08], "euclidean", "se", **F64)
    jcov = JCov.create([1.0], [0.08, 0.08])
    return (tsparse.sparse_kernel_matrix(X, tcov, max_scaled_dist=4.0, noise_var=0.1),
            jsparse.sparse_kernel_matrix(X, jcov, max_scaled_dist=4.0, noise_var=0.1))


def test_the_native_source_is_the_ports_own_copy():
    """The port compiles gprf_torch/csrc/gprf_native.cpp, byte for byte the
    source gprf_tpu builds, so both run the same machine code."""
    assert tnative.SOURCE == Path(REPO, "gprf_torch", "csrc", "gprf_native.cpp").resolve()
    with open(tnative.SOURCE, "rb") as f, open(os.path.join(REPO, "csrc", "gprf_native.cpp"),
                                              "rb") as g:
        assert f.read() == g.read()
    assert tnative.BUILD_ROOT == tnative.SOURCE.parent / "build"
    assert set(tnative.SIGNATURES) == {
        "range_pairs", "rcm_order", "sparse_chol_factor", "sparse_chol_logdet",
        "sparse_chol_nnz", "sparse_chol_export", "sparse_chol_solve",
        "sparse_chol_selected_inv", "sparse_chol_lmult", "sparse_chol_free"}


def test_native_cholesky_matches_jax():
    n = 90
    A = _spd(n, 0)
    lower = scipy.sparse.tril(A, format="csc")
    t = tnative.NativeCholesky(n, lower.indptr, lower.indices, lower.data)
    j = jnative.NativeCholesky(n, lower.indptr, lower.indices, lower.data)
    rng = np.random.default_rng(1)
    assert t.nnz() == j.nnz()
    np.testing.assert_allclose(t.logdet(), j.logdet(), rtol=RTOL_NATIVE)
    _, logdet = np.linalg.slogdet(A.toarray())
    np.testing.assert_allclose(t.logdet(), logdet, rtol=RTOL_NATIVE)
    for b in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        b0 = b.copy()
        _close(t.solve(b), j.solve(b), RTOL_NATIVE)
        _close(t.lmult(b), j.lmult(b), RTOL_NATIVE)
        np.testing.assert_array_equal(b, b0)  # the right-hand side is left as it was
    for ours, theirs in ((t.L(), j.L()), (t.selected_inverse_lower(), j.selected_inverse_lower())):
        assert isinstance(ours, scipy.sparse.csc_matrix)
        np.testing.assert_array_equal(ours.indptr, theirs.indptr)
        np.testing.assert_array_equal(ours.indices, theirs.indices)
        _close(ours.data, theirs.data, RTOL_NATIVE)
    # the selected inverse is A^-1 on the factor's lower pattern
    Z = t.selected_inverse_lower().tocoo()
    _close(Z.data, np.linalg.inv(A.toarray())[Z.row, Z.col], 1e-9)


def test_native_handle_is_freed_once_and_only_by_its_process():
    lower = scipy.sparse.tril(_spd(30, 2), format="csc")
    f = tnative.NativeCholesky(30, lower.indptr, lower.indices, lower.data)
    f.__del__()
    assert f._h is None
    f.__del__()  # a second call frees nothing
    g = tnative.NativeCholesky(30, lower.indptr, lower.indices, lower.data)
    g._pid = -1  # as a forked child sees a handle its parent made
    freed = []
    g._lib = type("Lib", (), {"sparse_chol_free": lambda self, h: freed.append(h)})()
    g.__del__()
    assert freed == [] and g._h is None
    bad = scipy.sparse.csc_matrix(-np.eye(4))
    with pytest.raises(np.linalg.LinAlgError):
        tnative.NativeCholesky(4, bad.indptr, bad.indices, bad.data)


def test_sparse_factor_matches_jax():
    Kt, Kj = _kernel()
    np.testing.assert_array_equal(Kt.toarray(), Kj.toarray())
    t, j = tsparse.SparseFactor(Kt), jsparse.SparseFactor(Kj)
    np.testing.assert_array_equal(t.P(), j.P())
    np.testing.assert_allclose(t.logdet(), j.logdet(), rtol=RTOL_NATIVE)
    rng = np.random.default_rng(2)
    for b in (rng.standard_normal(120), rng.standard_normal((120, 4))):
        _close(t.solve(b), j.solve(b), RTOL_NATIVE)
        _close(Kt @ t.solve(b), b, 1e-8)
    _close(t.L().toarray(), j.L().toarray(), RTOL_NATIVE)
    Zt, Zj = t.selected_inverse(), j.selected_inverse()
    assert isinstance(Zt, scipy.sparse.csr_matrix)
    _close(Zt.toarray(), Zj.toarray(), RTOL_NATIVE)
    # in the original order, exact on K's pattern
    Kc = Kt.tocoo()
    _close(np.asarray(Zt[Kc.row, Kc.col]).ravel(), np.linalg.inv(Kt.toarray())[Kc.row, Kc.col],
           1e-9)


def _case(name, seed=0):
    make_X, ls, dfn, wfn, nv, radius = CASES[name]
    rng = np.random.default_rng(seed)
    X = make_X(rng)
    Y = rng.standard_normal((len(X), 3))
    return (X, Y, cov_from_numpy([1.3], ls, dfn, wfn, **F64), JCov.create([1.3], ls, dfn, wfn),
            nv, radius)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("max_distance", [5.0, "exact"])
def test_gaussian_llgrad_sparse_matches_jax(name, max_distance):
    X, Y, tcov, jcov, nv, radius = _case(name)
    md = radius if max_distance == "exact" else max_distance
    t = tsl.gaussian_llgrad_sparse(X, Y, tcov, nv, grad_X=True, grad_cov=True, max_distance=md)
    j = jsl.gaussian_llgrad_sparse(X, Y, jcov, nv, grad_X=True, grad_cov=True, max_distance=md)
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL_LL)
    _close(t[1], j[1], RTOL_GRAD)
    _close(t[2], j[2], RTOL_GRAD)
    # gradients not asked for are 0-d zeros; an empty block is all zeros
    ll, gX, gC = tsl.gaussian_llgrad_sparse(X, Y, tcov, nv, max_distance=md)
    np.testing.assert_allclose(ll, t[0], rtol=1e-12)
    assert gX.shape == gC.shape == ()
    ll, gX, gC = tsl.gaussian_llgrad_sparse(X[:0], Y[:0], tcov, nv, grad_X=True)
    assert ll == 0.0 and gX.shape == (0, X.shape[1]) and gC.shape == (4,)


@pytest.mark.parametrize("name", CASES)
def test_gaussian_llgrad_sparse_matches_the_dense_term(name):
    """At a support radius that covers every pair the sparse term is the
    port's dense one, at gprf_tpu's own tolerances."""
    X, Y, tcov, _, nv, radius = _case(name)
    g = TGPRF(X, Y, None, tcov, nv, block_idxs=[np.arange(len(X))], neighbors=[], **F64)
    ll_d, gX_d, gC_d = g.gaussian_llgrad(X, Y, grad_X=True, grad_cov=True)
    ll_s, gX_s, gC_s = tsl.gaussian_llgrad_sparse(X, Y, tcov, nv, grad_X=True, grad_cov=True,
                                                  max_distance=radius)
    np.testing.assert_allclose(ll_s, ll_d, rtol=1e-10)
    rtol = 1e-8 if name.startswith("euclidean") else 1e-7
    np.testing.assert_allclose(gX_s, gX_d, rtol=rtol, atol=1e-10)
    np.testing.assert_allclose(gC_s, gC_d, rtol=rtol)


def test_a_pattern_in_several_components():
    """At 3 lengthscales the lld case's pattern falls apart into components,
    where the native RCM alone loses nodes (ROADMAP.md section 3): the order
    is a permutation, each component keeps its native order, and the term
    is the dense one of the same truncated matrix, whatever the points'
    order."""
    X, Y, tcov, _, nv, _ = _case("lld-matern32")
    # at 5 lengthscales two components, which the native routine orders right
    K5 = tsparse.sparse_kernel_matrix(X, tcov, max_scaled_dist=5.0, noise_var=nv)
    assert scipy.sparse.csgraph.connected_components(K5, directed=False)[0] == 2
    np.testing.assert_array_equal(tnative.rcm_order(len(X), K5.indptr, K5.indices),
                                  jnative.rcm_order(len(X), K5.indptr, K5.indices))
    K = tsparse.sparse_kernel_matrix(X, tcov, max_scaled_dist=3.0, noise_var=nv)
    ncomp, labels = scipy.sparse.csgraph.connected_components(K, directed=False)
    assert ncomp > 1
    perm = tnative.rcm_order(len(X), K.indptr, K.indices)
    np.testing.assert_array_equal(np.sort(perm), np.arange(len(X)))
    first = np.flatnonzero(labels == labels[perm[0]])
    np.testing.assert_array_equal(perm[:len(first)], first[jnative.rcm_order(
        len(first), *(lambda S: (S.indptr, S.indices))(K[first][:, first].tocsc()))])
    ll, gX, gC = tsl.gaussian_llgrad_sparse(X, Y, tcov, nv, grad_X=True, grad_cov=True,
                                            max_distance=3.0)
    Kd = K.toarray()
    dense = (-0.5 * np.sum(Y * np.linalg.solve(Kd, Y)) - 1.5 * np.linalg.slogdet(Kd)[1]
             - 1.5 * len(X) * np.log(2 * np.pi))
    np.testing.assert_allclose(ll, dense, rtol=1e-10)
    p = np.random.default_rng(4).permutation(len(X))
    llp, gXp, gCp = tsl.gaussian_llgrad_sparse(X[p], Y[p], tcov, nv, grad_X=True, grad_cov=True,
                                               max_distance=3.0)
    np.testing.assert_allclose(llp, ll, rtol=1e-12)
    _close(gXp, gX[p], 1e-10)
    _close(gCp, gC, 1e-10)


def test_the_lld_derivatives_are_guarded_at_coincident_points():
    X, Y, tcov, jcov, nv, _ = _case("lld-matern32")
    X[1] = X[0]  # ds/dh is singular where two points coincide
    t = tsl.gaussian_llgrad_sparse(X, Y, tcov, nv, grad_X=True, grad_cov=True)
    j = jsl.gaussian_llgrad_sparse(X, Y, jcov, nv, grad_X=True, grad_cov=True)
    assert np.isfinite(t[1]).all() and np.isfinite(t[2]).all()
    _close(t[1], j[1], RTOL_GRAD)


@pytest.fixture(scope="module")
def models():
    """(port, reference) GPRFs: 120 points, 9 grid blocks with their edges,
    dy 3."""
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(120, 2))
    Y = rng.standard_normal((120, 3))
    b = Blocker(grid_centers(9))
    blocks, edges = b.block_clusters(X), b.neighbors()
    tcov = cov_from_numpy([1.3], [0.3, 0.25], "euclidean", "se", **F64)
    jcov = JCov.create([1.3], [0.3, 0.25])
    return (TGPRF(X, Y, None, tcov, 0.05, block_idxs=blocks, neighbors=edges, **F64),
            JGPRF(X, Y, None, jcov, 0.05, block_idxs=blocks, neighbors=edges))


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("grads", [(True, True), (False, False)])
def test_gprf_sparse_llgrad_matches_jax(models, local, grads):
    tg, jg = models
    assert len(tg.neighbors) > 0
    t = tg.llgrad(grad_X=grads[0], grad_cov=grads[1], local=local, sparse=True)
    j = jg.llgrad(grad_X=grads[0], grad_cov=grads[1], local=local, sparse=True)
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL_LL)
    _close(t[1], j[1], RTOL_GRAD)
    _close(t[2], j[2], RTOL_GRAD)
    assert isinstance(t[0], float) and t[1].shape == (120, 2) and t[2].shape == (1, 4)
    if grads[0]:
        # at the default radius of 5 lengthscales the sparse objective is the dense one
        d = tg.llgrad(grad_X=True, grad_cov=True, local=local)
        np.testing.assert_allclose(t[0], d[0], rtol=1e-9)
        _close(t[1], d[1], 1e-6)


def test_the_sparse_llgrad_runs_on_the_host_whatever_the_models_width(models):
    """A float32 model's sparse llgrad is the float64 host computation, at
    the model's hyperparameters (rounded to float32)."""
    tg, _ = models
    g32 = TGPRF(tg.X, tg.Y, None, tg.cov, 0.05, block_idxs=tg.block_idxs,
                neighbors=tg.neighbors, device="cpu", dtype=torch.float32)
    a = g32.llgrad(grad_X=True, grad_cov=True, sparse=True, max_distance=2.0)
    b = tg.llgrad(grad_X=True, grad_cov=True, sparse=True, max_distance=2.0)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
    _close(a[1], b[1], 1e-6)
    assert a[1].dtype == a[2].dtype == np.float64


# ---- the seismic command line -----------------------------------------------------------

ARGV = ["--npts=80", "--obs_std=20", "--threshold=0.3", "--rpc_blocksize=20", "--task=xcov",
        "--sparse"]


def _log(d):
    with open(os.path.join(d, "log.txt")) as f:
        rows = [line.split() for line in f if line[0].isdigit()]
    return np.array([int(r[0]) for r in rows]), np.array([float(r[2]) for r in rows])


def test_run_seismic_sparse_host_engine_matches_jax(tmp_path, monkeypatch):
    """``--sparse`` on the host engine against the reference's command, in
    float64: the logged objective rows, 8 scipy iterations."""
    import scipy.optimize

    real = scipy.optimize.minimize
    monkeypatch.setattr(scipy.optimize, "minimize",
                        lambda *a, **kw: real(*a, **{**kw, "options": {"maxiter": 8}}))
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "sorted_isc.npy", jseis.make_synthetic_catalog(n=200, seed=3))
    argv = ARGV + ["--data_dir", str(data)]
    monkeypatch.setenv("SEISMIC_EXPERIMENTS", str(tmp_path / "torch"))
    args = tcli.build_parser().parse_args(argv + ["--device", "cpu"])
    info = tcli.do_run(args, device="cpu", dtype=torch.float64)
    assert info["edges"] > 0
    d = tcli.seismic_exp_dir(args)
    monkeypatch.setenv("SEISMIC_EXPERIMENTS", str(tmp_path / "jax"))
    jcli.main(argv)
    jd = jcli.seismic_exp_dir(jcli.build_parser().parse_args(argv))
    (ts, tv), (js, jv) = _log(d), _log(jd)
    assert len(ts) >= 9 and list(ts) == list(js)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0.011)  # log.txt keeps two decimals
    assert tv.max() > tv[0]
    assert {"log.txt", "covs.txt", "results.txt", "finished"} <= set(os.listdir(d))
