"""gprf_torch's prediction against gprf_tpu's, float64 on the CPU: the exact
GP, the BCM predictor with both combinations and its whole-test-set batched
form, the dataset's predictive scores, the analysis's predictive columns,
and the reference's IndexError under an RPC partition, raised in both
packages."""

import os

import numpy as np
import pytest
import torch

from gprf_tpu.analysis import results as jresults
from gprf_tpu.data import sampled as jsampled
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model import fullgp as jfullgp
from gprf_tpu.model import predict as jpredict
from gprf_tpu.model.gprf import GPRF as JGPRF
from gprf_tpu.partition.grid import Blocker, grid_centers
from gprf_torch.analysis import results as tresults
from gprf_torch.cli import gprfopt as tcli
from gprf_torch.data import sampled as tsampled
from gprf_torch.kernels.covfn import cross_kernel_matrix
from gprf_torch.model import fullgp as tfullgp
from gprf_torch.model import predict as tpredict
from gprf_torch.model.gprf import GPRF as TGPRF
from gprf_torch.utils.convert import cov_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6  # the tolerance of tests/test_predict.py


def _gp_data(seed, n, dy):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    K = np.exp(-np.sum((X[:, None] - X[None]) ** 2, -1) / 0.3**2) + 0.01 * np.eye(n)
    return X, np.linalg.cholesky(K) @ rng.normal(size=(n, dy)), rng


def _gprf_pair(X, Y, nblocks, ls=0.3, noise_var=0.01):
    """(port GPRF, reference GPRF) over one grid partition."""
    b = Blocker(grid_centers(nblocks))
    blocks, edges = b.block_clusters(X), b.neighbors()
    t = TGPRF(X, Y, b.block_clusters, cov_from_numpy([1.0], [ls, ls], **F64), noise_var,
              block_idxs=blocks, neighbors=edges, **F64)
    j = JGPRF(X, Y, b.block_clusters, JCov.create([1.0], [ls, ls]), noise_var,
              block_idxs=blocks, neighbors=edges)
    return t, j


def _close(a, b):
    np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-10)


def test_gp_matches_jax():
    X, Y, rng = _gp_data(0, 60, 3)
    Xstar = rng.uniform(size=(7, 2))
    t = tfullgp.GP(X, Y, cov_from_numpy([1.3], [0.25, 0.3], **F64), 0.02, **F64)
    j = jfullgp.GP(X, Y, JCov.create([1.3], [0.25, 0.3]), 0.02)
    for got, want in [(t.predict(Xstar), j.predict(Xstar)),
                      (t.covariance(Xstar), j.covariance(Xstar)),
                      (t.covariance(Xstar, include_obs=True), j.covariance(Xstar, include_obs=True)),
                      (t.factor(Y[:, :1]), j.factor(Y[:, :1])), (t.alpha_r, j.alpha_r),
                      (t.log_likelihood(), j.log_likelihood())]:
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)
    # the reference's column swap: a mutable y / alpha_r pair
    t.y, j.y = Y[:, 1:2], Y[:, 1:2]
    t.alpha_r, j.alpha_r = t.factor(t.y), j.factor(j.y)
    np.testing.assert_allclose(t.predict(Xstar), j.predict(Xstar), rtol=1e-8)
    assert t.predict(Xstar).shape == (7,)


def test_mcov_and_prior_sample_match_jax():
    X = np.random.default_rng(1).uniform(size=(40, 2))
    tcov, jcov = cov_from_numpy([1.0], [0.2, 0.2], **F64), JCov.create([1.0], [0.2, 0.2])
    np.testing.assert_allclose(tfullgp.mcov(X, tcov, 0.01), jfullgp.mcov(X, jcov, 0.01),
                               rtol=1e-14)
    np.testing.assert_allclose(
        tfullgp.prior_sample(X, tcov, 0.01, np.random.default_rng(2), n_samples=2),
        jfullgp.prior_sample(X, jcov, 0.01, np.random.default_rng(2), n_samples=2), rtol=1e-10)


@pytest.mark.parametrize("combine", ["device", "host"])
@pytest.mark.parametrize("test_noise_var", [0.0, 0.02])
def test_train_predictor_matches_jax(combine, test_noise_var):
    X, Y, rng = _gp_data(2, 80, 3)
    t, j = _gprf_pair(X, Y, 4)
    Xstar = rng.uniform(size=(7, 2))
    got = tpredict.train_predictor(t, combine=combine)(Xstar, test_noise_var=test_noise_var)
    want = jpredict.train_predictor(j, combine=combine)(Xstar, test_noise_var=test_noise_var)
    for a, b in zip(got, want):
        _close(a, b)
    assert got[0].dtype == np.float64 and got[1].shape == (7, 7)


def test_the_two_combinations_agree_with_a_test_cov():
    """The prior from test_cov, the experts from the model covariance."""
    X, Y, rng = _gp_data(3, 50, 2)
    t, j = _gprf_pair(X, Y, 4, noise_var=0.05)
    Xstar = rng.uniform(size=(6, 2))
    tcov, jcov = cov_from_numpy([1.3], [0.4, 0.4], **F64), JCov.create([1.3], [0.4, 0.4])
    d = tpredict.train_predictor(t, test_cov=tcov, combine="device")(Xstar, 0.01)
    h = tpredict.train_predictor(t, test_cov=tcov, combine="host")(Xstar, 0.01)
    ref = jpredict.train_predictor(j, test_cov=jcov, combine="device")(Xstar, 0.01)
    for a, b, r in zip(d, h, ref):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)
        _close(a, r)


def test_single_block_predictor_is_the_exact_gp():
    X, Y, rng = _gp_data(4, 30, 3)
    Xstar = rng.uniform(size=(5, 2))
    cov = cov_from_numpy([1.0], [0.3, 0.3], **F64)
    g = TGPRF(X, Y, lambda XX: [np.arange(len(XX))], cov, 0.05, block_idxs=[np.arange(30)],
              neighbors=[], **F64)
    mean, covp = g.train_predictor()(Xstar, test_noise_var=0.0)
    gp = tfullgp.GP(X, Y, cov, 0.05, **F64)
    np.testing.assert_allclose(covp, gp.covariance(Xstar), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(mean, gp.predict(Xstar), rtol=1e-6, atol=1e-9)


def test_block_predictor_matches_jax_and_the_per_call_oracle():
    """Ragged test blocks, ragged source sets, both padding axes, and an
    empty test block."""
    rng = np.random.default_rng(5)
    X, Y = rng.uniform(size=(120, 2)), rng.normal(size=(120, 3))
    t, j = _gprf_pair(X, Y, 9, ls=0.25, noise_var=0.05)
    Xtest = rng.uniform(size=(40, 2)) * 0.6  # the top row and right column stay empty
    test_blocks = Blocker(grid_centers(9)).block_clusters(Xtest)
    assert min(len(b) for b in test_blocks) == 0 < max(len(b) for b in test_blocks)
    got = tpredict.train_block_predictor(t)(test_blocks, Xtest, test_noise_var=0.05)
    want = jpredict.train_block_predictor(j)(test_blocks, Xtest, test_noise_var=0.05)
    host = tpredict.train_predictor(t, combine="host")
    assert sorted(got) == sorted(want) == [b for b, ix in enumerate(test_blocks) if len(ix)]
    for b in got:
        for a, w, h in zip(got[b], want[b], host(Xtest[test_blocks[b]], test_noise_var=0.05)):
            _close(a, w)
            np.testing.assert_allclose(a, h, rtol=1e-8, atol=1e-10)


def test_padding_is_exact():
    """A dummy expert's message is exactly zero, and a far query's SE
    cross-kernel underflows to exactly zero in float32 and float64."""
    X, Y, rng = _gp_data(6, 60, 2)
    t, _ = _gprf_pair(X, Y, 4)
    Xpad, mask, Ls, Alphas = tpredict._snapshot(t, None)
    Xq = torch.as_tensor(rng.uniform(size=(1, 5, 2)))
    src = torch.tensor([[0, 2]])
    args = (t.cov, t.cov, 0.01, 0.01)
    one = tpredict._combine(Xq, Xpad[src], Ls[src], Alphas[src], mask[src], *args)
    dummy = torch.tensor([[0, 2, 0, 0]])
    valid = torch.tensor([[True, True, False, False]])[:, :, None]
    padded = tpredict._combine(Xq, Xpad[dummy], Ls[dummy], Alphas[dummy], mask[dummy] & valid,
                               *args)
    for a, b in zip(one, padded):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
    for dtype in (torch.float32, torch.float64):
        cov = cov_from_numpy([1.0], [0.06, 0.06], device="cpu", dtype=dtype)
        near = torch.tensor([[0.5, 0.5]], dtype=dtype)
        far = near + torch.tensor([[tpredict._FAR, 0.0]], dtype=dtype)
        assert float(cross_kernel_matrix(cov, near, far)) == 0.0


def _both_data():
    kw = dict(n=360, ntrain=300, lscale=0.15, obs_std=0.02, yd=3, seed=2, noise_var=0.01)
    t, j = tsampled.SampledData(**kw), jsampled.SampledData(**kw)
    t.SY = j.SY.copy()  # one dataset: the two float64 prior draws differ in the last bits
    t.Ytest = j.Ytest.copy()
    return t, j


@pytest.mark.parametrize("local_dist", [1.0, 0.1])
def test_prediction_error_matches_jax(local_dist):
    t, j = _both_data()
    centers = grid_centers(9)
    t.set_centers(centers)
    j.set_centers(centers)
    X = t.X_obs + np.random.default_rng(7).normal(size=t.X_obs.shape) * 0.005
    FC = np.array([[0.012, 1.1, 0.14, 0.16]])
    for cov in (None, FC):
        got = t.prediction_error(X=X, cov=cov, local_dist=local_dist, **F64)
        want = j.prediction_error(X=X, cov=cov, local_dist=local_dist)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert 0 < got[0] < 1  # better than the mean


def test_prediction_error_gp_matches_jax():
    t, j = _both_data()
    np.testing.assert_allclose(t.prediction_error_gp(t.SX, **F64), j.prediction_error_gp(j.SX),
                               rtol=1e-9)


def test_prediction_under_an_rpc_partition_raises_in_both_packages():
    """The RPC replay indexes the training rows: the reference's
    prediction_error raises IndexError on the shorter test split, and the
    port keeps that."""
    kw = dict(n=330, ntrain=300, lscale=0.15, obs_std=0.02, yd=3, seed=2, noise_var=0.01)
    t, j = tsampled.SampledData(**kw), jsampled.SampledData(**kw)
    t.cluster_rpc(50, rng=np.random.RandomState(2))
    np.random.seed(2)
    j.cluster_rpc(50)
    with pytest.raises(IndexError):
        j.prediction_error()
    with pytest.raises(IndexError):
        t.prediction_error(**F64)
    with pytest.raises(IndexError):
        j.build_gprf(local_dist=0.1).train_predictor()(j.Xtest)
    with pytest.raises(IndexError):
        t.build_gprf(local_dist=0.1, **F64).train_predictor()(t.Xtest)


def test_analyze_run_with_predictions_matches_jax(tmp_path, monkeypatch):
    """A run directory analyzed with the predictive columns by both
    packages: results.txt equal to the printed digits."""
    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    d = tmp_path / "run"
    d.mkdir()
    small = dict(lscale=0.1, n=400, ntrain=360, nblocks=9, yd=3, local_dist=0.1)
    tcli.do_run(str(d), device="cpu", dtype=torch.float64, engine="device", task="xcov",
                max_iters=20, **small)
    jdata = jsampled.sample_data(n=400, ntrain=360, lscale=0.1, obs_std=0.01, yd=3, seed=0,
                                 centers=grid_centers(9), noise_var=0.01)
    tdata = tsampled.sample_data(n=400, ntrain=360, lscale=0.1, obs_std=0.01, yd=3, seed=0,
                        centers=grid_centers(9), noise_var=0.01)
    tdata.SY, tdata.Ytest = jdata.SY, jdata.Ytest  # one dataset for both
    tresults.analyze_run(str(d), tdata, local_dist=0.1, predict=True, X0=tdata.X_obs, **F64)
    ours = (d / "results.txt").read_text().splitlines()
    jresults.analyze_run(str(d), jdata, local_dist=0.1, predict=True, X0=jdata.X_obs)
    theirs = (d / "results.txt").read_text().splitlines()
    assert len(ours) == len(theirs) == 21
    for a, b in zip(ours, theirs):
        a, b = a.split(), b.split()
        assert a[:2] == b[:2] and a[3:] == b[3:]  # every metric to the printed digit
        np.testing.assert_allclose(float(a[2]), float(b[2]), rtol=RTOL, atol=0.011)
    final = [float(v) for v in ours[-2].split()[6:]]
    assert all(np.isfinite(final)) and all(v != 0.0 for v in final)
    assert os.path.exists(d / "finished")
