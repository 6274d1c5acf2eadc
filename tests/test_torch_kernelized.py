"""gprf_torch's kernelized (second-moment) objective against gprf_tpu's,
float64 on the CPU: kernelized_value_and_grad, GPRF(kernelized=True).llgrad
on the twins (PLAIN_OPS) and on LINALG_OPS, the identity with the Schur
and joint forms on Y, the leaves it runs, and the scipy driver over it."""

import os

import numpy as np
import pytest
import torch

from gprf_tpu.data.sampled import SampledData as JSampled
from gprf_tpu.model.gprf import GPRF as JGPRF
from gprf_tpu.model.kernelized import kernelized_value_and_grad as j_value_and_grad
from gprf_tpu.model.objective import GPRFParams as JParams
from gprf_tpu.optim import driver as jdriver
from gprf_tpu.partition.grid import grid_centers
from gprf_torch.data.sampled import SampledData as TSampled
from gprf_torch.model import kernelized as tk
from gprf_torch.model.gprf import GPRF as TGPRF
from gprf_torch.ops import mvn
from gprf_torch.optim import driver as tdriver
from gprf_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6  # the packages' parity gate: float64 on both sides, sums in another order
DY = 4
OPS = {"plain": mvn.PLAIN_OPS, "linalg": mvn.LINALG_OPS, "kernels": mvn.KERNEL_OPS}


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300), np.abs(a - b).max()


@pytest.fixture(scope="module")
def data():
    """(port dataset, reference dataset): n 150, 9 grid blocks, dy 4."""
    kw = dict(n=170, ntrain=150, lscale=0.15, obs_std=0.02, yd=DY, seed=6, noise_var=0.01)
    t, j = TSampled(**kw), JSampled(**kw)
    t.SY = j.SY.copy()
    for s in (t, j):
        s.set_centers(grid_centers(9))
    return t, j


def _models(data, ops=mvn.PLAIN_OPS, X=None):
    """(kernelized port model, kernelized reference model, the port's model
    on Y) over the same blocks and edges, at X (default X_obs)."""
    t, j = data
    tg = t.build_gprf(local_dist=0.1, **F64)
    X = t.X_obs if X is None else X
    YY = t.SY @ t.SY.T
    kw = dict(block_idxs=tg.block_idxs, neighbors=tg.neighbors)
    kt = TGPRF(X, YY, t.reblock, t.cov, t.noise_var, kernelized=True, dy=DY, ops=ops, **kw, **F64)
    kj = JGPRF(X, YY, j.reblock, j.cov, j.noise_var, kernelized=True, dy=DY, **kw)
    tg.update_X(X, update_blocks=False)
    return kt, kj, tg


@pytest.mark.parametrize("ops", OPS)
@pytest.mark.parametrize("local", [True, False])
def test_kernelized_llgrad_matches_jax(data, ops, local):
    kt, kj, _ = _models(data, OPS[ops])
    assert len(kt.neighbors) > 0
    t = kt.llgrad(grad_X=True, grad_cov=True, local=local)
    j = kj.llgrad(grad_X=True, grad_cov=True, local=local)
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL)
    _close(t[1], j[1])
    _close(t[2], j[2])
    assert t[1].shape == (150, 2) and t[2].shape == (1, 4) and t[1].dtype == np.float64
    ll, gX, gC = kt.llgrad(local=local)
    np.testing.assert_allclose(ll, j[0], rtol=RTOL)
    assert not gX.any() and not gC.any() and gC.shape == (1, 4)


@pytest.mark.parametrize("grad_X,grad_cov", [(True, False), (False, True)])
def test_kernelized_value_and_grad_matches_jax(data, grad_X, grad_cov):
    """The function under GPRF.llgrad, on the layout's joint-form arrays, at
    a perturbed X."""
    t, j = data
    kt, _, _ = _models(data)
    arrays = kt._device_arrays()
    X = t.X_obs + np.random.default_rng(3).normal(size=t.X_obs.shape) * 0.01
    row = [t.noise_var, 1.0, 0.15, 0.15]
    names = ("assignment", "mask", "pair_assignment", "pair_mask", "unary_weights",
             "pair_weights")
    ours = tk.kernelized_value_and_grad(
        params_from_numpy(X, row[1:2], row[2:], row[0], **F64), kt._Y_dev, *(arrays[k] for k in names), DY,
        grad_X=grad_X, grad_cov=grad_cov, ops=mvn.PLAIN_OPS)
    jp = JParams(X=np.asarray(X), wfn_params=np.asarray(row[1:2]), dfn_params=np.asarray(row[2:]),
                 noise_var=np.asarray(row[0]))
    theirs = j_value_and_grad(jp, np.asarray(kt.YY), *(arrays[k].numpy() for k in names), dy=DY,
                              grad_X=grad_X, grad_cov=grad_cov)
    np.testing.assert_allclose(float(ours[0]), float(theirs[0]), rtol=RTOL)
    for a, b in zip(ours[1:], theirs[1:]):
        _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("form", ["schur", "joint"])
def test_kernelized_on_y_y_t_is_the_objective_on_y(data, form):
    """tr(K^-1 Y Y^T) = sum(Y * K^-1 Y): the kernelized objective on YY =
    Y Y^T is the Schur and the joint form on Y."""
    X = data[0].X_obs + np.random.default_rng(4).normal(size=data[0].X_obs.shape) * 0.005
    kt, _, tg = _models(data, X=X)
    tg.form = form
    for local in (True, False):
        k = kt.llgrad(grad_X=True, grad_cov=True, local=local)
        y = tg.llgrad(grad_X=True, grad_cov=True, local=local)
        assert abs(k[0] - y[0]) <= 1e-9 * abs(y[0])
        _close(k[1], y[1], 1e-6)
        _close(k[2], y[2], 1e-6)


def test_kernelized_terms_run_only_chol_inv(data):
    """Every term is one chol_inv leaf batch (K1 on the card): unary
    [B, m, m] and pair [E, 2m, 2m], forward and backward, and no other
    leaf."""
    kt, _, _ = _models(data)
    calls = []
    kt.ops = mvn.PLAIN_OPS.map_leaves(
        lambda name, f: lambda *a: (calls.append((name, tuple(a[0].shape))), f(*a))[1])
    kt.llgrad(grad_X=True, grad_cov=True)
    B, m = kt.layout.assignment.shape
    assert calls == [("chol_inv", (B, m, m)), ("chol_inv", (len(kt.neighbors), 2 * m, 2 * m))]


def test_an_empty_pair_batch_and_the_missing_dy(data):
    t, _ = data
    kt, kj, _ = _models(data)
    lone = TGPRF(t.X_obs, kt.YY, None, t.cov, t.noise_var, kernelized=True, dy=DY,
                 block_idxs=kt.block_idxs, neighbors=[], **F64)
    jlone = JGPRF(t.X_obs, kt.YY, None, kj.cov, t.noise_var, kernelized=True, dy=DY,
                  block_idxs=kt.block_idxs, neighbors=[])
    a, b = lone.llgrad(grad_X=True), jlone.llgrad(grad_X=True)
    np.testing.assert_allclose(a[0], b[0], rtol=RTOL)
    _close(a[1], b[1])
    with pytest.raises(ValueError, match="dy"):
        TGPRF(t.X_obs, kt.YY, None, t.cov, t.noise_var, kernelized=True,
              block_idxs=kt.block_idxs, neighbors=[], **F64)


def test_do_optimization_runs_a_kernelized_model(tmp_path, data, monkeypatch):
    """The scipy driver over the kernelized model, unchanged: the log of 8
    iterations against the reference's."""
    import scipy.optimize

    real = scipy.optimize.minimize
    monkeypatch.setattr(scipy.optimize, "minimize", lambda *a, **kw: real(
        *a, **{**kw, "options": {**kw.get("options", {}), "maxiter": 8}}))
    t, j = data
    kt, kj, _ = _models(data)
    dirs = [tmp_path / "torch", tmp_path / "jax"]
    for d in dirs:
        d.mkdir()
    tdriver.do_optimization(str(dirs[0]), kt, t.X_obs, None, t)
    jdriver.do_optimization(str(dirs[1]), kj, j.X_obs, None, j)
    (ts, _, tv), (js, _, jv) = (tdriver.load_log(str(d)) for d in dirs)
    assert len(ts) >= 9 and list(ts) == list(js)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=0.011)  # log.txt keeps two decimals
    assert tv.max() > tv[0]
    assert os.path.exists(dirs[0] / "finished")
