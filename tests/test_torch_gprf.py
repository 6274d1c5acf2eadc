"""gprf_torch.model.gprf.GPRF, its neighbor discovery and
gprf_value_and_grad_schur against gprf_tpu's on the same seeded data,
float64 on the CPU.  gprf_tpu's GPRF takes its plain (non-Pallas) leaves on
the CPU; one case runs its Pallas leaves in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gprf_tpu.ops.pallas_mvn as pm
from gprf_tpu.data.sampled import SampledData as JSampled
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model import objective as jobjective
from gprf_tpu.model.gprf import GPRF as JGPRF
from gprf_tpu.model.neighbors import compute_neighbors as j_compute_neighbors
from gprf_tpu.partition.grid import grid_centers
from gprf_torch.data.sampled import SampledData as TSampled
from gprf_torch.model import objective as tobjective
from gprf_torch.model.gprf import GPRF as TGPRF
from gprf_torch.model.neighbors import compute_neighbors as t_compute_neighbors
from gprf_torch.ops import mvn
from gprf_torch.utils.convert import cov_from_numpy, params_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6  # both sides float64; the two packages order their sums differently


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300), np.abs(a - b).max()


@pytest.fixture(scope="module")
def data():
    """(port dataset, reference dataset): n 300, 9 grid blocks, dy 4."""
    kw = dict(n=330, ntrain=300, lscale=0.15, obs_std=0.02, yd=4, seed=2, noise_var=0.01)
    t, j = TSampled(**kw), JSampled(**kw)
    t.SY = j.SY.copy()  # the same Y to the last bit, so the comparison is of the model alone
    for s in (t, j):
        s.set_centers(grid_centers(9))
    return t, j


def _pair(data, **kw):
    t, j = data
    return (t.build_gprf(local_dist=0.1, **F64, **kw), j.build_gprf(local_dist=0.1))


def _assert_llgrad_close(tg, jg, **kw):
    t, j = tg.llgrad(**kw), jg.llgrad(**kw)
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL)
    _close(t[1], j[1])
    _close(t[2], j[2])
    assert isinstance(t[0], float) and t[1].dtype == t[2].dtype == np.float64
    assert t[1].flags.writeable and t[2].flags.writeable  # the drivers add priors in place
    return t


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("grad_X,grad_cov", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_llgrad_matches_jax(data, local, grad_X, grad_cov):
    tg, jg = _pair(data)
    assert tg.neighbors == jg.neighbors and len(tg.neighbors) == 20
    ll, gX, gC = _assert_llgrad_close(tg, jg, grad_X=grad_X, grad_cov=grad_cov, local=local)
    assert gX.shape == (300, 2) and gC.shape == (1, 4)
    assert bool(np.any(gX)) == grad_X and bool(np.any(gC)) == grad_cov


def test_layout_of_the_model_matches_jax(data):
    tg, jg = _pair(data)
    for f in ("assignment", "mask", "sizes", "edges", "neighbor_count"):
        np.testing.assert_array_equal(getattr(tg.layout, f), getattr(jg.layout, f))
    assert tg.neighbor_count == jg.neighbor_count and tg.n_blocks == jg.n_blocks
    for a, b in zip(tg.block_idxs, jg.block_idxs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wfn_str,threshold", [("se", 1e-3), ("se", 0.3), ("matern32", 0.05),
                                               ("se", 1.0)])
def test_compute_neighbors_matches_jax(data, wfn_str, threshold):
    t, _ = data
    layout = _pair(data)[0].layout
    X = t.X_obs
    jcov = JCov.create([1.2], [0.05, 0.08], "euclidean", wfn_str)
    tcov = cov_from_numpy([1.2], [0.05, 0.08], "euclidean", wfn_str, **F64)
    arrays = layout.device_arrays(**F64)
    t_edges = t_compute_neighbors(torch.as_tensor(X), arrays["assignment"], arrays["mask"], tcov,
                                  threshold=threshold)
    j_edges = j_compute_neighbors(jnp.asarray(X), jnp.asarray(layout.assignment),
                                  jnp.asarray(layout.mask), jcov, threshold=threshold)
    assert t_edges == j_edges
    assert (threshold == 1.0) == (t_edges == [])
    assert threshold == 1.0 or 0 < len(t_edges) < 36


def test_neighbors_discovered_by_the_model_match_jax(data):
    t, j = data
    args = dict(block_fn=None, noise_var=0.01, neighbor_threshold=0.05)
    tg = TGPRF(t.X_obs, t.SY, cov=t.cov, block_idxs=t.block_idxs, **args, **F64)
    jg = JGPRF(j.X_obs, j.SY, cov=j.cov, block_idxs=j.block_idxs, **args)
    assert tg.neighbors == jg.neighbors and tg.neighbors
    _assert_llgrad_close(tg, jg, grad_X=True)
    tg.update_X(t.SX, recompute_neighbors=True)  # block_fn None: the partition stays
    jg.update_X(j.SX, recompute_neighbors=True)
    assert tg.neighbors == jg.neighbors
    _assert_llgrad_close(tg, jg, grad_X=True)


def test_update_X_across_a_change_of_m_matches_jax(data):
    """Pull a third of the points into one block: the widest block outgrows
    the padded width and both models rebuild at the same new m."""
    t, _ = data
    tg, jg = _pair(data)
    m0 = tg.layout.block_pad
    X = t.X_obs.copy()
    X[:100] = X[:100] * 0.1 + 0.1
    for g in (tg, jg):
        g.update_X(X)
    assert tg.layout.block_pad == jg.layout.block_pad > m0
    np.testing.assert_array_equal(tg.layout.assignment, jg.layout.assignment)
    _assert_llgrad_close(tg, jg, grad_X=True, grad_cov=True)
    # and back: the width never shrinks
    for g in (tg, jg):
        g.update_X(t.X_obs)
    assert tg.layout.block_pad == jg.layout.block_pad > m0
    _assert_llgrad_close(tg, jg, grad_X=True)
    for g in (tg, jg):
        g.update_X(X * 1.01, update_blocks=False)
    _assert_llgrad_close(tg, jg, grad_X=True)


def test_update_covs_and_update_X_block_match_jax(data):
    t, _ = data
    tg, jg = _pair(data)
    FC = np.array([[0.02, 1.3, 0.12, 0.2]])
    block = t.SX[tg.block_idxs[4]] + 0.001
    for g in (tg, jg):
        g.update_covs(FC)
        g.update_X_block(4, block)
    assert tg.noise_var == jg.noise_var == 0.02
    np.testing.assert_array_equal(tg.X, jg.X)
    _assert_llgrad_close(tg, jg, grad_X=True, grad_cov=True)


def test_subset_and_single_term_llgrads_match_jax(data):
    tg, jg = _pair(data)
    np.testing.assert_allclose(tg.subset_llgrad([0, 1, 3, 4]), jg.subset_llgrad([0, 1, 3, 4]),
                               rtol=RTOL)
    np.testing.assert_allclose(tg.subset_llgrad(range(9)), tg.llgrad()[0], rtol=RTOL)
    for t, j in ((tg.llgrad_unary(2, grad_X=True, grad_cov=True),
                  jg.llgrad_unary(2, grad_X=True, grad_cov=True)),
                 (tg.llgrad_joint(4, 1, grad_X=True, grad_cov=True),
                  jg.llgrad_joint(4, 1, grad_X=True, grad_cov=True))):
        np.testing.assert_allclose(t[0], j[0], rtol=RTOL)
        _close(t[1], j[1])
        _close(t[2], j[2])
    ll, gX, gC = tg.gaussian_llgrad(np.zeros((0, 2)), np.zeros((0, 4)))
    assert ll == 0.0 and gX.shape == (0, 2) and gC.shape == (4,)


def test_local_gps_have_no_edges(data):
    t, j = data
    tg = t.build_gprf(local_dist=1.0, **F64)
    jg = j.build_gprf(local_dist=1.0)
    assert tg.neighbors == jg.neighbors == []
    _assert_llgrad_close(tg, jg, grad_X=True, grad_cov=True)


def test_the_models_leaves_are_an_option(data):
    """ops=PLAIN_OPS runs the twins under autograd; on the CPU the kernel
    wrappers run them too, so both agree to the last bits."""
    tg, _ = _pair(data)
    tp, _ = _pair(data, ops=mvn.PLAIN_OPS)
    a, b = tg.llgrad(grad_X=True, grad_cov=True), tp.llgrad(grad_X=True, grad_cov=True)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-12)
    _close(a[1], b[1], rtol=1e-9)
    _close(a[2], b[2], rtol=1e-9)


@pytest.mark.parametrize("option", [dict(kernelized=True), dict(form="dense"),
                                    dict(mesh=object()), dict(nonstationary=True)])
def test_unported_model_options_raise(data, option):
    """Options the port does not serve raise; an unknown form, and the
    kernelized model without its dy, are refused as wrong values (the joint
    form is served: tests/test_torch_joint.py; the kernelized model:
    tests/test_torch_kernelized.py)."""
    t, _ = data
    with pytest.raises(ValueError if {"form", "kernelized"} & set(option)
                       else NotImplementedError):
        TGPRF(t.X_obs, t.SY, t.reblock, t.cov, 0.01, block_idxs=t.block_idxs, neighbors=[],
              **option, **F64)


def test_unported_model_methods_raise(data):
    """llgrad(sparse=True) runs (tests/test_torch_sparse.py), but not on a
    kernelized model, which holds YY and no Y."""
    t, _ = data
    tg = TGPRF(t.X_obs, t.SY @ t.SY.T, t.reblock, t.cov, 0.01, kernelized=True, dy=4,
               block_idxs=t.block_idxs, neighbors=[], **F64)
    with pytest.raises(ValueError, match="YY"):
        tg.llgrad(sparse=True)


@pytest.mark.parametrize("test_noise_var", [0.0, 0.01])
def test_train_predictor_matches_jax(data, test_noise_var):
    """GPRF.train_predictor at the model's current X, after an update_X."""
    tg, jg = _pair(data)
    X = data[0].X_obs + np.random.default_rng(3).normal(size=data[0].X_obs.shape) * 0.005
    tg.update_X(X)
    jg.update_X(X)
    Xstar = data[0].Xtest[:9]
    for a, b in zip(tg.train_predictor()(Xstar, test_noise_var=test_noise_var),
                    jg.train_predictor()(Xstar, test_noise_var=test_noise_var)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-10)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("grad_X,grad_cov", [(True, True), (False, False)])
def test_value_and_grad_schur_matches_jax(monkeypatch, data, use_pallas, grad_X, grad_cov):
    """The function under GPRF.llgrad, gradCov's row laid out [nv, sv, l1,
    l2]; with use_pallas the reference's Pallas leaves run in interpret
    mode."""
    if use_pallas:
        for name in ("batched_chol_inv_pallas", "batched_tri_inv_pallas"):
            orig = getattr(pm, name)
            monkeypatch.setattr(pm, name, lambda A, interpret=False, _f=orig: _f(A, True))
        orig_mvn = pm.batched_mvn_ll_pallas
        monkeypatch.setattr(pm, "batched_mvn_ll_pallas",
                            lambda K, Y, n, interpret=False: orig_mvn(K, Y, n, True))
    t, j = data
    layout = _pair(data)[0].layout
    rng = np.random.default_rng(3)
    X = t.X_obs + rng.normal(size=t.X_obs.shape) * 0.005
    wfn, dfn, nv = [1.1], [0.12, 0.2], 0.02
    ta = layout.device_arrays(**F64)
    ja = {k: jnp.asarray(v.numpy()) for k, v in ta.items()}
    names = ("assignment", "mask", "edges", "unary_weights", "pair_weights")
    tll, tgX, tgC = tobjective.gprf_value_and_grad_schur(
        params_from_numpy(X, wfn, dfn, nv, **F64), torch.as_tensor(t.SY),
        *(ta[k] for k in names), grad_X=grad_X, grad_cov=grad_cov)
    jll, jgX, jgC = jobjective.gprf_value_and_grad_schur(
        jobjective.GPRFParams(X=jnp.asarray(X), wfn_params=jnp.asarray(wfn),
                              dfn_params=jnp.asarray(dfn), noise_var=jnp.asarray(nv)),
        jnp.asarray(j.SY), *(ja[k] for k in names), grad_X=grad_X, grad_cov=grad_cov,
        use_pallas=use_pallas)
    np.testing.assert_allclose(float(tll), float(jll), rtol=RTOL)
    _close(tgX.numpy(), jgX)
    _close(tgC.numpy(), jgC)
    assert tgC.shape == (1, 4) and not tll.requires_grad
