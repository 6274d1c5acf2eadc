"""gprf_torch.kernels, linalg.masked and partition.grid against their
gprf_tpu counterparts, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.kernels import covfn as jcovfn
from gprf_tpu.kernels import distances as jdist
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.linalg import masked as jmasked
from gprf_tpu.partition import grid as jgrid
from gprf_torch.kernels import covfn, distances
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.linalg import masked
from gprf_torch.partition import grid
from gprf_torch.utils.convert import cov_from_numpy, params_from_numpy

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@pytest.mark.parametrize("dx", [2, 3, 20])
def test_sq_euclidean_matches_jax(rng, dx):
    X1, X2 = rng.normal(size=(7, dx)), rng.normal(size=(5, dx))
    ls = rng.uniform(0.5, 2.0, size=dx)
    ref = jdist.sq_euclidean(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(ls))
    got = distances.sq_euclidean(_t(X1), _t(X2), _t(ls))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_scaled_distance_and_batching_match_jax(rng):
    X1, X2 = rng.normal(size=(4, 6, 2)), rng.normal(size=(4, 5, 2))
    ls = np.array([0.3, 0.7])
    ref = jax.vmap(lambda a, b: jdist.scaled_distance("euclidean", a, b, jnp.asarray(ls)))(
        jnp.asarray(X1), jnp.asarray(X2))
    got = distances.scaled_distance("euclidean", _t(X1), _t(X2), _t(ls))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("wfn", ["se", "matern32"])
def test_covfn_values_and_gradients_match_jax(rng, wfn):
    X1, X2 = rng.uniform(size=(6, 2)), rng.uniform(size=(5, 2))
    X2[0] = X1[0]  # a coincident pair
    sv, ls = np.array([1.3]), np.array([0.2, 0.4])
    jc = JCov.create(sv, ls, "euclidean", wfn)

    def f_jax(X1, sv, ls):
        return jnp.sum(jnp.sin(jcovfn.cross_kernel_matrix(jc.with_params(sv, ls), X1,
                                                          jnp.asarray(X2))))

    ins = [_t(a).requires_grad_(True) for a in (X1, sv, ls)]
    cov = GPCov(ins[1], ins[2], "euclidean", wfn)
    v = torch.sum(torch.sin(covfn.cross_kernel_matrix(cov, ins[0], _t(X2))))
    grads = torch.autograd.grad(v, ins)
    v_ref, g_ref = jax.value_and_grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(X1), jnp.asarray(sv), jnp.asarray(ls))
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-12)
    for got, ref in zip(grads, g_ref):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


def test_kernel_matrix_with_noise_matches_jax(rng):
    X = rng.uniform(size=(9, 2))
    jc = JCov.create([1.4], [0.3, 0.2])
    ref = jcovfn.kernel_matrix(jc, jnp.asarray(X), 0.05)
    got = covfn.kernel_matrix(cov_from_numpy([1.4], [0.3, 0.2], device="cpu",
                                             dtype=torch.float64), _t(X), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_safe_sqrt_zero_gradient_at_coincident_points():
    x = _t([0.0, 1e-21, 4.0]).requires_grad_(True)
    (g,) = torch.autograd.grad(distances.safe_sqrt(x).sum(), x)
    np.testing.assert_array_equal(g.numpy(), [0.0, 0.0, 0.25])
    X = _t([[0.1, 0.2], [0.1, 0.2], [0.5, 0.9]]).requires_grad_(True)
    r = distances.scaled_distance("euclidean", X, X, _t([0.3, 0.3]))
    (gX,) = torch.autograd.grad(r.sum(), X)
    assert np.isfinite(gX.numpy()).all()
    ref = jax.grad(lambda X: jnp.sum(jdist.scaled_distance(
        "euclidean", X, X, jnp.asarray([0.3, 0.3]))))(jnp.asarray(X.detach().numpy()))
    np.testing.assert_allclose(gX.numpy(), np.asarray(ref), rtol=1e-12)


def test_lld_waits_for_the_seismic_slice():
    """The great-circle distance, once a stub, now matches gprf_tpu's
    through the dispatch (the seismic tests hold it and its gradient)."""
    X = _t([[140.0, 10.0, 5.0], [141.0, 11.0, 50.0], [-40.0, -10.0, 0.0]])
    got = distances.scaled_sq_distance("lld", X, X, _t([40.0, 20.0]))
    ref = jdist.scaled_sq_distance("lld", jnp.asarray(X.numpy()), jnp.asarray(X.numpy()),
                                   jnp.asarray([40.0, 20.0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    with pytest.raises(ValueError):
        GPCov.create([1.0], [1.0], "nope", device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError):
        GPCov.create([1.0], [1.0], wfn_str="nope", device="cpu", dtype=torch.float64)


def test_masked_gaussian_ll_matches_jax(rng):
    m, dy, B = 10, 3, 3
    A = rng.normal(size=(B, m, m))
    K = np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)
    Y = rng.normal(size=(B, m, dy))
    mask = np.arange(m)[None, :] < np.array([[10], [7], [2]])
    ref_pad = jax.vmap(jmasked.pad_kernel_matrix)(jnp.asarray(K), jnp.asarray(mask))
    np.testing.assert_array_equal(masked.pad_kernel_matrix(_t(K), torch.as_tensor(mask)).numpy(),
                                  np.asarray(ref_pad))
    ll_ref, L_ref, a_ref = jax.vmap(jmasked.masked_gaussian_ll_cached)(
        jnp.asarray(K), jnp.asarray(Y), jnp.asarray(mask))
    ll, L, alpha = masked.masked_gaussian_ll_cached(_t(K), _t(Y), torch.as_tensor(mask))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=1e-12)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(a_ref), rtol=1e-10, atol=1e-14)
    assert float(masked.masked_gaussian_ll(_t(K[1]), _t(Y[1]), torch.as_tensor(mask[1]))) \
        == pytest.approx(float(ll_ref[1]), rel=1e-12)


def test_grid_partition_matches_jax(rng):
    for nblocks in (4, 9, 100):
        assert np.array_equal(np.asarray(grid.grid_centers(nblocks)),
                              np.asarray(jgrid.grid_centers(nblocks)))
        tb = grid.Blocker(grid.grid_centers(nblocks))
        jb = jgrid.Blocker(jgrid.grid_centers(nblocks))
        for diag in (True, False):
            assert tb.neighbors(diag) == jb.neighbors(diag)
        X = rng.uniform(size=(300, 2))
        for a, b in zip(tb.block_clusters(X), jb.block_clusters(X)):
            np.testing.assert_array_equal(a, b)
    assert len(grid.Blocker(grid.grid_centers(100)).neighbors(diag_connections=False)) == 180


def test_convert_carries_dtype_and_device():
    p = params_from_numpy(np.ones((3, 2)), [1.0], [0.1, 0.2], 0.01, device="cpu",
                          dtype=torch.float32)
    assert p.X.shape == (3, 2) and p.noise_var.shape == () and p.dfn_params.shape == (2,)
    assert {t.dtype for t in p} == {torch.float32}
    cov = cov_from_numpy(np.array([2.0]), np.array([0.5, 0.5]), "euclidean", "matern32",
                         device="cpu", dtype=torch.float64)
    assert cov.wfn_str == "matern32" and cov.wfn_params.tolist() == [2.0]
    assert cov.dfn_params.dtype == torch.float64 and cov.dfn_params.shape == (2,)
