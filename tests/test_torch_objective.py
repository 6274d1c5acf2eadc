"""gprf_torch.model.objective.gprf_ll_schur against gprf_tpu's, float64 on
the CPU: the log-likelihood and its gradients with respect to X, the
lengthscales, the signal variance and the noise variance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gprf_tpu.ops.pallas_mvn as pm
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model.gprf import GPRF
from gprf_tpu.model.objective import GPRFParams as JParams
from gprf_tpu.model.objective import gprf_ll_schur as j_ll_schur
from gprf_tpu.partition.grid import Blocker, grid_centers
from gprf_torch.model.objective import gprf_ll_schur
from gprf_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route gprf_tpu's Pallas leaves through interpret mode (the split
    compositions look them up at call time), as tests/test_objective.py does."""
    for name in ("batched_chol_inv_pallas", "batched_tri_inv_pallas"):
        orig = getattr(pm, name)
        monkeypatch.setattr(pm, name, lambda A, interpret=False, _f=orig: _f(A, True))
    orig_mvn = pm.batched_mvn_ll_pallas
    monkeypatch.setattr(pm, "batched_mvn_ll_pallas",
                        lambda K, Y, n, interpret=False: orig_mvn(K, Y, n, True))


def _problem(rng, n, nblocks, dy, diag, lscale=0.25, wfn="se"):
    X = rng.uniform(size=(n, 2))
    Y = rng.normal(size=(n, dy))
    b = Blocker(grid_centers(nblocks))
    cov = JCov.create([1.3], [lscale, 0.8 * lscale], wfn_str=wfn)
    g = GPRF(X, Y, None, cov, 0.01, block_idxs=b.block_clusters(X),
             neighbors=b.neighbors(diag_connections=diag))
    arrays = {k: np.asarray(v) for k, v in g.layout.device_arrays().items()}
    return X, Y, cov, arrays


def _jax_value_and_grad(X, Y, cov, arrays, use_pallas, dtype=jnp.float64):
    p = JParams(X=jnp.asarray(X, dtype), wfn_params=jnp.asarray(cov.wfn_params, dtype),
                dfn_params=jnp.asarray(cov.dfn_params, dtype),
                noise_var=jnp.asarray(0.01, dtype))

    def f(p):
        return j_ll_schur(p, jnp.asarray(Y, dtype), arrays["assignment"], arrays["mask"],
                          arrays["edges"], jnp.asarray(arrays["unary_weights"], dtype),
                          jnp.asarray(arrays["pair_weights"], dtype),
                          wfn_str=cov.wfn_str, use_pallas=use_pallas)

    v, g = jax.value_and_grad(f)(p)
    return float(v), [np.asarray(a) for a in (g.X, g.dfn_params, g.wfn_params, g.noise_var)]


def _torch_value_and_grad(X, Y, cov, arrays, dtype=torch.float64, acc_dtype=None):
    p = params_from_numpy(X, np.asarray(cov.wfn_params), np.asarray(cov.dfn_params), 0.01,
                          device="cpu", dtype=dtype)
    for t in p:
        t.requires_grad_(True)
    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    ll = gprf_ll_schur(p, torch.as_tensor(Y, dtype=dtype), t["assignment"], t["mask"],
                       t["edges"], t["unary_weights"].to(dtype), t["pair_weights"].to(dtype),
                       wfn_str=cov.wfn_str, acc_dtype=acc_dtype)
    grads = torch.autograd.grad(ll, (p.X, p.dfn_params, p.wfn_params, p.noise_var))
    return float(ll.detach()), [g.numpy() for g in grads]


PROBLEMS = [
    dict(n=40, nblocks=4, dy=3, diag=True),
    dict(n=60, nblocks=9, dy=4, diag=False),
    dict(n=30, nblocks=4, dy=2, diag=True, wfn="matern32"),
    dict(n=36, nblocks=9, dy=3, diag=True, lscale=0.15),
]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("prob", range(len(PROBLEMS)))
def test_gprf_ll_schur_matches_jax(rng, pallas_interpret, prob, use_pallas):
    X, Y, cov, arrays = _problem(rng, **PROBLEMS[prob])
    v_ref, g_ref = _jax_value_and_grad(X, Y, cov, arrays, use_pallas)
    v, g = _torch_value_and_grad(X, Y, cov, arrays)
    np.testing.assert_allclose(v, v_ref, rtol=1e-9)
    for got, ref in zip(g, g_ref):
        np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-10)


def test_no_edges_is_the_sum_of_local_gps(rng):
    X, Y, cov, arrays = _problem(rng, 30, 4, 2, True)
    arrays["edges"] = np.zeros((0, 2), np.int32)
    arrays["pair_weights"] = np.zeros((0,))
    arrays["unary_weights"] = np.ones_like(arrays["unary_weights"])
    v_ref, g_ref = _jax_value_and_grad(X, Y, cov, arrays, False)
    v, g = _torch_value_and_grad(X, Y, cov, arrays)
    np.testing.assert_allclose(v, v_ref, rtol=1e-9)
    np.testing.assert_allclose(g[0], g_ref[0], rtol=1e-7, atol=1e-10)


def test_float32_with_float64_tails_matches_jax(rng):
    """float32 block algebra with the scalar tails accumulated in float64,
    against gprf_tpu in float32 (whose tails follow the x64 flag, on here)."""
    X, Y, cov, arrays = _problem(rng, 40, 4, 3, True)
    v_ref, g_ref = _jax_value_and_grad(X, Y, cov, arrays, False, dtype=jnp.float32)
    v, g = _torch_value_and_grad(X, Y, cov, arrays, dtype=torch.float32,
                                 acc_dtype=torch.float64)
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    scale = np.abs(g_ref[0]).max()
    assert np.abs(g[0] - g_ref[0]).max() <= 1e-3 * scale
