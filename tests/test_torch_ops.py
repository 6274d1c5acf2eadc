"""gprf_torch.ops.mvn: the plain twins of K1, K2 and K3 and the analytic
backward passes of their autograd Functions, against the Pallas kernels of
gprf_tpu in interpret mode, in float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.linalg.masked import pad_kernel_matrix
from gprf_tpu.ops.pallas_mvn import (
    batched_chol_inv_pallas,
    batched_mvn_ll_pallas,
    batched_tri_inv_pallas,
)
from gprf_torch.ops import mvn

torch.set_num_threads(1)


def _spd(rng, B, m):
    A = rng.normal(size=(B, m, m))
    return np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)


def _masked(rng, B, m, dy, n_actives):
    K = _spd(rng, B, m)
    mask = np.arange(m)[None, :] < np.asarray(n_actives)[:, None]
    Kp = np.asarray(jax.vmap(pad_kernel_matrix)(jnp.asarray(K), jnp.asarray(mask)))
    Ym = rng.normal(size=(B, m, dy)) * mask[:, :, None]
    return Kp, Ym, mask.sum(axis=1).astype(np.float64)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@pytest.mark.parametrize("B,m", [(3, 24), (5, 40)])
def test_chol_inv_twin_matches_pallas(rng, B, m):
    K = _spd(rng, B, m)
    L_ref, W_ref = batched_chol_inv_pallas(jnp.asarray(K), True)
    L, W = mvn.chol_inv(_t(K))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("B,m", [(3, 24), (7, 33)])
def test_tri_inv_twin_matches_pallas(rng, B, m):
    L = np.linalg.cholesky(_spd(rng, B, m))
    W_ref = batched_tri_inv_pallas(jnp.asarray(L), True)
    np.testing.assert_allclose(mvn.tri_inv(_t(L)).numpy(), np.asarray(W_ref),
                               rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("n_actives,dy", [([20, 17, 9], 6), ([40, 40, 31, 3, 12], 1)])
def test_mvn_ll_twin_matches_pallas(rng, n_actives, dy):
    m = max(n_actives) if max(n_actives) % 8 == 0 else 24
    Kp, Ym, nact = _masked(rng, len(n_actives), m, dy, n_actives)
    ll_ref = batched_mvn_ll_pallas(jnp.asarray(Kp), jnp.asarray(Ym), jnp.asarray(nact), True)
    ll, L = mvn.mvn_ll(_t(Kp), _t(Ym), _t(nact))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=1e-10)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(Kp), rtol=1e-10, atol=1e-13)


def test_chol_inv_backward_matches_jax_vjp(rng):
    B, m = 3, 20
    K = _spd(rng, B, m)
    dL, dW = rng.normal(size=(2, B, m, m))
    _, vjp = jax.vjp(lambda K: batched_chol_inv_pallas(K, True), jnp.asarray(K))
    (dK_ref,) = vjp((jnp.asarray(dL), jnp.asarray(dW)))
    Kt = _t(K).requires_grad_(True)
    L, W = mvn.CholInv.apply(Kt)
    (dK,) = torch.autograd.grad((L, W), Kt, (_t(dL), _t(dW)))
    np.testing.assert_allclose(dK.numpy(), np.asarray(dK_ref), rtol=1e-8, atol=1e-12)


def test_mvn_ll_backward_matches_jax_vjp(rng):
    Kp, Ym, nact = _masked(rng, 4, 24, 5, [24, 19, 11, 6])
    g = rng.normal(size=4)
    _, vjp = jax.vjp(lambda K, Y, n: batched_mvn_ll_pallas(K, Y, n, True),
                     jnp.asarray(Kp), jnp.asarray(Ym), jnp.asarray(nact))
    refs = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_(True) for a in (Kp, Ym, nact)]
    grads = torch.autograd.grad(mvn.MvnLL.apply(*ins), ins, _t(g))
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-12)


def test_tri_inv_backward_matches_jax_vjp(rng):
    B, m = 3, 16
    L = np.linalg.cholesky(_spd(rng, B, m))
    dW = rng.normal(size=(B, m, m))
    _, vjp = jax.vjp(lambda L: batched_tri_inv_pallas(L, True), jnp.asarray(L))
    (dL_ref,) = vjp(jnp.asarray(dW))
    Lt = _t(L).requires_grad_(True)
    (dL,) = torch.autograd.grad(mvn.TriInv.apply(Lt), Lt, _t(dW))
    np.testing.assert_allclose(dL.numpy(), np.asarray(dL_ref), rtol=1e-8, atol=1e-12)


# The Functions return symmetrized K-cotangents, while finite differences of
# one matrix entry see only the triangle the factorization reads; so each
# check goes through a symmetric (or triangular) parametrization.


def test_gradcheck_chol_inv(rng):
    A = _t(rng.normal(size=(2, 6, 6))).requires_grad_(True)

    def f(A):
        return mvn.CholInv.apply(A @ A.mT + 6.0 * torch.eye(6, dtype=A.dtype))

    assert torch.autograd.gradcheck(f, (A,))


def test_gradcheck_mvn_ll(rng):
    A = _t(rng.normal(size=(3, 7, 7))).requires_grad_(True)
    Y = _t(rng.normal(size=(3, 7, 2))).requires_grad_(True)
    n = _t([7.0, 5.0, 3.0]).requires_grad_(True)

    def f(A, Y, n):
        return mvn.MvnLL.apply(A @ A.mT + 7.0 * torch.eye(7, dtype=A.dtype), Y, n)

    assert torch.autograd.gradcheck(f, (A, Y, n))


def test_gradcheck_tri_inv(rng):
    A = _t(rng.normal(size=(2, 6, 6))).requires_grad_(True)

    def f(A):
        return mvn.TriInv.apply(torch.tril(A) + 4.0 * torch.eye(6, dtype=A.dtype))

    assert torch.autograd.gradcheck(f, (A,))


def test_functions_match_twin_autograd(rng):
    """The analytic backward passes agree with PyTorch's autograd through
    the twins, end to end through a symmetric K(A)."""
    m, dy = 12, 3
    A = _t(rng.normal(size=(2, m, m)))
    Y = _t(rng.normal(size=(2, m, dy)))
    n = _t([m, m])
    C = _t(rng.normal(size=(2, m, m)))

    def f(A, ops):
        K = A @ A.mT + m * torch.eye(m, dtype=A.dtype)
        L, W = ops.chol_inv(K)
        return (ops.mvn_ll(K, Y, n).sum() + (L * C).sum() + (W * C).sum()
                + (ops.tri_inv(L) * C).sum())

    grads = []
    for ops in (mvn.KERNEL_OPS, mvn.PLAIN_OPS):
        a = A.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(f(a, ops), a)[0].numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-9, atol=1e-12)


def test_cpu_calls_launch_no_kernel(rng):
    mvn.reset_launch_counts()
    Kp, Ym, nact = _masked(rng, 2, 8, 2, [8, 5])
    K = _t(Kp).requires_grad_(True)
    ll = mvn.MvnLL.apply(K, _t(Ym), _t(nact))
    L, W = mvn.CholInv.apply(K)
    (ll.sum() + W.sum() + mvn.TriInv.apply(L).sum()).backward()
    assert mvn.launch_counts == {"chol_inv": 0, "mvn_ll": 0, "tri_inv": 0}


def test_twin_gives_nan_on_non_pd_like_jax(rng):
    K = _spd(rng, 2, 6)
    K[1] -= 100.0 * np.eye(6)
    L, W = mvn.chol_inv(_t(K))
    L_ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(K)))
    np.testing.assert_array_equal(np.isnan(L.numpy()), np.isnan(L_ref))
    assert np.isnan(L_ref[1]).any() and np.isfinite(L_ref[0]).all()
    np.testing.assert_allclose(L.numpy(), L_ref, rtol=1e-12)
    assert np.isnan(W[1].numpy()).any()


def test_kernel_caps_follow_shared_memory():
    """The caps the wrappers enforce are what 227 KB of shared memory holds."""
    m = mvn.MAX_M_CHOL_INV
    assert (2 * m * m + m) * 4 <= mvn.SMEM_BYTES
    assert 2 * mvn.MAX_M_TRI_INV**2 * 4 <= mvn.SMEM_BYTES
    assert mvn.mvn_max_m(50) == 216
    for dy in (1, 5, 50, 256):
        m = mvn.mvn_max_m(dy)
        assert mvn.mvn_smem_bytes(m, dy) <= mvn.SMEM_BYTES < mvn.mvn_smem_bytes(m + 1, dy)
        assert mvn.mvn_smem_bytes(m, dy) == (m * m + m * dy + m) * 4 + 64
    assert mvn.mvn_max_m(1) <= 256  # K2's register slices cover 8 x 32 columns
    assert 136 <= mvn.MAX_M_CHOL_INV and 136 <= mvn.mvn_max_m(50)


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError):
        mvn.chol_inv(torch.eye(4, device="meta")[None])
