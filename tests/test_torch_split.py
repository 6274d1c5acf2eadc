"""gprf_torch.ops.split_mvn against gprf_tpu.ops.split_mvn (Pallas leaves in
interpret mode), float64 on the CPU, with leaf=16 forcing the split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.linalg.masked import pad_kernel_matrix
from gprf_tpu.ops import split_mvn as jsplit
from gprf_torch.ops import mvn
from gprf_torch.ops import split_mvn as tsplit

torch.set_num_threads(1)


def _spd(rng, B, m):
    A = rng.normal(size=(B, m, m))
    return np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def test_split_point_matches_jax():
    for m in (17, 40, 136, 192, 216, 512):
        assert tsplit.split_point(m) == jsplit._split_point(m)


def test_chol_inv_split_matches_jax(rng):
    K = _spd(rng, 3, 40)
    L_ref, W_ref = jsplit.chol_inv_split(jnp.asarray(K), interpret=True, leaf=16)
    L, W = tsplit.chol_inv_split(_t(K), leaf=16)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), rtol=1e-9, atol=1e-12)


def test_tri_inv_split_matches_jax(rng):
    L = np.linalg.cholesky(_spd(rng, 4, 40))
    W_ref = jsplit.tri_inv_split(jnp.asarray(L), interpret=True, leaf=16)
    W = tsplit.tri_inv_split(_t(L), leaf=16)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dy", [1, 5])
def test_mvn_ll_split_matches_jax_across_the_boundary(rng, dy):
    # n_active above, at and below the split point h = 24 of m = 40; a block
    # masked past the boundary exercises the identity Schur leaf
    m, n_actives = 40, [40, 30, 24, 17, 8]
    K = _spd(rng, len(n_actives), m)
    mask = np.arange(m)[None, :] < np.asarray(n_actives)[:, None]
    Kp = np.asarray(jax.vmap(pad_kernel_matrix)(jnp.asarray(K), jnp.asarray(mask)))
    Ym = rng.normal(size=(len(n_actives), m, dy)) * mask[:, :, None]
    nact = mask.sum(axis=1).astype(np.float64)
    ll_ref = jsplit.mvn_ll_split(jnp.asarray(Kp), jnp.asarray(Ym), jnp.asarray(nact),
                                 interpret=True, leaf_mvn=16, leaf_chol=16)
    ll = tsplit.mvn_ll_split(_t(Kp), _t(Ym), _t(nact), leaf_mvn=16, leaf_chol=16)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=1e-9)


def test_split_gradients_match_jax(rng):
    """Cotangents through the compositions (leaf Functions + products)
    equal JAX's through its custom-VJP leaves."""
    m, dy = 40, 3
    A = rng.normal(size=(2, m, m))
    Y = rng.normal(size=(2, m, dy))
    C = rng.normal(size=(2, m, m))
    nact = np.array([m, m], dtype=np.float64)

    def f_jax(A, Y):
        K = jnp.einsum("bij,bkj->bik", A, A) + m * jnp.eye(m)
        L, W = jsplit.chol_inv_split(K, interpret=True, leaf=16)
        Wt = jsplit.tri_inv_split(L, interpret=True, leaf=16)
        ll = jsplit.mvn_ll_split(K, Y, jnp.asarray(nact), interpret=True,
                                 leaf_mvn=16, leaf_chol=16)
        return jnp.sum(ll) + jnp.sum((L + W + Wt) * C)

    def f_torch(A, Y):
        K = A @ A.mT + m * torch.eye(m, dtype=A.dtype)
        L, W = tsplit.chol_inv_split(K, leaf=16)
        Wt = tsplit.tri_inv_split(L, leaf=16)
        ll = tsplit.mvn_ll_split(K, Y, _t(nact), leaf_mvn=16, leaf_chol=16)
        return ll.sum() + ((L + W + Wt) * _t(C)).sum()

    v_ref, g_ref = jax.value_and_grad(f_jax, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(Y))
    At, Yt = _t(A).requires_grad_(True), _t(Y).requires_grad_(True)
    v = f_torch(At, Yt)
    g = torch.autograd.grad(v, (At, Yt))
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-9)
    for got, ref in zip(g, g_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-7, atol=1e-9)


def test_kernel_and_plain_ops_agree_through_the_split(rng):
    K = _t(_spd(rng, 2, 40))
    Y = _t(rng.normal(size=(2, 40, 4)))
    n = _t([40.0, 40.0])
    for a, b in zip(tsplit.chol_inv_split(K, leaf=16, ops=mvn.KERNEL_OPS),
                    tsplit.chol_inv_split(K, leaf=16, ops=mvn.PLAIN_OPS)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        tsplit.mvn_ll_split(K, Y, n, 16, 16, ops=mvn.KERNEL_OPS).numpy(),
        tsplit.mvn_ll_split(K, Y, n, 16, 16, ops=mvn.PLAIN_OPS).numpy(), rtol=1e-12)


def test_flagship_width_needs_no_split():
    """The leaf caps are the kernels' shared-memory caps, so m = 136 at
    dy = 50 goes straight to one kernel launch, and wider m splits."""
    assert tsplit.LEAF_CHOL == mvn.MAX_M_CHOL_INV >= 136
    assert tsplit.LEAF_TRI == mvn.MAX_M_TRI_INV >= 136
    assert mvn.mvn_max_m(50) >= 136
    calls = []
    ops = mvn.Ops(chol_inv=lambda K: calls.append(K.shape[-1]) or mvn.chol_inv_plain(K),
                  mvn_ll=lambda K, Y, n: calls.append(K.shape[-1]) or mvn.mvn_ll_plain(K, Y, n)[0],
                  tri_inv=mvn.tri_inv_plain)
    eye = torch.eye(136, dtype=torch.float64).expand(2, 136, 136)
    tsplit.chol_inv_split(eye, ops=ops)
    tsplit.mvn_ll_split(eye, torch.zeros(2, 136, 50, dtype=torch.float64),
                        _t([136.0, 136.0]), ops=ops)
    assert calls == [136, 136]
    calls.clear()
    wide = torch.eye(176, dtype=torch.float64).expand(1, 176, 176)
    tsplit.chol_inv_split(wide, ops=ops)
    assert calls == [88, 88]
