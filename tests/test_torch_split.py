"""gprf_torch.ops.split_mvn against gprf_tpu.ops.split_mvn (Pallas leaves in
interpret mode), float64 on the CPU, with leaf=16 forcing the split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.linalg.masked import pad_kernel_matrix
from gprf_tpu.ops import pallas_mvn as pm
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


def _padded_spd(rng, m, n_actives):
    K = _spd(rng, len(n_actives), m)
    mask = np.arange(m)[None, :] < np.asarray(n_actives)[:, None]
    return np.asarray(jax.vmap(pad_kernel_matrix)(jnp.asarray(K), jnp.asarray(mask)))


# n_active above, at and below the split point h = 24 of m = 40 (and of
# the nested splits at leaf 8)
@pytest.mark.parametrize("leaf", [16, 8])
def test_cholesky_split_matches_jax(rng, leaf):
    """The split over K5 leaves and K3 against gprf_tpu's Cholesky kernel
    run whole (its route's call above the port's leaf cap), values and
    cotangents, padded blocks included.  The split reads only K21 of the
    off-diagonal blocks, so its cotangent equals the kernel's symmetrized
    one once symmetrized itself (K is symmetric in every caller)."""
    Kp = _padded_spd(rng, 40, [40, 30, 24, 17, 8])
    dL = rng.normal(size=Kp.shape)
    L_ref, vjp = jax.vjp(lambda K: pm.batched_cholesky_pallas(K, True), jnp.asarray(Kp))
    (dK_ref,) = vjp(jnp.asarray(dL))
    K = _t(Kp).requires_grad_(True)
    L = tsplit.cholesky_split(K, leaf=leaf)
    (dK,) = torch.autograd.grad(L, K, _t(dL))
    np.testing.assert_allclose(L.detach().numpy(), np.asarray(L_ref), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose((0.5 * (dK + dK.mT)).numpy(), np.asarray(dK_ref),
                               rtol=1e-7, atol=1e-9)


def test_cholesky_split_keeps_every_leaf_on_the_kernels():
    """Up to the K5 cap one cholesky call; past it, leaves <= the cap and
    one triangular inverse per split, never a chol_inv."""
    calls = []

    def rec(name, f):
        return lambda A: calls.append((name, A.shape[-1])) or f(A)

    ops = mvn.Ops(chol_inv=rec("chol_inv", mvn.chol_inv_plain), mvn_ll=None,
                  tri_inv=rec("tri_inv", mvn.tri_inv_plain),
                  cholesky=rec("cholesky", mvn.cholesky_plain))
    assert tsplit.LEAF_CHOLESKY == mvn.MAX_M_CHOL == 240
    tsplit.cholesky_split(torch.eye(240, dtype=torch.float64)[None], ops=ops)
    assert calls == [("cholesky", 240)]
    calls.clear()
    tsplit.cholesky_split(torch.eye(248, dtype=torch.float64)[None], ops=ops)
    assert calls == [("cholesky", 128), ("tri_inv", 128), ("cholesky", 120)]
    calls.clear()
    tsplit.cholesky_split(torch.eye(40, dtype=torch.float64)[None], leaf=16, ops=ops)
    assert calls == [("cholesky", 16), ("tri_inv", 16), ("cholesky", 8), ("tri_inv", 24),
                     ("cholesky", 16)]


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
    assert tsplit.LEAF_TRI == mvn.MAX_M_TRI_INV >= 168
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
    wide = torch.eye(248, dtype=torch.float64).expand(1, 248, 248)
    tsplit.chol_inv_split(wide, ops=ops)
    assert calls == [128, 120]


@pytest.mark.parametrize("m", [176, 192, mvn.MAX_M_CHOL_INV, mvn.MAX_M_CHOL_INV + 8])
def test_chol_inv_leaf_follows_the_k1_cap(m):
    """The chol_inv leaf is K1's shared-memory cap, 240 for the blocked
    kernel: the seismic width 192 and every capacity growth up to the cap
    stay one K1 launch, and wider blocks split at split_point(m)."""
    assert tsplit.LEAF_CHOL == mvn.MAX_M_CHOL_INV == 240
    calls = []
    ops = mvn.Ops(chol_inv=lambda K: calls.append(K.shape[-1]) or mvn.chol_inv_plain(K),
                  mvn_ll=mvn.PLAIN_OPS.mvn_ll, tri_inv=mvn.tri_inv_plain)
    rng = np.random.default_rng(m)
    K = _t(_spd(rng, 2, m))
    L, W = tsplit.chol_inv_split(K, ops=ops)
    h = tsplit.split_point(m)
    assert calls == ([m] if m <= mvn.MAX_M_CHOL_INV else [h, m - h])
    L_ref, W_ref = mvn.chol_inv_plain(K)
    np.testing.assert_allclose(L.numpy(), L_ref.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(W.numpy(), W_ref.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("m", [200, 208, 209, 216])
def test_mvn_leaf_follows_the_k2_cap(m):
    """At dy = 50 the MVN leaf is K2's shared-memory cap, 208 for the blocked
    kernel: capacity growth up to m = 208 stays one K2 launch, wider blocks
    split at split_point(m) into a chol_inv leaf and an MVN leaf."""
    assert mvn.mvn_max_m(50) == 208
    calls = []
    ops = mvn.Ops(chol_inv=lambda K: calls.append(("chol_inv", K.shape[-1]))
                  or mvn.chol_inv_plain(K),
                  mvn_ll=lambda K, Y, n: calls.append(("mvn_ll", K.shape[-1]))
                  or mvn.mvn_ll_plain(K, Y, n)[0],
                  tri_inv=mvn.tri_inv_plain)
    eye = torch.eye(m, dtype=torch.float64).expand(1, m, m)
    ll = tsplit.mvn_ll_split(eye, torch.zeros(1, m, 50, dtype=torch.float64), _t([m]), ops=ops)
    h = tsplit.split_point(m)
    assert calls == ([("mvn_ll", m)] if m <= 208 else [("chol_inv", h), ("mvn_ll", m - h)])
    np.testing.assert_allclose(ll.numpy(), -0.5 * 50 * m * mvn.LOG_2PI, rtol=1e-12)


def _chol_inv_composed(K, leaf):
    """The 2x2 split as autograd composes it: slices, products, concatenation."""
    m = K.shape[-1]
    if m <= leaf:
        return mvn.chol_inv_plain(K)
    h = tsplit.split_point(m)
    A, K21, C = K[:, :h, :h], K[:, h:, :h], K[:, h:, h:]
    La, Wa = _chol_inv_composed(A, leaf)
    L21 = K21 @ Wa.mT
    Lc, Wc = _chol_inv_composed(C - L21 @ L21.mT, leaf)
    return (tsplit._assemble_lower(La, L21, Lc),
            tsplit._assemble_lower(Wa, -(Wc @ L21 @ Wa), Wc))


@pytest.mark.parametrize("m,leaf", [(40, 16), (100, 16), (137, 24), (20, 16)])
def test_chol_inv_split_function_matches_the_composed_split(rng, m, leaf):
    """CholInvSplit's forward and its hand-written pullback against autograd
    through the composed recursion, on a strided view of a wider batch and
    with cotangents on every entry of L and W (above the diagonal too)."""
    wide = _t(_spd(rng, 3, m + 5))
    K = wide[:, 5:, 5:]  # a view, as the split's upper block is
    gL, gW = _t(rng.normal(size=(3, m, m))), _t(rng.normal(size=(3, m, m)))
    out = {}
    for name, fn in (("function", lambda K: tsplit.chol_inv_split(K, leaf=leaf, ops=mvn.PLAIN_OPS)),
                     ("composed", lambda K: _chol_inv_composed(K, leaf))):
        Kv = K.clone().requires_grad_(True)
        L, W = fn(Kv)
        (dK,) = torch.autograd.grad((L * gL).sum() + (W * gW).sum(), Kv)
        out[name] = (L.detach(), W.detach(), dK)
    for a, b in zip(out["function"], out["composed"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)
    h = tsplit.split_point(m)
    if m > leaf:  # K's upper right block is not read
        assert torch.equal(out["function"][2][:, :h, h:], torch.zeros(3, h, m - h,
                                                                       dtype=torch.float64))


def test_chol_inv_pullback_matches_the_composed_pullback(rng):
    """The leaves' nine-launch pullback against the formula it fuses."""
    K = _t(_spd(rng, 2, 24))
    L, W = mvn.chol_inv_plain(K)
    dL, dW = _t(rng.normal(size=(2, 24, 24))), _t(rng.normal(size=(2, 24, 24)))
    ref = mvn._chol_pullback(L, W, torch.tril(dL + mvn._w_cotangent(W, dW)))
    out = torch.empty(2, 30, 30, dtype=torch.float64)[:, 3:27, 3:27]
    got = mvn.chol_inv_pullback(L, W, dL, dW, out=out)
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(mvn.chol_inv_pullback(L, W, dL, dW).numpy(), ref.numpy(),
                               rtol=1e-12, atol=1e-12)
