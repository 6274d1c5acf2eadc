"""The two routes of the objective that run K4 (mvn_ll_inv) and K5
(cholesky), against gprf_tpu's GPRF_MVN_INV and GPRF_UNARY_DOUBLING routes,
float64 on the CPU, with gprf_tpu's Pallas kernels in interpret mode:

- the K4 and K5 twins and autograd Functions against
  ``batched_mvn_ll_inv_pallas`` / ``batched_cholesky_pallas``;
- the recursive-doubling inverse against ``gprf_tpu.linalg.doubling``;
- ``gprf_ll_schur`` and ``FusedGridGPRF.value_and_grad`` on each route.

gprf_tpu reads its route toggles at import and its jit caches do not see
them, so every reference run sets the module flag, clears JAX's caches
before and after, and counts the calls of gprf_tpu's Pallas kernels to
show that the route really ran.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gprf_tpu.model.objective as jobjective
import gprf_tpu.ops.pallas_mvn as pm
import gprf_tpu.ops.split_mvn as jsplit
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.linalg import doubling as jdoubling
from gprf_tpu.linalg.masked import pad_kernel_matrix
from gprf_tpu.model import fused as jfused
from gprf_torch.linalg import doubling
from gprf_torch.model import fused as tfused
from gprf_torch.model.objective import gprf_ll_schur
from gprf_torch.ops import mvn, split_mvn
from gprf_torch.utils.convert import cov_from_numpy, params_from_numpy
from test_torch_fused import _assert_close, _entry_problem, _grid_problem
from test_torch_objective import PROBLEMS, _jax_value_and_grad, _problem

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
ROUTES = ("mvn_inv", "unary_doubling")
# each Pallas wrapper of gprf_tpu and its number of array arguments
_PALLAS = {"batched_chol_inv_pallas": 1, "batched_tri_inv_pallas": 1,
           "batched_cholesky_pallas": 1, "batched_mvn_ll_pallas": 3,
           "batched_mvn_ll_inv_pallas": 3}
# the port's options and the Pallas kernel whose calls show gprf_tpu's route
_ROUTE = {"mvn_inv": (dict(mvn_inv=True), "batched_mvn_ll_inv_pallas"),
          "unary_doubling": (dict(unary_doubling=True), "batched_cholesky_pallas")}


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """(route name, Counter of gprf_tpu's Pallas calls) with gprf_tpu's
    toggle for the route set, every Pallas kernel in interpret mode and
    counted, and JAX's caches cleared before and after."""
    jax.clear_caches()
    calls = collections.Counter()
    for name, n_arrays in _PALLAS.items():
        def counted(*args, _f=getattr(pm, name), _name=name, _n=n_arrays, **_):
            calls[_name] += 1
            return _f(*args[:_n], True)
        monkeypatch.setattr(pm, name, counted)
    monkeypatch.setattr(jsplit, "MVN_INV", request.param == "mvn_inv")
    monkeypatch.setattr(jobjective, "_UNARY_DOUBLING", request.param == "unary_doubling")
    yield request.param, calls
    jax.clear_caches()


def _counted_ops(calls, widths=None):
    """KERNEL_OPS with each primitive's calls counted (on the CPU the
    wrappers run the twins, so the launch counters stay at 0), and the
    width m of each call appended to ``widths[name]`` if given."""
    def counted(name, f):
        def g(*args):
            calls[name] += 1
            if widths is not None:
                widths[name].append(args[0].shape[-1])
            return f(*args)
        return g
    return mvn.Ops(*(counted(n, f) for n, f in zip(mvn.Ops._fields, mvn.KERNEL_OPS)))


def _assert_routes_ran(name, jax_calls, torch_calls, split=False):
    """Both packages ran the route's kernel; without a split, neither ran
    the default-route kernel it replaces."""
    opts, jax_kernel = _ROUTE[name]
    torch_kernel, default_jax, default_torch = {
        "mvn_inv": ("mvn_ll_inv", "batched_mvn_ll_pallas", "mvn_ll"),
        "unary_doubling": ("cholesky", "batched_chol_inv_pallas", "chol_inv"),
    }[name]
    assert jax_calls[jax_kernel] > 0 and torch_calls[torch_kernel] > 0
    if not split:
        assert jax_calls[default_jax] == 0 and torch_calls[default_torch] == 0


def _spd(rng, B, m):
    A = rng.normal(size=(B, m, m))
    return np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)


def _masked(rng, m, dy, n_actives):
    K = _spd(rng, len(n_actives), m)
    mask = np.arange(m)[None, :] < np.asarray(n_actives)[:, None]
    Kp = np.asarray(jax.vmap(pad_kernel_matrix)(jnp.asarray(K), jnp.asarray(mask)))
    Ym = rng.normal(size=(len(n_actives), m, dy)) * mask[:, :, None]
    return Kp, Ym, mask.sum(axis=1).astype(np.float64)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


# ---- K5: cholesky ------------------------------------------------------------


@pytest.mark.parametrize("m,n_actives", [(24, [24, 17, 9]), (33, [33, 5]), (40, [40, 40, 31, 3])])
def test_cholesky_twin_matches_pallas(rng, m, n_actives):
    Kp, _, _ = _masked(rng, m, 1, n_actives)
    L_ref = pm.batched_cholesky_pallas(jnp.asarray(Kp), True)
    L = mvn.cholesky(_t(Kp))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-10, atol=1e-13)


def test_cholesky_backward_matches_jax_vjp(rng):
    Kp, _, _ = _masked(rng, 24, 1, [24, 19, 11])
    dL = rng.normal(size=Kp.shape)
    _, vjp = jax.vjp(lambda K: pm.batched_cholesky_pallas(K, True), jnp.asarray(Kp))
    (dK_ref,) = vjp(jnp.asarray(dL))
    K = _t(Kp).requires_grad_(True)
    (dK,) = torch.autograd.grad(mvn.Cholesky.apply(K), K, _t(dL))
    np.testing.assert_allclose(dK.numpy(), np.asarray(dK_ref), rtol=1e-8, atol=1e-12)


def test_gradcheck_cholesky(rng):
    A = _t(rng.normal(size=(2, 6, 6))).requires_grad_(True)

    def f(A):  # symmetric in A, as K is in the objective
        return mvn.Cholesky.apply(A @ A.mT + 6.0 * torch.eye(6, dtype=A.dtype))

    assert torch.autograd.gradcheck(f, (A,))


# ---- K4: mvn_ll_inv ----------------------------------------------------------


@pytest.mark.parametrize("n_actives,dy", [([24, 17, 9], 6), ([40, 40, 31, 3, 12], 1)])
def test_mvn_ll_inv_twin_matches_pallas(rng, n_actives, dy):
    m = 24 if max(n_actives) <= 24 else 40
    Kp, Ym, nact = _masked(rng, m, dy, n_actives)
    args = (jnp.asarray(Kp), jnp.asarray(Ym), jnp.asarray(nact))
    ll_ref = pm.batched_mvn_ll_inv_pallas(*args, True)
    _, (W_ref, Z_ref) = pm._mvn_inv_fwd(*args, True)  # the VJP's residuals
    ll, W, Z = mvn.mvn_ll_inv(_t(Kp), _t(Ym), _t(nact))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=1e-10)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(Z.numpy(), np.asarray(Z_ref), rtol=1e-10, atol=1e-13)


def test_mvn_ll_inv_backward_matches_jax_vjp(rng):
    Kp, Ym, nact = _masked(rng, 24, 5, [24, 19, 11, 6])
    g = rng.normal(size=4)
    _, vjp = jax.vjp(lambda K, Y, n: pm.batched_mvn_ll_inv_pallas(K, Y, n, True),
                     jnp.asarray(Kp), jnp.asarray(Ym), jnp.asarray(nact))
    refs = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_(True) for a in (Kp, Ym, nact)]
    grads = torch.autograd.grad(mvn.MvnLLInv.apply(*ins), ins, _t(g))
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-12)


def test_gradcheck_mvn_ll_inv(rng):
    A = _t(rng.normal(size=(3, 7, 7))).requires_grad_(True)
    Y = _t(rng.normal(size=(3, 7, 2))).requires_grad_(True)
    n = _t([7.0, 5.0, 3.0]).requires_grad_(True)

    def f(A, Y, n):
        return mvn.MvnLLInv.apply(A @ A.mT + 7.0 * torch.eye(7, dtype=A.dtype), Y, n)

    assert torch.autograd.gradcheck(f, (A, Y, n))


def test_route_functions_match_twin_autograd(rng):
    """K4's and K5's analytic backward passes agree with PyTorch's autograd
    through their twins, end to end through a symmetric K(A)."""
    m, dy = 12, 3
    A = _t(rng.normal(size=(2, m, m)))
    Y = _t(rng.normal(size=(2, m, dy)))
    n = _t([m, m])
    C = _t(rng.normal(size=(2, m, m)))

    def f(A, ops):
        K = A @ A.mT + m * torch.eye(m, dtype=A.dtype)
        return ops.mvn_ll_inv(K, Y, n).sum() + (ops.cholesky(K) * C).sum()

    grads = []
    for ops in (mvn.KERNEL_OPS, mvn.PLAIN_OPS):
        a = A.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(f(a, ops), a)[0].numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-9, atol=1e-12)


def test_route_caps_follow_shared_memory():
    """K5 holds K1's blocked working set (mp^2 floats and the factor's 1 KB
    block, mp = 16 ceil(m/16)) and K4 holds K2's (mp^2 + mp dyp floats, the
    block and 8 partial sums); the gates are those formulas and dy <= 256."""
    m = mvn.MAX_M_CHOL
    assert m == mvn.MAX_M_CHOL_INV == 240
    assert mvn.chol_inv_smem_bytes(m) <= mvn.SMEM_BYTES < mvn.chol_inv_smem_bytes(m + 1)
    assert mvn.chol_inv_smem_bytes(m) == (240 * 240 + 16 * 16) * 4
    assert mvn.mvn_inv_supported(208, 50) and not mvn.mvn_inv_supported(209, 50)
    assert mvn.mvn_smem_bytes(208, 50) <= mvn.SMEM_BYTES < mvn.mvn_smem_bytes(209, 50)
    assert mvn.mvn_smem_bytes(208, 50) == (208 * 208 + 208 * 52 + 16 * 16 + 8) * 4
    assert mvn.mvn_smem_bytes(136, 50) == 112_896 + 1_024 + 32
    assert mvn.mvn_inv_supported(136, 50) and mvn.mvn_inv_supported(192, 50)
    assert mvn.mvn_inv_supported(40, 256) and not mvn.mvn_inv_supported(8, 257)
    # K4 takes what K2 takes, at every dy
    for dy in (1, 5, 50, 51, 256):
        cap = mvn.mvn_max_m(dy)
        assert mvn.mvn_inv_supported(cap, dy) and not mvn.mvn_inv_supported(cap + 1, dy)
    assert mvn.mvn_max_m(1) == 224 and mvn.mvn_max_m(256) == 144


def test_mvn_leaves_take_k4_where_it_fits():
    """mvn_ll_split(mvn_inv=True): a leaf that K4 takes runs mvn_ll_inv, a
    leaf beyond its gate runs mvn_ll, and a forced split runs K4 at its
    Schur leaf; without the option every leaf runs mvn_ll."""
    calls = []
    ops = mvn.Ops(chol_inv=mvn.chol_inv_plain,
                  mvn_ll=lambda K, Y, n: calls.append(("mvn_ll", K.shape[-1]))
                  or mvn.mvn_ll_plain(K, Y, n)[0],
                  tri_inv=mvn.tri_inv_plain,
                  mvn_ll_inv=lambda K, Y, n: calls.append(("mvn_ll_inv", K.shape[-1]))
                  or mvn.mvn_ll_inv_plain(K, Y, n)[0])

    def run(m, dy, **kw):
        calls.clear()
        eye = torch.eye(m, dtype=torch.float64).expand(1, m, m)
        split_mvn.mvn_ll_split(eye, torch.zeros(1, m, dy, dtype=torch.float64),
                               _t([float(m)]), ops=ops, **kw)
        return list(calls)

    assert run(136, 50, mvn_inv=True) == [("mvn_ll_inv", 136)]
    assert run(200, 50, mvn_inv=True) == [("mvn_ll_inv", 200)]
    assert run(208, 50, mvn_inv=True) == [("mvn_ll_inv", 208)]
    # a forced leaf above K4's gate (mvn_max_m(50) = 208) runs mvn_ll
    assert run(216, 50, mvn_inv=True, leaf_mvn=216) == [("mvn_ll", 216)]
    assert run(160, 256, mvn_inv=True, leaf_mvn=160) == [("mvn_ll", 160)]
    assert run(136, 50) == [("mvn_ll", 136)]
    assert run(40, 3, mvn_inv=True, leaf_mvn=16, leaf_chol=16) == [("mvn_ll_inv", 16)]


# ---- the doubling inverse ------------------------------------------------------


def test_doubling_split_matches_jax():
    for m in (1, 8, 17, 24, 40, 64, 136, 152, 248, 256):
        assert doubling._doubling_split(m) == jdoubling._doubling_split(m)
    assert doubling._doubling_split(136) == (17, 3)


@pytest.mark.parametrize("m", [8, 24, 136])
def test_tri_inv_doubling_matches_jax(rng, m):
    L = np.linalg.cholesky(_spd(rng, 2, m))
    dW = rng.normal(size=L.shape)
    W_ref, vjp = jax.vjp(jdoubling.batched_tri_inv_doubling, jnp.asarray(L))
    (dL_ref,) = vjp(jnp.asarray(dW))
    Lt = _t(L).requires_grad_(True)
    W = doubling.batched_tri_inv_doubling(Lt)
    (dL,) = torch.autograd.grad(W, Lt, _t(dW))
    np.testing.assert_allclose(W.detach().numpy(), np.asarray(W_ref), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(W.detach().numpy(), np.linalg.inv(L), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(dL.numpy(), np.asarray(dL_ref), rtol=1e-8, atol=1e-12)


# ---- the routes through the objective and the fused engine -----------------------


def _torch_value_and_grad(X, Y, cov, arrays, ops, **opts):
    p = params_from_numpy(X, np.asarray(cov.wfn_params), np.asarray(cov.dfn_params), 0.01,
                          **F64)
    for t in p:
        t.requires_grad_(True)
    t = {k: torch.as_tensor(np.array(v)) for k, v in arrays.items()}
    ll = gprf_ll_schur(p, _t(Y), t["assignment"], t["mask"], t["edges"],
                       t["unary_weights"].double(), t["pair_weights"].double(),
                       wfn_str=cov.wfn_str, ops=ops, **opts)
    grads = torch.autograd.grad(ll, (p.X, p.dfn_params, p.wfn_params, p.noise_var))
    return float(ll.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("prob", range(len(PROBLEMS)))
def test_gprf_ll_schur_route_matches_jax(rng, route, prob):
    name, jax_calls = route
    X, Y, cov, arrays = _problem(rng, **PROBLEMS[prob])
    v_ref, g_ref = _jax_value_and_grad(X, Y, cov, arrays, use_pallas=True)
    torch_calls = collections.Counter()
    v, g = _torch_value_and_grad(X, Y, cov, arrays, _counted_ops(torch_calls),
                                 **_ROUTE[name][0])
    _assert_routes_ran(name, jax_calls, torch_calls)
    np.testing.assert_allclose(v, v_ref, rtol=1e-9)
    for got, ref in zip(g, g_ref):
        np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-10)


def _fused_pair(p, name, torch_calls, widths=None):
    args = (p["X0"], p["Y"], p["centers"], p["edges"], p["X_obs"], p["obs_std"])
    jf = jfused.FusedGridGPRF(*args, JCov.create(p["wfn"], p["dfn"]), p["noise_var"],
                              pair_mode="schur_pallas")
    tf = tfused.FusedGridGPRF(*args, cov_from_numpy(p["wfn"], p["dfn"], **F64),
                              p["noise_var"], ops=_counted_ops(torch_calls, widths), **F64,
                              **_ROUTE[name][0])
    assert tf.m == jf.m
    return jf, tf


def test_fused_entry_problem_route_matches_jax(route):
    name, jax_calls = route
    torch_calls = collections.Counter()
    p = _entry_problem()
    jf, tf = _fused_pair(p, name, torch_calls)
    rng = np.random.default_rng(1)
    for _ in range(2):
        x = (p["X0"] + rng.normal(size=p["X0"].shape) * 0.01).reshape(-1)
        _assert_close(*tf.value_and_grad(x), *jf.value_and_grad(x))
    _assert_routes_ran(name, jax_calls, torch_calls)


def test_fused_forced_split_route_matches_jax(route, monkeypatch):
    """Leaf 16 in both packages: the pair MVN splits, so K4 runs at a Schur
    leaf after A-side chol_inv leaves, and K5's backward splits its K3.
    The port's K5 leaf is 16 too, so the unary-doubling route factors its
    blocks by cholesky_split (where gprf_tpu's runs its Cholesky kernel
    whole) and K5 runs only at leaves of width <= 16."""
    name, jax_calls = route
    monkeypatch.setattr(jsplit, "LEAF_CHOL", 16)
    monkeypatch.setattr(jsplit, "LEAF_MVN", 16)
    monkeypatch.setattr(split_mvn, "LEAF_CHOL", 16)
    monkeypatch.setattr(split_mvn, "LEAF_TRI", 16)
    monkeypatch.setattr(split_mvn, "LEAF_CHOLESKY", 16)
    monkeypatch.setattr(split_mvn, "mvn_max_m", lambda dy: 16)
    torch_calls = collections.Counter()
    widths = collections.defaultdict(list)
    p = _grid_problem(3, 200, 4, 4, 0.3)
    jf, tf = _fused_pair(p, name, torch_calls, widths)
    assert tf.m > 32
    x = p["X0"].reshape(-1)
    _assert_close(*tf.value_and_grad(x), *jf.value_and_grad(x))
    _assert_routes_ran(name, jax_calls, torch_calls, split=True)
    assert torch_calls["chol_inv"] > 0  # the split's A-side leaves
    assert max(widths["tri_inv"], default=0) <= 16
    if name == "unary_doubling":
        assert torch_calls["cholesky"] >= 3 and max(widths["cholesky"]) <= 16
