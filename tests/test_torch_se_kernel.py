"""gprf_torch.ops.se_kernel on the CPU: the plain twin of the SE
kernel-matrix kernel against autograd through the composition the Schur
objective ran before it (``cross_kernel_matrix``, the masks,
``pad_kernel_matrix``), in float64; and the objective's routing of its
kernel matrices through ``Ops.se_kernel``.  The kernel itself is held
against the twin on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.objective import GPRFParams, _schur_ll, gprf_ll_schur
from gprf_torch.ops import mvn, se_kernel
from gprf_torch.partition.grid import Blocker, grid_centers

torch.set_num_threads(1)
F64 = torch.float64


def _inputs(mode, R, k, padded, seed=0, N=3, m=9, dx=2):
    """Points of N blocks (pair mode: N pairs of blocks side by side),
    masks with the last rows padded where ``padded``, and each replica's
    sv, ls (k of them) and, in block mode, nv."""
    g = torch.Generator().manual_seed(seed)
    Xi = torch.rand(R, N, m, dx, generator=g, dtype=F64) * 0.5
    lo = 3 if padded else m
    mi = (torch.arange(m) < torch.randint(lo, m + 1, (R, N, 1), generator=g)).to(F64)
    if padded:
        mi[..., -1] = 0.0
    if mode == "block":
        Xj, mj, nv = Xi, mi, 0.01 + 0.05 * torch.rand(R, generator=g, dtype=F64)
    else:
        Xj = torch.rand(R, N, m, dx, generator=g, dtype=F64) * 0.5 + 0.2
        mj, nv = mi.flip(1), None
    sv = 0.5 + torch.rand(R, generator=g, dtype=F64)
    ls = 0.2 + 0.3 * torch.rand(R, k, generator=g, dtype=F64)
    return Xi, Xj, mi, mj, sv, ls, nv


def _cotangent(kind, shape, seed=1):
    G = torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=F64)
    return torch.tril(G) if kind == "lower" else G


def _value_and_grads(f, args, G):
    """K and the gradients of <K, G> to every input that takes one (both
    point sets in pair mode, the one in block mode, sv, ls, nv)."""
    Xi, Xj, mi, mj, sv, ls, nv = args
    block = nv is not None
    xi = Xi.clone().requires_grad_(True)
    xj = xi if block else Xj.clone().requires_grad_(True)
    hyper = [t.clone().requires_grad_(True) for t in (sv, ls)]
    nvg = nv.clone().requires_grad_(True) if block else None
    K = f(xi, xj, mi, mj, *hyper, nvg)
    leaves = [xi] + ([] if block else [xj]) + hyper + ([nvg] if block else [])
    return K.detach(), torch.autograd.grad(K, leaves, G)


@pytest.mark.parametrize("G_kind", ["full", "lower"])
@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("mode", ["pair", "block"])
def test_twin_matches_composition_autograd(mode, R, k, padded, G_kind):
    """The twin's forward is the composition; its closed-form backward
    equals autograd through the composition under a cotangent that is not
    symmetric (full) and one that is lower-triangular only, as the
    objective's splits hand back."""
    args = _inputs(mode, R, k, padded, seed=R * 10 + k)
    G = _cotangent(G_kind, args[0].shape[:3] + (args[0].shape[2],))
    K_ref, g_ref = _value_and_grads(se_kernel.se_matrix_plain, args, G)
    K, g = _value_and_grads(se_kernel.se_kernel_plain, args, G)
    assert torch.equal(K, K_ref)
    for got, ref in zip(g, g_ref):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-14)
    if padded:  # a padded row and column: zero, with 1 on the diagonal in block mode
        Kp = K[..., -1, :]
        assert torch.all(Kp[..., :-1] == 0) and torch.all(K[..., :-1, -1] == 0)
        assert torch.all(Kp[..., -1] == (1.0 if mode == "block" else 0.0))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", ["pair", "block"])
def test_twin_gradcheck(mode, k):
    args = _inputs(mode, 2, k, True, seed=5, N=2, m=5)
    Xi, Xj, mi, mj, sv, ls, nv = args
    leaves = [Xi.requires_grad_(True)] + ([] if mode == "block" else [Xj.requires_grad_(True)])
    leaves += [sv.requires_grad_(True), ls.requires_grad_(True)]
    if nv is not None:
        leaves.append(nv.requires_grad_(True))
    assert torch.autograd.gradcheck(se_kernel.se_kernel_plain, (Xi, Xj, mi, mj, sv, ls, nv))


@pytest.mark.parametrize("mode", ["pair", "block"])
def test_the_kernel_wrapper_runs_the_twin_on_the_cpu(mode):
    """On CPU tensors the kernel's Function computes the twin's function
    and launches nothing."""
    args = _inputs(mode, 2, 2, True, seed=3)
    G = _cotangent("full", args[0].shape[:3] + (args[0].shape[2],))
    mvn.reset_launch_counts()
    K, g = _value_and_grads(se_kernel.se_kernel, args, G)
    K_ref, g_ref = _value_and_grads(se_kernel.se_kernel_plain, args, G)
    assert torch.equal(K, K_ref)
    for got, ref in zip(g, g_ref):
        assert torch.equal(got, ref)
    assert mvn.launch_counts["se_kernel"] == 0 and mvn.launch_counts["se_kernel_bwd"] == 0


def test_only_asked_gradients_are_computed():
    """With only X asking, the hyperparameters get no gradient."""
    Xi, Xj, mi, mj, sv, ls, nv = _inputs("pair", 1, 2, True)
    Xi.requires_grad_(True)
    K = se_kernel.se_kernel_plain(Xi, Xj, mi, mj, sv, ls, nv)
    (g,) = torch.autograd.grad(K.sum(), [Xi])
    assert g.shape == Xi.shape and sv.grad is None and ls.grad is None


@pytest.mark.parametrize("bad", ["Xj", "mi", "ls", "nv"])
def test_wrong_shapes_raise(bad):
    args = list(_inputs("block", 2, 2, True))
    i = {"Xj": 1, "mi": 2, "ls": 5, "nv": 6}[bad]
    args[i] = args[i][:1] if bad in ("ls", "nv") else args[i][..., :1]
    with pytest.raises(ValueError):
        se_kernel.se_kernel(*args)


def test_serves_only_the_se_euclidean_broadcast_form():
    assert se_kernel.serves("euclidean", "se", 2)
    assert se_kernel.serves("euclidean", "se", 15)
    assert not se_kernel.serves("euclidean", "se", 16)
    assert not se_kernel.serves("euclidean", "matern32", 2)
    assert not se_kernel.serves("lld", "matern32", 3)


def _layout(X, nblocks):
    b = Blocker(grid_centers(nblocks))
    blocks = b.block_clusters(X[:, :2])
    m = (max(len(ix) for ix in blocks) + 7) // 8 * 8
    assignment = np.zeros((len(blocks), m), dtype=np.int64)
    mask = np.zeros((len(blocks), m), dtype=bool)
    for i, ix in enumerate(blocks):
        assignment[i, :len(ix)] = ix
        mask[i, :len(ix)] = True
    edges = np.asarray(b.neighbors(diag_connections=True))
    counts = np.bincount(edges.reshape(-1), minlength=len(blocks))
    return (torch.as_tensor(assignment), torch.as_tensor(mask), torch.as_tensor(edges),
            torch.as_tensor(1.0 - counts, dtype=F64), torch.ones(len(edges), dtype=F64))


def _counted(ops, calls):
    def count(name, f):
        def g(*args):
            calls[name] = calls.get(name, 0) + 1
            return f(*args)
        return g
    return ops.map_leaves(count)


@pytest.mark.parametrize("cov,dx,expected", [(("euclidean", "se"), 2, 2),
                                             (("euclidean", "se"), 16, 0),
                                             (("euclidean", "matern32"), 2, 0),
                                             (("lld", "matern32"), 3, 0)])
def test_schur_ll_routes_se_through_ops(cov, dx, expected):
    """("euclidean", "se") at dx < 16 builds both passes' matrices through
    ops.se_kernel, one call a pass; every other covariance and wide dx keep
    cross_kernel_matrix."""
    rng = np.random.default_rng(2)
    n = 60
    X = rng.uniform(size=(n, dx))
    if cov[0] == "lld":  # lon, lat in degrees and depth in km
        X = X * np.array([1.0, 1.0, 20.0])
    assignment, mask, edges, uw, pw = _layout(X, 4)
    Y = torch.as_tensor(rng.normal(size=(n, 3)))
    ls = [30.0, 10.0] if cov[0] == "lld" else [0.3] * dx
    gcov = GPCov(wfn_params=torch.tensor([1.2], dtype=F64), dfn_params=torch.tensor(ls, dtype=F64),
                 dfn_str=cov[0], wfn_str=cov[1])
    calls = {}
    Xt = torch.as_tensor(X)[None].requires_grad_(True)
    ll = _schur_ll(Xt, Y, assignment[None], mask[None], edges, uw, pw, gcov,
                   torch.tensor(0.01, dtype=F64), ops=_counted(mvn.PLAIN_OPS, calls))
    torch.autograd.grad(ll.sum(), Xt)
    assert calls.get("se_kernel", 0) == expected
    assert calls["chol_inv"] >= 1


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("k", [1, 2])
def test_schur_objective_equals_the_composition(R, k):
    """gprf_ll_schur on PLAIN_OPS (the twin's closed-form backward) against
    the same objective with the kernel matrices composed under plain
    autograd, as before the kernel: value and gradients to X, the
    lengthscales, the signal variance and the noise variance at 1e-12."""
    rng = np.random.default_rng(7 + R + k)
    n, dy = 80, 3
    X = rng.uniform(size=(R, n, 2))
    assignment, mask, edges, uw, pw = _layout(X[0], 9)
    Y = torch.as_tensor(rng.normal(size=(n, dy)))
    composed = mvn.PLAIN_OPS._replace(
        se_kernel=lambda Xi, Xj, mi, mj, sv, ls, nv: se_kernel.se_matrix_plain(
            Xi, Xj, mi, mj, sv, ls, nv))
    ls = torch.as_tensor(rng.uniform(0.2, 0.4, size=(R, k)))
    out = []
    for ops in (mvn.PLAIN_OPS, composed):
        p = GPRFParams(X=torch.as_tensor(X), wfn_params=torch.full((R, 1), 1.3, dtype=F64),
                       dfn_params=ls, noise_var=torch.full((R,), 0.02, dtype=F64))
        p = GPRFParams(*(t.clone().requires_grad_(True) for t in p))
        ll = gprf_ll_schur(p, Y, torch.stack([assignment] * R), torch.stack([mask] * R), edges,
                           uw, pw, ops=ops)
        out.append((ll.detach(), torch.autograd.grad(ll.sum(), list(p))))
    (v, g), (v_ref, g_ref) = out
    torch.testing.assert_close(v, v_ref, rtol=1e-12, atol=0)
    for got, ref in zip(g, g_ref):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12 * float(ref.abs().max()))
