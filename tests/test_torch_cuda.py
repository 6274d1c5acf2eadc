"""The hand-written CUDA kernels of gprf_torch against their plain twins.

These need a CUDA device (marked ``gpu``) and skip elsewhere.  The machine
with the card has no JAX, so run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Kernels compute in float32; the references are the twins in float64 on the
same card.  The test matrices are A A^T + m I, so kappa(K) <= ~5 and the
float32 kernels agree with float64 to ~1e-5 relative.
"""

import os

import numpy as np
import pytest
import torch

import gprf_torch  # noqa: F401  (precision pins)
from gprf_torch.linalg.doubling import batched_tri_inv_doubling
from gprf_torch.ops import mvn, se_kernel
from gprf_torch.ops.split_mvn import chol_inv_split, cholesky_split, mvn_ll_split, tri_inv_split

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

RTOL = 1e-4
# a chunked Schur loss against the same loss whole: the value's relative
# difference and the gradients' cosine (only the summation order differs)
CHUNK_RTOL = 1e-6
CHUNK_COSINE = 0.999999


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spd(rng, B, m, n_active=None):
    A = rng.normal(size=(B, m, m))
    K = np.einsum("bij,bkj->bik", A, A) / m + np.eye(m)
    if n_active is not None:
        mask = (np.arange(m)[None, :] < np.asarray(n_active)[:, None]).astype(float)
        K = K * mask[:, :, None] * mask[:, None, :] + np.eye(m) * (1 - mask)[:, None, :]
    return K


def _close(a, b, rtol=RTOL):
    a = a.double().cpu().numpy()
    b = b.double().cpu().numpy()
    scale = max(np.abs(b).max(), 1.0)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


# K1 and K5 run one factor, and K2 and K4 one factor with right-hand sides:
# name -> (kernel, twin), each returning a tuple (K1: L, W; K5: L; K2: ll, L;
# K4: ll, W, Z)
FACTOR_KERNELS = {
    "chol_inv": (mvn.chol_inv, mvn.chol_inv_plain),
    "cholesky": (lambda K: (mvn.cholesky(K),), lambda K: (mvn.cholesky_plain(K),)),
}
MVN_KERNELS = {
    "mvn_ll": (mvn.mvn_ll, mvn.mvn_ll_plain),
    "mvn_ll_inv": (mvn.mvn_ll_inv, mvn.mvn_ll_inv_plain),
}
factor_kernels = pytest.mark.parametrize("name", list(FACTOR_KERNELS))
mvn_kernels = pytest.mark.parametrize("name", list(MVN_KERNELS))


# one block, ragged and full last blocks of K1's 16-wide blocking, the
# flagship width, the first capacity growth, the former cap, the seismic
# width and the cap
@pytest.mark.parametrize("B,m", [(3, 37), (5, 136), (2, 168), (1, 1), (4, 65), (3, 2), (2, 3),
                                 (3, 15), (3, 16), (3, 17), (3, 33), (5, 152), (2, 192),
                                 (2, mvn.MAX_M_CHOL_INV)])
def test_chol_inv_kernel(dev, B, m):
    rng = np.random.default_rng(m)
    K = torch.as_tensor(_spd(rng, B, m), device=dev)
    mvn.reset_launch_counts()
    L, W = mvn.chol_inv(K.float())
    torch.cuda.synchronize()
    assert mvn.launch_counts["chol_inv"] == 1
    L_ref, W_ref = mvn.chol_inv_plain(K)
    _close(L, L_ref)
    _close(W, W_ref)
    assert torch.all(torch.triu(L, 1) == 0) and torch.all(torch.triu(W, 1) == 0)


@factor_kernels
def test_chol_inv_kernel_reads_only_the_lower_triangle(dev, name):
    """NaN above K's diagonal changes no bit of L or W: the factor reads
    the lower triangle only, and the in-place inverse never reads the strict
    upper parts of the diagonal blocks, which the factor leaves unwritten."""
    kernel, plain = FACTOR_KERNELS[name]
    rng = np.random.default_rng(11)
    K = torch.as_tensor(_spd(rng, 3, 45), device=dev).float()
    dirty = K + torch.triu(torch.full_like(K, float("nan")), 1)
    clean_out = kernel(K.contiguous())
    dirty_out = kernel(dirty.contiguous())
    torch.cuda.synchronize()
    refs = plain(torch.tril(K.double()) + torch.tril(K.double(), -1).mT)
    for got, same, ref in zip(dirty_out, clean_out, refs):
        assert torch.isfinite(got).all() and torch.equal(got, same)
        _close(got, ref)


@factor_kernels
def test_chol_inv_kernel_keeps_identity_padding_exact(dev, name):
    kernel, plain = FACTOR_KERNELS[name]
    B, m = 4, 136
    n_active = np.array([136, 100, 97, 40])
    rng = np.random.default_rng(5)
    K = torch.as_tensor(_spd(rng, B, m, n_active), device=dev)
    out = kernel(K.float())
    torch.cuda.synchronize()
    for got, ref in zip(out, plain(K)):
        _close(got, ref)
        for b, n in enumerate(n_active):
            assert torch.all(got[b, n:, n:] == torch.eye(m - n, device=dev))
            assert torch.all(got[b, n:, :n] == 0)


def _chol_inv_steps(K):
    """(L, W) by the two step loops of ``_chol_inv_kernel``
    (gprf_tpu/ops/pallas_mvn.py), one [m, m] block in float64: the factor
    scales column k by d = rsqrt(max(a_kk, 1e-30)) (so L_kk = a_kk d); the
    substitution for W divides row k by L_kk where |L_kk| > 1e-30, else by
    1e-30."""
    A = K.clone()
    m = K.shape[0]
    idx = torch.arange(m)
    for k in range(m):
        d = torch.rsqrt(torch.clamp(A[k, k], min=1e-30))
        col = torch.where(idx >= k, A[k] * d, 0.0)
        A[k] = col
        colu = torch.where(idx > k, col, 0.0)
        A = A - torch.outer(colu, colu)
    L = torch.tril(A.mT)
    return L, _tri_inv_steps(L)


def _tri_inv_steps(L):
    """W by the substitution loop that ``_chol_inv_kernel`` and
    ``_mvn_inv_kernel`` share: row k is divided by L_kk where
    |L_kk| > 1e-30, else by 1e-30."""
    m = L.shape[0]
    W = torch.zeros_like(L)
    eye = torch.eye(m, dtype=L.dtype)
    for k in range(m):
        lkk = L[k, k]
        W[k] = (eye[k] - L[k] @ W) / (lkk if abs(float(lkk)) > 1e-30 else 1e-30)
    return W


@factor_kernels
def test_chol_inv_kernel_clamps_pivots_like_the_tpu_kernel(dev, name):
    """A pivot of 1e-31 and a negative pivot, each with nonzero entries below
    it: the factor scales their columns by rsqrt(max(a_kk, 1e-30)), so L_kk
    is 1e-31 * 1e15 = 1e-16 and -0.5e15, and W divides by those L_kk (not
    by 1/d, which the factor's panel solve uses), as the TPU kernel's steps
    do (``_chol_kernel``'s step is ``_chol_inv_kernel``'s first loop).  W
    reaches 1e16, so it is compared entry by entry, relative."""
    rng = np.random.default_rng(10)
    B, m = 2, 37
    K = _spd(rng, B, m)
    for p, v in ((5, 1e-31), (20, -0.5)):  # in block columns 0 and 1
        K[:, p, :p] = K[:, :p, p] = 0.0
        K[:, p, p] = v
        K[:, p + 1:, p] = K[:, p, p + 1:] = 1e-16 * rng.normal(size=(B, m - p - 1))
    K = K.astype(np.float32).astype(np.float64)  # the kernel's inputs, exactly
    out = FACTOR_KERNELS[name][0](torch.as_tensor(K, dtype=torch.float32, device=dev))
    torch.cuda.synchronize()
    for b in range(B):
        L_ref, W_ref = _chol_inv_steps(torch.as_tensor(K[b]))
        assert float(L_ref[20, 20]) < -1e14 and 0.0 < float(L_ref[5, 5]) < 1e-15
        assert float(W_ref[5, 5]) > 1e15 and -1e-14 < float(W_ref[20, 20]) < 0.0
        for got, ref in zip(out, (L_ref, W_ref)):
            err = (got[b].double().cpu() - ref).abs() / (ref.abs() + 1.0)
            assert float(err.max()) <= 1e-4


@factor_kernels
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_chol_inv_kernel_takes_views_at_any_offset(dev, offset, name):
    """K1 and K5 copy K by 4-byte cp.async, as K2 does, so a contiguous view
    that starts off a 16-byte boundary is taken as it is."""
    kernel, plain = FACTOR_KERNELS[name]
    rng = np.random.default_rng(13)
    K = torch.as_tensor(_spd(rng, 3, 36), device=dev)
    flat = torch.zeros(K.numel() + offset, device=dev)
    flat[offset:] = K.float().flatten()
    out = kernel(flat[offset:].view(K.shape))
    torch.cuda.synchronize()
    for got, ref in zip(out, plain(K)):
        _close(got, ref)


@factor_kernels
def test_chol_inv_kernel_refuses_past_its_cap(dev, name):
    kernel = FACTOR_KERNELS[name][0]
    cap = {"chol_inv": mvn.MAX_M_CHOL_INV, "cholesky": mvn.MAX_M_CHOL}[name]
    assert cap >= 192
    out = kernel(torch.eye(cap, device=dev)[None])
    torch.cuda.synchronize()
    for got in out:
        assert torch.equal(got[0], torch.eye(cap, device=dev))
    with pytest.raises(ValueError):
        kernel(torch.eye(cap + 1, device=dev)[None])


def test_chol_inv_kernel_fits_two_ctas_an_sm_at_the_flagship(dev):
    """K5 runs K1's kernel, so this is its occupancy too."""
    from gprf_torch.ops import _build

    lib = _build.load().lib
    assert mvn.MAX_M_CHOL == mvn.MAX_M_CHOL_INV
    assert lib.gprf_chol_inv_ctas_per_sm(136) == 2
    assert lib.gprf_chol_inv_ctas_per_sm(mvn.MAX_M_CHOL_INV) == 1


# ragged and full last blocks of K3's 16-wide blocking, the flagship width,
# the first capacity growth, the former cap and the cap
@pytest.mark.parametrize("B,m", [(3, 37), (7, 136), (2, 168), (2, 3), (2, 1), (3, 2), (3, 15),
                                 (3, 16), (3, 17), (3, 33), (5, 152), (2, 224)])
def test_tri_inv_kernel(dev, B, m):
    rng = np.random.default_rng(m)
    L = torch.linalg.cholesky(torch.as_tensor(_spd(rng, B, m), device=dev))
    mvn.reset_launch_counts()
    W = mvn.tri_inv(L.float().contiguous())
    torch.cuda.synchronize()
    assert mvn.launch_counts["tri_inv"] == 1
    _close(W, mvn.tri_inv_plain(L))
    assert torch.all(torch.triu(W, 1) == 0)


def _tri(dev, B, m, seed=4):
    rng = np.random.default_rng(seed)
    return torch.linalg.cholesky(torch.as_tensor(_spd(rng, B, m), device=dev))


def test_tri_inv_kernel_reads_only_the_lower_triangle(dev):
    L = _tri(dev, 3, 45)
    dirty = L.float() + torch.triu(torch.full_like(L.float(), float("nan")), 1)
    W = mvn.tri_inv(dirty.contiguous())
    torch.cuda.synchronize()
    assert torch.isfinite(W).all()
    _close(W, mvn.tri_inv_plain(torch.tril(L)))


def test_tri_inv_kernel_guards_the_reciprocal_like_the_tpu_kernel(dev):
    """A diagonal entry of 1e-31 is read as 1e-30 (the guard of
    ``_tri_inv_kernel``), so W's last row is ~1e30 and equals the twin's on
    L with that entry set to 1e-30."""
    L = _tri(dev, 2, 40)
    L[:, -1, -1] = 1e-31
    W = mvn.tri_inv(L.float().contiguous())
    torch.cuda.synchronize()
    ref = L.clone()
    ref[:, -1, -1] = 1e-30
    ref = mvn.tri_inv_plain(ref)
    assert ref[:, -1, -1].min() >= 1e29
    _close(W[:, :-1], ref[:, :-1])
    _close(W[:, -1:], ref[:, -1:])


def test_tri_inv_kernel_keeps_identity_padding_exact(dev):
    B, m = 4, 136
    n_active = np.array([136, 100, 97, 40])
    rng = np.random.default_rng(5)
    L = torch.linalg.cholesky(torch.as_tensor(_spd(rng, B, m, n_active), device=dev))
    W = mvn.tri_inv(L.float().contiguous())
    torch.cuda.synchronize()
    _close(W, mvn.tri_inv_plain(L))
    for b, n in enumerate(n_active):
        assert torch.all(W[b, n:, n:] == torch.eye(m - n, device=dev))
        assert torch.all(W[b, n:, :n] == 0)
    assert torch.all(torch.triu(W, 1) == 0)


def test_tri_inv_kernel_refuses_past_its_cap(dev):
    mvn.tri_inv(torch.eye(mvn.MAX_M_TRI_INV, device=dev)[None])
    with pytest.raises(ValueError):
        mvn.tri_inv(torch.eye(mvn.MAX_M_TRI_INV + 1, device=dev)[None])


def _mvn_inputs(dev, B, m, dy, n_active=None, seed=None):
    rng = np.random.default_rng(m + dy if seed is None else seed)
    n_active = rng.integers(m // 2, m + 1, size=B) if n_active is None else np.asarray(n_active)
    K = torch.as_tensor(_spd(rng, B, m, n_active), device=dev)
    mask = torch.as_tensor(np.arange(m)[None, :] < n_active[:, None], device=dev)
    Y = torch.as_tensor(rng.normal(size=(B, m, dy)), device=dev) * mask[:, :, None]
    return K, Y, torch.as_tensor(n_active, dtype=torch.float64, device=dev)


# K2's 16-wide blocking: one block, ragged and full last blocks, the flagship
# width, the first capacity growth and the caps at dy = 50, 1 and 256; dy
# ragged against K2's 4-wide columns and 16-wide tiles
@pytest.mark.parametrize("B,m,dy", [(3, 37, 5), (9, 136, 50), (2, mvn.mvn_max_m(50), 50),
                                    (4, 40, 1), (2, mvn.mvn_max_m(1), 1), (3, 40, 200),
                                    (2, 1, 1), (2, 1, 256), (3, 15, 5), (3, 16, 50), (3, 17, 1),
                                    (3, 33, 256), (5, 152, 50), (4, 136, 5),
                                    (2, mvn.mvn_max_m(256), 256)])
def test_mvn_kernel(dev, B, m, dy):
    K, Y, na = _mvn_inputs(dev, B, m, dy)
    mvn.reset_launch_counts()
    ll, L = mvn.mvn_ll(K.float(), Y.float(), na.float())
    torch.cuda.synchronize()
    assert mvn.launch_counts["mvn_ll"] == 1
    ll_ref, L_ref = mvn.mvn_ll_plain(K, Y, na)
    _close(ll, ll_ref)
    _close(L, L_ref)
    assert torch.all(torch.triu(L, 1) == 0)


@mvn_kernels
@pytest.mark.parametrize("k_offset,y_offset", [(1, 2), (2, 1), (4, 4), (3, 3)])
def test_mvn_kernel_takes_views_at_any_offset(dev, k_offset, y_offset, name):
    """K2 and K4 copy K and Y by 4-byte cp.async, so contiguous views that
    start off a 16-byte boundary are taken as they are."""
    kernel, plain = MVN_KERNELS[name]
    B, m, dy = 3, 36, 8
    K, Y, na = _mvn_inputs(dev, B, m, dy, seed=12)

    def view_at(t, offset):
        flat = torch.zeros(t.numel() + offset, device=dev)
        flat[offset:] = t.float().flatten()
        return flat[offset:].view(t.shape)

    out = kernel(view_at(K, k_offset), view_at(Y, y_offset), na.float())
    torch.cuda.synchronize()
    for got, ref in zip(out, plain(K, Y, na)):
        _close(got, ref)


@mvn_kernels
def test_mvn_kernel_keeps_identity_padding_exact(dev, name):
    """Padded rows stay identity rows of L (K2) and of W (K4), and zero rows
    of K4's Z, bit for bit."""
    kernel, plain = MVN_KERNELS[name]
    n_active = [136, 100, 97, 40, 1]
    K, Y, na = _mvn_inputs(dev, 5, 136, 50, n_active, seed=8)
    out = kernel(K.float(), Y.float(), na.float())
    torch.cuda.synchronize()
    for got, ref in zip(out, plain(K, Y, na)):
        _close(got, ref)
    for b, n in enumerate(n_active):
        assert torch.all(out[1][b, n:, n:] == torch.eye(136 - n, device=dev))
        assert torch.all(out[1][b, n:, :n] == 0)
        if name == "mvn_ll_inv":
            assert torch.all(out[2][b, n:] == 0)


@mvn_kernels
def test_mvn_kernel_reads_only_the_lower_triangle(dev, name):
    """NaN above K's diagonal changes no bit of any output: the factor reads
    the lower triangle only, and K4's in-place inverse never reads the
    strict upper parts of the diagonal blocks."""
    kernel, plain = MVN_KERNELS[name]
    K, Y, na = _mvn_inputs(dev, 3, 45, 5, seed=9)
    dirty = K.float() + torch.triu(torch.full_like(K.float(), float("nan")), 1)
    clean_out = kernel(K.float().contiguous(), Y.float(), na.float())
    dirty_out = kernel(dirty.contiguous(), Y.float(), na.float())
    torch.cuda.synchronize()
    refs = plain(torch.tril(K) + torch.tril(K, -1).mT, Y, na)
    for got, same, ref in zip(dirty_out, clean_out, refs):
        assert torch.isfinite(got).all() and torch.equal(got, same)
        _close(got, ref)


def _mvn_steps(K, Y, n):
    """(ll, L, Z) by the step loop of ``_mvn_kernel``, which is the
    factorization sweep of ``_mvn_inv_kernel`` too (gprf_tpu/ops/pallas_mvn.py),
    one [m, m] block in float64: pivot d = rsqrt(max(a_kk, 1e-30)), column k
    of L is a[:, k] d (so L_kk = a_kk d), logdet adds log(max(a_kk, 1e-30))."""
    A, Z = K.clone(), Y.clone()
    m, dy = Y.shape
    idx = torch.arange(m)
    logdet = torch.zeros((), dtype=K.dtype)
    for k in range(m):
        akk = torch.clamp(A[k, k], min=1e-30)
        d = torch.rsqrt(akk)
        logdet = logdet + torch.log(akk)
        col = torch.where(idx >= k, A[k] * d, 0.0)
        A[k] = col
        colu = torch.where(idx > k, col, 0.0)
        A = A - torch.outer(colu, colu)
        Z[k] = Z[k] * d
        Z = Z - torch.outer(colu, Z[k])
    ll = -0.5 * torch.sum(Z * Z) - 0.5 * dy * logdet - 0.5 * dy * n * mvn.LOG_2PI
    return ll, torch.tril(A.mT), Z


@mvn_kernels
def test_mvn_kernel_clamps_pivots_like_the_tpu_kernel(dev, name):
    """A pivot of 1e-31 and a negative pivot, each with nonzero entries below
    it: the kernel scales their columns and right-hand sides by
    rsqrt(max(a_kk, 1e-30)) and adds log(max(a_kk, 1e-30)) to logdet, as the
    TPU kernel's step does (not 1/L_kk and 2 log L_kk).  In block 1 the
    rows of Y at the two pivots are zero, so ll shows the clamped logdet.
    K4's W comes from L by ``_mvn_inv_kernel``'s substitution, which divides
    by the guarded L_kk (1e-16 and -0.5e15 here), and reaches 1e16; its Z
    reaches 1e15 in block 0, so Z is compared normwise."""
    rng = np.random.default_rng(10)
    B, m, dy = 2, 37, 5
    K = _spd(rng, B, m)
    for p, v in ((5, 1e-31), (20, -0.5)):  # in block columns 0 and 1
        K[:, p, :p] = K[:, :p, p] = 0.0
        K[:, p, p] = v
        K[:, p + 1:, p] = K[:, p, p + 1:] = 1e-16 * rng.normal(size=(B, m - p - 1))
    Y = rng.normal(size=(B, m, dy))
    Y[1, [5, 20]] = 0.0
    K = K.astype(np.float32).astype(np.float64)  # the kernel's inputs, exactly
    out = MVN_KERNELS[name][0](torch.as_tensor(K, dtype=torch.float32, device=dev),
                               torch.as_tensor(Y, dtype=torch.float32, device=dev),
                               torch.full((B,), float(m), device=dev))
    torch.cuda.synchronize()
    for b in range(B):
        ll_ref, L_ref, Z_ref = _mvn_steps(torch.as_tensor(K[b]), torch.as_tensor(Y[b]), m)
        assert float(L_ref[20, 20]) < -1e14 and 0.0 < float(L_ref[5, 5]) < 1e-15
        assert abs(float(out[0][b]) - float(ll_ref)) <= 1e-5 * abs(float(ll_ref))
        tri_ref = L_ref if name == "mvn_ll" else _tri_inv_steps(L_ref)
        err = (out[1][b].double().cpu() - tri_ref).abs() / (tri_ref.abs() + 1.0)
        assert float(err.max()) <= 1e-4
        if name == "mvn_ll_inv":
            assert float(tri_ref[5, 5]) > 1e15 and -1e-14 < float(tri_ref[20, 20]) < 0.0
            z_err = (out[2][b].double().cpu() - Z_ref).abs().max()
            assert float(z_err) <= 1e-4 * float(Z_ref.abs().max())


@mvn_kernels
def test_mvn_kernel_refuses_past_its_cap(dev, name):
    kernel = MVN_KERNELS[name][0]
    cap = mvn.mvn_max_m(50)
    assert cap >= 200
    out = kernel(torch.eye(cap, device=dev)[None], torch.zeros(1, cap, 50, device=dev),
                 torch.full((1,), float(cap), device=dev))
    torch.cuda.synchronize()
    assert torch.equal(out[1][0], torch.eye(cap, device=dev))
    with pytest.raises(ValueError):
        kernel(torch.eye(cap + 1, device=dev)[None], torch.zeros(1, cap + 1, 50, device=dev),
               torch.ones(1, device=dev))


@pytest.mark.parametrize("query", ["gprf_mvn_ctas_per_sm", "gprf_mvn_inv_ctas_per_sm"])
def test_mvn_kernel_fits_two_ctas_an_sm_at_the_flagship(dev, query):
    from gprf_torch.ops import _build

    ctas_per_sm = getattr(_build.load().lib, query)
    assert ctas_per_sm(136, 50) == 2
    assert ctas_per_sm(mvn.mvn_max_m(50), 50) == 1


# K5's 16-wide blocking, as K1's: one block, ragged and full last blocks, the
# flagship width, the first capacity growth, the seismic width and the cap
@pytest.mark.parametrize("B,m", [(3, 37), (5, 136), (2, mvn.MAX_M_CHOL), (1, 1), (4, 65), (3, 2),
                                 (2, 3), (3, 15), (3, 16), (3, 17), (3, 33), (5, 152), (2, 192)])
def test_cholesky_kernel(dev, B, m):
    rng = np.random.default_rng(m)
    K = torch.as_tensor(_spd(rng, B, m, rng.integers(m // 2, m + 1, size=B)), device=dev)
    mvn.reset_launch_counts()
    L = mvn.cholesky(K.float())
    torch.cuda.synchronize()
    assert mvn.launch_counts["cholesky"] == 1
    _close(L, mvn.cholesky_plain(K))
    assert torch.all(torch.triu(L, 1) == 0)


# K4's 16-wide blocking, as K2's: one block, ragged and full last blocks, the
# flagship width, the first capacity growth and the caps at dy = 50, 1, 51
# and 256; dy ragged against the 4-wide columns and 16-wide tiles of Z
@pytest.mark.parametrize("B,m,dy", [(3, 37, 5), (9, 136, 50), (2, mvn.mvn_max_m(50), 50),
                                    (4, 40, 1), (2, 169, 1), (3, 40, 200), (1, 1, 3), (2, 1, 256),
                                    (3, 2, 5), (3, 3, 51), (3, 15, 5), (3, 16, 50), (3, 17, 1),
                                    (3, 33, 256), (4, 65, 51), (5, 152, 50), (4, 136, 5),
                                    (2, mvn.mvn_max_m(1), 1), (2, mvn.mvn_max_m(51), 51),
                                    (2, mvn.mvn_max_m(256), 256)])
def test_mvn_inv_kernel(dev, B, m, dy):
    K, Y, na = _mvn_inputs(dev, B, m, dy)
    mvn.reset_launch_counts()
    ll, W, Z = mvn.mvn_ll_inv(K.float(), Y.float(), na.float())
    torch.cuda.synchronize()
    assert mvn.launch_counts["mvn_ll_inv"] == 1
    for got, ref in zip((ll, W, Z), mvn.mvn_ll_inv_plain(K, Y, na)):
        _close(got, ref)
    assert torch.all(torch.triu(W, 1) == 0)


def test_empty_batch_launches_nothing(dev):
    K = torch.zeros(0, 8, 8, device=dev)
    mvn.reset_launch_counts()
    assert mvn.chol_inv(K)[0].shape == (0, 8, 8)
    assert mvn.tri_inv(K).shape == (0, 8, 8)
    assert mvn.mvn_ll(K, torch.zeros(0, 8, 3, device=dev), torch.zeros(0, device=dev))[0].shape == (0,)
    assert mvn.cholesky(K).shape == (0, 8, 8)
    assert mvn.mvn_ll_inv(K, torch.zeros(0, 8, 3, device=dev),
                          torch.zeros(0, device=dev))[2].shape == (0, 8, 3)
    z = torch.zeros(1, 0, 8, 2, device=dev)
    assert se_kernel.se_matrix(z, z, z[..., 0], z[..., 0], torch.ones(1, device=dev),
                               torch.ones(1, 1, device=dev), None).shape == (1, 0, 8, 8)
    assert mvn.launch_counts == {"chol_inv": 0, "mvn_ll": 0, "tri_inv": 0, "mvn_ll_inv": 0,
                                 "cholesky": 0, "se_kernel": 0, "se_kernel_bwd": 0}


def test_functions_backward_match_twin_autograd(dev):
    rng = np.random.default_rng(1)
    B, m, dy = 4, 72, 6
    A = torch.as_tensor(rng.normal(size=(B, m, m)), device=dev)
    Y = torch.as_tensor(rng.normal(size=(B, m, dy)), device=dev)
    na = torch.full((B,), float(m), device=dev, dtype=torch.float64)
    cL = torch.as_tensor(rng.normal(size=(B, m, m)), device=dev)

    def f(A, Y, ops):
        K = A @ A.mT / m + torch.eye(m, device=dev, dtype=A.dtype)
        L, W = ops.chol_inv(K)
        Wt = ops.tri_inv(L)
        return ops.mvn_ll(K, Y, na.to(A.dtype)).sum() + (L * cL.to(A.dtype)).sum() \
            + 1e-2 * ((W + Wt) * cL.to(A.dtype)).sum()

    def g(A, Y, ops):  # the K4 and K5 Functions
        K = A @ A.mT / m + torch.eye(m, device=dev, dtype=A.dtype)
        return ops.mvn_ll_inv(K, Y, na.to(A.dtype)).sum() + (ops.cholesky(K) * cL.to(A.dtype)).sum()

    for fn in (f, g):
        grads = []
        for ops, dt in ((mvn.KERNEL_OPS, torch.float32), (mvn.PLAIN_OPS, torch.float64)):
            a = A.to(dt).requires_grad_(True)
            y = Y.to(dt).requires_grad_(True)
            grads.append(torch.autograd.grad(fn(a, y, ops), (a, y)))
        for g_k, g_p in zip(*grads):
            _close(g_k, g_p, rtol=1e-3)


def test_split_on_card_matches_twin(dev):
    rng = np.random.default_rng(2)
    B, m, dy = 3, 200, 50  # under K1's cap: the leaf of 96 forces chol_inv splits
    K = torch.as_tensor(_spd(rng, B, m), device=dev)
    Y = torch.as_tensor(rng.normal(size=(B, m, dy)), device=dev)
    na = torch.full((B,), float(m), device=dev, dtype=torch.float64)
    mvn.reset_launch_counts()
    L, W = chol_inv_split(K.float(), leaf=96)
    assert mvn.launch_counts["chol_inv"] == 3  # 104 -> 56 + 48, and 96
    _close(L, mvn.chol_inv_plain(K)[0])
    _close(tri_inv_split(L), W)
    _close(mvn_ll_split(K.float(), Y.float(), na.float(), leaf_mvn=96),
           mvn.mvn_ll_plain(K, Y, na)[0])
    mvn.reset_launch_counts()
    _close(mvn_ll_split(K.float(), Y.float(), na.float(), leaf_mvn=96, mvn_inv=True),
           mvn.mvn_ll_plain(K, Y, na)[0])
    assert mvn.launch_counts["mvn_ll_inv"] == 1 and mvn.launch_counts["mvn_ll"] == 0


@pytest.mark.parametrize("m", [24, 136])
def test_doubling_on_card_matches_twin(dev, m):
    rng = np.random.default_rng(3)
    L = torch.linalg.cholesky(torch.as_tensor(_spd(rng, 4, m), device=dev))
    _close(batched_tri_inv_doubling(L.float()), mvn.tri_inv_plain(L))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    K = torch.eye(8, device=dev).expand(2, 8, 8).contiguous()
    with pytest.raises(TypeError):
        mvn.chol_inv(K.double())
    with pytest.raises(ValueError):
        mvn.tri_inv(K.mT)  # not contiguous
    with pytest.raises(ValueError):
        mvn.chol_inv(torch.eye(mvn.MAX_M_CHOL_INV + 1, device=dev)[None])
    with pytest.raises(ValueError):
        mvn.mvn_ll(K, torch.zeros(2, 8, 3, device=dev), torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        mvn.mvn_ll(K, torch.zeros(2, 8, 257, device=dev), torch.zeros(2, device=dev))


def test_route_wrappers_reject_what_the_kernels_do_not_take(dev):
    K = torch.eye(8, device=dev).expand(2, 8, 8).contiguous()
    Y = torch.zeros(2, 8, 3, device=dev)
    n = torch.full((2,), 8.0, device=dev)
    cap = mvn.mvn_max_m(50)  # K4's, as K2's
    with pytest.raises(TypeError):
        mvn.cholesky(K.double())
    with pytest.raises(ValueError):
        mvn.cholesky(K.mT)  # not contiguous
    with pytest.raises(ValueError):
        mvn.cholesky(torch.eye(241, device=dev)[None])
    with pytest.raises(TypeError):
        mvn.mvn_ll_inv(K, Y.double(), n)
    with pytest.raises(ValueError):
        mvn.mvn_ll_inv(K, Y, torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        mvn.mvn_ll_inv(torch.eye(cap + 1, device=dev)[None],
                       torch.zeros(1, cap + 1, 50, device=dev), torch.ones(1, device=dev))
    with pytest.raises(ValueError):
        mvn.mvn_ll_inv(K, torch.zeros(2, 8, 257, device=dev), n)
    mvn.reset_launch_counts()
    # the largest shapes the gates admit do launch
    mvn.cholesky(torch.eye(240, device=dev)[None])
    mvn.mvn_ll_inv(torch.eye(cap, device=dev)[None], torch.zeros(1, cap, 50, device=dev),
                   torch.ones(1, device=dev))
    torch.cuda.synchronize()
    assert mvn.launch_counts["cholesky"] == 1 and mvn.launch_counts["mvn_ll_inv"] == 1


@pytest.mark.parametrize("m", [872, 888])
def test_wide_splits_on_card_match_twin(dev, m):
    """chol_inv_split and mvn_ll_split at the 80k experiment's widths (three
    and four recursion levels) over the kernels against the float64 twins,
    forward and backward (symmetric parts of d/dK: a split reads K's lower
    blocks only), on ragged blocks, with their leaves' launches."""
    rng = np.random.default_rng(m)
    B, dy = 3, 50
    n_active = [m, m - 20, m - 300]
    K = torch.as_tensor(_spd(rng, B, m, n_active), device=dev)
    Y = torch.as_tensor(rng.normal(size=(B, m, dy)), device=dev)
    Y = Y * (torch.arange(m, device=dev)[None, :, None] < torch.tensor(n_active, device=dev)[:, None, None])
    na = torch.tensor(n_active, device=dev, dtype=torch.float64)
    cots = [torch.as_tensor(rng.normal(size=(B, m, m)), device=dev) for _ in range(2)]
    g_ll = torch.as_tensor(rng.normal(size=(B,)), device=dev)

    def sym(g):
        return (g + g.mT) / 2

    def chol_inv_grads(f, Kin):
        Kin = Kin.clone().requires_grad_(True)
        L, W = f(Kin)
        (gK,) = torch.autograd.grad((L, W), Kin, [c.to(L.dtype) for c in cots])
        return L.detach(), W.detach(), sym(gK)

    def mvn_grads(f, Kin, Yin, nin):
        Kin, Yin = Kin.clone().requires_grad_(True), Yin.clone().requires_grad_(True)
        ll = f(Kin, Yin, nin)
        gK, gY = torch.autograd.grad(ll, (Kin, Yin), g_ll.to(ll.dtype))
        return ll.detach(), sym(gK), gY

    mvn.reset_launch_counts()
    got = chol_inv_grads(chol_inv_split, K.float())
    torch.cuda.synchronize()
    assert mvn.launch_counts["chol_inv"] == 4  # leaves 224/216, nothing in the backward
    for a, b in zip(got, chol_inv_grads(mvn.chol_inv_plain, K)):
        _close(a, b, rtol=1e-3 if a is got[2] else RTOL)
    mvn.reset_launch_counts()
    got = mvn_grads(mvn_ll_split, K.float(), Y.float(), na.float())
    torch.cuda.synchronize()
    assert {k: mvn.launch_counts[k] for k in ("chol_inv", "mvn_ll", "tri_inv")} == {
        "chol_inv": 4, "mvn_ll": 1, "tri_inv": 1}
    ref = mvn_grads(lambda *a: mvn.mvn_ll_plain(*a)[0], K, Y, na)
    _close(got[0], ref[0], rtol=1e-5)
    _close(got[1], ref[1], rtol=1e-3)
    _close(got[2], ref[2], rtol=1e-3)


@pytest.mark.parametrize("R", [1, 2])
def test_chunked_schur_loss_on_card_equals_unchunked(dev, R):
    """pair_chunk=5 on the kernels against the same loss unchunked: the
    chunks' forwards run again in the backward (K2 twice, K3 once a chunk),
    and only the summation order differs."""
    from gprf_torch.model.objective import _schur_ll
    from gprf_torch.kernels.gpcov import GPCov
    from gprf_torch.partition.grid import Blocker, grid_centers

    rng = np.random.default_rng(11)
    n, dy = 900, 50
    X = rng.uniform(size=(R, n, 2))
    Y = torch.as_tensor(rng.normal(size=(n, dy)), device=dev, dtype=torch.float32)
    b = Blocker(grid_centers(16))
    blocks = b.block_clusters(X[0])
    m = (max(len(ix) for ix in blocks) + 7) // 8 * 8
    assignment = np.zeros((16, m), dtype=np.int64)
    mask = np.zeros((16, m), dtype=bool)
    for i, ix in enumerate(blocks):
        assignment[i, :len(ix)] = ix
        mask[i, :len(ix)] = True
    edges = np.asarray(b.neighbors(diag_connections=True))
    counts = np.bincount(edges.reshape(-1), minlength=16)
    nch = -(-len(edges) // 5)

    def t(a, dt=None):
        return torch.as_tensor(a, device=dev, dtype=dt)

    out = []
    for chunk in (None, 5):
        Xt = t(X, torch.float32).requires_grad_(True)
        cov = GPCov(wfn_params=t([[1.0]] * R, torch.float32),
                    dfn_params=t([[0.2, 0.2]] * R, torch.float32))
        mvn.reset_launch_counts()
        ll = _schur_ll(Xt, Y, t(np.stack([assignment] * R)), t(np.stack([mask] * R)), t(edges),
                       t(1.0 - counts, torch.float32), t(np.ones(len(edges)), torch.float32),
                       cov, t([0.01] * R, torch.float32), acc_dtype=torch.float64,
                       pair_chunk=chunk)
        (g,) = torch.autograd.grad(ll.sum(), Xt)
        torch.cuda.synchronize()
        out.append((ll.detach().cpu(), g.double().flatten(), dict(mvn.launch_counts)))
    (v, g, n_whole), (vc, gc, n_chunked) = out
    assert n_whole["mvn_ll"] == 1 and n_chunked["mvn_ll"] == 2 * nch
    assert n_chunked["tri_inv"] == nch
    assert float(((v - vc).abs() / v.abs()).max()) <= CHUNK_RTOL
    assert float(g @ gc / (g.norm() * gc.norm())) > CHUNK_COSINE


def test_pair_chunk_rule_on_card_at_80k(dev):
    """The 80k shapes (80,000 points, 100 grid blocks, 342 edges, m > 512,
    dy 50) at R = 1: the rule runs the pair pass whole (no remat, no dummy
    edge); its loss and gradient equal pair_chunk=64's, and its peak memory
    above the resident stays within [0.5, 1.25] times the rule's estimate
    E PAIR_BUFFERS m^2 4 bytes."""
    from gprf_torch.kernels.gpcov import GPCov
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.model.objective import PAIR_BUFFERS
    from gprf_torch.optim.lbfgs import value_and_grad
    from gprf_torch.partition.grid import Blocker, grid_centers
    from gprf_torch.utils import profiling

    rng = np.random.default_rng(80)
    n, dy, obs_std = 80000, 50, 0.007071
    SX = rng.uniform(size=(n, 2))
    X_obs = SX + obs_std * rng.standard_normal(SX.shape)
    centers = np.asarray(grid_centers(100))
    cov = GPCov.create([1.0], [0.021213, 0.021213], "euclidean", "se", device=dev,
                       dtype=torch.float32)
    fused = FusedSyntheticGPRF(X_obs, rng.standard_normal((n, dy)),
                               Blocker(centers).neighbors(diag_connections=True), X_obs, obs_std,
                               cov, 0.01, task="x", centers=centers, device=dev,
                               dtype=torch.float32, acc_dtype=torch.float64)
    E, m = fused.edges.shape[0], fused.m
    assert E == 342 and m > 512 and fused.loss_pair_chunk() is None
    x = torch.as_tensor(fused.theta0(), dtype=torch.float32, device=dev)
    out = {}
    for chunk in (None, 64):
        fused.pair_chunk = chunk
        loss = fused.loss_fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        profiling.fit_counts.update(pair_passes=0, pair_chunks=0, pair_dummy_edges=0,
                                    pair_schur_blocked=0)
        v, g = value_and_grad(loss, x)
        torch.cuda.synchronize()
        counts = {k: profiling.fit_counts[k] for k in
                  ("pair_passes", "pair_chunks", "pair_dummy_edges", "pair_schur_blocked")}
        out[chunk] = (float(v), g.double(), torch.cuda.max_memory_allocated() - resident, counts)
        del loss, v, g
    (v, g, peak, counts), (vc, gc, _, counts_c) = out[None], out[64]
    # every chunk's S built in the split's blocks (m > K2's leaf at dy 50)
    assert counts == dict(pair_passes=1, pair_chunks=1, pair_dummy_edges=0,
                          pair_schur_blocked=1)
    assert counts_c == dict(pair_passes=1, pair_chunks=6, pair_dummy_edges=6 * 64 - E,
                            pair_schur_blocked=6)
    assert abs(v - vc) <= CHUNK_RTOL * abs(v)
    assert float(g @ gc / (g.norm() * gc.norm())) > CHUNK_COSINE
    estimate = E * PAIR_BUFFERS * m * m * 4
    assert 0.5 * estimate <= peak <= 1.25 * estimate, (peak / 1e9, estimate / 1e9)


def test_pair_pass_builds_s_whole_at_the_flagship_width(dev):
    """The 10k shapes at m = 136 (under K2's leaf at dy 50): one loss+grad
    builds every Schur complement whole, so no chunk counts as blocked."""
    from gprf_torch.kernels.gpcov import GPCov
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.optim.lbfgs import value_and_grad
    from gprf_torch.partition.grid import Blocker, grid_centers
    from gprf_torch.utils import profiling

    rng = np.random.default_rng(10)
    n, dy, obs_std = 10000, 50, 0.02
    X_obs = rng.uniform(size=(n, 2)) + obs_std * rng.standard_normal((n, 2))
    centers = np.asarray(grid_centers(100))
    cov = GPCov.create([1.0], [0.06, 0.06], "euclidean", "se", device=dev, dtype=torch.float32)
    fused = FusedSyntheticGPRF(X_obs, rng.standard_normal((n, dy)),
                               Blocker(centers).neighbors(diag_connections=True), X_obs, obs_std,
                               cov, 0.01, task="x", centers=centers, device=dev,
                               dtype=torch.float32, acc_dtype=torch.float64)
    assert fused.m == 136 < mvn.mvn_max_m(dy)  # the program's rule on this draw
    profiling.fit_counts.update(pair_passes=0, pair_chunks=0, pair_schur_blocked=0)
    v, g = value_and_grad(fused.loss_fn(), torch.as_tensor(fused.theta0(), dtype=torch.float32,
                                                            device=dev))
    torch.cuda.synchronize()
    assert torch.isfinite(v) and bool(torch.isfinite(g).all())
    assert profiling.fit_counts["pair_chunks"] == 1
    assert profiling.fit_counts["pair_schur_blocked"] == 0


def test_schur_conditional_on_card_matches_the_composition(dev):
    """SchurConditional at [16, 896, 896] float32, split at the pair pass's
    h: the blocks of S that the split reads, rhs and every gradient against
    the eager composition it replaced (both float32 on cuBLAS, TF32 off)."""
    from gprf_torch.model.objective import SchurConditional
    from gprf_torch.ops.split_mvn import mvn_split_width

    N, m, dy = 16, 896, 50
    h = mvn_split_width(m, dy)
    assert h == 448 and not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=dev).manual_seed(21)
    A = torch.randn(N, m, m, generator=g, device=dev) / m ** 0.5
    C = A @ A.mT + torch.eye(m, device=dev)
    leaves = [t.requires_grad_(True) for t in (
        C, torch.randn(N, m, dy, generator=g, device=dev),
        torch.randn(N, m, m, generator=g, device=dev) / m ** 0.5,
        torch.randn(N, m, dy, generator=g, device=dev))]
    S, rhs = SchurConditional.apply(leaves[0].clone(), *leaves[1:], h)
    S_ref = leaves[0] - leaves[2].mT @ leaves[2]
    rhs_ref = leaves[1] - leaves[2].mT @ leaves[3]
    for a, b in ((S[:, :, :h], S_ref[:, :, :h]), (S[:, h:, h:], S_ref[:, h:, h:]),
                 (rhs, rhs_ref)):
        _close(a.detach(), b.detach())
    dS = torch.randn(N, m, m, generator=g, device=dev)
    dS[:, :h, h:] = 0
    drhs = torch.randn(N, m, dy, generator=g, device=dev)
    grads = torch.autograd.grad((S, rhs), leaves, (dS, drhs))
    grads_ref = torch.autograd.grad((S_ref, rhs_ref), leaves, (dS, drhs))
    for a, b in zip(grads, grads_ref):
        _close(a, b)


@pytest.mark.parametrize("n", [20000, 36004, 160000])
def test_runner_dot_rows_do_not_depend_on_the_replicas_on_card(dev, n):
    """The L-BFGS runner's dot product on the card gives each row the bits
    it gives that row alone at R 1-8 (a matrix product, or one sum over the
    row, differs in the last bits), so a replica of a batched run steps as
    its start steps alone; n as the 10k, seismic and 80k fits have it."""
    from gprf_torch.optim.lbfgs import _dot

    g = torch.Generator(device=dev).manual_seed(n)
    for trial in range(4):
        a = torch.randn(8, n, generator=g, device=dev)
        b = torch.randn(8, n, generator=g, device=dev) + trial * 1e-3 * a
        for reps in (1, 2, 3, 4, 8):
            rows = _dot(a[:reps], b[:reps])
            for r in range(reps):
                assert torch.equal(rows[r], _dot(a[r], b[r])), (trial, reps, r)


def _wide_blocks_value_and_grad(dev, dtype, ops, m=248, dy=4):
    """ll and d ll / dX of three blocks of width m (two pairs) on the
    unary-doubling route."""
    from gprf_torch.model.objective import gprf_ll_schur
    from gprf_torch.utils.convert import params_from_numpy

    rng = np.random.default_rng(6)
    n_active = [m, m - 18, m - 48]
    X = rng.uniform(size=(sum(n_active), 2))
    Y = rng.normal(size=(sum(n_active), dy))
    assignment = np.zeros((3, m), dtype=np.int64)
    mask = np.zeros((3, m), dtype=bool)
    start = 0
    for b, n in enumerate(n_active):
        assignment[b, :n] = np.arange(start, start + n)
        mask[b, :n] = True
        start += n
    edges = np.array([[0, 1], [1, 2]])
    p = params_from_numpy(X, [1.0], [0.1, 0.1], 0.1, device=dev, dtype=dtype)
    p.X.requires_grad_(True)

    def t(a, dt=None):
        return torch.as_tensor(a, device=dev, dtype=dt)

    ll = gprf_ll_schur(p, t(Y, dtype), t(assignment), t(mask), t(edges),
                       t([0.0, -1.0, 0.0], dtype), t([1.0, 1.0], dtype), ops=ops,
                       unary_doubling=True)
    (gX,) = torch.autograd.grad(ll, p.X)
    return float(ll.detach()), gX.double().flatten()


def test_unary_doubling_route_runs_past_the_cholesky_cap(dev):
    """At m = 248 > MAX_M_CHOL the route factors its blocks by
    cholesky_split over K5 leaves and K3 (before, mvn.cholesky raised) and
    agrees with the twins in float64."""
    assert 248 > mvn.MAX_M_CHOL
    mvn.reset_launch_counts()
    v, g = _wide_blocks_value_and_grad(dev, torch.float32, mvn.KERNEL_OPS)
    torch.cuda.synchronize()
    assert mvn.launch_counts["cholesky"] >= 2 and mvn.launch_counts["tri_inv"] >= 1
    v_ref, g_ref = _wide_blocks_value_and_grad(dev, torch.float64, mvn.PLAIN_OPS)
    assert abs(v - v_ref) <= 1e-5 * abs(v_ref)
    assert float(g @ g_ref / (g.norm() * g_ref.norm())) > 0.9999


def test_cholesky_split_on_card_matches_twin(dev):
    rng = np.random.default_rng(7)
    K = torch.as_tensor(_spd(rng, 4, 248, [248, 240, 201, 130]), device=dev)
    mvn.reset_launch_counts()
    L = cholesky_split(K.float())
    torch.cuda.synchronize()
    assert mvn.launch_counts["cholesky"] == 2 and mvn.launch_counts["tri_inv"] == 1
    _close(L, mvn.cholesky_plain(K))
    assert torch.all(torch.triu(L, 1) == 0)


# ---- the synthetic experiment on the card -----------------------------------


def _sampled(noise_var):
    from gprf_torch.data.sampled import SampledData
    from gprf_torch.partition.grid import grid_centers

    s = SampledData(n=650, ntrain=600, lscale=0.12, obs_std=0.015, yd=5, seed=3,
                    noise_var=noise_var)
    s.set_centers(grid_centers(9))
    return s


def _a_third_into_one_corner(X_obs):
    """A third of the points moved into one corner block: m goes 88 -> 240,
    past K2's cap, so the pair pass splits over K1 and K2 leaves."""
    X = X_obs.copy()
    X[:200] = X[:200] * 0.3 + 0.02
    return X


@pytest.fixture(scope="module")
def sampled():
    """n 600, 9 grid blocks, dy 5 (gprf_torch's own sampler; no JAX here).
    Noise variance 0.1 keeps kappa(K) under 1e3, where two float32
    factorizations agree to the 1e-5 these tests hold the whole ll to; at
    the command line's 0.01 float32 itself is further than that from
    float64 (test_gprf_llgrad_on_card_at_the_flagship_noise)."""
    return _sampled(0.1)


def _agree(a, b):
    """loss rel <= 1e-5 and gradient cosine > 0.9999 between two llgrads."""
    assert abs(a[0] - b[0]) <= 1e-5 * abs(b[0]), (a[0], b[0])
    for g, g_ref in ((a[1], b[1]), (a[2], b[2])):
        g, g_ref = g.reshape(-1), g_ref.reshape(-1)
        assert g @ g_ref / (np.linalg.norm(g) * np.linalg.norm(g_ref)) > 0.9999


@pytest.mark.parametrize("local", [True, False])
def test_gprf_llgrad_on_card_matches_the_twins(dev, sampled, local):
    """GPRF.llgrad in float32 on the kernels against the same on the twins,
    before and after update_X crosses a change of the padded width m."""
    kernels, twins = (sampled.build_gprf(local_dist=0.1, device=dev, dtype=torch.float32, ops=ops)
                      for ops in (mvn.KERNEL_OPS, mvn.PLAIN_OPS))
    mvn.reset_launch_counts()
    _agree(kernels.llgrad(grad_X=True, grad_cov=True, local=local),
           twins.llgrad(grad_X=True, grad_cov=True, local=local))
    assert all(mvn.launch_counts[k] >= 1 for k in ("chol_inv", "mvn_ll", "tri_inv"))
    m0 = kernels.layout.block_pad
    X = _a_third_into_one_corner(sampled.X_obs)
    for g in (kernels, twins):
        g.update_X(X)
    assert kernels.layout.block_pad == twins.layout.block_pad > m0
    _agree(kernels.llgrad(grad_X=True, grad_cov=True, local=local),
           twins.llgrad(grad_X=True, grad_cov=True, local=local))


@pytest.mark.parametrize("moved", [False, True])
@pytest.mark.parametrize("local", [True, False])
def test_gprf_llgrad_on_card_at_the_flagship_noise(dev, local, moved):
    """At the command line's noise variance 0.01 the blocks reach kappa
    2.3e3 (7.8e3 after the move) and weighted terms of 3 to 13 times |ll|
    cancel into ll, so float32 cannot hold 1e-5 of |ll|: on an H100 the
    twins in float32 stand up to 3.4e-5 from the twins in float64, and the
    kernels up to 4.6e-5, the difference entering in the pair pass's
    quadratic forms (scripts/torch_ll_float32_error.py).  So here the
    kernels are held to float64: within 1e-4 (twice that floor), gradient
    cosine above 0.9999, and no more than 4 times further from float64
    than the float32 twins are, unless within 1e-5."""
    s = _sampled(0.01)
    kernels, twins, exact = (
        s.build_gprf(local_dist=0.1, device=dev, dtype=dtype, ops=ops)
        for dtype, ops in ((torch.float32, mvn.KERNEL_OPS), (torch.float32, mvn.PLAIN_OPS),
                           (torch.float64, mvn.PLAIN_OPS)))
    out = []
    mvn.reset_launch_counts()
    for g in (kernels, twins, exact):
        if moved:
            g.update_X(_a_third_into_one_corner(s.X_obs))
        out.append(g.llgrad(grad_X=True, grad_cov=True, local=local))
    assert all(mvn.launch_counts[k] >= 1 for k in ("chol_inv", "mvn_ll", "tri_inv"))
    assert kernels.layout.block_pad == (240 if moved else 88)
    (ll_k, *grads_k), (ll_t, *_), (ll, *grads) = out
    err_k, err_t = abs(ll_k - ll) / abs(ll), abs(ll_t - ll) / abs(ll)
    assert err_k <= 1e-4, (ll_k, ll_t, ll)
    assert err_k <= max(4 * err_t, 1e-5), (ll_k, ll_t, ll)
    for g, g_ref in zip(grads_k, grads):
        g, g_ref = g.reshape(-1), g_ref.reshape(-1)
        assert g @ g_ref / (np.linalg.norm(g) * np.linalg.norm(g_ref)) > 0.9999


def test_gprf_single_terms_on_card_match_the_twins(dev, sampled):
    kernels, twins = (sampled.build_gprf(local_dist=0.1, device=dev, dtype=torch.float32, ops=ops)
                      for ops in (mvn.KERNEL_OPS, mvn.PLAIN_OPS))
    a, b = kernels.subset_llgrad([0, 1, 3, 4]), twins.subset_llgrad([0, 1, 3, 4])
    assert abs(a - b) <= 1e-5 * abs(b)
    _agree(kernels.llgrad_joint(4, 1, grad_X=True, grad_cov=True),
           twins.llgrad_joint(4, 1, grad_X=True, grad_cov=True))


@pytest.mark.parametrize("task", ["x", "xcov"])
def test_device_engine_driver_on_card_across_a_growth(dev, sampled, tmp_path, task):
    """Two dispatches from a capacity one notch too small: the driver grows
    it, keeps going, and leaves a state that loads back onto the card."""
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.optim import lbfgs

    def make(m=None):
        return FusedSyntheticGPRF(
            sampled.X_obs, sampled.SY, sampled.neighbors, sampled.X_obs, sampled.obs_std,
            sampled.cov, sampled.noise_var, task=task, C0=np.array([[0.1]]),
            centers=np.asarray(sampled.centers), m=m, device=dev, dtype=torch.float32,
            acc_dtype=torch.float64)

    m_fit = make().m
    fused = make(m_fit - 8)
    mvn.reset_launch_counts()
    theta = lbfgs.do_optimization_fused_theta(str(tmp_path), fused, fused.theta0(), max_iters=20,
                                              steps_per_dispatch=10)
    assert fused.m == m_fit + 8 and np.isfinite(theta).all()
    assert all(mvn.launch_counts[k] >= 20 for k in ("chol_inv", "mvn_ll", "tri_inv"))
    with open(tmp_path / "log.txt") as f:
        rows = [line.split() for line in f if line[0].isdigit()]
    values = np.array([float(r[2]) for r in rows])
    assert [int(r[0]) for r in rows] == list(range(20))
    assert np.isfinite(values).all() and values[-1] > values[0]
    assert (tmp_path / "covs.txt").exists() == (task == "xcov")
    carry, it = lbfgs.load_optimizer_state(str(tmp_path), dev)
    assert it == 20 and carry["x"].device.type == "cuda" and carry["x"].dtype == torch.float32
    assert carry["valid"].dtype == torch.bool and carry["head"].dtype == torch.int64
    assert carry["v"].dtype == torch.float64  # the objective's float64 tails
    np.testing.assert_array_equal(carry["x"].double().cpu().numpy(), theta)
    # resumed: the log goes on without a repeated step index
    lbfgs.do_optimization_fused_theta(str(tmp_path), make(fused.m), fused.theta0(), max_iters=40,
                                      steps_per_dispatch=10, resume=True)
    with open(tmp_path / "log.txt") as f:
        steps = [int(line.split()[0]) for line in f if line[0].isdigit()]
    assert steps == list(range(40))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_command_line_runs_on_the_card_by_default(dev, tmp_path, monkeypatch, engine):
    from gprf_torch.analysis.results import load_final_results
    from gprf_torch.cli import gprfopt

    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    argv = ["--ntrain", "400", "--ntest", "50", "--nblocks", "9", "--lscale", "0.1",
            "--local_dist", "0.1", "--yd", "5", "--task", "x", "--engine", engine,
            "--max_iters", "40", "--maxsec", "20"]
    mvn.reset_launch_counts()
    gprfopt.main(argv)
    assert all(mvn.launch_counts[k] >= 1 for k in ("chol_inv", "mvn_ll", "tri_inv"))
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    files = set(os.listdir(d))
    assert {"log.txt", "results.txt", "finished"} <= files
    assert any(f.startswith("step_") and f.endswith("_X.npy") for f in files)
    final, true_row = load_final_results(d)
    assert np.isfinite(true_row["mll"]) and np.isfinite(final["mll"])


# ---- the seismic slice -------------------------------------------------------------


@pytest.fixture(scope="module")
def seismic_problem():
    """1,600 events of the synthetic catalog, observed with the command
    line's noise (obs_std 20), a PD-tree of under 210 points a leaf over the
    wrapped (lon, lat), edges at threshold 0.6, Y seeded normal (dy 50)."""
    from gprf_torch.data.seismic import make_synthetic_catalog
    from gprf_torch.model.gprf import GPRF
    from gprf_torch.partition.pdtree import PDTree, wrap_lon
    from gprf_torch.utils.convert import cov_from_numpy

    X_true = make_synthetic_catalog(n=1600, seed=1)[:, (2, 3, 7)]
    prior_std = 20.0 * np.array([0.01, 0.01, 1.0])
    rng = np.random.default_rng(0)
    means = X_true + rng.standard_normal(X_true.shape) * prior_std
    Y = rng.standard_normal((len(means), 50))
    X2 = means[:, :2].copy()
    X2[:, 0] = wrap_lon(X2[:, 0])
    tree = PDTree(X2, 210)
    cov64 = cov_from_numpy([1.0], [40.0, 40.0], "lld", "matern32", device="cpu",
                           dtype=torch.float64)
    edges = GPRF(means, Y, None, cov64, 0.1, block_idxs=tree.leaf_idx(), neighbor_threshold=0.6,
                 device="cpu", dtype=torch.float64).neighbors
    assert len(edges) > 0
    return dict(means=means, prior_std=prior_std, Y=Y, tree=tree, edges=edges, cov=cov64)


def _seismic_engine(p, dev, ops):
    """The seismic engine at the command line's width m = 192, task xcov."""
    from gprf_torch.model.fused_seismic import FusedSeismicGPRF

    return FusedSeismicGPRF(p["means"], p["Y"], p["tree"], p["edges"], p["means"], p["prior_std"],
                            p["cov"], 0.1, task="xcov", m=192, device=dev, dtype=torch.float32,
                            acc_dtype=torch.float64, ops=ops)


def _seismic_thetas(fused, p, R):
    from gprf_torch.cli.run_seismic import multistart_thetas

    theta0 = fused.theta0(p["means"], np.array([[0.1, 1.0, 40.0, 40.0]]))
    return multistart_thetas(theta0, "xcov", p["means"].size, R, 0)


def _loss_grad(fused, theta, dev):
    from gprf_torch.optim.lbfgs import value_and_grad

    v, g = value_and_grad(fused.loss_fn(), torch.as_tensor(theta, dtype=torch.float32,
                                                           device=dev))
    return v.double().cpu().numpy(), g.double().cpu().numpy()


@pytest.mark.parametrize("R", [1, 4])
def test_seismic_loss_on_card_matches_the_twins(dev, seismic_problem, R):
    """FusedSeismicGPRF's loss and gradient at m = 192 on the kernels (K1 on
    [R B, 192, 192], K2 and K3 on [R E, 192, 192]) against the same on the
    twins: per replica, loss rel <= 1e-5 and gradient cosine > 0.9999."""
    kernels, twins = (_seismic_engine(seismic_problem, dev, ops)
                      for ops in (mvn.KERNEL_OPS, mvn.PLAIN_OPS))
    thetas = _seismic_thetas(kernels, seismic_problem, R)
    theta = thetas[0] if R == 1 else thetas
    mvn.reset_launch_counts()
    v, g = _loss_grad(kernels, theta, dev)
    torch.cuda.synchronize()
    assert dict(mvn.launch_counts) == {"chol_inv": 1, "mvn_ll": 1, "tri_inv": 1, "mvn_ll_inv": 0,
                                       "cholesky": 0, "se_kernel": 0, "se_kernel_bwd": 0}
    v_ref, g_ref = _loss_grad(twins, theta, dev)
    for a, b, ga, gb in zip(v.reshape(-1), v_ref.reshape(-1), g.reshape(R, -1),
                            g_ref.reshape(R, -1)):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
        assert ga @ gb / (np.linalg.norm(ga) * np.linalg.norm(gb)) > 0.9999


def test_folded_multistart_loss_on_card_matches_single_losses(dev, seismic_problem):
    """Four replicas folded into one kernel batch give each replica's own
    loss and gradient, with one launch of each kernel where single losses
    take four."""
    fused = _seismic_engine(seismic_problem, dev, mvn.KERNEL_OPS)
    thetas = _seismic_thetas(fused, seismic_problem, 4)
    v, g = _loss_grad(fused, thetas, dev)
    mvn.reset_launch_counts()
    for r in range(4):
        v1, g1 = _loss_grad(fused, thetas[r], dev)
        assert abs(v[r] - v1) <= 1e-6 * abs(v1), (v[r], v1)
        assert g[r] @ g1 / (np.linalg.norm(g[r]) * np.linalg.norm(g1)) > 0.999999
    assert mvn.launch_counts["chol_inv"] == 4
    overflow = fused.overflow_fn()
    flags = overflow(torch.as_tensor(thetas, dtype=torch.float32, device=dev))
    assert flags.shape == (4,)
    for r in range(4):
        one = overflow(torch.as_tensor(thetas[r], dtype=torch.float32, device=dev))
        assert one.shape == () and bool(one) == bool(flags[r])


def test_assign_blocks_pdtree_on_card_matches_the_host(dev, seismic_problem):
    """The float32 traversal on the card against the float64 host replay on
    moved points: points within float32's reach of a split plane may fall
    on the other side, and there are few."""
    from gprf_torch.partition.pdtree import wrap_lon
    from gprf_torch.partition.pdtree_device import FlatPDTree, assign_blocks_pdtree

    tree = seismic_problem["tree"]
    rng = np.random.default_rng(3)
    Xp = seismic_problem["means"][:, :2] + rng.normal(size=(len(seismic_problem["means"]), 2)) * 0.1
    Xp[:, 0] = wrap_lon(Xp[:, 0])
    host = np.empty(len(Xp), dtype=np.int64)
    for b, ix in enumerate(tree.recluster(Xp)):
        host[ix] = b
    flat = FlatPDTree(tree)
    got = assign_blocks_pdtree(torch.as_tensor(Xp, dtype=torch.float32, device=dev),
                               flat.device_arrays(dev, torch.float32), flat.depth)
    assert got.device.type == "cuda"
    differ = int((got.cpu().numpy() != host).sum())
    assert differ <= 2, differ
    exact = assign_blocks_pdtree(torch.as_tensor(Xp, device=dev),
                                 flat.device_arrays(dev, torch.float64), flat.depth)
    np.testing.assert_array_equal(exact.cpu().numpy(), host)


@pytest.mark.parametrize("engine", [["--engine", "host", "--maxsec", "5"],
                                    ["--engine", "device", "--multistart", "2", "--max_iters",
                                     "40"]])
def test_seismic_command_line_runs_on_the_card_by_default(dev, tmp_path, monkeypatch, engine):
    from gprf_torch.cli import run_seismic
    from gprf_torch.data.seismic import make_synthetic_catalog

    monkeypatch.setenv("SEISMIC_EXPERIMENTS", str(tmp_path / "exp"))
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "sorted_isc.npy", make_synthetic_catalog(n=800, seed=2))
    argv = ["--npts=-1", "--obs_std=20", "--threshold=0.6", "--rpc_blocksize=210", "--task=xcov",
            "--data_dir", str(data)] + engine
    mvn.reset_launch_counts()
    info = run_seismic.main(argv)
    assert all(mvn.launch_counts[k] >= 1 for k in ("chol_inv", "mvn_ll", "tri_inv"))
    d = run_seismic.seismic_exp_dir(run_seismic.build_parser().parse_args(argv))
    files = set(os.listdir(d))
    assert {"log.txt", "covs.txt", "results.txt", "finished"} <= files
    assert ("multistart.txt" in files) == ("device" in engine)
    with open(os.path.join(d, "log.txt")) as f:
        values = [float(line.split()[2]) for line in f if line[0].isdigit()]
    assert np.isfinite(values).all() and max(values) > values[0] and info["blocks"] >= 4


# ---- RPC partitions and prediction on the card -------------------------------------

# The float32 predictor on the card against the float64 one: SMSE relative,
# MSLL absolute (nats); the limits of chip_smoke.py's predict phase
PREDICT_RTOL_SMSE = 1e-4
PREDICT_ATOL_MSLL = 1e-4


def _labels(blocks, n):
    lab = np.empty(n, dtype=np.int64)
    for b, ix in enumerate(blocks):
        lab[ix] = b
    return lab


@pytest.fixture(scope="module")
def rpc_sampled():
    """n 600, dy 5, over an RPC partition of block size 80 (8 blocks)."""
    from gprf_torch.data.sampled import SampledData

    s = SampledData(n=650, ntrain=600, lscale=0.12, obs_std=0.015, yd=5, seed=3, noise_var=0.01)
    s.cluster_rpc(80, rng=np.random.RandomState(3))
    return s


def test_rpc_replay_on_card_matches_the_host(dev, rpc_sampled):
    """The float32 median replay on the card against the float64 host
    replay, at X_obs and moved by N(0, 0.02^2): counted, at most 2 of 600
    points in another block; the two folded into one replay equal each
    alone."""
    from gprf_torch.partition.rpc_device import FlatRPCTree, assign_blocks_rpc

    s = rpc_sampled
    flat = FlatRPCTree(s.rpc_splits, d=2)
    arrays = flat.device_arrays(device=dev, dtype=torch.float32)
    Xs = np.stack([s.X_obs, s.X_obs + np.random.default_rng(4).normal(size=s.X_obs.shape) * 0.02])

    def replay(X):
        return assign_blocks_rpc(torch.as_tensor(X, dtype=torch.float32, device=dev), arrays,
                                 flat.depth, flat.n_nodes)

    folded = replay(Xs)
    for r, X in enumerate(Xs):
        alone = replay(X)
        assert torch.equal(folded[r], alone)
        moved = int(np.sum(alone.cpu().numpy() != _labels(s.reblock(X), len(X))))
        assert moved <= 2, moved


def test_rpc_loss_on_card_matches_the_twins(dev, rpc_sampled):
    from gprf_torch.model.fused import FusedSyntheticGPRF

    s = rpc_sampled
    edges = s.build_gprf(local_dist=0.1, device=dev, dtype=torch.float32).neighbors
    fused = FusedSyntheticGPRF(s.X_obs, s.SY, edges, s.X_obs, s.obs_std, s.cov, s.noise_var,
                               rpc_tree=s.rpc_splits, device=dev, dtype=torch.float32,
                               acc_dtype=torch.float64)
    x = torch.as_tensor(s.X_obs.reshape(-1), dtype=torch.float32, device=dev)
    out = []
    mvn.reset_launch_counts()
    for ops in (mvn.KERNEL_OPS, mvn.PLAIN_OPS):
        fused.ops = ops
        th = x.clone().requires_grad_(True)
        v = fused.loss_fn()(th)
        (g,) = torch.autograd.grad(v, th)
        out.append((float(v.detach()), g.double().cpu().numpy()))
    assert all(mvn.launch_counts[k] >= 1 for k in ("chol_inv", "mvn_ll", "tri_inv"))
    (v, g), (v_ref, g_ref) = out
    assert abs(v - v_ref) <= 1e-5 * abs(v_ref)
    assert g @ g_ref / (np.linalg.norm(g) * np.linalg.norm(g_ref)) > 0.9999


def test_block_caches_on_card_run_k5(dev):
    """The predictor's (L, alpha) in float32 on K5 against float64 on the
    twins, at the command line's noise 0.01 (kappa up to ~2e3)."""
    from gprf_torch.model import predict

    s = _sampled(0.01)
    g32, g64 = (s.build_gprf(local_dist=0.1, device=dev, dtype=dtype, ops=ops)
                for dtype, ops in ((torch.float32, mvn.KERNEL_OPS),
                                   (torch.float64, mvn.PLAIN_OPS)))
    mvn.reset_launch_counts()
    _, _, L32, A32 = predict._snapshot(g32, None)
    torch.cuda.synchronize()
    assert mvn.launch_counts["cholesky"] == 1 and L32.shape == (9, 88, 88)
    _, _, L64, A64 = predict._snapshot(g64, None)
    assert mvn.launch_counts["cholesky"] == 1
    assert float((L32.double() - L64).abs().max() / L64.abs().max()) <= RTOL
    assert float((A32.double() - A64).abs().max() / A64.abs().max()) <= 1e-3


def test_predictor_on_card_float32_against_float64(dev):
    s = _sampled(0.01)
    X = s.X_obs + np.random.default_rng(5).normal(size=s.X_obs.shape) * 0.005
    mvn.reset_launch_counts()
    (s32, b32, d32), (s64, b64, d64) = (
        s.prediction_error(X=X, local_dist=0.1, device=dev, dtype=dtype, ops=ops)
        for dtype, ops in ((torch.float32, mvn.KERNEL_OPS), (torch.float64, mvn.PLAIN_OPS)))
    assert mvn.launch_counts["cholesky"] == 1
    assert abs(s32 - s64) <= PREDICT_RTOL_SMSE * abs(s64) and 0 < s64 < 1
    assert max(abs(b32 - b64), abs(d32 - d64)) <= PREDICT_ATOL_MSLL


def test_exact_gp_on_card_matches_the_cpu(dev):
    s = _sampled(0.01)
    on_card = s.prediction_error_gp(s.X_obs, device=dev, dtype=torch.float64)
    on_cpu = s.prediction_error_gp(s.X_obs, device="cpu", dtype=torch.float64)
    assert np.isfinite(on_card) and abs(on_card - on_cpu) <= 1e-9 * abs(on_cpu)


@pytest.mark.parametrize("engine", [["--engine", "host", "--maxsec", "10"],
                                    ["--engine", "device", "--max_iters", "40"],
                                    ["--engine", "device", "--multistart", "2", "--max_iters",
                                     "20"]])
def test_rpc_command_line_runs_on_the_card(dev, tmp_path, monkeypatch, engine):
    from gprf_torch.analysis.results import load_final_results
    from gprf_torch.cli import gprfopt

    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    argv = ["--ntrain", "400", "--ntest", "50", "--rpc_blocksize", "60", "--lscale", "0.1",
            "--local_dist", "0.1", "--yd", "5", "--task", "x"] + engine
    mvn.reset_launch_counts()
    gprfopt.main(argv)
    assert all(mvn.launch_counts[k] >= 1 for k in ("chol_inv", "mvn_ll", "tri_inv"))
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    files = set(os.listdir(d))
    assert {"log.txt", "results.txt", "finished"} <= files
    assert ("multistart.txt" in files) == ("--multistart" in engine)
    with open(os.path.join(d, "log.txt")) as f:
        values = [float(line.split()[2]) for line in f if line[0].isdigit()]
    assert np.isfinite(values).all() and max(values) > values[0]
    assert np.isfinite(load_final_results(d)[1]["mll"])


def test_analyze_full_on_the_card(dev, tmp_path, monkeypatch):
    """A fit, then --analyze --analyze_full on its directory: the predictive
    columns fill, through K5."""
    from gprf_torch.analysis.results import load_results
    from gprf_torch.cli import gprfopt

    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    argv = ["--ntrain", "400", "--ntest", "50", "--nblocks", "9", "--lscale", "0.1",
            "--local_dist", "0.1", "--yd", "5", "--task", "x", "--engine", "device",
            "--max_iters", "20"]
    gprfopt.main(argv)
    mvn.reset_launch_counts()
    gprfopt.main(argv + ["--analyze", "--analyze_full"])
    assert mvn.launch_counts["cholesky"] >= 1 and mvn.launch_counts["mvn_ll_inv"] == 0
    rows = load_results(gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv)))[:, 6:]
    assert np.isfinite(rows).all() and (rows != 0).all() and (rows[:, :2] < 1).all()


# ---- the float64 tail and the GPLVM baselines on the card ---------------------


@pytest.mark.parametrize("name", ["chol_inv", "mvn_ll", "tri_inv", "mvn_ll_inv", "cholesky"])
def test_kernels_refuse_float64_on_the_card(dev, name):
    """The five kernels are float32: a CUDA float64 input raises, launches
    nothing and never drops to a twin; LINALG_OPS is the float64 route."""
    K = torch.eye(8, device=dev, dtype=torch.float64).expand(2, 8, 8).contiguous()
    args = {"mvn_ll": (K, torch.zeros(2, 8, 3, device=dev, dtype=torch.float64),
                       torch.full((2,), 8.0, device=dev, dtype=torch.float64)),
            "mvn_ll_inv": (K, torch.zeros(2, 8, 3, device=dev, dtype=torch.float64),
                           torch.full((2,), 8.0, device=dev, dtype=torch.float64))}.get(name, (K,))
    mvn.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        getattr(mvn, name)(*args)
    assert not any(mvn.launch_counts.values())
    out = getattr(mvn.LINALG_OPS, name)(*args)
    assert all(o.dtype == torch.float64 and o.is_cuda for o in (out if isinstance(out, tuple)
                                                                   else (out,)))
    assert not any(mvn.launch_counts.values())


@pytest.mark.parametrize("m", [136, 888])
def test_linalg_ops_on_card_match_the_cpu(dev, m):
    """cuSOLVER against LAPACK in float64, whole blocks at any width: the
    MVN density and its gradients."""
    rng = np.random.default_rng(7)
    K = _spd(rng, 3, m, n_active=[m, m - 5, m - 40])
    live = np.arange(m)[None, :, None] < np.array([m, m - 5, m - 40])[:, None, None]
    Y = rng.normal(size=(3, m, 5)) * live
    n = [float(m), m - 5.0, m - 40.0]
    out = {}
    for where in ("cpu", dev):
        t = [torch.as_tensor(a, dtype=torch.float64, device=where).requires_grad_(True)
             for a in (K, Y)]
        ll = mvn_ll_split(t[0], t[1], torch.tensor(n, dtype=torch.float64, device=where),
                          ops=mvn.LINALG_OPS)
        out[str(where)] = (ll.detach().cpu(), *(g.cpu() for g in torch.autograd.grad(ll.sum(), t)))
    for a, b in zip(out[str(dev)], out["cpu"]):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-10 * float(b.abs().max()))


def test_refine_iters_on_the_card_launches_no_kernel(dev, tmp_path, monkeypatch):
    """The command line's float64 tail runs on the card over LINALG_OPS: the
    float32 loop launches K1-K3, the tail none."""
    from gprf_torch.cli import gprfopt

    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    real, tail = gprfopt.refine_f64, {}

    def counted(*args, **kw):
        before = dict(mvn.launch_counts)
        out = real(*args, **kw)
        tail.update({k: mvn.launch_counts[k] - before[k] for k in before})
        return out

    monkeypatch.setattr(gprfopt, "refine_f64", counted)
    argv = ["--ntrain", "400", "--ntest", "50", "--nblocks", "9", "--lscale", "0.1",
            "--local_dist", "0.1", "--yd", "5", "--task", "xcov", "--engine", "device",
            "--max_iters", "20", "--refine_iters", "10"]
    mvn.reset_launch_counts()
    gprfopt.main(argv)
    assert all(mvn.launch_counts[k] >= 1 for k in ("chol_inv", "mvn_ll", "tri_inv"))
    assert set(tail) == set(mvn.launch_counts) and not any(tail.values())
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    with open(os.path.join(d, "log.txt")) as f:
        steps = [int(line.split()[0]) for line in f if line[0].isdigit()]
    assert steps == list(range(30))


@pytest.mark.parametrize("gplvm_type", ["sparse", "titsias", "bayesian", "basic"])
def test_gplvm_baselines_on_the_card(dev, tmp_path, monkeypatch, gplvm_type):
    """Each baseline through the command line on the card (float32), and its
    first evaluation against float64 on the CPU at float32's jitter (the
    jitter follows the width: 1e-4 in float32, 1e-6 in float64)."""
    from gprf_torch.cli import gprfopt
    from gprf_torch.model import sgplvm

    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    argv = ["--ntrain", "400", "--ntest", "50", "--nblocks", "1", "--lscale", "0.1",
            "--local_dist", "1.0", "--yd", "5", "--task", "x", "--gplvm_type", gplvm_type,
            "--num_inducing", "40", "--maxsec", "10"]
    gprfopt.main(argv)
    d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
    with open(os.path.join(d, "log.txt")) as f:
        values = [float(line.split()[2]) for line in f if line[0].isdigit()]
    assert len(values) >= 3 and np.isfinite(values).all() and max(values) > values[0]
    rng = np.random.default_rng(2)
    X, Z, Y = rng.uniform(size=(300, 2)), rng.uniform(size=(40, 2)), rng.normal(size=(300, 5))
    got = {}
    monkeypatch.setattr(sgplvm, "_rel_jitter", lambda dtype: 1e-4)
    for where, dt in ((dev, torch.float32), ("cpu", torch.float64)):
        t = [torch.as_tensor(a, dtype=dt, device=where) for a in (X, Z, np.log(0.1), Y)]
        if gplvm_type == "bayesian":
            got[dt] = sgplvm._bgplvm_objective_and_grads(
                t[0], torch.full_like(t[0], np.log(4e-4)), t[1], t[2], t[3], 1.0, 0.01, True)
        else:
            got[dt] = sgplvm._objective_and_grads(*t, 1.0, 0.01, gplvm_type, True)
    ll32, ll64 = float(got[torch.float32][0]), float(got[torch.float64][0])
    assert abs(ll32 - ll64) <= 1e-4 * abs(ll64)
    g32 = torch.cat([g.reshape(-1).double().cpu() for g in got[torch.float32][1:]])
    g64 = torch.cat([g.reshape(-1) for g in got[torch.float64][1:]])
    assert float(g32 @ g64 / (g32.norm() * g64.norm())) > 0.999


# ---- the kernelized and sparse llgrads on the card ----------------------------------


def _kernelized(s, dev, dtype, ops):
    """The kernelized model over s's partition, YY = SY SY^T formed on the card."""
    from gprf_torch.model.gprf import GPRF

    SY = torch.as_tensor(s.SY, dtype=torch.float64, device=dev)
    base = s.build_gprf(local_dist=0.1, device="cpu", dtype=torch.float64)
    return GPRF(s.X_obs, (SY @ SY.T).to(dtype), s.reblock, s.cov, s.noise_var, kernelized=True,
                dy=s.SY.shape[1], block_idxs=base.block_idxs, neighbors=base.neighbors,
                device=dev, dtype=dtype, ops=ops)


@pytest.mark.parametrize("moved", [False, True])
@pytest.mark.parametrize("local", [True, False])
def test_kernelized_llgrad_on_card_runs_k1_alone(dev, sampled, local, moved):
    """The kernelized objective in float32 on the kernels against the twins,
    at m = 88 (pairs at 176, one K1 leaf) and after the move to m = 240
    (pairs at 480, split into K1 leaves of 240); it launches K1 and no other
    kernel, and in float64 (LINALG_OPS) it is the Schur form on Y."""
    kernels, twins, exact = (_kernelized(sampled, dev, dtype, ops) for dtype, ops in (
        (torch.float32, mvn.KERNEL_OPS), (torch.float32, mvn.PLAIN_OPS),
        (torch.float64, mvn.LINALG_OPS)))
    schur = sampled.build_gprf(local_dist=0.1, device=dev, dtype=torch.float64,
                               ops=mvn.LINALG_OPS)
    models = (kernels, twins, exact, schur)
    if moved:
        for g in models:
            g.update_X(_a_third_into_one_corner(sampled.X_obs))
    assert kernels.layout.block_pad == (240 if moved else 88)
    mvn.reset_launch_counts()
    a = kernels.llgrad(grad_X=True, grad_cov=True, local=local)
    assert mvn.launch_counts["chol_inv"] == (3 if moved else 2)
    assert sum(mvn.launch_counts.values()) == mvn.launch_counts["chol_inv"]
    _agree(a, twins.llgrad(grad_X=True, grad_cov=True, local=local))
    k, y = (g.llgrad(grad_X=True, grad_cov=True, local=local) for g in (exact, schur))
    assert abs(k[0] - y[0]) <= 1e-9 * abs(y[0])
    np.testing.assert_allclose(k[1], y[1], rtol=1e-6, atol=1e-6 * np.abs(y[1]).max())


def test_sparse_llgrad_of_a_card_model_runs_on_the_host(dev, sampled):
    """llgrad(sparse=True) of a model on the card is the float64 host
    computation, the same as a CPU model's, and launches no kernel."""
    on_card, on_cpu = (sampled.build_gprf(local_dist=0.1, device=d, dtype=torch.float64,
                                          ops=mvn.LINALG_OPS) for d in (dev, "cpu"))
    mvn.reset_launch_counts()
    a = on_card.llgrad(grad_X=True, grad_cov=True, sparse=True)
    assert sum(mvn.launch_counts.values()) == 0
    b = on_cpu.llgrad(grad_X=True, grad_cov=True, sparse=True)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    dense = on_card.llgrad(grad_X=True, grad_cov=True)
    assert abs(a[0] - dense[0]) <= 1e-6 * abs(dense[0])


def test_seismic_sparse_runs_on_the_host_engine_of_the_card(dev, tmp_path, monkeypatch):
    from gprf_torch.cli import run_seismic
    from gprf_torch.data.seismic import make_synthetic_catalog

    monkeypatch.setenv("SEISMIC_EXPERIMENTS", str(tmp_path / "exp"))
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "sorted_isc.npy", make_synthetic_catalog(n=800, seed=2))
    argv = ["--npts=400", "--obs_std=20", "--threshold=0.6", "--rpc_blocksize=210",
            "--task=xcov", "--data_dir", str(data), "--sparse"]
    with pytest.raises(ValueError, match="--engine host"):
        run_seismic.main(argv + ["--engine", "device"])
    assert not os.path.exists(tmp_path / "exp")
    run_seismic.main(argv + ["--engine", "host", "--maxsec", "5"])
    d = run_seismic.seismic_exp_dir(run_seismic.build_parser().parse_args(argv))
    assert {"log.txt", "covs.txt", "results.txt", "finished"} <= set(os.listdir(d))
    with open(os.path.join(d, "log.txt")) as f:
        values = [float(line.split()[2]) for line in f if line[0].isdigit()]
    assert len(values) >= 3 and max(values) > values[0]


# ---- the SE kernel matrices ---------------------------------------------------


def _se_inputs(dev, mode, R, N, m, dx, k, seed=0):
    """Points of N block pairs (block i's in a 0.1-wide cell, block j's in
    the next cell over) with ragged masks, and each replica's sv, ls
    (k = 1 or dx) and, in block mode, nv; float64 on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    opts = dict(generator=gen, device=dev, dtype=torch.float64)
    Xi = torch.rand(R, N, m, dx, **opts) * 0.1
    n_act = m - torch.randint(0, max(m // 4, 1), (R, N, 1), generator=gen, device=dev)
    mi = (torch.arange(m, device=dev) < n_act).double()
    if mode == "block":
        Xj, mj, nv = Xi, mi, 0.01 + 0.01 * torch.rand(R, **opts)
    else:
        Xj = torch.rand(R, N, m, dx, **opts) * 0.1 + 0.05
        mj, nv = mi.flip(1), None
    sv = 0.5 + torch.rand(R, **opts)
    ls = 0.015 + 0.02 * torch.rand(R, k, **opts)
    G = torch.randn(R, N, m, m, **opts)  # not symmetric
    return (Xi, Xj, mi, mj, sv, ls, nv), G


def _se_run(f, args, G, dtype):
    """K and the gradients (dXi, dXj, d sv, d ls, d nv) of <K, G> under
    ``f`` at ``dtype``, for every input that takes one."""
    block = args[6] is not None  # block mode: Xj is Xi
    args = [None if a is None else a.to(dtype) for a in args]
    Xi = args[0].detach().requires_grad_(True)
    Xj = Xi if block else args[1].detach().requires_grad_(True)
    sv, ls = (a.detach().requires_grad_(True) for a in args[4:6])
    nv = None if args[6] is None else args[6].detach().requires_grad_(True)
    K = f(Xi, Xj, args[2], args[3], sv, ls, nv)
    leaves = [Xi] + ([] if block else [Xj]) + [sv, ls] + ([] if nv is None else [nv])
    return K.detach(), torch.autograd.grad(K, leaves, G.to(dtype))


# the 10k cell's pair pass, the 80k unary and pair passes; then the kernel's
# other paths: m not a multiple of 4, one row tile, the generic dx (1, 3, 5,
# 15), one lengthscale, two replicas
@pytest.mark.parametrize("mode,R,N,m,dx,k", [
    ("pair", 1, 342, 136, 2, 2), ("block", 1, 100, 896, 2, 2), ("pair", 1, 342, 896, 2, 2),
    ("block", 1, 100, 136, 2, 2), ("pair", 2, 5, 37, 2, 1), ("block", 2, 4, 130, 3, 3),
    ("block", 1, 3, 64, 1, 1), ("pair", 1, 2, 200, 5, 5), ("pair", 2, 3, 129, 15, 1)])
def test_se_kernel_matches_twin(dev, mode, R, N, m, dx, k):
    """The kernel in float32 against its twin in float32: the forward and
    every gradient (dX of both point sets, d sv, d ls, d nv), normwise, under
    a cotangent that is not symmetric.  The forward is the twin's arithmetic
    entry by entry; the gradients sum in another order."""
    args, G = _se_inputs(dev, mode, R, N, m, dx, k, seed=m + dx)
    mvn.reset_launch_counts()
    K, grads = _se_run(se_kernel.se_kernel, args, G, torch.float32)
    torch.cuda.synchronize()
    assert mvn.launch_counts["se_kernel"] == 1 and mvn.launch_counts["se_kernel_bwd"] == 1
    K_ref, grads_ref = _se_run(se_kernel.se_kernel_plain, args, G, torch.float32)
    _close(K, K_ref, rtol=1e-6)
    for got, ref in zip(grads, grads_ref):
        _close(got, ref)


def test_se_kernel_counts_launches_and_refuses_float64(dev):
    """One forward launch and one backward launch a call; float64 on the
    card raises (the float64 route takes the twin, LINALG_OPS)."""
    args, G = _se_inputs(dev, "pair", 1, 3, 40, 2, 2)
    mvn.reset_launch_counts()
    for _ in range(2):
        _se_run(se_kernel.se_kernel, args, G, torch.float32)
    torch.cuda.synchronize()
    assert mvn.launch_counts["se_kernel"] == 2 and mvn.launch_counts["se_kernel_bwd"] == 2
    with pytest.raises(TypeError, match="float32"):
        se_kernel.se_kernel(*args)
    assert mvn.LINALG_OPS.se_kernel is se_kernel.se_kernel_plain


def test_exact_gp_at_10k_on_card_matches_the_benchmark_reference(dev):
    """One loss+grad of the device engine in one block at n = 10,000 (the
    benchmark's exact-GP cell: m = 10,000, chol_inv_split six levels deep at
    batch 1, 64 K1 leaves) against the cell's float64 reference, within the
    cell's limits."""
    from gprf_torch.kernels.gpcov import GPCov
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.optim.lbfgs import value_and_grad
    from gprfbench import data as bdata
    from gprfbench import spec

    cell = spec.load_cell("fullgp10k.device_fit")
    cfg = cell.config
    problem = bdata.make_problem(cell, 2**31 + 2201, dev)
    X_obs = problem.x_obs(bdata.JOB, 0)
    cov = GPCov.create([cfg["signal_var"]], [cfg["lscale"]] * cfg["dx"], "euclidean", "se",
                       device="cpu", dtype=torch.float64)
    fused = FusedSyntheticGPRF(X_obs, problem.Y, problem.edges, X_obs, cfg["obs_std"], cov,
                               cfg["noise_var"], task="x", centers=problem.centers, device=dev,
                               dtype=torch.float32, acc_dtype=torch.float64)
    assert fused.n_blocks == 1 and fused.m == cfg["ntrain"]
    theta = torch.as_tensor(X_obs.reshape(-1), dtype=torch.float32, device=dev)
    mvn.reset_launch_counts()
    v, g = value_and_grad(fused.loss_fn(), theta)
    assert mvn.launch_counts["chol_inv"] == 64
    ref = problem.ref_loss(theta.double().cpu().numpy().reshape(-1, 2), X_obs, grad=True)
    loss_gap = abs(float(v) - ref.value) / abs(ref.value)
    grad_gap = float(torch.linalg.vector_norm(g.double() - ref.grad)) / ref.ll_grad_norm
    print("exact GP at 10k: loss_gap %.3e grad_gap %.3e" % (loss_gap, grad_gap))
    assert loss_gap <= cell.limits["loss_gap"] and grad_gap <= cell.limits["grad_gap"]
