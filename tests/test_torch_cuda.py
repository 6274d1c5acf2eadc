"""The hand-written CUDA kernels of gprf_torch against their plain twins.

These need a CUDA device (marked ``gpu``) and skip elsewhere.  The machine
with the card has no JAX, so run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Kernels compute in float32; the references are the twins in float64 on the
same card.  The test matrices are A A^T + m I, so kappa(K) <= ~5 and the
float32 kernels agree with float64 to ~1e-5 relative.
"""

import numpy as np
import pytest
import torch

import gprf_torch  # noqa: F401  (precision pins)
from gprf_torch.ops import mvn
from gprf_torch.ops.split_mvn import chol_inv_split, mvn_ll_split, tri_inv_split

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

RTOL = 1e-4


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


@pytest.mark.parametrize("B,m", [(3, 37), (5, 136), (2, 168), (1, 1), (4, 65)])
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


@pytest.mark.parametrize("B,m", [(3, 37), (7, 136), (2, 168), (2, 3)])
def test_tri_inv_kernel(dev, B, m):
    rng = np.random.default_rng(m)
    L = torch.linalg.cholesky(torch.as_tensor(_spd(rng, B, m), device=dev))
    W = mvn.tri_inv(L.float().contiguous())
    torch.cuda.synchronize()
    _close(W, mvn.tri_inv_plain(L))


@pytest.mark.parametrize("B,m,dy", [(3, 37, 5), (9, 136, 50), (2, 216, 50), (4, 40, 1),
                                    (2, 240, 1), (3, 40, 200)])
def test_mvn_kernel(dev, B, m, dy):
    rng = np.random.default_rng(m + dy)
    n_active = rng.integers(m // 2, m + 1, size=B)
    K = torch.as_tensor(_spd(rng, B, m, n_active), device=dev)
    mask = torch.as_tensor(np.arange(m)[None, :] < n_active[:, None], device=dev)
    Y = torch.as_tensor(rng.normal(size=(B, m, dy)), device=dev) * mask[:, :, None]
    na = torch.as_tensor(n_active, dtype=torch.float64, device=dev)
    ll, L = mvn.mvn_ll(K.float(), Y.float(), na.float())
    torch.cuda.synchronize()
    ll_ref, L_ref = mvn.mvn_ll_plain(K, Y, na)
    _close(ll, ll_ref)
    _close(L, L_ref)


def test_empty_batch_launches_nothing(dev):
    K = torch.zeros(0, 8, 8, device=dev)
    mvn.reset_launch_counts()
    assert mvn.chol_inv(K)[0].shape == (0, 8, 8)
    assert mvn.tri_inv(K).shape == (0, 8, 8)
    assert mvn.mvn_ll(K, torch.zeros(0, 8, 3, device=dev), torch.zeros(0, device=dev))[0].shape == (0,)
    assert mvn.launch_counts == {"chol_inv": 0, "mvn_ll": 0, "tri_inv": 0}


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

    grads = []
    for ops, dt in ((mvn.KERNEL_OPS, torch.float32), (mvn.PLAIN_OPS, torch.float64)):
        a = A.to(dt).requires_grad_(True)
        y = Y.to(dt).requires_grad_(True)
        grads.append(torch.autograd.grad(f(a, y, ops), (a, y)))
    for g_k, g_p in zip(*grads):
        _close(g_k, g_p, rtol=1e-3)


def test_split_on_card_matches_twin(dev):
    rng = np.random.default_rng(2)
    B, m, dy = 3, 200, 50  # forces chol/tri splits at the 168 leaf cap
    K = torch.as_tensor(_spd(rng, B, m), device=dev)
    Y = torch.as_tensor(rng.normal(size=(B, m, dy)), device=dev)
    na = torch.full((B,), float(m), device=dev, dtype=torch.float64)
    L, W = chol_inv_split(K.float())
    _close(L, mvn.chol_inv_plain(K)[0])
    _close(tri_inv_split(L), W)
    _close(mvn_ll_split(K.float(), Y.float(), na.float(), leaf_mvn=96),
           mvn.mvn_ll_plain(K, Y, na)[0])


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    K = torch.eye(8, device=dev).expand(2, 8, 8).contiguous()
    with pytest.raises(TypeError):
        mvn.chol_inv(K.double())
    with pytest.raises(ValueError):
        mvn.tri_inv(K.mT)  # not contiguous
    with pytest.raises(ValueError):
        mvn.chol_inv(torch.eye(170, device=dev)[None])
    with pytest.raises(ValueError):
        mvn.mvn_ll(K, torch.zeros(2, 8, 3, device=dev), torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        mvn.mvn_ll(K, torch.zeros(2, 8, 257, device=dev), torch.zeros(2, device=dev))
