"""The three batched Cholesky kernels of the GPRF hot loop, with their plain
PyTorch twins and analytic backward passes.

    K1  chol_inv(K)            -> (L, W = L^-1)      csrc/chol_inv.cu
    K2  mvn_ll(Kp, Ym, n_act)  -> (ll [B], L)        csrc/mvn.cu
    K3  tri_inv(L)             -> W = L^-1           csrc/tri_inv.cu

Each wrapper runs its hand-written CUDA kernel on a CUDA tensor and its
plain twin (``*_plain``) on a CPU tensor; any other input raises.  The
``autograd.Function``s (:class:`CholInv`, :class:`MvnLL`, :class:`TriInv`)
have one forward, through the wrapper, and one analytic backward written
as batched matrix products, the pullbacks of the TPU kernels' custom VJPs
(``gprf_tpu/ops/pallas_mvn.py``).  Their K-cotangents are symmetrized: K is
always a symmetric function of the inputs, so end-to-end gradients equal
autodiff's.

:data:`KERNEL_OPS` (the Functions) and :data:`PLAIN_OPS` (the twins under
PyTorch's own autograd) let a caller run the same composition on either,
which is how the kernels are held against their twins on the card.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gprf_torch.linalg.masked import cholesky_nan
from gprf_torch.ops import _build

LOG_2PI = math.log(2.0 * math.pi)

# Largest dynamic shared memory one CTA may use on the H100 (227 KB).
SMEM_BYTES = 232_448
_F32 = 4
# K1 holds K, the running inverse and one column: (2 m^2 + m) floats.
MAX_M_CHOL_INV = 168
# K3 holds L and the running inverse: 2 m^2 floats.
MAX_M_TRI_INV = 168
# K2's static shared memory (per-warp partial sums of the quadratic form).
_MVN_STATIC_BYTES = 16 * _F32
# K2 keeps each lane's slice of a row of Y in registers: dy <= 8 * 32.
MAX_DY_MVN = 256


def mvn_smem_bytes(m: int, dy: int) -> int:
    """K2's shared memory: K, Y and one column of L."""
    return (m * m + m * dy + m) * _F32 + _MVN_STATIC_BYTES


def mvn_max_m(dy: int) -> int:
    """Largest m whose K2 working set fits the CTA's shared memory; 216 at
    the flagship dy = 50."""
    m = int(math.isqrt(SMEM_BYTES // _F32))
    while mvn_smem_bytes(m, dy) > SMEM_BYTES:
        m -= 1
    return m


# Kernel launches per wrapper since the last reset.  Only a launch of the
# CUDA kernel counts; the twin never does.
launch_counts = {"chol_inv": 0, "mvn_ll": 0, "tri_inv": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---- plain twins -----------------------------------------------------------


def _eye_like(A):
    m = A.shape[-1]
    return torch.eye(m, dtype=A.dtype, device=A.device).expand(A.shape)


def tri_inv_plain(L):
    return torch.linalg.solve_triangular(L, _eye_like(L), upper=False)


def chol_inv_plain(K):
    L = cholesky_nan(K)
    return L, tri_inv_plain(L)


def mvn_ll_plain(Kp, Ym, n_active):
    dy = Ym.shape[-1]
    L = cholesky_nan(Kp)
    z = torch.linalg.solve_triangular(L, Ym, upper=False)
    quad = torch.sum(z * z, dim=(-2, -1))
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    ll = -0.5 * quad - 0.5 * dy * logdet - 0.5 * dy * n_active.to(Kp.dtype) * LOG_2PI
    return ll, L


# ---- kernel wrappers ---------------------------------------------------------


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"inputs must all be on the CPU or on one CUDA device, got {devs}")
    return False


def _check(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")


def _square_batch(name, A):
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name}: expected [B, m, m], got {tuple(A.shape)}")
    return A.shape[0], A.shape[1]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def chol_inv(K):
    """K1: (L, W) with L = chol(K) lower and W = L^-1, for SPD [B, m, m].

    Replaces ``_chol_inv_kernel`` (gprf_tpu/ops/pallas_mvn.py).  On the
    H100 it is bound by the m sequential steps of the factorization, each
    paced by the warps' chains of shared-memory accesses to their rows; one
    CTA per matrix keeps K and the inverse on-chip for the whole k-loop and
    folds the substitution for W into it (csrc/chol_inv.cu)."""
    if _on_cpu(K):
        return chol_inv_plain(K)
    B, m = _square_batch("chol_inv", K)
    _check("chol_inv", K, (B, m, m))
    if m > MAX_M_CHOL_INV:
        raise ValueError(f"chol_inv: m={m} exceeds the kernel's cap {MAX_M_CHOL_INV}; "
                         "use split_mvn.chol_inv_split")
    L = torch.empty_like(K)
    W = torch.empty_like(K)
    if B:
        with torch.cuda.device(K.device):
            _build.call("gprf_chol_inv", K.data_ptr(), L.data_ptr(), W.data_ptr(), B, m,
                        _stream(K))
        launch_counts["chol_inv"] += 1
    return L, W


def mvn_ll(Kp, Ym, n_active):
    """K2: (ll [B], L) for padded-masked Kp [B, m, m], zero-padded Ym
    [B, m, dy] and active counts [B].

    Replaces ``_mvn_kernel`` (gprf_tpu/ops/pallas_mvn.py).  Bound, like K1,
    by m sequential steps of shared-memory row updates; the substitution of
    the dy right-hand sides, the log-determinant and the quadratic form
    share the factorization's k-loop, so K and Y are read once and only ll
    and L are written (csrc/mvn.cu)."""
    if _on_cpu(Kp, Ym, n_active):
        return mvn_ll_plain(Kp, Ym, n_active)
    B, m = _square_batch("mvn_ll", Kp)
    dy = Ym.shape[-1]
    _check("mvn_ll", Kp, (B, m, m))
    _check("mvn_ll", Ym, (B, m, dy))
    _check("mvn_ll", n_active, (B,))
    if dy > MAX_DY_MVN:
        raise ValueError(f"mvn_ll: dy={dy} exceeds the kernel's cap {MAX_DY_MVN}")
    cap = mvn_max_m(dy)
    if m > cap:
        raise ValueError(f"mvn_ll: m={m} exceeds the kernel's cap {cap} at dy={dy}; "
                         "use split_mvn.mvn_ll_split")
    ll = torch.empty((B,), dtype=Kp.dtype, device=Kp.device)
    L = torch.empty_like(Kp)
    if B:
        with torch.cuda.device(Kp.device):
            _build.call("gprf_mvn_ll", Kp.data_ptr(), Ym.data_ptr(), n_active.data_ptr(),
                        ll.data_ptr(), L.data_ptr(), B, m, dy, _stream(Kp))
        launch_counts["mvn_ll"] += 1
    return ll, L


def tri_inv(L):
    """K3: W = L^-1 for lower-triangular [B, m, m] (upper triangle ignored).

    Replaces ``_tri_inv_kernel`` (gprf_tpu/ops/pallas_mvn.py).  Bound, like
    K1, by m sequential substitution steps of shared-memory row updates;
    one CTA per matrix keeps L and the inverse on-chip (csrc/tri_inv.cu)."""
    if _on_cpu(L):
        return tri_inv_plain(L)
    B, m = _square_batch("tri_inv", L)
    _check("tri_inv", L, (B, m, m))
    if m > MAX_M_TRI_INV:
        raise ValueError(f"tri_inv: m={m} exceeds the kernel's cap {MAX_M_TRI_INV}; "
                         "use split_mvn.tri_inv_split")
    W = torch.empty_like(L)
    if B:
        with torch.cuda.device(L.device):
            _build.call("gprf_tri_inv", L.data_ptr(), W.data_ptr(), B, m, _stream(L))
        launch_counts["tri_inv"] += 1
    return W


# ---- autograd ----------------------------------------------------------------


def _sym(A):
    return 0.5 * (A + A.mT)


def _w_cotangent(W, dW):
    """d(L^-1) = -L^-1 dL L^-1  =>  dL = -W^T dW W^T (lower part used)."""
    return -(W.mT @ dW @ W.mT)


class CholInv(torch.autograd.Function):
    """(L, W) = K1(K), with the einsum-only pullback of ``_chol_inv_bwd``:
    dL += -tril(W^T dW W^T), then dK = sym(W^T phi(L^T dL) W)."""

    @staticmethod
    def forward(ctx, K):
        L, W = chol_inv(K.contiguous())
        ctx.save_for_backward(L, W)
        return L, W

    @staticmethod
    def backward(ctx, dL, dW):
        L, W = ctx.saved_tensors
        dLt = torch.tril(dL + _w_cotangent(W, dW))
        P = L.mT @ dLt
        phi = torch.tril(P) - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
        return _sym(W.mT @ _sym(phi) @ W)


class MvnLL(torch.autograd.Function):
    """ll = K2(Kp, Ym, n_active), with the pullback of ``_mvn_bwd``:
    dK = g/2 (alpha alpha^T - dy K^-1), dY = -g alpha, where K^-1 = W^T W
    and alpha = W^T W Y come from W = L^-1 by the K3 kernel."""

    @staticmethod
    def forward(ctx, Kp, Ym, n_active):
        Ym = Ym.contiguous()
        ll, L = mvn_ll(Kp.contiguous(), Ym, n_active.to(Kp.dtype).contiguous())
        ctx.save_for_backward(L, Ym)
        return ll

    @staticmethod
    def backward(ctx, g):
        from gprf_torch.ops.split_mvn import tri_inv_split

        L, Ym = ctx.saved_tensors
        dy = Ym.shape[-1]
        W = tri_inv_split(L)
        alpha = W.mT @ (W @ Ym)
        gb = g[:, None, None]
        dK = gb * 0.5 * (alpha @ alpha.mT - dy * (W.mT @ W))
        d_nact = -0.5 * dy * LOG_2PI * g if ctx.needs_input_grad[2] else None
        return dK, -gb * alpha, d_nact


class TriInv(torch.autograd.Function):
    """W = K3(L), with the pullback of ``_tri_inv_bwd``: dL = -tril(W^T dW W^T)."""

    @staticmethod
    def forward(ctx, L):
        W = tri_inv(L.contiguous())
        ctx.save_for_backward(W)
        return W

    @staticmethod
    def backward(ctx, dW):
        (W,) = ctx.saved_tensors
        return torch.tril(_w_cotangent(W, dW))


class Ops(NamedTuple):
    """The three leaf primitives a composition runs on."""

    chol_inv: Callable  # K -> (L, W)
    mvn_ll: Callable  # (Kp, Ym, n_active) -> ll
    tri_inv: Callable  # L -> W


KERNEL_OPS = Ops(
    chol_inv=CholInv.apply,
    mvn_ll=MvnLL.apply,
    tri_inv=TriInv.apply,
)
PLAIN_OPS = Ops(
    chol_inv=chol_inv_plain,
    mvn_ll=lambda Kp, Ym, n_active: mvn_ll_plain(Kp, Ym, n_active)[0],
    tri_inv=tri_inv_plain,
)
