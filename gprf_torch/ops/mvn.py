"""The five batched Cholesky kernels of the GPRF objective, with their plain
PyTorch twins and analytic backward passes.

    K1  chol_inv(K)                -> (L, W = L^-1)              csrc/chol_inv.cu
    K2  mvn_ll(Kp, Ym, n_act)      -> (ll [B], L)                csrc/mvn.cu
    K3  tri_inv(L)                 -> W = L^-1                   csrc/tri_inv.cu
    K4  mvn_ll_inv(Kp, Ym, n_act)  -> (ll [B], W, Z = L^-1 Ym)   csrc/mvn_inv.cu
    K5  cholesky(K)                -> L                          csrc/chol_inv.cu

K1-K3 carry the default route of the objective; K4 the MVN+inverse route
and K5 the unary-doubling route (:mod:`gprf_torch.model.objective`).

Each wrapper runs its hand-written CUDA kernel on a CUDA tensor and its
plain twin (``*_plain``) on a CPU tensor; any other input raises.  The
``autograd.Function``s (:class:`CholInv`, :class:`MvnLL`, :class:`TriInv`,
:class:`MvnLLInv`, :class:`Cholesky`) have one forward, through the
wrapper, and one analytic backward written as batched matrix products, the
pullbacks of the TPU kernels' custom VJPs (``gprf_tpu/ops/pallas_mvn.py``).
Their K-cotangents are symmetrized: K is always a symmetric function of the
inputs, so end-to-end gradients equal autodiff's.

:data:`KERNEL_OPS` (the Functions) and :data:`PLAIN_OPS` (the twins under
PyTorch's own autograd) let a caller run the same composition on either,
which is how the kernels are held against their twins on the card.
:data:`LINALG_OPS` is the float64 route of the card, which the kernels
refuse: ``torch.linalg`` (cuSOLVER on the card, LAPACK on the CPU), the
same arithmetic as the twins, but checked and never split.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gprf_torch.linalg.masked import cholesky_nan
from gprf_torch.ops import _build
from gprf_torch.utils.profiling import counter_group

LOG_2PI = math.log(2.0 * math.pi)

# Largest dynamic shared memory one CTA may use on the H100 (227 KB).
SMEM_BYTES = 232_448
_F32 = 4
# The kernels work in blocks of NB over m padded to a multiple of NB.
NB = 16
# The factor's static shared memory, in K1, K2, K4 and K5: one NB x NB block
# (D_k^T).
_FACTOR_STATIC_BYTES = NB * NB * _F32
# K2's and K4's static shared memory: the factor's and 8 per-warp partial sums.
_MVN_BLOCKED_STATIC_BYTES = _FACTOR_STATIC_BYTES + 8 * _F32
# K2 and K4 take dy <= 256.
MAX_DY_MVN = 256


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def chol_inv_smem_bytes(m: int) -> int:
    """K1's shared memory: K at the padded width mp (mp^2 floats), which
    becomes L and then, in place, W = L^-1, and the factor's static block;
    83,968 B at m = 136.  K5's too: it is K1 up to the store of L."""
    mp = _round_up(m, NB)
    return mp * mp * _F32 + _FACTOR_STATIC_BYTES


# Largest m whose K1 working set fits the CTA's shared memory: 240.
MAX_M_CHOL_INV = max(m for m in range(1, 512) if chol_inv_smem_bytes(m) <= SMEM_BYTES)
# K5 runs K1's factor on the same buffer, so it has K1's cap.
MAX_M_CHOL = MAX_M_CHOL_INV


def mvn_smem_bytes(m: int, dy: int) -> int:
    """K2's shared memory: K (and then L) at the padded width mp, mp^2
    floats, and Y (and then L^-1 Y) at mp x dyp, dy padded to a multiple
    of 4; 112,896 B of dynamic shared memory at m = 136, dy = 50.  K4's
    too: W = L^-1 overwrites L in place."""
    mp, dyp = _round_up(m, NB), _round_up(dy, 4)
    return (mp * mp + mp * dyp) * _F32 + _MVN_BLOCKED_STATIC_BYTES


def mvn_max_m(dy: int) -> int:
    """Largest m whose K2 (and K4) working set fits the CTA's shared
    memory; 208 at the flagship dy = 50."""
    m = int(math.isqrt(SMEM_BYTES // _F32))
    while mvn_smem_bytes(m, dy) > SMEM_BYTES:
        m -= 1
    return m


def tri_inv_smem_bytes(m: int) -> int:
    """K3's shared memory: W = L^-1 at the padded width mp (mp^2 floats)
    and two buffers of one 16-row panel of L (16 mp floats each)."""
    mp = _round_up(m, NB)
    return (mp * mp + 2 * NB * mp) * _F32


# Largest m whose K3 working set fits the CTA's shared memory: 224.
MAX_M_TRI_INV = max(m for m in range(1, 512) if tri_inv_smem_bytes(m) <= SMEM_BYTES)


def mvn_inv_supported(m: int, dy: int) -> bool:
    """Whether K4 takes (m, dy): K2's working set (:func:`mvn_smem_bytes`)
    fits the CTA's shared memory (m <= 208 at the flagship dy = 50) and
    dy <= 256.  The MVN leaves of
    :func:`gprf_torch.ops.split_mvn.mvn_ll_split` gate on it on every
    device, so the CPU and the card take the same route."""
    return dy <= MAX_DY_MVN and m <= mvn_max_m(dy)


# Kernel launches per wrapper since the last reset: the "launches" group of
# the port's counters (gprf_torch.utils.profiling).  Only a launch of the
# CUDA kernel counts; the twin never does.
launch_counts = counter_group("launches", ("chol_inv", "mvn_ll", "tri_inv", "mvn_ll_inv",
                                           "cholesky"))


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


def cholesky_plain(K):
    return cholesky_nan(K)


def _mvn_plain(Kp, Ym, n_active, factor=cholesky_nan):
    """(ll, L, Z = L^-1 Ym) by the library factorization."""
    dy = Ym.shape[-1]
    L = factor(Kp)
    z = torch.linalg.solve_triangular(L, Ym, upper=False)
    quad = torch.sum(z * z, dim=(-2, -1))
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    ll = -0.5 * quad - 0.5 * dy * logdet - 0.5 * dy * n_active.to(Kp.dtype) * LOG_2PI
    return ll, L, z


def mvn_ll_plain(Kp, Ym, n_active):
    ll, L, _ = _mvn_plain(Kp, Ym, n_active)
    return ll, L


def mvn_ll_inv_plain(Kp, Ym, n_active):
    ll, L, z = _mvn_plain(Kp, Ym, n_active)
    return ll, tri_inv_plain(L), z


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

    Replaces ``_chol_inv_kernel`` (gprf_tpu/ops/pallas_mvn.py).  Bound by
    the length of its dependency chain, not by FLOPs or bytes, so it runs
    K2's blocked factor (ceil(m/16) left-looking block columns, the diagonal
    block factored in registers) and then K3's blocked inverse (the
    diagonal blocks at once, then ceil(m/16) - 1 block rows) where it ran
    m rank-1 steps.  One CTA per matrix keeps one buffer in shared memory:
    L overwrites K, is stored, and W overwrites L in place, reading L's
    off-diagonal blocks from the transposes that the factor left above the
    diagonal.  Two CTAs share an SM at m = 136 (csrc/chol_inv.cu,
    csrc/blocked.cuh, :func:`chol_inv_smem_bytes`)."""
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

    Replaces ``_mvn_kernel`` (gprf_tpu/ops/pallas_mvn.py).  Bound by the
    length of its dependency chain, not by FLOPs or bytes, so it runs
    ceil(m/16) left-looking block columns instead of m rank-1 steps: one
    warp factors each 16 x 16 diagonal block in registers while the others
    update the panel and the right-hand sides, then all apply the block's
    inverse as register-tiled products.  K and Y are read once and only ll
    and L are written; two CTAs share an SM at m = 136, dy = 50
    (csrc/mvn.cu, :func:`mvn_smem_bytes`)."""
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

    Replaces ``_tri_inv_kernel`` (gprf_tpu/ops/pallas_mvn.py).  Bound by
    the length of its dependency chain, not by FLOPs or bytes, so it runs
    ceil(m/16) block rows instead of m substitution steps: the 16 x 16
    diagonal blocks are inverted at once in registers, then each block row
    is two register-tiled products, left-looking.  One CTA per matrix keeps
    W in shared memory and streams L in 16-row panels; two CTAs share an SM
    at m = 136 (csrc/tri_inv.cu, :func:`tri_inv_smem_bytes`)."""
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


def mvn_ll_inv(Kp, Ym, n_active):
    """K4: (ll [B], W = L^-1, Z = L^-1 Ym) for padded-masked Kp [B, m, m],
    zero-padded Ym [B, m, dy] and active counts [B], where (m, dy) pass
    :func:`mvn_inv_supported`.

    Replaces ``_mvn_inv_kernel`` (gprf_tpu/ops/pallas_mvn.py).  Bound by
    the length of its dependency chain, not by FLOPs or bytes, so it runs
    K2's blocked factor with the right-hand sides (ceil(m/16) left-looking
    block columns) and then K1's blocked inverse in place (the diagonal
    blocks at once, then ceil(m/16) - 1 block rows) where it ran m rank-1
    steps over two m x m buffers.  One pass over K gives ll and both
    residuals of the backward pass; L never leaves the SM, and W overwrites
    it in K2's working set, so two CTAs share an SM at m = 136, dy = 50
    (csrc/mvn_inv.cu, csrc/blocked.cuh, :func:`mvn_smem_bytes`)."""
    if _on_cpu(Kp, Ym, n_active):
        return mvn_ll_inv_plain(Kp, Ym, n_active)
    B, m = _square_batch("mvn_ll_inv", Kp)
    dy = Ym.shape[-1]
    _check("mvn_ll_inv", Kp, (B, m, m))
    _check("mvn_ll_inv", Ym, (B, m, dy))
    _check("mvn_ll_inv", n_active, (B,))
    if not mvn_inv_supported(m, dy):
        raise ValueError(f"mvn_ll_inv: (m={m}, dy={dy}) exceeds the kernel's shared memory "
                         "or dy cap; gate on mvn_inv_supported and use split_mvn.mvn_ll_split")
    ll = torch.empty((B,), dtype=Kp.dtype, device=Kp.device)
    W = torch.empty_like(Kp)
    Z = torch.empty_like(Ym)
    if B:
        with torch.cuda.device(Kp.device):
            _build.call("gprf_mvn_ll_inv", Kp.data_ptr(), Ym.data_ptr(), n_active.data_ptr(),
                        ll.data_ptr(), W.data_ptr(), Z.data_ptr(), B, m, dy, _stream(Kp))
        launch_counts["mvn_ll_inv"] += 1
    return ll, W, Z


def cholesky(K):
    """K5: lower Cholesky factor L of SPD [B, m, m], m <= 240.

    Replaces ``_chol_kernel`` (gprf_tpu/ops/pallas_mvn.py).  Bound by the
    length of its dependency chain, not by FLOPs or bytes, so it runs K1's
    blocked factor (ceil(m/16) left-looking block columns, the diagonal
    block factored in registers) where it ran m rank-1 steps, and stores
    L: K1's kernel up to that store, one CTA per matrix on one buffer, two
    CTAs an SM at m = 136 (csrc/chol_inv.cu, csrc/blocked.cuh,
    :func:`chol_inv_smem_bytes`).  Above its cap it raises, where the TPU
    pipeline falls back to XLA's Cholesky without a word; callers go
    through :func:`gprf_torch.ops.split_mvn.cholesky_split`, which keeps
    every leaf on the kernels."""
    if _on_cpu(K):
        return cholesky_plain(K)
    B, m = _square_batch("cholesky", K)
    _check("cholesky", K, (B, m, m))
    if m > MAX_M_CHOL:
        raise ValueError(f"cholesky: m={m} exceeds the kernel's cap {MAX_M_CHOL}")
    L = torch.empty_like(K)
    if B:
        with torch.cuda.device(K.device):
            _build.call("gprf_cholesky", K.data_ptr(), L.data_ptr(), B, m, _stream(K))
        launch_counts["cholesky"] += 1
    return L


# ---- autograd ----------------------------------------------------------------


def _sym(A):
    return 0.5 * (A + A.mT)


def _w_cotangent(W, dW):
    """d(L^-1) = -L^-1 dL L^-1  =>  dL = -W^T dW W^T (lower part used)."""
    return -(W.mT @ dW @ W.mT)


def _chol_pullback(L, W, dL):
    """The Cholesky pullback with K^-1 through W = L^-1:
    dK = sym(W^T sym(phi) W), phi = tril(L^T dL) - diag(L^T dL) / 2."""
    P = L.mT @ dL
    phi = torch.tril(P) - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
    return _sym(W.mT @ _sym(phi) @ W)


def _mvn_pullback(W, Z, g, needs_nact):
    """(dK, dY, d n_active) of the masked MVN from W = L^-1 and Z = L^-1 Y:
    alpha = W^T Z, dK = g/2 (alpha alpha^T - dy W^T W), dY = -g alpha."""
    dy = Z.shape[-1]
    alpha = W.mT @ Z
    gb = g[:, None, None]
    dK = gb * 0.5 * (alpha @ alpha.mT - dy * (W.mT @ W))
    d_nact = -0.5 * dy * LOG_2PI * g if needs_nact else None
    return dK, -gb * alpha, d_nact


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
        return _chol_pullback(L, W, torch.tril(dL + _w_cotangent(W, dW)))


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
        W = tri_inv_split(L)
        return _mvn_pullback(W, W @ Ym, g, ctx.needs_input_grad[2])


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


class MvnLLInv(torch.autograd.Function):
    """ll = K4(Kp, Ym, n_active), with the products-only pullback of
    ``_mvn_inv_bwd`` from the saved W and Z: no K3 in the backward."""

    @staticmethod
    def forward(ctx, Kp, Ym, n_active):
        ll, W, Z = mvn_ll_inv(Kp.contiguous(), Ym.contiguous(),
                              n_active.to(Kp.dtype).contiguous())
        ctx.save_for_backward(W, Z)
        return ll

    @staticmethod
    def backward(ctx, g):
        W, Z = ctx.saved_tensors
        return _mvn_pullback(W, Z, g, ctx.needs_input_grad[2])


class Cholesky(torch.autograd.Function):
    """L = K5(K), with the pullback of ``_chol_bwd``: W = L^-1 from K3
    (through ``tri_inv_split``), then the Cholesky pullback."""

    @staticmethod
    def forward(ctx, K):
        L = cholesky(K.contiguous())
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, dL):
        from gprf_torch.ops.split_mvn import tri_inv_split

        (L,) = ctx.saved_tensors
        return _chol_pullback(L, tri_inv_split(L), dL)


class Ops(NamedTuple):
    """The leaf primitives a composition runs on.  ``mvn_ll_inv`` and
    ``cholesky`` default to the kernels, so a caller may name only the first
    three.  ``leaf_caps``: whether the leaves have the kernels'
    shared-memory caps, so that :mod:`gprf_torch.ops.split_mvn` splits a
    wider block; leaves without caps take any width whole."""

    chol_inv: Callable  # K -> (L, W)
    mvn_ll: Callable  # (Kp, Ym, n_active) -> ll
    tri_inv: Callable  # L -> W
    mvn_ll_inv: Callable = MvnLLInv.apply  # (Kp, Ym, n_active) -> ll
    cholesky: Callable = Cholesky.apply  # K -> L
    leaf_caps: bool = True

    def map_leaves(self, fn):
        """These Ops with each leaf primitive ``f`` of field ``name``
        replaced by ``fn(name, f)`` (to count or record its calls)."""
        return self._replace(**{n: fn(n, getattr(self, n)) for n in self._fields
                                if n != "leaf_caps"})


KERNEL_OPS = Ops(
    chol_inv=CholInv.apply,
    mvn_ll=MvnLL.apply,
    tri_inv=TriInv.apply,
    mvn_ll_inv=MvnLLInv.apply,
    cholesky=Cholesky.apply,
)
PLAIN_OPS = Ops(
    chol_inv=chol_inv_plain,
    mvn_ll=lambda Kp, Ym, n_active: mvn_ll_plain(Kp, Ym, n_active)[0],
    tri_inv=tri_inv_plain,
    mvn_ll_inv=lambda Kp, Ym, n_active: mvn_ll_inv_plain(Kp, Ym, n_active)[0],
    cholesky=cholesky_plain,
)


# ---- float64 on the library ----------------------------------------------------


def cholesky_checked(K):
    """Lower Cholesky factor by ``torch.linalg.cholesky_ex``.  A finite
    block that is not positive definite raises: identity-padded rows factor
    exactly, so a padded block never does, and a float64 Schur complement
    of a noisy kernel matrix should not either.  A non-finite block gives a
    NaN factor, as the twins do, so that an optimizer rejects the point.
    One host sync a call, to read ``info``."""
    L, info = torch.linalg.cholesky_ex(K)
    failed = info != 0
    if bool((failed & torch.isfinite(K).flatten(-2).all(dim=-1)).any()):
        bad = torch.nonzero(failed.reshape(-1)).reshape(-1)[:8].tolist()
        raise torch.linalg.LinAlgError(
            f"cholesky_checked: {int(failed.sum())} finite blocks of {tuple(K.shape)} are not "
            f"positive definite (flat batch indices {bad}...)")
    m = K.shape[-1]
    lower = torch.ones((m, m), dtype=torch.bool, device=K.device).tril()
    return L.masked_fill(failed[..., None, None] & lower, float("nan"))


def _linalg_chol_inv(K):
    L = cholesky_checked(K)
    return L, tri_inv_plain(L)


# The float64 route of the card (the kernels refuse float64): the library's
# factorization under PyTorch's autograd, in whole blocks at any width.  The
# reference's float64 objective goes through XLA's Cholesky and triangular
# solve, not through its float32 Pallas kernels; the same holds here.
LINALG_OPS = Ops(
    chol_inv=_linalg_chol_inv,
    mvn_ll=lambda Kp, Ym, n_active: _mvn_plain(Kp, Ym, n_active, cholesky_checked)[0],
    tri_inv=tri_inv_plain,
    mvn_ll_inv=lambda Kp, Ym, n_active: _mvn_plain(Kp, Ym, n_active, cholesky_checked)[0],
    cholesky=cholesky_checked,
    leaf_caps=False,
)
