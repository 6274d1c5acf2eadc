"""The squared-exponential kernel matrices of the Schur objective as one
hand-written kernel, with its plain twin and its analytic backward.

    pair   (nv None):   K[r, n, a, b] = mi_a mj_b sv_r exp(-sum_d ((xi_ad - xj_bd) / l_rd)^2)
    block  (nv [R]):    pad_kernel_matrix(K(X, X) + nv_r I, mask), called with Xj = Xi, mj = mi

for points ``Xi, Xj [R, N, m, dx]``, masks ``mi, mj [R, N, m]`` (0 or 1, in
X's dtype) and each replica's hyperparameters ``sv [R]``, ``ls [R, k]``
(k = 1 or dx) and ``nv [R]``.  The scaled squared distance is
``sq_euclidean``'s broadcast-difference form (the points divided by the
lengthscales, then the difference), which it takes for dx < 16; so
:func:`serves` routes ``("euclidean", "se")`` at dx < 16 here and leaves
every other covariance on ``cross_kernel_matrix``.

The kernel (``csrc/se_kernel.cu``) replaces no TPU kernel: XLA fuses the
JAX package's broadcast chain into one loop, and this restores that fusion
on the card, where eager PyTorch wrote each step of the chain as a whole
tensor and kept them for the backward.  It writes K once and keeps nothing
for the backward but its inputs; the backward reads the cotangent G once,
recomputes each entry, and reduces to the points:

    w_ab = sv G_ab e_ab mi_a mj_b,     e_ab = exp(-r2_ab)
    dXi_a = -2 sum_b w_ab (u_a - v_b) / l,   dXj_b = 2 sum_a w_ab (u_a - v_b) / l
    d sv = sum w / sv,   d l_d = -(sum_a dXi_ad xi_ad + sum_b dXj_bd xj_bd) / l_d,
    d nv = sum_a G_aa mi_a (block mode)

with u = x / l.  G need not be symmetric (the objective's splits read only
K's lower blocks), so rows and columns are summed in full.  On the card the
sums over a tile are the kernel's and the sums of the tiles' partials a
second pass here, in a fixed order.

:func:`se_kernel` launches the kernel on CUDA float32 tensors (and raises on
any other CUDA input) and runs the twin on the CPU; :func:`se_kernel_plain`
runs the twin anywhere (``PLAIN_OPS`` and ``LINALG_OPS``, the float64
route of the card).  The twin's forward is the composition the objective ran
before the kernel; its backward is the closed form above in PyTorch.
"""

from __future__ import annotations

import torch

from gprf_torch.kernels.covfn import cross_kernel_matrix
from gprf_torch.kernels.distances import _QUADRATIC_EXPANSION_MIN_DIM, sq_euclidean
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.linalg.masked import pad_kernel_matrix
from gprf_torch.ops import _build
from gprf_torch.ops._build import launch_counts

# the kernel's tile (csrc/se_kernel.cu): the backward's partial sums come
# per column tile for the row points and per row tile for the column points
TILE_ROWS, TILE_COLS = 64, 128


def serves(dfn_str: str, wfn_str: str, dx: int) -> bool:
    """Whether the covariance is this module's: the SE profile over the
    scaled euclidean distance in its broadcast-difference form (dx < 16)."""
    return (dfn_str, wfn_str) == ("euclidean", "se") and dx < _QUADRATIC_EXPANSION_MIN_DIM


def _hyper(sv, ls):
    """sv and the lengthscales shaped to broadcast against [R, N, m, .]."""
    R = sv.shape[0]
    return sv.reshape(R, 1, 1, 1), ls.reshape(R, 1, 1, -1)


def se_matrix_plain(Xi, Xj, mi, mj, sv, ls, nv):
    """The twin's forward: the kernel matrices as the objective composed
    them from ``cross_kernel_matrix``, the masks and ``pad_kernel_matrix``."""
    svb, lsb = _hyper(sv, ls)
    K = cross_kernel_matrix(GPCov(wfn_params=svb, dfn_params=lsb), Xi, Xj)
    if nv is None:
        return K * (mi[..., :, None] * mj[..., None, :])
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return pad_kernel_matrix(K + nv.reshape(-1, 1, 1, 1) * eye, mi)


def _length_grad(dXi, Xi, dXj, Xj, ls):
    """d l from the points' gradients: -(sum dXi xi + sum dXj xj)_d / l_d,
    summed over d where one lengthscale serves every dimension."""
    t = torch.sum(dXi * Xi, dim=(1, 2)) + torch.sum(dXj * Xj, dim=(1, 2))  # [R, dx]
    if ls.shape[-1] == 1:
        t = torch.sum(t, dim=-1, keepdim=True)
    return -t / ls


def _noise_grad(G, mi):
    """d nv = sum_a G_aa mi_a, per replica."""
    return torch.sum(torch.diagonal(G, dim1=-2, dim2=-1) * mi, dim=(1, 2))


def _ls_nv_grads(G, dXi, Xi, dXj, Xj, mi, ls, nv, hyper):
    """(d ls, d nv) where ``hyper`` (sv's, ls's, nv's) asks for them."""
    return (_length_grad(dXi, Xi, dXj, Xj, ls) if hyper[1] else None,
            _noise_grad(G, mi) if hyper[2] and nv is not None else None)


def se_grads_plain(G, Xi, Xj, mi, mj, sv, ls, nv, hyper=(True, True, True)):
    """The twin's backward, in closed form: (dXi, dXj, d sv, d ls, d nv)
    under the cotangent G [R, N, m, m]; each of the last three only where
    ``hyper`` asks for it (and d nv only in block mode), else None."""
    svb, lsb = _hyper(sv, ls)
    U, V = Xi / lsb, Xj / lsb
    W0 = G * torch.exp(-sq_euclidean(Xi, Xj, lsb)) * (mi[..., :, None] * mj[..., None, :])
    W = svb * W0
    dU, dV = torch.empty_like(U), torch.empty_like(V)
    for d in range(U.shape[-1]):  # one [R, N, m, m] difference at a time
        WD = W * (U[..., :, None, d] - V[..., None, :, d])
        dU[..., d] = -2.0 * torch.sum(WD, dim=-1)
        dV[..., d] = 2.0 * torch.sum(WD, dim=-2)
    dXi, dXj = dU / lsb, dV / lsb
    dsv = torch.sum(W0, dim=(1, 2, 3)) if hyper[0] else None
    return (dXi, dXj, dsv) + _ls_nv_grads(G, dXi, Xi, dXj, Xj, mi, ls, nv, hyper)


def _operands(Xi, Xj, mi, mj, sv, ls, nv):
    """(R, N, m, dx, k) after checking the operands' shapes."""
    if Xi.dim() != 4 or Xj.shape != Xi.shape:
        raise ValueError(f"se_kernel: Xi and Xj must be [R, N, m, dx] alike, got "
                         f"{tuple(Xi.shape)} and {tuple(Xj.shape)}")
    R, N, m, dx = Xi.shape
    k = ls.shape[-1]
    if k not in (1, dx) or tuple(ls.shape) != (R, k) or tuple(sv.shape) != (R,):
        raise ValueError(f"se_kernel: expected sv [{R}] and ls [{R}, 1 or {dx}], got "
                         f"{tuple(sv.shape)} and {tuple(ls.shape)}")
    for name, t in (("mi", mi), ("mj", mj)):
        if tuple(t.shape) != (R, N, m):
            raise ValueError(f"se_kernel: {name} must be [{R}, {N}, {m}], got {tuple(t.shape)}")
    if nv is not None and tuple(nv.shape) != (R,):
        raise ValueError(f"se_kernel: nv must be [{R}], got {tuple(nv.shape)}")
    return R, N, m, dx, k


def _kernel_operands(Xi, Xj, mi, mj, sv, ls, nv):
    R, N, m, dx, k = _operands(Xi, Xj, mi, mj, sv, ls, nv)
    if not serves("euclidean", "se", dx):
        raise ValueError(f"se_kernel: the kernel takes dx < {_QUADRATIC_EXPANSION_MIN_DIM}, "
                         f"got {dx}")
    for name, t, shape in (("Xi", Xi, (R, N, m, dx)), ("Xj", Xj, (R, N, m, dx)),
                           ("mi", mi, (R, N, m)), ("mj", mj, (R, N, m)), ("sv", sv, (R,)),
                           ("ls", ls, (R, k))) + ((("nv", nv, (R,)),) if nv is not None else ()):
        _build.check(f"se_kernel {name}", t, shape)
    return R, N, m, dx, k


def se_matrix(Xi, Xj, mi, mj, sv, ls, nv):
    """K [R, N, m, m] by the kernel on one CUDA device (float32, contiguous
    operands), by the twin on the CPU."""
    tensors = (Xi, Xj, mi, mj, sv, ls) + ((nv,) if nv is not None else ())
    if _build.on_cpu(*tensors):
        _operands(Xi, Xj, mi, mj, sv, ls, nv)
        return se_matrix_plain(Xi, Xj, mi, mj, sv, ls, nv)
    R, N, m, dx, k = _kernel_operands(Xi, Xj, mi, mj, sv, ls, nv)
    K = torch.empty((R, N, m, m), dtype=Xi.dtype, device=Xi.device)
    if R * N and m:
        with torch.cuda.device(Xi.device):
            _build.call("gprf_se_kernel", Xi.data_ptr(), Xj.data_ptr(), mi.data_ptr(),
                        mj.data_ptr(), sv.data_ptr(), ls.data_ptr(),
                        None if nv is None else nv.data_ptr(), K.data_ptr(), R * N, N, m, dx,
                        k, _build.stream(Xi))
        launch_counts["se_kernel"] += 1
    return K


def se_grads(G, Xi, Xj, mi, mj, sv, ls, nv, hyper=(True, True, True)):
    """(dXi, dXj, d sv, d ls, d nv) by the backward kernel and one sum of
    its tiles' partials on one CUDA device, by the twin on the CPU
    (:func:`se_grads_plain`'s contract)."""
    tensors = (G, Xi, Xj, mi, mj, sv, ls) + ((nv,) if nv is not None else ())
    if _build.on_cpu(*tensors):
        return se_grads_plain(G, Xi, Xj, mi, mj, sv, ls, nv, hyper)
    R, N, m, dx, k = _kernel_operands(Xi, Xj, mi, mj, sv, ls, nv)
    _build.check("se_kernel G", G, (R, N, m, m))
    nrt, nct = -(-m // TILE_ROWS), -(-m // TILE_COLS)
    opts = dict(dtype=Xi.dtype, device=Xi.device)
    dxi = torch.empty((R, N, nct, m, dx), **opts)
    dxj = torch.empty((R, N, nrt, m, dx), **opts)
    dsv = torch.empty((R, N, nrt * nct), **opts)
    if R * N and m:
        with torch.cuda.device(Xi.device):
            _build.call("gprf_se_kernel_bwd", G.data_ptr(), Xi.data_ptr(), Xj.data_ptr(),
                        mi.data_ptr(), mj.data_ptr(), sv.data_ptr(), ls.data_ptr(),
                        dxi.data_ptr(), dxj.data_ptr(), dsv.data_ptr(), R * N, N, m, dx, k,
                        _build.stream(Xi))
        launch_counts["se_kernel_bwd"] += 1
    dXi, dXj = torch.sum(dxi, dim=2), torch.sum(dxj, dim=2)
    dsv = torch.sum(dsv, dim=(1, 2)) if hyper[0] else None
    return (dXi, dXj, dsv) + _ls_nv_grads(G, dXi, Xi, dXj, Xj, mi, ls, nv, hyper)


class SEKernel(torch.autograd.Function):
    """K = :func:`se_matrix`, or the twin where ``plain``, with the backward
    of :func:`se_grads` (or the twin's).  Saves only its inputs; each
    gradient is returned where ``needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, Xi, Xj, mi, mj, sv, ls, nv, plain):
        args = tuple(None if t is None else t.contiguous() for t in (Xi, Xj, mi, mj, sv, ls, nv))
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return (se_matrix_plain if plain else se_matrix)(*args)

    @staticmethod
    def backward(ctx, G):
        needs = ctx.needs_input_grad
        dXi, dXj, dsv, dls, dnv = (se_grads_plain if ctx.plain else se_grads)(
            G.contiguous(), *ctx.saved_tensors, hyper=needs[4:7])
        return (dXi if needs[0] else None, dXj if needs[1] else None, None, None,
                dsv, dls, dnv, None)


def se_kernel(Xi, Xj, mi, mj, sv, ls, nv=None):
    """The kernel matrices [R, N, m, m] (module docstring) on the kernel,
    with its backward kernel; the twin on CPU tensors."""
    return SEKernel.apply(Xi, Xj, mi, mj, sv, ls, nv, False)


def se_kernel_plain(Xi, Xj, mi, mj, sv, ls, nv=None):
    """The same on the twin, on any device and in any dtype."""
    return SEKernel.apply(Xi, Xj, mi, mj, sv, ls, nv, True)
