"""The second-moment ("kernelized") observation objective (mirror of
``gprf_tpu/model/kernelized.py``).

Each block observes the second-moment matrix ``YY = Y Y^T`` in place of
the features Y, and its Gaussian term is

    ll = -1/2 tr(K^-1 YYb) - dy/2 logdet K - dy n_active/2 log 2 pi,

``YYb = YY[idx][:, idx]`` masked on both sides.  Unary blocks [B, m] and
stacked pairs [E, 2m] (the layout's joint-form arrays) each make one term,
weighted as in the joint form.

The reference factors every term with XLA's Cholesky.  Here each goes
through the leaf primitives ``ops``: ``(L, W) = chol_inv_split(Kp)``, then
``tr(K^-1 YYb) = sum((W @ YYb) * W)`` and ``logdet = 2 sum(log diag L)``.
On the card in float32 that is K1 (a unary term at m = 136 is one leaf;
a pair at 2m = 272, past K1's cap of 240, splits into leaves of 136 and
cuBLAS glue), and the gradients flow through ``CholInv``'s pullback, which
launches no kernel.  ``PLAIN_OPS`` runs the twins, ``LINALG_OPS`` float64
on ``torch.linalg``.
"""

from __future__ import annotations

import math

import torch

from gprf_torch.kernels.covfn import cross_kernel_matrix
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.linalg.masked import pad_kernel_matrix
from gprf_torch.model.objective import GPRFParams, _value_and_grad
from gprf_torch.ops.mvn import KERNEL_OPS, Ops
from gprf_torch.ops.split_mvn import chol_inv_split

_LOG_2PI = math.log(2.0 * math.pi)


def kernelized_terms(X, YY, assignment, mask, cov: GPCov, noise_var, dy: int,
                     ops: Ops = KERNEL_OPS):
    """The terms [N] of the gathers ``assignment``/``mask`` [N, w]."""
    idx = assignment.long()
    maskf = mask.to(X.dtype)
    YYb = YY[idx[:, :, None], idx[:, None, :]] * (maskf[:, :, None] * maskf[:, None, :])
    # index_select, not X[idx]: its backward is an index_add, where advanced
    # indexing's sort-based one took 4.8 of 14.0 device ms of a flagship
    # loss+grad on the H100
    Xb = X.index_select(0, idx.reshape(-1)).reshape(*idx.shape, X.shape[-1])
    K = cross_kernel_matrix(cov, Xb, Xb)
    K = K + noise_var * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    L, W = chol_inv_split(pad_kernel_matrix(K, mask), ops=ops)
    trace = torch.sum((W @ YYb) * W, dim=(-2, -1))
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    n_active = torch.sum(maskf, dim=-1)
    return -0.5 * trace - 0.5 * dy * logdet - 0.5 * dy * n_active * _LOG_2PI


def kernelized_ll(params: GPRFParams, YY, assignment, mask, pair_assignment, pair_mask,
                  unary_weights, pair_weights, dy: int, dfn_str: str = "euclidean",
                  wfn_str: str = "se", ops: Ops = KERNEL_OPS):
    """The scalar kernelized objective: weighted unary and pair terms."""
    cov = GPCov(wfn_params=params.wfn_params, dfn_params=params.dfn_params,
                dfn_str=dfn_str, wfn_str=wfn_str)

    def terms(a, m):
        return kernelized_terms(params.X, YY, a, m, cov, params.noise_var, dy, ops)

    ll = torch.sum(unary_weights * terms(assignment, mask))
    if pair_assignment.shape[0] > 0:
        ll = ll + torch.sum(pair_weights * terms(pair_assignment, pair_mask))
    return ll


def kernelized_value_and_grad(params: GPRFParams, YY, assignment, mask, pair_assignment,
                              pair_mask, unary_weights, pair_weights, dy: int,
                              dfn_str: str = "euclidean", wfn_str: str = "se",
                              grad_X: bool = True, grad_cov: bool = False,
                              ops: Ops = KERNEL_OPS):
    """(ll, gradX [n, dx], gradCov [1, 2 + k]) of :func:`kernelized_ll` by
    autograd, gradCov's row laid out [nv, sv, lengthscales]."""
    return _value_and_grad(
        lambda p: kernelized_ll(p, YY, assignment, mask, pair_assignment, pair_mask,
                                unary_weights, pair_weights, dy, dfn_str=dfn_str,
                                wfn_str=wfn_str, ops=ops),
        params, grad_X, grad_cov)
