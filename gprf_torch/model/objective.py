"""The GPRF objective in the Schur-complement pair form (mirror of
``gprf_tpu/model/objective.py``, its inverse-factor kernel formulation).

    ll = sum_{(i,j) in E} log N(Y_ij | 0, K(X_ij)) + sum_i (1 - |E_i|) log N(Y_i | 0, K(X_i))

Each pair factors through the unary factor of its i-side block,

    chol([[Kii, Kij], [Kji, Kjj]]) = [[L_i, 0], [B^T, chol(S)]],
    B = W_i Kij,  S = Kjj - B^T B,  W_i = L_i^-1,

so the unary pass runs K1 (chol_inv) over all blocks, and the pair pass
runs K2 (mvn_ll) over every Schur complement, both through the split
compositions of :mod:`gprf_torch.ops.split_mvn`.  Every "solve" is then a
batched matrix product with the explicit inverse factor, which the noise
jitter keeps well conditioned.  Gradients with respect to X, the kernel
hyperparameters and the noise variance come from autograd through the
kernels' analytic backward passes.

All float32 products run at full precision (``gprf_torch`` pins TF32
off): the Schur complement must stay numerically positive definite.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gprf_torch.kernels.covfn import cross_kernel_matrix
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.linalg.masked import pad_kernel_matrix
from gprf_torch.ops.mvn import KERNEL_OPS, Ops
from gprf_torch.ops.split_mvn import chol_inv_split, mvn_ll_split

_LOG_2PI = math.log(2.0 * math.pi)


class GPRFParams(NamedTuple):
    """Differentiable parameters of the objective."""

    X: torch.Tensor  # [n, dx] latent input locations
    wfn_params: torch.Tensor  # [1] signal variance
    dfn_params: torch.Tensor  # [k] lengthscales
    noise_var: torch.Tensor  # [] observation noise variance


def _schur_ll(X, Y, assignment, mask, edges, unary_weights, pair_weights,
              cov: GPCov, noise_var, acc_dtype=None, ops: Ops = KERNEL_OPS):
    """GPRF log-likelihood with the pair terms factored through the unary
    inverse factors.  ``acc_dtype`` (default: X's dtype) accumulates the
    scalar tails: the per-block quadratic forms, log-determinants and the
    weighted block sums."""
    dtype = X.dtype
    acc = dtype if acc_dtype is None else acc_dtype
    dy = Y.shape[-1]
    m = assignment.shape[1]
    assignment = assignment.long()
    maskf = mask.to(dtype)
    eye = torch.eye(m, dtype=dtype, device=X.device)

    # ---- unary pass: K1 over every block
    # index_select, not X[assignment]: its backward is an index_add, where
    # advanced indexing's is a sort-based index_put that took ~0.6 ms of a
    # flagship evaluation on the H100 (it sums in another order, so the X
    # gradient on the card varies in the last bits from run to run)
    Xb = X.index_select(0, assignment.reshape(-1)).reshape(*assignment.shape, X.shape[-1])
    Kp = pad_kernel_matrix(cross_kernel_matrix(cov, Xb, Xb) + noise_var * eye, mask)
    Ym = Y[assignment] * maskf[:, :, None]
    Ls, Ws = chol_inv_split(Kp, ops=ops)
    Zs = Ws @ Ym
    quads = torch.sum((Zs * Zs).to(acc), dim=(1, 2))
    logdets = 2.0 * torch.sum(torch.log(torch.diagonal(Ls, dim1=1, dim2=2)).to(acc), dim=1)
    nbs = torch.sum(maskf.to(acc), dim=1)
    unary_ll = -0.5 * quads - 0.5 * dy * logdets - 0.5 * dy * nbs * _LOG_2PI
    total = torch.sum(unary_weights.to(acc) * unary_ll)
    if edges.shape[0] == 0:
        return total

    # ---- pair pass: K2 over every Schur complement against the i-side factor
    ei = edges[:, 0].long()
    ej = edges[:, 1].long()
    Kij = cross_kernel_matrix(cov, Xb[ei], Xb[ej])
    Kij = Kij * (maskf[ei][:, :, None] * maskf[ej][:, None, :])
    Bm = Ws[ei] @ Kij
    # padded rows of Kp[ej] are identity and the matching Bm columns are
    # zero, so S stays padded-masked
    S = Kp[ej] - Bm.mT @ Bm
    rhs = Ym[ej] - Bm.mT @ Zs[ei]
    nbj = torch.sum(maskf[ej], dim=1)
    pair_ll = unary_ll[ei] + mvn_ll_split(S, rhs, nbj, ops=ops).to(acc)
    return total + torch.sum(pair_weights.to(acc) * pair_ll)


def gprf_ll_schur(params: GPRFParams, Y, assignment, mask, edges, unary_weights,
                  pair_weights, dfn_str: str = "euclidean", wfn_str: str = "se",
                  acc_dtype=None, ops: Ops = KERNEL_OPS):
    """Scalar GPRF log-likelihood via the Schur-complement pair form.

    ``assignment``/``mask`` are the padded [B, m] block layout, ``edges``
    the [E, 2] block pairs, and the weights the per-term combination
    weights (1 - |E_i| for blocks, 1 for pairs)."""
    cov = GPCov(wfn_params=params.wfn_params, dfn_params=params.dfn_params,
                dfn_str=dfn_str, wfn_str=wfn_str)
    return _schur_ll(params.X, Y, assignment, mask, edges, unary_weights, pair_weights,
                     cov, params.noise_var, acc_dtype=acc_dtype, ops=ops)
