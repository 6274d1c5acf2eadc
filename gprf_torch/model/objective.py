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
jitter keeps well conditioned.

Two routes of the reference run other kernels; each is an explicit option
(the reference reads them from the environment):

- ``mvn_inv`` (``GPRF_MVN_INV``): every MVN leaf that K4 takes runs
  mvn_ll_inv, which also returns W = L^-1 and L^-1 Y, so the pair
  backward is products only and launches no K3.
- ``unary_doubling`` (``GPRF_UNARY_DOUBLING``): the unary factors come from
  K5 (cholesky; above its cap m = 240 through the split of
  :func:`gprf_torch.ops.split_mvn.cholesky_split`, where the reference
  falls back to XLA's Cholesky) and their inverses from the
  recursive-doubling :func:`gprf_torch.linalg.doubling.batched_tri_inv_doubling`.

Gradients with respect to X, the kernel hyperparameters and the noise
variance come from autograd through the kernels' analytic backward passes.

All float32 products run at full precision (``gprf_torch`` pins TF32
off): the Schur complement must stay numerically positive definite.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gprf_torch.kernels.covfn import cross_kernel_matrix
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.linalg.doubling import batched_tri_inv_doubling
from gprf_torch.linalg.masked import pad_kernel_matrix
from gprf_torch.ops.mvn import KERNEL_OPS, Ops
from gprf_torch.ops.split_mvn import chol_inv_split, cholesky_split, mvn_ll_split

_LOG_2PI = math.log(2.0 * math.pi)


class GPRFParams(NamedTuple):
    """Differentiable parameters of the objective."""

    X: torch.Tensor  # [n, dx] latent input locations
    wfn_params: torch.Tensor  # [1] signal variance
    dfn_params: torch.Tensor  # [k] lengthscales
    noise_var: torch.Tensor  # [] observation noise variance


def _schur_ll(X, Y, assignment, mask, edges, unary_weights, pair_weights,
              cov: GPCov, noise_var, acc_dtype=None, ops: Ops = KERNEL_OPS,
              mvn_inv: bool = False, unary_doubling: bool = False):
    """GPRF log-likelihood [R] of R replicas, with the pair terms factored
    through the unary inverse factors.

    Each replica has its own points ``X [R, n, dx]``, layout ``assignment``
    and ``mask [R, B, m]`` and hyperparameters (``cov``'s ``wfn_params
    [R, 1]``, ``dfn_params [R, k]``, ``noise_var [R]``); Y, the edges and
    the weights are shared.  The replicas are folded into the kernels'
    batch: K1 runs once on [R B, m, m], K2 (and K3 in its backward) once on
    [R E, m, m], and the terms are summed back per replica.

    ``acc_dtype`` (default: X's dtype) accumulates the scalar tails: the
    per-block quadratic forms, log-determinants and the weighted block
    sums.  ``mvn_inv`` and ``unary_doubling`` pick the routes of the module
    docstring."""
    dtype = X.dtype
    acc = dtype if acc_dtype is None else acc_dtype
    R, B, m = assignment.shape
    dy = Y.shape[-1]
    maskf = mask.to(dtype)
    eye = torch.eye(m, dtype=dtype, device=X.device)
    # hyperparameters broadcast against the [R, B, m, .] block tensors
    cov = GPCov(wfn_params=cov.wfn_params.reshape(R, 1, 1, 1),
                dfn_params=cov.dfn_params.reshape(R, 1, 1, -1),
                dfn_str=cov.dfn_str, wfn_str=cov.wfn_str)
    noise_var = noise_var.reshape(R, 1, 1, 1)

    # ---- unary pass: K1 over every block (K5 + doubling on that route)
    # index_select, not X[assignment]: its backward is an index_add, where
    # advanced indexing's is a sort-based index_put that took ~0.6 ms of a
    # flagship evaluation on the H100 (it sums in another order, so the X
    # gradient on the card varies in the last bits from run to run)
    n = X.shape[1]
    flat = assignment.long()
    if R > 1:  # replica r's points sit at rows r n .. r n + n - 1 of the flat X
        flat = flat + torch.arange(R, device=X.device).reshape(R, 1, 1) * n
    Xb = X.reshape(R * n, -1).index_select(0, flat.reshape(-1)).reshape(R, B, m, X.shape[-1])
    Kp = pad_kernel_matrix(cross_kernel_matrix(cov, Xb, Xb) + noise_var * eye, mask)
    Ym = Y[assignment.long()] * maskf[..., None]
    if unary_doubling:
        Ls = cholesky_split(Kp.reshape(R * B, m, m), ops=ops)
        Ws = batched_tri_inv_doubling(Ls)
    else:
        Ls, Ws = chol_inv_split(Kp.reshape(R * B, m, m), ops=ops)
    Ls, Ws = Ls.reshape(R, B, m, m), Ws.reshape(R, B, m, m)
    Zs = Ws @ Ym
    quads = torch.sum((Zs * Zs).to(acc), dim=(-2, -1))
    logdets = 2.0 * torch.sum(torch.log(torch.diagonal(Ls, dim1=-2, dim2=-1)).to(acc), dim=-1)
    nbs = torch.sum(maskf.to(acc), dim=-1)
    unary_ll = -0.5 * quads - 0.5 * dy * logdets - 0.5 * dy * nbs * _LOG_2PI  # [R, B]
    total = torch.sum(unary_weights.to(acc) * unary_ll, dim=-1)
    E = edges.shape[0]
    if E == 0:
        return total

    # ---- pair pass: K2 (or K4) over every Schur complement against the i-side factor
    ei = edges[:, 0].long()
    ej = edges[:, 1].long()
    Kij = cross_kernel_matrix(cov, Xb[:, ei], Xb[:, ej])
    Kij = Kij * (maskf[:, ei][..., :, None] * maskf[:, ej][..., None, :])
    Bm = Ws[:, ei] @ Kij
    # padded rows of Kp[ej] are identity and the matching Bm columns are
    # zero, so S stays padded-masked
    S = Kp[:, ej] - Bm.mT @ Bm
    rhs = Ym[:, ej] - Bm.mT @ Zs[:, ei]
    nbj = torch.sum(maskf[:, ej], dim=-1)
    pair_mvn = mvn_ll_split(S.reshape(R * E, m, m), rhs.reshape(R * E, m, dy),
                            nbj.reshape(R * E), ops=ops, mvn_inv=mvn_inv)
    pair_ll = unary_ll[:, ei] + pair_mvn.reshape(R, E).to(acc)
    return total + torch.sum(pair_weights.to(acc) * pair_ll, dim=-1)


def gprf_ll_schur(params: GPRFParams, Y, assignment, mask, edges, unary_weights,
                  pair_weights, dfn_str: str = "euclidean", wfn_str: str = "se",
                  acc_dtype=None, ops: Ops = KERNEL_OPS, mvn_inv: bool = False,
                  unary_doubling: bool = False):
    """GPRF log-likelihood via the Schur-complement pair form.

    ``assignment``/``mask`` are the padded [B, m] block layout, ``edges``
    the [E, 2] block pairs, and the weights the per-term combination
    weights (1 - |E_i| for blocks, 1 for pairs).  A scalar, or [R] for R
    replicas: then ``params.X`` is [R, n, dx], the layout [R, B, m] and the
    hyperparameters carry a leading R (:func:`_schur_ll`).  ``mvn_inv`` and
    ``unary_doubling`` pick a route (module docstring); both default off."""
    batched = params.X.dim() == 3
    cov = GPCov(wfn_params=params.wfn_params, dfn_params=params.dfn_params,
                dfn_str=dfn_str, wfn_str=wfn_str)
    X = params.X if batched else params.X[None]
    ll = _schur_ll(X, Y, assignment if batched else assignment[None],
                   mask if batched else mask[None], edges, unary_weights, pair_weights,
                   cov, params.noise_var, acc_dtype=acc_dtype, ops=ops, mvn_inv=mvn_inv,
                   unary_doubling=unary_doubling)
    return ll if batched else ll[0]


def gprf_value_and_grad_schur(params: GPRFParams, Y, assignment, mask, edges, unary_weights,
                              pair_weights, dfn_str: str = "euclidean", wfn_str: str = "se",
                              grad_X: bool = True, grad_cov: bool = False, acc_dtype=None,
                              ops: Ops = KERNEL_OPS):
    """(ll, gradX [n, dx], gradCov [1, 2 + k]) by autograd over
    :func:`gprf_ll_schur`, the contract of ``GPRF.llgrad``.

    gradCov's row is [d/d noise_var, d/d signal_var, d/d lengthscales].  A
    gradient that is not asked for comes back as zeros of its shape."""
    X = params.X.detach().requires_grad_(grad_X)
    hyper = [t.detach().requires_grad_(grad_cov)
             for t in (params.noise_var, params.wfn_params, params.dfn_params)]
    p = GPRFParams(X=X, wfn_params=hyper[1], dfn_params=hyper[2], noise_var=hyper[0])
    with torch.set_grad_enabled(grad_X or grad_cov):
        ll = gprf_ll_schur(p, Y, assignment, mask, edges, unary_weights, pair_weights,
                           dfn_str=dfn_str, wfn_str=wfn_str, acc_dtype=acc_dtype, ops=ops)
    leaves = ([X] if grad_X else []) + (hyper if grad_cov else [])
    grads = list(torch.autograd.grad(ll, leaves)) if leaves else []
    gradX = grads.pop(0) if grad_X else torch.zeros_like(X)
    if grad_cov:
        gradCov = torch.cat([g.reshape(-1) for g in grads]).reshape(1, -1)
    else:
        gradCov = torch.zeros((1, sum(t.numel() for t in hyper)), dtype=X.dtype, device=X.device)
    return ll.detach(), gradX, gradCov
