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
jitter keeps well conditioned.  The conditional of block j on block i,
S and the residual Y_j - B^T W_i Y_i, is one autograd Function
(:class:`SchurConditional`): the subtraction in the products' epilogue,
only the blocks of S that the split reads, and one product of width m in
its backward where autograd's would run two.

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

The kernel matrices of both passes, where the covariance is the SE profile
over the scaled euclidean distance at dx < 16, come from ``ops.se_kernel``
(:mod:`gprf_torch.ops.se_kernel`): one kernel builds the masked, padded
matrices from the points, and its backward reduces the cotangent to the
points and hyperparameters, where eager PyTorch wrote and kept every step
of the chain.  Every other covariance (the seismic great-circle
Matern-3/2) composes them from ``cross_kernel_matrix``.

The joint form :func:`gprf_ll` is the reference's parity oracle: each
pair is one 2m-wide masked Gaussian density over the stacked blocks,
factored by ``torch.linalg`` (the reference factors it with XLA's
Cholesky, not with a kernel), and shares no algebra with the Schur split.

Chunking bounds peak memory at wide m: ``pair_chunk`` (and ``unary_chunk``
of the joint form) evaluates the batch in chunks whose forward is computed
again in the backward (``torch.utils.checkpoint``; ``jax.checkpoint`` under
``lax.map`` in the reference), so the backward keeps one chunk's
factorizations alive at a time.  The Schur form pads the edges with
zero-weight (0, 0) dummy edges to a multiple of the chunk, as the
reference does.  :func:`auto_pair_chunk` is the fused engines' rule: no
chunk where the whole pass fits half the card's memory, else the fewest
equal chunks that fit.  The reference chunks by 64 edges past m = 512, a
size set by a TPU's memory; the port keeps that rule on the CPU only.  A
chunk changes only the order in which the pair terms are summed.

All float32 products run at full precision (``gprf_torch`` pins TF32
off): the Schur complement must stay numerically positive definite.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from gprf_torch.kernels.covfn import cross_kernel_matrix
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.linalg.doubling import batched_tri_inv_doubling
from gprf_torch.linalg.masked import masked_gaussian_ll, pad_kernel_matrix
from gprf_torch.ops import se_kernel
from gprf_torch.ops.mvn import KERNEL_OPS, Ops
from gprf_torch.ops.split_mvn import (chol_inv_split, cholesky_split, gram_read_blocks_cotangent,
                                     mvn_ll_split, mvn_split_width, sub_gram_read_blocks_)
from gprf_torch.utils.profiling import fit_counts, span

_LOG_2PI = math.log(2.0 * math.pi)

# [m, m] buffers an edge that the whole pair pass holds at its peak, per
# replica, from what its backward keeps: the masked Kij, the gathered W_i,
# B and S, mvn_ll_split's blocks and factors (about 2), and the backward's
# gradients of those.  Above what was resident, with the unary pass in it,
# an H100 read at m = 896 over 342 edges: 7.6 buffers an edge at R = 1 and
# 7.5 at R = 4 in float32 through the SE kernel, 10.1 in float64 on
# LINALG_OPS, and 16.6 in float32 where the kernel matrices are composed
# eagerly (a Matern-3/2 covariance, which the SE kernel does not serve).
# 14 keeps each of them within [0.5, 1.25] of the rule's estimate, and
# changes no choice at half an H100: R = 1 at 80k runs whole at any count
# under 38, and R = 4 needs two chunks at any count above 9.7.  The eager
# path holds about 19% more than the estimate: a covariance the SE kernel
# does not serve relies on the other half of the card for that.
PAIR_BUFFERS = 14
# the reference's rule, kept where there is no card: 64 edges past m = 512
REFERENCE_PAIR_CHUNK = 64
REFERENCE_CHUNK_PAST_M = 512


def pair_budget_bytes(device) -> int | None:
    """The bytes the pair pass may hold on ``device``: half the card's
    memory (the total, not what is free, so the choice does not depend on
    what the caching allocator holds); None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory // 2


def auto_pair_chunk(E: int, R: int, m: int, itemsize: int, budget_bytes: int | None):
    """The pair chunk of E edges of R replicas at width m and ``itemsize``
    bytes an element: None (the whole pass, no remat, no dummy edges) where
    R E PAIR_BUFFERS m^2 itemsize bytes fit ``budget_bytes``, else ceil(E /
    nch) edges for nch = ceil(need / budget) chunks, which pads fewer than
    nch dummy edges.  With no budget (the CPU), the reference's 64 edges
    past m = 512."""
    if budget_bytes is None:
        return REFERENCE_PAIR_CHUNK if m > REFERENCE_CHUNK_PAST_M else None
    need = R * E * PAIR_BUFFERS * m * m * itemsize
    if need <= budget_bytes:
        return None
    nch = -(-need // budget_bytes)
    return -(-E // nch)


class GPRFParams(NamedTuple):
    """Differentiable parameters of the objective."""

    X: torch.Tensor  # [n, dx] latent input locations
    wfn_params: torch.Tensor  # [1] signal variance
    dfn_params: torch.Tensor  # [k] lengthscales
    noise_var: torch.Tensor  # [] observation noise variance


def _remat(fn, *args):
    """fn(*args), its intermediate tensors computed again in the backward
    instead of kept (plainly when no gradient is being recorded)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _block_term(Xb, Yb, mask, cov: GPCov, noise_var):
    """Masked Gaussian log-densities [N] of padded blocks Xb [N, w, dx]."""
    K = cross_kernel_matrix(cov, Xb, Xb)
    K = K + noise_var * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return masked_gaussian_ll(K, Yb, mask)


def _batch_terms(X, Y, assignment, mask, cov: GPCov, noise_var, chunk_size):
    """Vector [N] of the masked block log-densities of the gathers
    ``assignment``/``mask`` [N, w], in chunks of ``chunk_size`` whose
    forward the backward computes again (None: all at once)."""
    N = assignment.shape[0]
    if N == 0:
        return torch.zeros((0,), dtype=X.dtype, device=X.device)

    def terms(idx, msk):
        idx = idx.long()
        return _block_term(X[idx], Y[idx], msk, cov, noise_var)

    if chunk_size is None or N <= chunk_size:
        return terms(assignment, mask)
    return torch.cat([_remat(terms, assignment[s:s + chunk_size], mask[s:s + chunk_size])
                      for s in range(0, N, chunk_size)])


class SchurConditional(torch.autograd.Function):
    """The Gaussian conditional of block j on block i in the pair pass,

        S = C - Bm^T Bm,   rhs = Yj - Bm^T Zi,

    of ``C = Kp[ej]`` [..., m, m], ``Yj = Ym[ej]`` [..., m, dy], ``Bm = W_i
    Kij`` [..., m, m] and ``Zi = Zs[ei]`` [..., m, dy]; returns (S, rhs).

    Each product is one ``baddbmm`` with beta 1 and alpha -1, so the
    subtraction happens in cuBLAS's epilogue.  S is built in C's storage
    (``mark_dirty``): C must be a contiguous tensor of the caller's own,
    such as the gather ``Kp[:, ej]``, that nothing reads again.  Where ``h``
    is given (the width at which :func:`mvn_ll_split` splits S,
    :func:`gprf_torch.ops.split_mvn.mvn_split_width`), only the blocks the
    split reads are built (3/4 of the product; ``sub_gram_read_blocks_``),
    and S[:h, h:] keeps C's values.

    The backward is exact for the S built and any cotangent (dS need not be
    symmetric, nor zero where S keeps C): dC = dS, dYj = drhs, dZi = -Bm
    drhs and dBm = -Bm T - Zi drhs^T, T = dS0 + dS0^T of dS on the blocks
    built (``gram_read_blocks_cotangent``): one product of width m, where
    autograd's ``BmmBackward0`` runs two and sums their branches, folded
    onto the rank-dy term by one ``baddbmm``.  Only Bm and Zi are saved."""

    @staticmethod
    def forward(ctx, C, Yj, Bm, Zi, h):
        m, dy = C.shape[-1], Yj.shape[-1]
        B = Bm.reshape(-1, m, m)
        sub_gram_read_blocks_(C.view(-1, m, m), B, h)
        ctx.h = h
        rhs = torch.baddbmm(Yj.reshape(-1, m, dy), B.mT, Zi.reshape(-1, m, dy), alpha=-1)
        ctx.mark_dirty(C)
        ctx.save_for_backward(Bm, Zi)
        return C, rhs.view(Yj.shape)

    @staticmethod
    def backward(ctx, dS, drhs):
        Bm, Zi = ctx.saved_tensors
        m, dy = Zi.shape[-2:]
        B, dr = Bm.reshape(-1, m, m), drhs.reshape(-1, m, dy)
        dBm = dZi = None
        if ctx.needs_input_grad[2]:
            T = gram_read_blocks_cotangent(dS.reshape(-1, m, m), ctx.h)
            dBm = torch.bmm(Zi.reshape(-1, m, dy), dr.mT)
            dBm = dBm.baddbmm_(B, T, beta=-1, alpha=-1).view(Bm.shape)
        if ctx.needs_input_grad[3]:
            dZi = torch.bmm(B, dr).neg_().view(Zi.shape)
        return (dS if ctx.needs_input_grad[0] else None,
                drhs if ctx.needs_input_grad[1] else None, dBm, dZi, None)


def _schur_ll(X, Y, assignment, mask, edges, unary_weights, pair_weights,
              cov: GPCov, noise_var, acc_dtype=None, ops: Ops = KERNEL_OPS,
              mvn_inv: bool = False, unary_doubling: bool = False, pair_chunk: int | None = None):
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
    docstring, and the covariance the kernel matrices' path (``ops.se_kernel``
    where :func:`gprf_torch.ops.se_kernel.serves` it).  ``pair_chunk`` runs
    the pair pass in chunks of that many edges (module docstring).  The
    running fit's ``pair_passes``, ``pair_chunks``, ``pair_dummy_edges``
    and ``pair_schur_blocked`` (chunks whose S was built in the split's
    blocks) count the path taken."""
    dtype = X.dtype
    acc = dtype if acc_dtype is None else acc_dtype
    R, B, m = assignment.shape
    dy = Y.shape[-1]
    maskf = mask.to(dtype)
    if se_kernel.serves(cov.dfn_str, cov.wfn_str, X.shape[-1]):
        # one kernel a pass builds the masked matrices from the points; the
        # hyperparameters made contiguous once for both passes
        sv = cov.wfn_params.reshape(R).contiguous()
        ls = cov.dfn_params.reshape(R, -1).contiguous()
        nv = noise_var.reshape(R).contiguous()

        def unary_matrices(Xb):
            return ops.se_kernel(Xb, Xb, maskf, maskf, sv, ls, nv)

        def pair_matrices(Xi, Xj, mi, mj):
            return ops.se_kernel(Xi, Xj, mi, mj, sv, ls, None)
    else:
        eye = torch.eye(m, dtype=dtype, device=X.device)
        # hyperparameters broadcast against the [R, B, m, .] block tensors
        cov = GPCov(wfn_params=cov.wfn_params.reshape(R, 1, 1, 1),
                    dfn_params=cov.dfn_params.reshape(R, 1, 1, -1),
                    dfn_str=cov.dfn_str, wfn_str=cov.wfn_str)
        noise_var = noise_var.reshape(R, 1, 1, 1)

        def unary_matrices(Xb):
            return pad_kernel_matrix(cross_kernel_matrix(cov, Xb, Xb) + noise_var * eye, mask)

        def pair_matrices(Xi, Xj, mi, mj):
            return cross_kernel_matrix(cov, Xi, Xj) * (mi[..., :, None] * mj[..., None, :])

    # ---- unary pass: K1 over every block (K5 + doubling on that route)
    with span("unary_pass"):
        # index_select, not X[assignment]: its backward is an index_add, where
        # advanced indexing's is a sort-based index_put that took ~0.6 ms of a
        # flagship evaluation on the H100 (it sums in another order, so the X
        # gradient on the card varies in the last bits from run to run)
        n = X.shape[1]
        flat = assignment.long()
        if R > 1:  # replica r's points sit at rows r n .. r n + n - 1 of the flat X
            flat = flat + torch.arange(R, device=X.device).reshape(R, 1, 1) * n
        Xb = X.reshape(R * n, -1).index_select(0, flat.reshape(-1)).reshape(R, B, m, X.shape[-1])
        Kp = unary_matrices(Xb)
        Ym = Y[assignment.long()] * maskf[..., None]
        with span("unary_factor"):
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
    h = mvn_split_width(m, dy, ops)  # where mvn_ll_split splits S, the blocks it reads

    def pair_sum(edges_c, pw_c):
        # each chunk, and again in the backward where the remat recomputes it
        with span("pair_pass"):
            ei = edges_c[:, 0]
            ej = edges_c[:, 1]
            Ec = edges_c.shape[0]
            Kij = pair_matrices(Xb[:, ei], Xb[:, ej], maskf[:, ei], maskf[:, ej])
            Bm = Ws[:, ei] @ Kij
            # padded rows of Kp[ej] are identity and the matching Bm columns are
            # zero, so S stays padded-masked
            S, rhs = SchurConditional.apply(Kp[:, ej], Ym[:, ej], Bm, Zs[:, ei], h)
            nbj = torch.sum(maskf[:, ej], dim=-1)
            pair_mvn = mvn_ll_split(S.reshape(R * Ec, m, m), rhs.reshape(R * Ec, m, dy),
                                    nbj.reshape(R * Ec), ops=ops, mvn_inv=mvn_inv)
            pair_ll = unary_ll[:, ei] + pair_mvn.reshape(R, Ec).to(acc)
            return torch.sum(pw_c.to(acc) * pair_ll, dim=-1)

    edges = edges.long()
    fit_counts["pair_passes"] += 1
    blocked = int(h is not None)
    if pair_chunk is None or E <= pair_chunk:
        fit_counts["pair_chunks"] += 1
        fit_counts["pair_schur_blocked"] += blocked
        return total + pair_sum(edges, pair_weights)
    # pad with zero-weight (0, 0) dummy edges to whole chunks: a block
    # against itself has a positive definite Schur complement (the noise
    # variance), so the dummies add exactly 0
    nch = -(-E // pair_chunk)
    pad = nch * pair_chunk - E
    fit_counts["pair_chunks"] += nch
    fit_counts["pair_schur_blocked"] += nch * blocked
    fit_counts["pair_dummy_edges"] += pad
    edges = torch.cat([edges, edges.new_zeros((pad, 2))])
    pair_weights = torch.cat([pair_weights, pair_weights.new_zeros((pad,))])
    for c in range(nch):
        sl = slice(c * pair_chunk, (c + 1) * pair_chunk)
        total = total + _remat(pair_sum, edges[sl], pair_weights[sl])
    return total


def gprf_ll_schur(params: GPRFParams, Y, assignment, mask, edges, unary_weights,
                  pair_weights, dfn_str: str = "euclidean", wfn_str: str = "se",
                  acc_dtype=None, ops: Ops = KERNEL_OPS, mvn_inv: bool = False,
                  unary_doubling: bool = False, pair_chunk: int | None = None):
    """GPRF log-likelihood via the Schur-complement pair form.

    ``assignment``/``mask`` are the padded [B, m] block layout, ``edges``
    the [E, 2] block pairs, and the weights the per-term combination
    weights (1 - |E_i| for blocks, 1 for pairs).  A scalar, or [R] for R
    replicas: then ``params.X`` is [R, n, dx], the layout [R, B, m] and the
    hyperparameters carry a leading R (:func:`_schur_ll`).  ``mvn_inv`` and
    ``unary_doubling`` pick a route (module docstring); both default off.
    ``pair_chunk`` bounds the pair pass's batch (module docstring)."""
    batched = params.X.dim() == 3
    cov = GPCov(wfn_params=params.wfn_params, dfn_params=params.dfn_params,
                dfn_str=dfn_str, wfn_str=wfn_str)
    X = params.X if batched else params.X[None]
    ll = _schur_ll(X, Y, assignment if batched else assignment[None],
                   mask if batched else mask[None], edges, unary_weights, pair_weights,
                   cov, params.noise_var, acc_dtype=acc_dtype, ops=ops, mvn_inv=mvn_inv,
                   unary_doubling=unary_doubling, pair_chunk=pair_chunk)
    return ll if batched else ll[0]


def gprf_ll(params: GPRFParams, Y, assignment, mask, pair_assignment, pair_mask,
            unary_weights, pair_weights, dfn_str: str = "euclidean", wfn_str: str = "se",
            unary_chunk: int | None = None, pair_chunk: int | None = None):
    """Scalar GPRF log-likelihood in the joint form: every block and every
    stacked pair ``pair_assignment``/``pair_mask`` [E, 2m] one masked
    Gaussian density through ``torch.linalg``.  Numerically equal to
    :func:`gprf_ll_schur`; the chunks bound the batches (module
    docstring)."""
    cov = GPCov(wfn_params=params.wfn_params, dfn_params=params.dfn_params,
                dfn_str=dfn_str, wfn_str=wfn_str)
    unary = _batch_terms(params.X, Y, assignment, mask, cov, params.noise_var, unary_chunk)
    ll = torch.sum(unary_weights * unary)
    if pair_assignment.shape[0] > 0:
        pair = _batch_terms(params.X, Y, pair_assignment, pair_mask, cov, params.noise_var,
                            pair_chunk)
        ll = ll + torch.sum(pair_weights * pair)
    return ll


def _value_and_grad(f, params: GPRFParams, grad_X: bool, grad_cov: bool):
    """(ll, gradX, gradCov) of the objective ``f(params)`` by autograd,
    the contract of ``GPRF.llgrad``: gradCov's row is [d/d noise_var,
    d/d signal_var, d/d lengthscales], and a gradient that is not asked for
    comes back as zeros of its shape."""
    X = params.X.detach().requires_grad_(grad_X)
    hyper = [t.detach().requires_grad_(grad_cov)
             for t in (params.noise_var, params.wfn_params, params.dfn_params)]
    p = GPRFParams(X=X, wfn_params=hyper[1], dfn_params=hyper[2], noise_var=hyper[0])
    with torch.set_grad_enabled(grad_X or grad_cov):
        ll = f(p)
    leaves = ([X] if grad_X else []) + (hyper if grad_cov else [])
    grads = list(torch.autograd.grad(ll, leaves)) if leaves else []
    gradX = grads.pop(0) if grad_X else torch.zeros_like(X)
    if grad_cov:
        gradCov = torch.cat([g.reshape(-1) for g in grads]).reshape(1, -1)
    else:
        gradCov = torch.zeros((1, sum(t.numel() for t in hyper)), dtype=X.dtype, device=X.device)
    return ll.detach(), gradX, gradCov


def gprf_value_and_grad_schur(params: GPRFParams, Y, assignment, mask, edges, unary_weights,
                              pair_weights, dfn_str: str = "euclidean", wfn_str: str = "se",
                              grad_X: bool = True, grad_cov: bool = False, acc_dtype=None,
                              ops: Ops = KERNEL_OPS, pair_chunk: int | None = None):
    """(ll, gradX [n, dx], gradCov [1, 2 + k]) by autograd over
    :func:`gprf_ll_schur` (:func:`_value_and_grad`'s contract)."""
    return _value_and_grad(
        lambda p: gprf_ll_schur(p, Y, assignment, mask, edges, unary_weights, pair_weights,
                                dfn_str=dfn_str, wfn_str=wfn_str, acc_dtype=acc_dtype, ops=ops,
                                pair_chunk=pair_chunk),
        params, grad_X, grad_cov)


def gprf_value_and_grad(params: GPRFParams, Y, assignment, mask, pair_assignment, pair_mask,
                        unary_weights, pair_weights, dfn_str: str = "euclidean",
                        wfn_str: str = "se", grad_X: bool = True, grad_cov: bool = False,
                        unary_chunk: int | None = None, pair_chunk: int | None = None):
    """(ll, gradX [n, dx], gradCov [1, 2 + k]) by autograd over the joint
    form :func:`gprf_ll` (:func:`_value_and_grad`'s contract)."""
    return _value_and_grad(
        lambda p: gprf_ll(p, Y, assignment, mask, pair_assignment, pair_mask, unary_weights,
                          pair_weights, dfn_str=dfn_str, wfn_str=wfn_str,
                          unary_chunk=unary_chunk, pair_chunk=pair_chunk),
        params, grad_X, grad_cov)
