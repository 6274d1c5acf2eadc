"""Block-2x2 Schur-split compositions over the leaf kernels of
:mod:`gprf_torch.ops.mvn`.

A width-m problem is split (recursively) into half-width leaves glued by
batched matrix products:

    K = [[A, K12], [K21, C]],   chol(K) = [[L_A, 0], [L21, L_C']]
    L21 = K21 W_A^T,  C' = C - L21 L21^T,  W_A = L_A^-1

Each leaf is one kernel launch.  The leaf caps are the kernels' own
shared-memory caps on the H100 (:data:`LEAF_CHOL` = 240 for K1,
:data:`LEAF_TRI` = 224 for K3, :data:`LEAF_CHOLESKY` = 240 for K5,
:func:`gprf_torch.ops.mvn.mvn_max_m` = 208 at dy = 50 for K2 and K4), so the
flagship width m = 136 goes straight to the kernels and only wider blocks
split.  The ``leaf`` arguments force a split, for tests and comparisons.
Leaves without caps (``ops.leaf_caps`` false: :data:`~gprf_torch.ops.mvn.LINALG_OPS`,
the float64 route on ``torch.linalg``) take a block of any width whole
unless a ``leaf`` is given.

Where a gradient is taken, :func:`chol_inv_split` is one autograd Function
(:class:`CholInvSplit`): its forward writes every block of L and W into one
buffer each, and its backward runs the recursion's pullback by hand into one
buffer of dK, with no slice, concatenation or zero fill of autograd's.

Identity-padded masking passes through the split exactly: a padded row in
the A part stays an identity row of L_A, and a padded row in the C part
has zero K21 and L21 rows, so C' keeps its identity row.  Split points are
rounded to multiples of 8, as in ``gprf_tpu/ops/split_mvn.py``.
"""

from __future__ import annotations

import torch

from gprf_torch.ops.mvn import (
    KERNEL_OPS,
    MAX_M_CHOL,
    MAX_M_CHOL_INV,
    MAX_M_TRI_INV,
    Ops,
    mvn_inv_supported,
    chol_inv_pullback,
    mvn_max_m,
)

LEAF_CHOL = MAX_M_CHOL_INV
LEAF_TRI = MAX_M_TRI_INV
LEAF_CHOLESKY = MAX_M_CHOL


def split_point(m: int) -> int:
    """Upper-half width: ceil(m/2) rounded up to a multiple of 8."""
    return (((m + 1) // 2) + 7) // 8 * 8


def _leaf(leaf, cap, ops, m):
    """The widest leaf: the one given, else the kernel's cap, else (leaves
    without caps) m itself."""
    if leaf is not None:
        return leaf
    return cap if ops.leaf_caps else m


def mvn_split_width(m: int, dy: int, ops: Ops = KERNEL_OPS, leaf: int | None = None):
    """The width h of the upper half at which :func:`mvn_ll_split` splits a
    width-m problem of dy columns (``split_point(m)``), or None where one
    leaf takes it whole: the one rule of the split and of the pair pass,
    which builds only the blocks the split reads."""
    return split_point(m) if m > _leaf(leaf, mvn_max_m(dy), ops, m) else None


def _blocks(M, h):
    return M[:, :h, :h], M[:, h:, :h], M[:, h:, h:]


def sub_gram_read_blocks_(C, B, h):
    """C - B^T B for C, B [N, m, m], written into C's storage on the blocks
    that :func:`mvn_ll_split` reads at split width h (:func:`_blocks`: the
    left h columns and the lower-right block; every block where h is None),
    each block one ``baddbmm`` with the subtraction in its epilogue.  The
    block above the diagonal keeps C's values."""
    if h is None:
        return C.baddbmm_(B.mT, B, alpha=-1)
    C[:, :, :h].baddbmm_(B.mT, B[:, :, :h], alpha=-1)
    C[:, h:, h:].baddbmm_(B[:, :, h:].mT, B[:, :, h:], alpha=-1)
    return C


def gram_read_blocks_cotangent(G, h):
    """T = G0 + G0^T of a cotangent G [N, m, m] of
    :func:`sub_gram_read_blocks_`'s output, G0 being G on the blocks built
    (every block where h is None): B's gradient is -B T.  Each block of T
    is written once."""
    if h is None:
        return G + G.mT
    T = torch.empty_like(G)
    for a, b in ((slice(None, h), slice(None, h)), (slice(h, None), slice(h, None))):
        torch.add(G[:, a, b], G[:, a, b].mT, out=T[:, a, b])
    T[:, h:, :h] = G[:, h:, :h]
    T[:, :h, h:] = G[:, h:, :h].mT
    return T


def _assemble_lower(A, B21, C):
    """[[A, 0], [B21, C]] for [N, h, h], [N, m-h, h], [N, m-h, m-h]."""
    zt = torch.zeros(A.shape[0], A.shape[1], C.shape[2], dtype=A.dtype, device=A.device)
    return torch.cat([torch.cat([A, zt], dim=2), torch.cat([B21, C], dim=2)], dim=1)


def chol_inv_split(K, leaf: int | None = None, ops: Ops = KERNEL_OPS):
    """(L, W = L^-1) for SPD [B, m, m] with chol_inv leaves."""
    m = K.shape[-1]
    leaf = _leaf(leaf, LEAF_CHOL, ops, m)
    if m <= leaf:
        return ops.chol_inv(K)
    return CholInvSplit.apply(K, leaf, ops)


def _chol_inv_into(K, L, W, leaf, ops, saved):
    """Writes chol_inv(K) into the views L and W, whose blocks above the
    diagonal are zero, and appends what the pullback reads of each split
    node, (K21, X = Wc L21), after its children's:

        L21 = K21 W_A^T,  S = C - L21 L21^T,  (L_C, W_C) = chol_inv(S),
        W21 = -X W_A."""
    m = K.shape[-1]
    if m <= leaf:
        Lk, Wk = ops.chol_inv(K)
        L.copy_(Lk)
        W.copy_(Wk)
        return
    h = split_point(m)
    A, K21, C = _blocks(K, h)
    La, L21, Lc = _blocks(L, h)
    Wa, W21, Wc = _blocks(W, h)
    _chol_inv_into(A, La, Wa, leaf, ops, saved)
    L21.baddbmm_(K21, Wa.mT, beta=0)
    _chol_inv_into(torch.baddbmm(C, L21, L21.mT, alpha=-1), Lc, Wc, leaf, ops, saved)
    X = Wc @ L21
    W21.baddbmm_(X, Wa, beta=0, alpha=-1)
    saved += [K21, X]


def _chol_inv_pullback_into(L, W, dL, dW, dK, leaf, saved):
    """Writes the cotangent of K into the view dK (zero above the blocks'
    diagonal, as K's upper right blocks are not read) from the cotangents
    dL and dW, views that it accumulates into.  It visits the nodes in the
    reverse of :func:`_chol_inv_into`'s order, popping ``saved``."""
    m = L.shape[-1]
    if m <= leaf:
        chol_inv_pullback(L, W, dL, dW, out=dK)
        return
    h = split_point(m)
    X = saved.pop()
    K21 = saved.pop()
    La, L21, Lc = _blocks(L, h)
    Wa, W21, Wc = _blocks(W, h)
    dLa, dL21, dLc = _blocks(dL, h)
    dWa, dW21, dWc = _blocks(dW, h)
    dA, dK21, dC = _blocks(dK, h)
    # W21 = -X Wa, X = Wc L21
    dX = dW21 @ Wa.mT  # the cotangent of X is -dX
    dWa.baddbmm_(X.mT, dW21, alpha=-1)
    dWc.baddbmm_(dX, L21.mT, alpha=-1)
    dL21.baddbmm_(Wc.mT, dX, alpha=-1)
    # (Lc, Wc) = chol_inv(S), S = C - L21 L21^T: dC = dS
    _chol_inv_pullback_into(Lc, Wc, dLc, dWc, dC, leaf, saved)
    dL21.baddbmm_(dC + dC.mT, L21, alpha=-1)
    # L21 = K21 Wa^T
    dK21.baddbmm_(dL21, Wa, beta=0)
    dWa.baddbmm_(dL21.mT, K21)
    _chol_inv_pullback_into(La, Wa, dLa, dWa, dA, leaf, saved)


class CholInvSplit(torch.autograd.Function):
    """(L, W = L^-1) of SPD [B, m, m] through the 2x2 split down to leaves
    of width ``leaf`` on ``ops.chol_inv``, with the split's pullback written
    by hand and each leaf's by :func:`chol_inv_pullback`.  Per split node
    the forward runs four products (the Schur subtraction in its product's
    epilogue) and the backward seven and one transposed sum; the gradient
    is the one autograd gives through the composed recursion."""

    @staticmethod
    def forward(ctx, K, leaf, ops):
        B, m = K.shape[0], K.shape[-1]
        L = K.new_zeros(B, m, m)
        W = K.new_zeros(B, m, m)
        saved = []
        _chol_inv_into(K, L, W, leaf, ops, saved)
        ctx.leaf = leaf
        ctx.save_for_backward(L, W, *saved)
        return L, W

    @staticmethod
    def backward(ctx, dL, dW):
        L, W, *saved = ctx.saved_tensors
        dK = torch.zeros_like(L)
        _chol_inv_pullback_into(L, W, dL.clone(memory_format=torch.contiguous_format),
                                dW.clone(memory_format=torch.contiguous_format), dK,
                                ctx.leaf, saved)
        return dK, None, None


def tri_inv_split(L, leaf: int | None = None, ops: Ops = KERNEL_OPS):
    """W = L^-1 for lower-triangular [B, m, m] with tri_inv leaves:
    inv([[A, 0], [B, C]]) = [[Wa, 0], [-Wc B Wa, Wc]]."""
    m = L.shape[-1]
    leaf = _leaf(leaf, LEAF_TRI, ops, m)
    if m <= leaf:
        return ops.tri_inv(L)
    h = split_point(m)
    A, B21, C = _blocks(L, h)
    Wa = tri_inv_split(A, leaf, ops)
    Wc = tri_inv_split(C, leaf, ops)
    return _assemble_lower(Wa, -(Wc @ B21 @ Wa), Wc)


def cholesky_split(K, leaf: int | None = None, ops: Ops = KERNEL_OPS):
    """L = chol(K) for SPD [B, m, m] with cholesky leaves, W_A from
    ``tri_inv_split``: L21 = K21 W_A^T, L_C = chol(C - L21 L21^T).  Up to
    the leaf cap it is one K5 launch; wider (where ``gprf_tpu``'s pipeline
    falls back to XLA's Cholesky) every leaf stays on the kernels."""
    m = K.shape[-1]
    leaf = _leaf(leaf, LEAF_CHOLESKY, ops, m)
    if m <= leaf:
        return ops.cholesky(K)
    h = split_point(m)
    A, K21, C = _blocks(K, h)
    La = cholesky_split(A, leaf, ops)
    L21 = K21 @ tri_inv_split(La, ops=ops).mT
    Lc = cholesky_split(C - L21 @ L21.mT, leaf, ops)
    return _assemble_lower(La, L21, Lc)


def mvn_ll_split(Kp, Ym, n_active, leaf_mvn: int | None = None,
                 leaf_chol: int | None = None, ops: Ops = KERNEL_OPS, mvn_inv: bool = False):
    """Masked Gaussian log-density [B] (the contract of ``mvn_ll``) via the
    Schur split:

        ll = [-1/2 |Wa Y1|^2 - dy/2 logdet A] + MVN(C', Y2 - L21 Wa Y1, n_active)

    ``mvn_inv`` sends each MVN leaf that K4 takes (:func:`mvn_inv_supported`)
    to ``ops.mvn_ll_inv``, whose backward needs no triangular inverse; the
    other leaves stay on ``ops.mvn_ll``."""
    m = Kp.shape[-1]
    dy = Ym.shape[-1]
    h = mvn_split_width(m, dy, ops, leaf_mvn)
    if h is None:
        if mvn_inv and mvn_inv_supported(m, dy):
            return ops.mvn_ll_inv(Kp, Ym, n_active)
        return ops.mvn_ll(Kp, Ym, n_active)
    A, K21, C = _blocks(Kp, h)
    La, Wa = chol_inv_split(A, leaf_chol, ops)
    z1 = Wa @ Ym[:, :h, :]
    L21 = K21 @ Wa.mT
    rhs2 = Ym[:, h:, :] - L21 @ z1
    quad1 = torch.sum(z1 * z1, dim=(1, 2))
    logdet1 = 2.0 * torch.sum(torch.log(torch.diagonal(La, dim1=1, dim2=2)), dim=1)
    ll2 = mvn_ll_split(C - L21 @ L21.mT, rhs2, n_active, leaf_mvn, leaf_chol, ops, mvn_inv)
    return ll2 - 0.5 * quad1 - 0.5 * dy * logdet1
