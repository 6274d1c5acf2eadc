"""Block-2x2 Schur-split compositions over the leaf kernels of
:mod:`gprf_torch.ops.mvn`.

A width-m problem is split (recursively) into half-width leaves glued by
batched matrix products:

    K = [[A, K12], [K21, C]],   chol(K) = [[L_A, 0], [L21, L_C']]
    L21 = K21 W_A^T,  C' = C - L21 L21^T,  W_A = L_A^-1

Each leaf is one kernel launch.  The leaf caps are the kernels' own
shared-memory caps on the H100 (:data:`LEAF_CHOL` = 168 for K1 and K3,
:func:`gprf_torch.ops.mvn.mvn_max_m` = 216 at dy = 50 for K2), so the
flagship width m = 136 goes straight to the kernels and only wider blocks
split.  The ``leaf`` arguments force a split, for tests and comparisons.

Identity-padded masking passes through the split exactly: a padded row in
the A part stays an identity row of L_A, and a padded row in the C part
has zero K21 and L21 rows, so C' keeps its identity row.  Split points are
rounded to multiples of 8, as in ``gprf_tpu/ops/split_mvn.py``.
"""

from __future__ import annotations

import torch

from gprf_torch.ops.mvn import KERNEL_OPS, MAX_M_CHOL_INV, MAX_M_TRI_INV, Ops, mvn_max_m

LEAF_CHOL = MAX_M_CHOL_INV
LEAF_TRI = MAX_M_TRI_INV


def split_point(m: int) -> int:
    """Upper-half width: ceil(m/2) rounded up to a multiple of 8."""
    return (((m + 1) // 2) + 7) // 8 * 8


def _blocks(M, h):
    return M[:, :h, :h], M[:, h:, :h], M[:, h:, h:]


def _assemble_lower(A, B21, C):
    """[[A, 0], [B21, C]] for [N, h, h], [N, m-h, h], [N, m-h, m-h]."""
    zt = torch.zeros(A.shape[0], A.shape[1], C.shape[2], dtype=A.dtype, device=A.device)
    return torch.cat([torch.cat([A, zt], dim=2), torch.cat([B21, C], dim=2)], dim=1)


def chol_inv_split(K, leaf: int | None = None, ops: Ops = KERNEL_OPS):
    """(L, W = L^-1) for SPD [B, m, m] with chol_inv leaves."""
    m = K.shape[-1]
    leaf = LEAF_CHOL if leaf is None else leaf
    if m <= leaf:
        return ops.chol_inv(K)
    h = split_point(m)
    A, K21, C = _blocks(K, h)
    La, Wa = chol_inv_split(A, leaf, ops)
    L21 = K21 @ Wa.mT
    Lc, Wc = chol_inv_split(C - L21 @ L21.mT, leaf, ops)
    W21 = -(Wc @ L21 @ Wa)
    return _assemble_lower(La, L21, Lc), _assemble_lower(Wa, W21, Wc)


def tri_inv_split(L, leaf: int | None = None, ops: Ops = KERNEL_OPS):
    """W = L^-1 for lower-triangular [B, m, m] with tri_inv leaves:
    inv([[A, 0], [B, C]]) = [[Wa, 0], [-Wc B Wa, Wc]]."""
    m = L.shape[-1]
    leaf = LEAF_TRI if leaf is None else leaf
    if m <= leaf:
        return ops.tri_inv(L)
    h = split_point(m)
    A, B21, C = _blocks(L, h)
    Wa = tri_inv_split(A, leaf, ops)
    Wc = tri_inv_split(C, leaf, ops)
    return _assemble_lower(Wa, -(Wc @ B21 @ Wa), Wc)


def mvn_ll_split(Kp, Ym, n_active, leaf_mvn: int | None = None,
                 leaf_chol: int | None = None, ops: Ops = KERNEL_OPS):
    """Masked Gaussian log-density [B] (the contract of ``mvn_ll``) via the
    Schur split:

        ll = [-1/2 |Wa Y1|^2 - dy/2 logdet A] + MVN(C', Y2 - L21 Wa Y1, n_active)
    """
    m = Kp.shape[-1]
    dy = Ym.shape[-1]
    leaf_mvn = mvn_max_m(dy) if leaf_mvn is None else leaf_mvn
    if m <= leaf_mvn:
        return ops.mvn_ll(Kp, Ym, n_active)
    h = split_point(m)
    A, K21, C = _blocks(Kp, h)
    La, Wa = chol_inv_split(A, leaf_chol, ops)
    z1 = Wa @ Ym[:, :h, :]
    L21 = K21 @ Wa.mT
    rhs2 = Ym[:, h:, :] - L21 @ z1
    quad1 = torch.sum(z1 * z1, dim=(1, 2))
    logdet1 = 2.0 * torch.sum(torch.log(torch.diagonal(La, dim1=1, dim2=2)), dim=1)
    ll2 = mvn_ll_split(C - L21 @ L21.mT, rhs2, n_active, leaf_mvn, leaf_chol, ops)
    return ll2 - 0.5 * quad1 - 0.5 * dy * logdet1
