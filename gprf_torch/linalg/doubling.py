"""Recursive-doubling batched triangular inverse (mirror of
``gprf_tpu/linalg/doubling.py``).

    inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B A^-1, C^-1]]

L is cut into equal diagonal base blocks (m with its factors of two peeled
off while the half stays >= 8: base 17 and 3 levels at m = 136).  Every
base block is inverted at once by a short unrolled forward substitution,
then pairs are combined level by level, each level two batched matrix
products over all pairs.  About B m^3 work against m^3 / 3 for a
substitution, in ~2 log2(m / base) sequential products instead of m steps.

The reference writes this as plain array code with no Pallas kernel, so
here it is plain tensor code: the unary-doubling route of the objective
runs it on the factors of the Cholesky kernel (K5), and autograd
differentiates it.
"""

from __future__ import annotations

import torch


def _doubling_split(m: int, base_max: int = 32) -> tuple[int, int]:
    """(base, levels) with base * 2**levels == m: m's factors of two peeled
    off while the half stays >= 8, then more while base > base_max."""
    base, levels = m, 0
    while base % 2 == 0 and base // 2 >= 8:
        base //= 2
        levels += 1
    while base > base_max and base % 2 == 0:
        base //= 2
        levels += 1
    return base, levels


def _diag_blocks(L, s: int):
    """[B, m/s, s, s] diagonal blocks of [B, m, m]."""
    B, m, _ = L.shape
    nb = m // s
    d = torch.diagonal(L.reshape(B, nb, s, nb, s), dim1=1, dim2=3)  # [B, s, s, nb]
    return d.movedim(-1, 1)


def _subdiag_blocks(L, s: int):
    """[B, m/(2s), s, s] blocks at block positions (2p+1, 2p)."""
    return _diag_blocks(L, 2 * s)[:, :, s:, :s]


def _base_inv(Ld):
    """Unrolled forward substitution: W = L^-1 for [N, s, s], s small."""
    N, s, _ = Ld.shape
    if s == 1:
        return 1.0 / Ld
    eye = torch.eye(s, dtype=Ld.dtype, device=Ld.device)
    rows = [1.0 / Ld[:, 0, 0:1] * eye[0][None]]
    for k in range(1, s):
        Wk = torch.stack(rows, dim=1)  # [N, k, s]
        acc = torch.einsum("nl,nls->ns", Ld[:, k, :k], Wk)
        rows.append((eye[k][None] - acc) / Ld[:, k, k][:, None])
    return torch.stack(rows, dim=1)


def batched_tri_inv_doubling(L):
    """W = L^-1 for a batch of lower-triangular [B, m, m]: parallel base
    block inverses, then levelwise pair combination by batched products."""
    B, m, _ = L.shape
    s, levels = _doubling_split(m)
    nb = m // s
    W = _base_inv(_diag_blocks(L, s).reshape(B * nb, s, s)).reshape(B, nb, s, s)
    for _ in range(levels):
        A = W[:, 0::2]  # [B, nb/2, s, s]
        C = W[:, 1::2]
        W21 = -(C @ _subdiag_blocks(L, s) @ A)
        top = torch.cat([A, torch.zeros_like(A)], dim=3)
        bot = torch.cat([W21, C], dim=3)
        W = torch.cat([top, bot], dim=2)  # [B, nb/2, 2s, 2s]
        s *= 2
    return W.reshape(B, m, m)
