"""The plain reference of the GPRF objective: plain PyTorch, no kernel,
no padding, no batching, imports nothing of the program.

The objective is the paper's joint form (Moore & Russell 2015, eq. 5):

    ll(X) = sum_b (1 - |E_b|) log N(Y_b | 0, K_b) + sum_{(i,j) in E} log N(Y_ij | 0, K_ij)

over the blocks b of the nearest-center partition of X and the stacked
pairs of blocks of each edge, each term a dense Gaussian density through
its own Cholesky factor, with the gradient in closed form per term as the
reference's ``gaussian_llgrad`` gives it:

    alpha = K^-1 Y,  dll/dK = (alpha alpha^T - dy K^-1) / 2,
    dll/dx_a = -4 / l^2 sum_b (dll/dK o K_se)_ab (x_a - x_b).

The program computes the same function by another algebra (each pair
through the Schur complement of its i-side block's inverse factor).  Add
the Gaussian prior of X around X_obs and negate: the loss the optimizer
minimizes.

``tf32=True`` is the control: every matrix product takes its operands
rounded to TF32 (10 explicit mantissa bits, round to nearest even) and
accumulates in the working dtype, which is what a TF32 tensor core does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

LOG_2PI = math.log(2.0 * math.pi)


def round_tf32(x):
    """x (float32) rounded to the nearest TF32 value, kept in float32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def mm(a, b, tf32: bool):
    if tf32:
        return round_tf32(a) @ round_tf32(b)
    return a @ b


@dataclass
class Kernel:
    lscale: float
    signal_var: float
    noise_var: float


def labels(X, centers, tf32: bool = False):
    """Each point's nearest center, argmin_c |c|^2 - 2 x.c, scored at X's
    own dtype (float32 for the engine's state, float64 for X_obs):
    within rounding of a boundary both blocks are nearest, and
    the score at the program's width takes the side the program takes."""
    C = centers.to(X.dtype)
    # a batch of one, the program's own product shape
    XC = mm(X[None], C.T, tf32 and X.dtype == torch.float32)[0]
    return torch.argmin(-2.0 * XC + torch.sum(C * C, dim=1), dim=1)


def term(Xt, Yt, kern: Kernel, tf32: bool, grad: bool):
    """(ll, dll/dX [p, dx] or None) of one dense Gaussian term."""
    p, dy = Yt.shape
    r2 = sum((Xt[:, None, k] - Xt[None, :, k]) ** 2 for k in range(Xt.shape[1]))
    Kse = kern.signal_var * torch.exp(-r2 / kern.lscale**2)
    K = Kse + kern.noise_var * torch.eye(p, dtype=Xt.dtype, device=Xt.device)
    L = torch.linalg.cholesky(K)
    Kinv = torch.cholesky_inverse(L)
    alpha = mm(Kinv, Yt, tf32)
    ll = (-0.5 * torch.sum(Yt * alpha) - dy * torch.sum(torch.log(torch.diagonal(L)))
          - 0.5 * p * dy * LOG_2PI)
    if not grad:
        return ll, None
    G = 0.5 * (mm(alpha, alpha.T, tf32) - dy * Kinv) * Kse
    gX = -4.0 / kern.lscale**2 * (torch.sum(G, dim=1)[:, None] * Xt - mm(G, Xt, tf32))
    return ll, gX


@dataclass
class Loss:
    value: float  # the loss, -(ll + prior)
    grad: torch.Tensor | None  # its gradient [n * dx], float64
    ll_grad_norm: float | None  # |dll/dX|, the scale the gradient gap is read against


def loss(X, Y, X_obs, obs_std: float, centers, edges, kern: Kernel, *, grad: bool,
         dtype=torch.float64, tf32: bool = False, label_X=None) -> Loss:
    """The loss at X [n, dx] (the program's values, any dtype), computed at
    ``dtype``; ``label_X`` (default X) is what the partition is read from,
    at its own dtype."""
    dev = Y.device
    Xw = X.to(device=dev, dtype=dtype)
    Yw = Y.to(dtype)
    lab = labels((X if label_X is None else label_X).to(dev), centers.to(dev), tf32)
    B = centers.shape[0]
    members = [torch.nonzero(lab == b).reshape(-1) for b in range(B)]
    degree = torch.zeros(B, dtype=torch.int64)
    for i, j in edges.tolist():
        degree[i] += 1
        degree[j] += 1
    terms = [(1 - int(degree[b]), members[b]) for b in range(B)]
    terms += [(1, torch.cat([members[i], members[j]])) for i, j in edges.tolist()]
    ll = torch.zeros((), dtype=torch.float64, device=dev)
    gX = torch.zeros_like(Xw) if grad else None
    for w, idx in terms:
        if w == 0 or idx.numel() == 0:
            continue
        t_ll, t_g = term(Xw[idx], Yw[idx], kern, tf32, grad)
        ll = ll + w * t_ll.to(torch.float64)
        if grad:
            gX.index_add_(0, idx, w * t_g)
    Xo = torch.as_tensor(X_obs, device=dev, dtype=torch.float64)
    r = (Xw.to(torch.float64) - Xo) / obs_std
    prior = -0.5 * torch.sum(r * r) - 0.5 * r.numel() * math.log(2 * math.pi * obs_std**2)
    value = float(-(ll + prior))
    if not grad:
        return Loss(value, None, None)
    g_ll = gX.to(torch.float64).reshape(-1)
    total = -(g_ll - (r / obs_std).reshape(-1))
    return Loss(value, total, float(torch.linalg.vector_norm(g_ll)))
