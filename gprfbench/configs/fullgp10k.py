"""The exact GP at the paper's size as the benchmark makes it, and its plain
reference: the Full-GP row of the true-GP suite of Moore & Russell (2015),
``gprfopt.py --ntrain 10000 --nblocks 1 --local_dist 1.0 ...``.  Plain
PyTorch: nothing here imports the program or JAX.

**The data** is the synthetic problem's (:class:`gprfbench.data.Problem`):
SX uniform on the unit square, Y an exact draw from the SE prior, each
job's X_obs around SX.  One centre and no edges, so the program holds
every point in one block of width m = n.

**The reference** is the GP marginal likelihood of all n points, written
directly:

    ll(X) = -1/2 tr(Y^T K^-1 Y) - dy/2 log det K - n dy/2 log 2 pi,
    K = sv exp(-|x_a - x_b|^2 / l^2) + nv I,

through one Cholesky factor of K, plus the Gaussian prior of X around
X_obs, negated; its gradient by autograd.  It shares neither the term
loop, the partition nor the closed-form gradient of ``reference.py``, so
the cell is checked by a second derivation.  ``control=True`` computes the
same function in float32 with every matrix product's operands rounded to
TF32, in the backward too, the Cholesky factorization's own products among
them (:func:`cholesky_tf32`): what TF32 tensor cores would compute.
"""

from __future__ import annotations

import math

import torch

from gprfbench.data import Problem
from gprfbench.reference import Loss, round_tf32

LOG_2PI = math.log(2.0 * math.pi)
TF32_LEAF = 256  # the control's factorization splits blocks wider than this


class _TF32Product(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and the backward's products
    likewise."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.mT, a.mT @ g


def mm(a, b, tf32: bool):
    return _TF32Product.apply(a, b) if tf32 else a @ b


def cholesky_tf32(K):
    """The lower Cholesky factor of K [n, n] with every product's operands
    rounded to TF32: above ``TF32_LEAF`` columns, the factor of the leading
    half, the panel by a triangular solve, and the factor of the trailing
    half less the panel's TF32 Gram product, each half in the same way."""
    n = K.shape[-1]
    if n <= TF32_LEAF:
        return torch.linalg.cholesky(K)
    h = n // 2
    La = cholesky_tf32(K[:h, :h])
    L21 = torch.linalg.solve_triangular(La, K[h:, :h].mT, upper=False).mT
    Lc = cholesky_tf32(K[h:, h:] - mm(L21, L21.mT, True))
    top = torch.cat([La, torch.zeros_like(K[:h, h:])], dim=1)
    return torch.cat([top, torch.cat([L21, Lc], dim=1)], dim=0)


def exact_gp_ll(X, Y, lscale: float, signal_var: float, noise_var: float, tf32: bool = False):
    """log N(Y | 0, K(X) + noise_var I) of all the rows of X [n, dx] and Y
    [n, dy], through one Cholesky factor (:func:`cholesky_tf32` where
    ``tf32``); a 0-d tensor at X's dtype."""
    n, dy = Y.shape
    r2 = sum((X[:, None, k] - X[None, :, k]) ** 2 for k in range(X.shape[1]))
    K = signal_var * torch.exp(-r2 / lscale**2)
    K = K + noise_var * torch.eye(n, dtype=X.dtype, device=X.device)
    L = cholesky_tf32(K) if tf32 else torch.linalg.cholesky(K)
    alpha = mm(torch.cholesky_inverse(L), Y, tf32)
    return (-0.5 * torch.sum(Y * alpha) - dy * torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * n * dy * LOG_2PI)


def loss(X, Y, X_obs, config: dict, *, grad: bool, dtype=torch.float64,
         tf32: bool = False) -> Loss:
    """The loss -(ll + X prior) at X [n, dx] (the program's values, any
    dtype), computed at ``dtype``, with its gradient [n dx] in float64."""
    dev = Y.device
    Xw = torch.as_tensor(X).to(device=dev, dtype=dtype).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        ll = exact_gp_ll(Xw, Y.to(dtype), config["lscale"], config["signal_var"],
                         config["noise_var"], tf32)
    obs_std = config["obs_std"]
    Xo = torch.as_tensor(X_obs, device=dev, dtype=torch.float64)
    r = (Xw.detach().to(torch.float64) - Xo) / obs_std
    prior = -0.5 * torch.sum(r * r) - 0.5 * r.numel() * math.log(2 * math.pi * obs_std**2)
    value = float(-(ll.detach().to(torch.float64) + prior))
    if not grad:
        return Loss(value, None, None)
    (g_ll,) = torch.autograd.grad(ll, Xw)
    g_ll = g_ll.to(torch.float64).reshape(-1)
    return Loss(value, -(g_ll - (r / obs_std).reshape(-1)),
                float(torch.linalg.vector_norm(g_ll)))


class FullGPProblem(Problem):
    """The synthetic problem in one block, checked against the exact GP."""

    def __init__(self, config: dict, local_dist: float, seed: int, device: torch.device):
        if config["nblocks"] != 1 or local_dist < 1.0:
            raise ValueError("the exact GP is one block with no edges: nblocks 1, local_dist 1.0")
        super().__init__(config, local_dist, seed, device)

    def ref_loss(self, X, X_obs, *, grad: bool, control: bool = False) -> Loss:
        """The exact GP's loss at X in float64, or with ``control`` in float32
        with TF32 products."""
        return loss(X, self.Y_dev, X_obs, self.config, grad=grad,
                    dtype=torch.float32 if control else torch.float64, tf32=control)


def make_problem(config: dict, local_dist: float, seed: int, device: torch.device):
    # the configuration states TF32 off, PyTorch's default for products
    assert not torch.backends.cuda.matmul.allow_tf32, "the configuration runs with TF32 off"
    return FullGPProblem(config, local_dist, seed, device)
