"""Scan-style L-BFGS with retrospective Armijo control (mirror of
``make_scan_lbfgs_runner`` in ``gprf_tpu/optim/device_lbfgs.py``).

Exactly one loss+gradient evaluation per iteration and no data-dependent
control flow: step k evaluates the point proposed by step k-1; if the
decrease was insufficient the state reverts and the step scale shrinks, so
the trial evaluation *is* the next iteration's evaluation.  The accept and
revert decisions are ``torch.where`` selections on device tensors, so a
dispatch of S iterations never waits for the device; the caller reads the
per-dispatch outputs once.
"""

from __future__ import annotations

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def value_and_grad(loss_fn, x):
    """(loss, gradient) of a scalar loss at x, both detached."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        v = loss_fn(x)
        (g,) = torch.autograd.grad(v, x)
    return v.detach(), g


def make_scan_lbfgs_runner(loss_fn, num_steps: int, memory_size: int = 10,
                           c1: float = 1e-4, eta_shrink: float = 0.5,
                           eta_grow: float = 1.2, aux_fn=None):
    """(init_fn, run_fn): ``init_fn(x0) -> carry`` and ``run_fn(carry) ->
    (carry, (values, accepted, gnorms))`` advancing ``num_steps``
    iterations.  The carry is a dict of tensors.

    ``aux_fn`` (optional, theta -> 0-d bool tensor) is evaluated on the
    last evaluated point and the pending proposal and its OR is appended to
    the outputs (the fused loss's capacity-overflow flag); a non-finite
    point is masked out."""
    M = memory_size

    def init_fn(x0):
        v0, g0 = value_and_grad(loss_fn, x0)
        n, dt, dev = x0.shape[0], x0.dtype, x0.device
        return dict(
            x=x0, v=v0, g=g0, x_prev=x0, v_prev=v0, g_prev=g0,
            first=torch.ones((), dtype=torch.bool, device=dev),
            eta=torch.ones((), dtype=dt, device=dev),
            S=torch.zeros((M, n), dtype=dt, device=dev),
            Ymem=torch.zeros((M, n), dtype=dt, device=dev),
            rho=torch.zeros((M,), dtype=dt, device=dev),
            valid=torch.zeros((M,), dtype=torch.bool, device=dev),
            head=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def _two_loop(g, S, Ymem, rho, valid, head):
        # newest-first order of the circular memory
        idxs = (head - 1 - torch.arange(M, device=g.device)) % M
        S, Ymem, rho, valid = S[idxs], Ymem[idxs], rho[idxs], valid[idxs]
        q = g
        alphas = []
        for i in range(M):
            alpha = torch.where(valid[i], rho[i] * torch.dot(S[i], q), 0.0)
            q = q - alpha * Ymem[i] * valid[i]
            alphas.append(alpha)
        # initial Hessian scaling gamma = s.y / y.y of the newest pair
        sy = torch.dot(S[0], Ymem[0])
        yy = torch.dot(Ymem[0], Ymem[0])
        r = torch.where(valid[0] & (yy > 0), sy / yy, 1.0) * q
        for i in reversed(range(M)):  # oldest-first
            beta = torch.where(valid[i], rho[i] * torch.dot(Ymem[i], r), 0.0)
            r = r + torch.where(valid[i], alphas[i] - beta, 0.0) * S[i]
        return -r  # descent direction

    def step(c):
        v_new, g_new = value_and_grad(loss_fn, c["x"])
        # nonmonotone slack at float32's resolution of the objective: the
        # block factorizations compute in f32 whatever the accumulator
        slack = 8.0 * _F32_EPS * torch.abs(c["v_prev"])
        expected = c1 * torch.abs(torch.dot(c["g_prev"], c["x"] - c["x_prev"]))
        ok = c["first"] | (v_new <= c["v_prev"] - expected) | (v_new <= c["v_prev"] + slack)

        # on accept: fold (s, y) into memory if the curvature is positive
        s = c["x"] - c["x_prev"]
        y = g_new - c["g_prev"]
        sy = torch.dot(s, y)
        store = ok & ~c["first"] & (sy > 1e-10)
        h = (c["head"] % M).reshape(1)
        S = torch.where(store, c["S"].index_copy(0, h, s[None]), c["S"])
        Ymem = torch.where(store, c["Ymem"].index_copy(0, h, y[None]), c["Ymem"])
        rho_h = 1.0 / torch.where(sy > 1e-10, sy, 1.0)
        rho = torch.where(store, c["rho"].index_copy(0, h, rho_h.reshape(1)), c["rho"])
        valid = torch.where(store, c["valid"].index_fill(0, h, True), c["valid"])
        head = torch.where(store, c["head"] + 1, c["head"])

        # effective state: accepted -> new point; rejected -> revert
        x_eff = torch.where(ok, c["x"], c["x_prev"])
        v_eff = torch.where(ok, v_new, c["v_prev"])
        g_eff = torch.where(ok, g_new, c["g_prev"])
        eta = torch.where(ok, torch.clamp_max(c["eta"] * eta_grow, 1.0), c["eta"] * eta_shrink)

        d = _two_loop(g_eff, S, Ymem, rho, valid, head)
        # first-iteration safeguard: gradient-norm-scaled steepest descent
        gn = torch.linalg.vector_norm(g_eff)
        d = torch.where(valid.any(), d, -g_eff / torch.clamp_min(gn, 1.0))
        out = dict(
            x=x_eff + eta * d, v=v_eff, g=g_eff, x_prev=x_eff, v_prev=v_eff, g_prev=g_eff,
            first=torch.zeros_like(c["first"]), eta=eta, S=S, Ymem=Ymem, rho=rho,
            valid=valid, head=head,
        )
        return out, (v_eff, ok, gn)

    def run_fn(carry):
        traj = []
        for _ in range(num_steps):
            carry, outs = step(carry)
            traj.append(outs)
        values, accepted, gnorms = (torch.stack(t) for t in zip(*traj))
        if aux_fn is None:
            return carry, (values, accepted, gnorms)

        def masked(pt):
            return aux_fn(pt) & torch.isfinite(pt).all()

        return carry, (values, accepted, gnorms,
                       masked(carry["x_prev"]) | masked(carry["x"]))

    return init_fn, run_fn
