"""Scan-style L-BFGS with retrospective Armijo control, and the drivers
around it that keep the experiment's file protocol (mirror of
``make_scan_lbfgs_runner``, ``make_multistart_runner``, the multistart
drivers, ``do_optimization_fused``, ``do_optimization_fused_theta`` and
``refine_f64`` in ``gprf_tpu/optim/device_lbfgs.py``).

Exactly one loss+gradient evaluation per iteration and no data-dependent
control flow: step k evaluates the point proposed by step k-1; if the
decrease was insufficient the state reverts and the step scale shrinks, so
the trial evaluation *is* the next iteration's evaluation.  The accept and
revert decisions are ``torch.where`` selections on device tensors, so a
dispatch of S iterations never waits for the device; the caller reads the
per-dispatch outputs once.

Every state tensor may carry leading replica dimensions: R independent
optimizations of a loss that maps thetas [R, n] to values [R] advance
together (multistart), each with its own acceptance, curvature memory,
``head`` and step scale.  The reference ``vmap``s its runner; here the
replicas are folded into the loss's own batch, so its kernels launch once
for all of them.

The three drivers (single start, multistart, the float64 tail) share one
dispatch loop, :func:`_dispatch_loop`, with one stall rule and one closing
``finally``; each gives it its differences as data (:class:`_Plan`) and
one function that reads a dispatch's outputs on the host.

The runner and the drivers mark their layers with spans of
:mod:`gprf_torch.utils.profiling` (``fit``, ``init_eval``, ``dispatch``,
``step``, ``forward``, ``backward``, ``update``, ``overflow_check``,
``sync``, ``grow``, ``checkpoint``, ``replica_health``), recorded only
while a profiler records, and count each fit's evaluations, steps,
accepted steps, dispatches, host reads, capacity growths, checkpoints and
restarts of diverged replicas.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections.abc import Callable

import numpy as np
import torch

from gprf_torch.utils import profiling
from gprf_torch.utils.io import save_step
from gprf_torch.utils.profiling import fit_counts, span

_F32_EPS = float(torch.finfo(torch.float32).eps)


def value_and_grad(loss_fn, x):
    """(loss, gradient) of a loss at x, both detached.  For replicas x
    [R, n] and values [R], the gradient of their sum is each replica's own,
    since the terms are independent."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        with span("forward"):
            v = loss_fn(x)
        with span("backward"):
            (g,) = torch.autograd.grad(v.sum() if v.dim() else v, x)
    return v.detach(), g


# the partial sums of each dot product: a fixed shape, whatever the replicas
_DOT_FOLD = 32


def _dot(a, b):
    """a . b over the last dimension, for any leading dimensions, with the
    same roundings in each row whatever the leading shape: the row is summed
    as _DOT_FOLD partial sums and then those, where a matrix product, or one
    sum over the row, picks its reduction order from the number of rows.  So
    a replica of a batched run takes the steps its start takes alone, as far
    as the loss agrees (the CUDA reductions checked bit for bit at R 1-8 and
    n up to 160,000 by the card tests)."""
    p = a * b
    n = p.shape[-1]
    k = -(-n // _DOT_FOLD)
    if k * _DOT_FOLD != n:
        p = torch.nn.functional.pad(p, (0, k * _DOT_FOLD - n))
    return p.unflatten(-1, (_DOT_FOLD, k)).sum(-1).sum(-1)


def make_scan_lbfgs_runner(loss_fn, num_steps: int, memory_size: int = 10,
                           c1: float = 1e-4, eta_shrink: float = 0.5,
                           eta_grow: float = 1.2, aux_fn=None):
    """(init_fn, run_fn): ``init_fn(x0) -> carry`` and ``run_fn(carry) ->
    (carry, (values, accepted, gnorms))`` advancing ``num_steps``
    iterations.  The carry is a dict of tensors.  x0 is [n], or [R, n] for
    R replicas, and then every output carries a leading R (values
    [R, num_steps]).

    ``aux_fn`` (optional, theta -> bool tensor, one per replica) is
    evaluated on the last evaluated point and the pending proposal and its
    OR is appended to the outputs (the fused loss's capacity-overflow
    flag); a non-finite point is masked out."""
    M = memory_size

    def init_fn(x0):
        fit_counts["evaluations"] += 1
        with span("init_eval"):
            v0, g0 = value_and_grad(loss_fn, x0)
            batch, n, dt, dev = x0.shape[:-1], x0.shape[-1], x0.dtype, x0.device
            return dict(
                x=x0, v=v0, g=g0, x_prev=x0, v_prev=v0, g_prev=g0,
                first=torch.ones(batch, dtype=torch.bool, device=dev),
                eta=torch.ones(batch, dtype=dt, device=dev),
                S=torch.zeros((*batch, M, n), dtype=dt, device=dev),
                Ymem=torch.zeros((*batch, M, n), dtype=dt, device=dev),
                rho=torch.zeros((*batch, M), dtype=dt, device=dev),
                valid=torch.zeros((*batch, M), dtype=torch.bool, device=dev),
                head=torch.zeros(batch, dtype=torch.int64, device=dev),
            )

    def _two_loop(g, S, Ymem, rho, valid, head):
        # newest-first order of the circular memory
        idxs = (head[..., None] - 1 - torch.arange(M, device=g.device)) % M
        S = torch.take_along_dim(S, idxs[..., None], dim=-2)
        Ymem = torch.take_along_dim(Ymem, idxs[..., None], dim=-2)
        rho = torch.take_along_dim(rho, idxs, dim=-1)
        valid = torch.take_along_dim(valid, idxs, dim=-1)
        q = g
        alphas = []
        for i in range(M):
            use = valid[..., i]
            alpha = torch.where(use, rho[..., i] * _dot(S[..., i, :], q), 0.0)
            q = q - alpha[..., None] * Ymem[..., i, :] * use[..., None]
            alphas.append(alpha)
        # initial Hessian scaling gamma = s.y / y.y of the newest pair
        sy = _dot(S[..., 0, :], Ymem[..., 0, :])
        yy = _dot(Ymem[..., 0, :], Ymem[..., 0, :])
        r = torch.where(valid[..., 0] & (yy > 0), sy / yy, 1.0)[..., None] * q
        for i in reversed(range(M)):  # oldest-first
            use = valid[..., i]
            beta = torch.where(use, rho[..., i] * _dot(Ymem[..., i, :], r), 0.0)
            r = r + torch.where(use, alphas[i] - beta, 0.0)[..., None] * S[..., i, :]
        return -r  # descent direction

    def update(c, v_new, g_new):
        """The step after its evaluation: acceptance, memory fold, two-loop
        recursion and the next proposal."""
        # nonmonotone slack at float32's resolution of the objective: the
        # block factorizations compute in f32 whatever the accumulator
        slack = 8.0 * _F32_EPS * torch.abs(c["v_prev"])
        expected = c1 * torch.abs(_dot(c["g_prev"], c["x"] - c["x_prev"]))
        ok = c["first"] | (v_new <= c["v_prev"] - expected) | (v_new <= c["v_prev"] + slack)

        # on accept: fold (s, y) into memory slot head % M if the curvature
        # is positive
        s = c["x"] - c["x_prev"]
        y = g_new - c["g_prev"]
        sy = _dot(s, y)
        store = ok & ~c["first"] & (sy > 1e-10)
        slot = (torch.arange(M, device=s.device) == (c["head"] % M)[..., None]) & store[..., None]
        S = torch.where(slot[..., None], s[..., None, :], c["S"])
        Ymem = torch.where(slot[..., None], y[..., None, :], c["Ymem"])
        rho_h = 1.0 / torch.where(sy > 1e-10, sy, 1.0)
        rho = torch.where(slot, rho_h[..., None], c["rho"])
        valid = c["valid"] | slot
        head = torch.where(store, c["head"] + 1, c["head"])

        # effective state: accepted -> new point; rejected -> revert
        x_eff = torch.where(ok[..., None], c["x"], c["x_prev"])
        v_eff = torch.where(ok, v_new, c["v_prev"])
        g_eff = torch.where(ok[..., None], g_new, c["g_prev"])
        eta = torch.where(ok, torch.clamp_max(c["eta"] * eta_grow, 1.0), c["eta"] * eta_shrink)

        d = _two_loop(g_eff, S, Ymem, rho, valid, head)
        # first-iteration safeguard: gradient-norm-scaled steepest descent
        gn = torch.sqrt(_dot(g_eff, g_eff))
        d = torch.where(valid.any(dim=-1)[..., None], d,
                        -g_eff / torch.clamp_min(gn, 1.0)[..., None])
        out = dict(
            x=x_eff + eta[..., None] * d, v=v_eff, g=g_eff, x_prev=x_eff, v_prev=v_eff,
            g_prev=g_eff, first=torch.zeros_like(c["first"]), eta=eta, S=S, Ymem=Ymem,
            rho=rho, valid=valid, head=head,
        )
        return out, (v_eff, ok, gn)

    def step(c):
        fit_counts["evaluations"] += 1
        fit_counts["steps"] += 1
        with span("step"):
            v_new, g_new = value_and_grad(loss_fn, c["x"])
            with span("update"):
                return update(c, v_new, g_new)

    def run_fn(carry):
        fit_counts["dispatches"] += 1
        traj = []
        for _ in range(num_steps):
            carry, outs = step(carry)
            traj.append(outs)
        values, accepted, gnorms = (torch.stack(t, dim=-1) for t in zip(*traj))
        if aux_fn is None:
            return carry, (values, accepted, gnorms)

        def masked(pt):
            return aux_fn(pt) & torch.isfinite(pt).all(dim=-1)

        with span("overflow_check"):
            overflow = masked(carry["x_prev"]) | masked(carry["x"])
        return carry, (values, accepted, gnorms, overflow)

    return init_fn, run_fn


def make_multistart_runner(loss_fn, num_steps: int, **kwargs):
    """R independent optimizations of a replica-batched loss (thetas
    [R, n] -> values [R]) from different starts, advancing together:
    :func:`make_scan_lbfgs_runner` with x0s [R, n].  Each replica's
    trajectory is the one its start gives alone, up to the reassociation
    of the loss's batched reductions: the runner's own (:func:`_dot`) do not
    depend on R."""
    return make_scan_lbfgs_runner(loss_fn, num_steps, **kwargs)


# ---- the dispatch loop: the file protocol around the runner -------------------

class GrowingRunner:
    """The scan-L-BFGS runner over a fused evaluator (``loss_fn``,
    ``overflow_fn``, ``grow_capacity``) with the capacity-growth policy of
    the drivers: when a dispatch reports that a block outgrew the padded
    slot count, :meth:`grow` enlarges the capacity, rebuilds the runner on
    the loss at the new capacity, and restarts the carry at the current
    point, keeping the curvature memory and the step scale (the steps that
    dropped points stay in the trajectory; their loss differed little)."""

    KEPT = ("S", "Ymem", "rho", "valid", "head", "eta")

    def __init__(self, fused, steps_per_dispatch: int):
        self.fused = fused
        self.steps_per_dispatch = steps_per_dispatch
        self._make()

    def _make(self):
        self.init_fn, self.run_fn = make_scan_lbfgs_runner(
            self.fused.loss_fn(), self.steps_per_dispatch, aux_fn=self.fused.overflow_fn())

    def grow(self, carry, at: str = "x"):
        """Grow, and restart at ``carry[at]``: the single-start drivers at
        the pending proposal ``x``, the multistart driver at the last
        evaluated point ``x_prev``, as the reference's drivers do."""
        fit_counts["capacity_growths"] += 1
        with span("grow"):
            self.fused.grow_capacity()
            self._make()
            return {**self.init_fn(carry[at]), **{k: carry[k] for k in self.KEPT}}


def _truncate_log_rows(path, it0):
    """Drop rows with step index >= ``it0`` (and any trailer lines) from an
    append-mode log so that a resumed run appends a monotone trajectory.

    Optimizer-state snapshots ride a wall-clock cadence while log.txt and
    covs.txt get rows every dispatch, so the saved state can lag the logs by
    up to ``ckpt_every_sec``; the resumed run executes those iterations
    again and would otherwise repeat their step indices."""
    if not os.path.exists(path):
        return
    keep = []
    with open(path) as f:
        for line in f:
            parts = line.split(None, 1)
            try:
                step = int(parts[0])
            except (ValueError, IndexError):
                continue
            if step < it0:
                keep.append(line)
    with open(path, "w") as f:
        f.writelines(keep)


def save_optimizer_state(d, carry, it: int):
    """Checkpoint the whole scan-L-BFGS carry (point, gradient, curvature
    memory), each entry at its own dtype, so a run resumes mid-optimization
    on the same trajectory."""
    flat = {k: v.detach().cpu().numpy() for k, v in carry.items()}
    flat["__iter__"] = np.asarray(it)
    np.savez(os.path.join(d, "optimizer_state.npz"), **flat)


def load_optimizer_state(d, device: torch.device | str):
    """(carry on ``device``, it) from a saved optimizer checkpoint, or
    (None, 0).  Each tensor comes back at the dtype it was saved with
    (``first`` and ``valid`` bool, ``head`` int64)."""
    path = os.path.join(d, "optimizer_state.npz")
    if not os.path.exists(path):
        return None, 0
    with np.load(path) as z:
        it = int(z["__iter__"])
        carry = {k: torch.as_tensor(z[k], device=device) for k in z.files if k != "__iter__"}
    return carry, it


def last_accepted(d):
    """The last point a single-start run accepted, whose value its log's
    last row shows: ``x_prev`` of the optimizer state its driver saved in
    ``d``, float64 on the host.  A float64 tail starts here, not at the
    point the driver returns: that is its next proposal, never evaluated,
    and it may lie below the loop's last row."""
    with np.load(os.path.join(d, "optimizer_state.npz")) as z:
        return z["x_prev"].astype(np.float64)


def _host(t):
    """``t`` as a numpy array on the host: a read that waits for the card
    (a ``sync`` span, counted in ``host_syncs``)."""
    fit_counts["host_syncs"] += 1
    with span("sync"):
        return t.cpu().numpy()


def _fc_from_tail(fused, tail, ntheta):
    """The host-side cov row from just the packed-cov tail of theta, through
    the evaluator's own ``unpack_host`` on a zero-padded vector (the X
    segment does not influence FC)."""
    full = np.zeros(ntheta, dtype=np.float64)
    full[ntheta - tail.size:] = tail
    return fused.unpack_host(full)[1]


class _Stall:
    """The one stall rule, over each dispatch's objective values nll
    [R, steps] (R = 1 for a single start): the run stops at the
    ``patience``-th dispatch in a row in which no replica's best value fell
    ``tol`` (relative) below its best so far.  A non-finite value counts as
    +inf: a diverged replica's column improves nothing, its first finite
    value after a restart does."""

    def __init__(self, tol: float, patience: int):
        self.tol, self.patience = tol, patience
        self.best = np.inf  # [R] after the first dispatch
        self.count = 0

    def __call__(self, nll) -> bool:
        best = np.where(np.isfinite(nll), nll, np.inf).min(axis=1)
        with np.errstate(invalid="ignore"):  # inf - inf: a column that never was finite
            improved = np.isfinite(best) & ~(self.best - best < self.tol * (np.abs(self.best)
                                                                             + 1e-12))
        self.best = np.minimum(self.best, best)
        if improved.any():
            self.count = 0
            return False
        self.count += 1
        return self.count >= self.patience


@dataclasses.dataclass
class _Plan:
    """What tells one driver's loop from another's, as data
    (:func:`_dispatch_loop`)."""

    steps: int  # a dispatch
    end: int  # the step index the loop stops before
    maxsec: float
    tol: float  # the stall rule's (:class:`_Stall`)
    patience: int
    # the carry's current point: where a growth restarts it, what a
    # checkpoint saves and what the loop returns
    at: str = "x"
    mode: str = "w"  # of the row files; those of ``files`` open at the start
    files: tuple = ("log.txt",)
    # theta -> (X, FC) of the checkpoints (None: no checkpoints), which come
    # on the cadence and after the last dispatch
    unpack: Callable | None = None
    ckpt_every_sec: float = 10.0
    save_state: bool = False  # the optimizer state at each checkpoint
    trailer: str = "optimization finished after %.fs\n"
    finish: bool = True  # the ``finished`` marker and ``counters.json``


def _point(carry, at):
    """(theta, values) on the host, float64: ``carry[at]`` and None, or for
    replicas the point of the one with the least value ``v``, and every
    replica's value [R]."""
    if carry[at].dim() == 1:
        return _host(carry[at].double()), None
    v = _host(carry["v"].double())
    return _host(carry[at][int(np.argmin(v))].double()), v


def _dispatch_loop(d, fused, plan: _Plan, read, x0, carry=None, it: int = 0):
    """The drivers' one loop over dispatches of the scan-L-BFGS runner on
    ``fused`` (:class:`GrowingRunner`), from x0 [n] or, for R replicas,
    [R, n] (or from a resumed ``carry`` at step ``it``), inside the
    :func:`~gprf_torch.utils.profiling.fit` of the run.

    In each dispatch the driver's ``read(carry, outs, it, grow) -> (carry,
    nll, winner, fc)`` reads the runner's outputs on the host, calls
    ``grow(carry)`` where the capacity overflowed, and returns the steps'
    objective values nll [R, steps], the replica whose column log.txt shows
    and the covs.txt row (None for none).  Replicas also get
    ``multistart.txt``, a column each.  Returns :func:`_point` at
    ``plan.at``."""
    S = plan.steps
    batched = x0.dim() == 2
    with profiling.fit(fused.m, replicas=x0.shape[0] if batched else 1) as fit:
        runner = GrowingRunner(fused, S)
        if carry is None:
            carry = runner.init_fn(x0)
        files = {}

        def write(name, text):
            if name not in files:
                files[name] = open(os.path.join(d, name), plan.mode)
            files[name].write(text)
            files[name].flush()

        for name in plan.files + (("multistart.txt",) if batched else ()):
            write(name, "")
        stalled = _Stall(plan.tol, plan.patience)
        t0 = time.time()
        last_ckpt = -np.inf

        def grow(c):
            return runner.grow(c, at=plan.at)

        def checkpoint(it_base):
            fit_counts["checkpoints"] += 1
            with span("checkpoint"):
                theta, _ = _point(carry, plan.at)
                # never leave a non-finite step_*_X.npy for the analysis to read
                if not np.all(np.isfinite(theta)):
                    raise FloatingPointError("optimizer diverged to non-finite theta")
                X, FC = plan.unpack(theta)
                # the index of this dispatch's last logged row, so the analysis
                # finds a checkpoint for the final step
                save_step(d, it_base + S - 1, X=X, FC=FC)
                if plan.save_state:
                    save_optimizer_state(d, carry, it_base + S)

        try:
            while it < plan.end and time.time() - t0 < plan.maxsec:
                with span("dispatch"):
                    carry, outs = runner.run_fn(carry)
                    carry, nll, winner, fc = read(carry, outs, it, grow)
                    now = time.time() - t0
                    write("log.txt", "".join("%d %.2f %.2f\n" % (it + k, now, -nll[winner, k])
                                             for k in range(S)))
                    if batched:
                        write("multistart.txt", "".join(
                            "%d %.2f %s\n" % (it + k, now, " ".join("%.2f" % -v for v in nll[:, k]))
                            for k in range(S)))
                    if fc is not None:
                        write("covs.txt", "%d %s\n" % (it + S - 1, fc))
                if plan.unpack is not None and now - last_ckpt >= plan.ckpt_every_sec:
                    checkpoint(it)
                    last_ckpt = now
                it += S
                if stalled(nll):
                    break
            if it and plan.unpack is not None:
                checkpoint(it - S)
        finally:
            write("log.txt", plan.trailer % (time.time() - t0))
            for f in files.values():
                f.close()
            if plan.finish:
                with open(os.path.join(d, "finished"), "w") as f:
                    f.write("")
                fit.write(d, fused.m)
        return _point(carry, plan.at)


# ---- the drivers --------------------------------------------------------------------

def do_optimization_fused_theta(d, fused, theta0, maxsec: float = 3600, max_iters: int = 600,
                                steps_per_dispatch: int = 20, ftol: float = 1e-6,
                                resume: bool = False, ckpt_every_sec: float = 10.0,
                                stall_patience: int = 4):
    """Device-loop driver over a theta-packed fused evaluator
    (:class:`~gprf_torch.model.fused.FusedSyntheticGPRF`): log.txt rows per
    L-BFGS iteration, step X / cov checkpoints through the theta unpacking,
    covs.txt for hyperparameter trajectories, the ``finished`` marker, and
    the optimizer state for ``resume``.

    Per dispatch one small tensor crosses to the host: the step values, the
    steps' acceptance, the overflow flag and, on cov-bearing tasks, the cov
    tail of the last evaluated point.  theta and the (memory x n) optimizer
    state cross only on the ``ckpt_every_sec`` cadence and after the last
    dispatch.  Beside ``finished``, in the same ``finally``, the fit's
    counters go to ``counters.json`` (:class:`~gprf_torch.utils.profiling.Fit`).

    When a block outgrows the padded slot count the capacity grows and the
    run goes on from the current point (:class:`GrowingRunner`).  A
    non-finite objective raises ``FloatingPointError``.

    Returns the final flat theta (float64 on the host)."""
    ncov = fused.ncov
    ntheta = int(np.asarray(theta0).size)
    S = steps_per_dispatch
    carry, it = load_optimizer_state(d, fused.device) if resume else (None, 0)
    appending = bool(it)
    if appending:
        _truncate_log_rows(os.path.join(d, "log.txt"), it)
        _truncate_log_rows(os.path.join(d, "covs.txt"), it)

    def read(carry, outs, it, grow):
        step_values, accepted, _, overflow = outs
        # the cov tail of the last EVALUATED point (x_prev; carry["x"] is the
        # next proposal), so the covs.txt row pairs with the logged objective
        out = _host(torch.cat([step_values.double(), accepted.double(),
                               overflow.double().reshape(1),
                               carry["x_prev"][ntheta - ncov:].double()]))
        fit_counts["steps_accepted"] += int(out[S:2 * S].sum())
        tail = out[2 * S + 1:]
        if not np.all(np.isfinite(out[:S])):
            raise FloatingPointError("optimizer diverged to non-finite objective")
        if out[2 * S]:
            carry = grow(carry)
            # as in the reference, the restarted carry's last evaluated
            # point is the current one, and this dispatch's row shows it
            tail = _host(carry["x_prev"][ntheta - ncov:].double())
        return carry, out[None, :S], 0, _fc_from_tail(fused, tail, ntheta) if ncov else None

    plan = _Plan(S, max_iters, maxsec, ftol, stall_patience, mode="a" if appending else "w",
                 files=("log.txt", "covs.txt") if ncov else ("log.txt",),
                 unpack=fused.unpack_host, ckpt_every_sec=ckpt_every_sec, save_state=True)
    x0 = torch.as_tensor(np.asarray(theta0).reshape(-1), dtype=fused.dtype, device=fused.device)
    return _dispatch_loop(d, fused, plan, read, x0, carry, it)[0]


def do_optimization_fused(d, fused, X0, maxsec: float = 3600, max_iters: int = 400,
                          steps_per_dispatch: int = 20, ftol: float = 1e-6,
                          resume: bool = False, ckpt_every_sec: float = 10.0,
                          stall_patience: int = 4):
    """The task=x driver: :func:`do_optimization_fused_theta` over a theta
    that is X alone (no covs.txt).  Returns the final flat X."""
    if fused.task != "x":
        raise ValueError(f"task {fused.task!r} packs more than X: use do_optimization_fused_theta")
    return do_optimization_fused_theta(
        d, fused, np.asarray(X0).reshape(-1), maxsec=maxsec, max_iters=max_iters,
        steps_per_dispatch=steps_per_dispatch, ftol=ftol, resume=resume,
        ckpt_every_sec=ckpt_every_sec, stall_patience=stall_patience)


# ---- multistart: R replicas in one loop ----------------------------------------

def _replica_bad_mask(x, v):
    """[R] bool on the device: the replicas whose proposal or value is not
    finite."""
    return ~(torch.isfinite(x).all(dim=-1) & torch.isfinite(v))


def _sanitize_replicas(carry, bad=None):
    """Restart every replica whose state went non-finite instead of ending
    the run: it resumes from its last evaluated point ``x_prev`` (or the
    best healthy replica's, if that too is not finite) with a cleared
    curvature memory, step scale 0.25 and v = +inf, so it cannot win before
    its next evaluation.  Raises only when no replica is left.  ``bad`` is
    the host copy of :func:`_replica_bad_mask` (computed when omitted).
    Returns (carry, number restarted)."""
    if bad is None:
        bad = _replica_bad_mask(carry["x"], carry["v"]).cpu().numpy()
    if not bad.any():
        return carry, 0
    host = {k: v.cpu().numpy().copy() for k, v in carry.items()}
    prev_ok = np.isfinite(host["x_prev"]).all(axis=1)
    vs = np.where(prev_ok & np.isfinite(host["v"]), host["v"], np.inf)
    donor = int(np.argmin(vs))
    if not np.isfinite(vs[donor]):
        raise FloatingPointError("every replica diverged to non-finite state")
    for r in np.where(bad)[0]:
        src = host["x_prev"][r] if prev_ok[r] else host["x_prev"][donor]
        host["x"][r] = src
        host["x_prev"][r] = src
        host["g"][r] = host["g_prev"][r] = 0.0
        host["v"][r] = host["v_prev"][r] = np.inf
        host["first"][r] = True
        host["eta"][r] = 0.25
        host["S"][r] = host["Ymem"][r] = host["rho"][r] = 0.0
        host["valid"][r] = False
        host["head"][r] = 0
    return ({k: torch.as_tensor(v, device=carry[k].device) for k, v in host.items()},
            int(bad.sum()))


def _check_capacity_all(fused, thetas):
    """True iff the current capacity m holds every replica; one batched
    call where the evaluator has it."""
    batch = getattr(fused, "check_capacity_batch", None)
    if batch is not None:
        return bool(batch(thetas))
    return all(fused.check_capacity(t) for t in thetas)


def _run_multistart(d, fused, theta0s, unpack, write_covs, maxsec, max_iters,
                    steps_per_dispatch, ftol, stall_patience):
    """The multistart driver: R replicas in one runner, the stall rule per
    replica, restarts of diverged replicas, ``multistart.txt`` and the
    standard file protocol written for the currently best replica, whose
    last evaluated point ``x_prev`` (value ``v``) is checkpointed and
    returned.

    Per dispatch the host reads the [R, steps] values and acceptance, the
    health mask (the span ``replica_health``, with the restarts), the [R]
    overflow flags, the values ``v`` and, with covs, the winner's cov tail.
    On an overflow every replica grows together (:class:`GrowingRunner`,
    restarted at ``x_prev``).  In ``counters.json``, ``steps_accepted``
    sums the replicas' accepted steps and ``replica_restarts`` counts the
    restarts."""
    theta0s = np.asarray(theta0s, dtype=np.float64)
    ntheta = theta0s.shape[1]
    S = steps_per_dispatch
    ncov = fused.ncov if write_covs else 0

    def read(carry, outs, it, grow):
        values, accepted, _, overflow = outs
        # [R, steps] nll, then the steps' acceptance
        out = _host(torch.cat([values.double(), accepted.double()], dim=-1))
        fit_counts["steps_accepted"] += int(out[:, S:].sum())
        with span("replica_health"):
            bad = _host(_replica_bad_mask(carry["x"], carry["v"]))
            carry, n_restarted = _sanitize_replicas(carry, bad)
        fit_counts["replica_restarts"] += n_restarted
        if n_restarted:
            print("multistart: restarted %d diverged replica(s)" % n_restarted)
        # a replica just restarted at its last finite point is checked again
        # at the next dispatch
        if (_host(overflow) & ~bad).any():
            carry = grow(carry)
        winner = int(np.argmin(_host(carry["v"].double())))
        fc = None
        if ncov:
            fc = _fc_from_tail(fused, _host(carry["x_prev"][winner, ntheta - ncov:].double()),
                               ntheta)
        return carry, out[:, :S], winner, fc

    plan = _Plan(S, max_iters, maxsec, ftol, stall_patience, at="x_prev",
                 files=("log.txt", "covs.txt") if ncov else ("log.txt",), unpack=unpack)
    x0s = torch.as_tensor(theta0s, dtype=fused.dtype, device=fused.device)
    theta, final_v = _dispatch_loop(d, fused, plan, read, x0s)
    return theta, float(final_v.min()), final_v


def do_optimization_multistart(d, fused, X0s, maxsec: float = 3600, max_iters: int = 400,
                               steps_per_dispatch: int = 20, ftol: float = 1e-6,
                               stall_patience: int = 4):
    """Multistart over a task=x fused loss from starts X0s [R, n, dx]: the
    per-replica objectives in ``multistart.txt``, the winner through the
    standard file protocol.  Returns (best_x, best_v, final_values [R])."""
    X0s = np.asarray(X0s, dtype=np.float64)
    shape = X0s.shape[1:]
    return _run_multistart(d, fused, X0s.reshape(X0s.shape[0], -1),
                           lambda t: (t.reshape(shape), None), False, maxsec, max_iters,
                           steps_per_dispatch, ftol, stall_patience)


def do_optimization_multistart_theta(d, fused, theta0s, maxsec: float = 3600,
                                     max_iters: int = 600, steps_per_dispatch: int = 20,
                                     ftol: float = 1e-6, stall_patience: int = 4):
    """Multistart over a theta-packed fused evaluator (synthetic cov/xcov or
    seismic) from thetas [R, ntheta]: the winner's X and cov trajectory
    through the standard file protocol (log.txt, step checkpoints,
    covs.txt), the per-replica objectives in ``multistart.txt``.  Returns
    (best_theta, best_v, final_values [R])."""
    return _run_multistart(d, fused, theta0s, fused.unpack_host, True, maxsec, max_iters,
                           steps_per_dispatch, ftol, stall_patience)


# ---- the float64 tail ------------------------------------------------------------

def refine_f64(d, make_fused, x32, it0, iters: int = 60, steps_per_dispatch: int = 10,
               maxsec: float = 1800, *, device: torch.device | str | None = None):
    """Float64 refinement phase: rebuild the fused loss at float64 and go on
    optimizing from the float32 solution ``x32`` (the flat X, or the packed
    theta of a cov / xcov / seismic task).  The float32 objective's roundoff
    floors late-stage convergence at large n.

    ``make_fused(torch.float64)`` builds the evaluator; it should take
    :data:`~gprf_torch.ops.mvn.LINALG_OPS`, since the kernels are float32
    only.  The tail runs on that evaluator's device, which is ``device``
    where one is given (else it raises): the card by default, where the
    reference runs its tail on the host CPU because a TPU emulates float64.
    The H100 computes float64 natively.

    As the reference: log.txt rows go on from ``it0``, a step checkpoint
    (and a covs.txt row, the file opened at the first one) per dispatch;
    blocks wider than ``GPRF_REFINE_MAX_M`` (default 512) skip the phase
    with a message and return ``x32``; past m = 512 a dispatch is 2 steps;
    ``GPRF_REFINE_MAXSEC`` overrides ``maxsec``; the phase stops after two
    dispatches in a row that improve the best objective by less than 1e-9
    relative.  Unlike the reference, a block that outgrows the capacity
    grows it (:class:`GrowingRunner`) instead of dropping points.  It
    writes no ``finished`` marker and no ``counters.json``: the run's
    float32 loop wrote them.

    Returns the final flat vector (float64 on the host)."""
    maxsec = float(os.environ.get("GPRF_REFINE_MAXSEC", maxsec))
    fused = make_fused(torch.float64)
    if device is not None and fused.device != torch.device(device):
        raise ValueError(f"make_fused built the evaluator on {fused.device}, not on {device}")
    max_m = int(os.environ.get("GPRF_REFINE_MAX_M", 512))
    if fused.m > max_m:
        print("refine_f64: block width m=%d exceeds the cap %d; "
              "skipping the f64 phase (raise GPRF_REFINE_MAX_M to force)" % (fused.m, max_m))
        return np.asarray(x32)
    if fused.m > 512:
        # a dispatch of ten wide-m steps would overrun the time budget's cadence
        steps_per_dispatch = min(steps_per_dispatch, 2)
    print("refine_f64: running the f64 tail on %s" % (fused.device,))
    S = steps_per_dispatch

    def read(carry, outs, it, grow):
        step_values, _, _, overflow = outs
        out = _host(torch.cat([step_values, overflow.double().reshape(1)]))
        if out[S]:
            carry = grow(carry)
        # a step file every dispatch, inside it
        X, FC = fused.unpack_host(_host(carry["x"]))
        save_step(d, it + S - 1, X=X, FC=FC)
        return carry, out[None, :S], 0, FC

    plan = _Plan(S, it0 + iters, maxsec, 1e-9, 2, mode="a",
                 trailer="f64 refinement finished after %.fs\n", finish=False)
    x0 = torch.as_tensor(np.asarray(x32, dtype=np.float64), device=fused.device)
    return _dispatch_loop(d, fused, plan, read, x0, it=it0)[0]
