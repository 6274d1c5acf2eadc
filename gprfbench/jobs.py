"""The closed loop: whole fits, back to back, until the window ends.

A job is one fit from a fresh X_obs, run through the program's own
optimization loop by an engine.  The default engine, :class:`Engine`, is
the one of the mixes whose ``engine`` is ``device``: ``do_optimization_fused``
over ``FusedSyntheticGPRF``, built as ``gprfopt --engine device`` builds it.
A mix that needs another brings ``traffic/<mix>.py`` with
``make_engine(problem, traffic, device)``, returning an object with the
methods of :class:`Engine` (``fit``, ``warm_up``, ``last_state``,
``instrumented``), as a subclass of it may; :func:`make_engine` finds it.

Each job builds its engine inside the window, since a user pays that once
a fit, and writes its run directory under ``TMPDIR``.  The job that runs
when the window ends stops through the loop's own ``maxsec``; the window
runs to the end of that job and counts every evaluation done in it.

The benchmark counts evaluations by wrapping the engine's loss on the
instance, and times each job's build and checkpoints, so that the window
splits into build, checkpoint and the optimizer's loop
(:meth:`Window.attribution`).  In a traced run it also puts its own spans
around the calls into the program (``trace.Tracer.span``) and records the
shape of every call of the K1-K3 wrappers.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from gprfbench import data as bdata
from gprfbench import spec
from gprfbench.trace import Tracer


@dataclass
class Job:
    index: int
    X_obs: np.ndarray
    dir: str
    evals: int = 0
    eval_times: list = field(default_factory=list)
    t_start: float = 0.0
    t_end: float = 0.0
    x_final: np.ndarray | None = None
    error: str | None = None
    completed: bool = False
    m_end: int | None = None
    build_s: float = 0.0  # the engine's build, inside the window
    ckpt_s: float = 0.0  # the loop's checkpoint writes
    dispatches: int = 0

    @property
    def loop_s(self) -> float:
        """The rest of the job's time: the optimizer's dispatches and
        their synchronizations."""
        return self.t_end - self.t_start - self.build_s - self.ckpt_s


@dataclass
class Window:
    t_start: float
    t_end: float
    jobs: list
    kernel_calls: list  # (wrapper, B, m, dy) in the traced window

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    @property
    def evals(self) -> int:
        return sum(j.evals for j in self.jobs)

    def attribution(self) -> dict:
        """The window's seconds split into the jobs' builds, checkpoints
        and loops, and the loop's milliseconds an evaluation."""
        build = sum(j.build_s for j in self.jobs)
        ckpt = sum(j.ckpt_s for j in self.jobs)
        loop = sum(j.loop_s for j in self.jobs)
        return {"window_s": self.seconds, "build_s": build, "ckpt_s": ckpt, "loop_s": loop,
                "loop_ms_per_eval": loop / max(self.evals, 1) * 1e3}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _patched(obj, name, wrap):
    """``obj.name`` replaced by ``wrap(original)`` for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


class Engine:
    """The program's device engine, built as ``gprf_torch.cli.gprfopt
    --engine device`` builds it.  ``device`` is where the objective runs;
    the program is imported here and nowhere else in the harness.  The
    start capacity is the configuration's ``assumed.m`` where it names
    one, else the program's own rule (the largest block at X_obs, rounded
    up to 8)."""

    def __init__(self, problem: bdata.Problem, traffic: dict, device: torch.device):
        from gprf_torch.kernels.gpcov import GPCov

        self.problem = problem
        self.traffic = traffic
        self.device = device
        cfg = problem.config
        self.m = cfg["assumed"].get("m")
        self.cov = GPCov.create([cfg["signal_var"]], [cfg["lscale"]] * cfg["dx"], "euclidean",
                                "se", device="cpu", dtype=torch.float64)
        self.job = None  # the job that runs

    def fit(self, job: Job, maxsec: float, tracer: Tracer, loop: dict | None = None,
            steps_per_dispatch: int | None = None):
        """One fit of ``job``, stopping through the loop's ``maxsec``."""
        from gprf_torch.model.fused import FusedSyntheticGPRF
        from gprf_torch.optim.lbfgs import do_optimization_fused

        p, cfg = self.problem, self.problem.config
        self.job = job
        t_build = time.perf_counter()
        with tracer.span("job_build"):
            fused = FusedSyntheticGPRF(
                job.X_obs, p.Y, p.edges, job.X_obs, cfg["obs_std"], self.cov, cfg["noise_var"],
                task="x", centers=p.centers, m=self.m, device=self.device, dtype=torch.float32,
                acc_dtype=torch.float64)
        make_loss = fused.loss_fn

        def counted_loss():
            loss = make_loss()

            def counted(theta):
                tracer.tick()
                job.evals += 1
                job.eval_times.append(time.perf_counter())
                return loss(theta)
            return counted

        fused.loss_fn = counted_loss
        loop = dict(self.traffic["loop"] if loop is None else loop)
        t_loop = time.perf_counter()
        job.build_s += t_loop - t_build
        kwargs = {} if steps_per_dispatch is None else {"steps_per_dispatch": steps_per_dispatch}
        job.x_final = do_optimization_fused(
            job.dir, fused, job.X_obs, maxsec=maxsec - (t_loop - job.t_start), **loop, **kwargs)
        job.m_end = fused.m

    def warm_up(self, root: str):
        """One short job at the cell's shapes: the kernel library, the
        libraries' handles and every shape of a dispatch and a checkpoint."""
        job = Job(-1, self.problem.x_obs(bdata.WARM), os.path.join(root, "warm"))
        os.makedirs(job.dir)
        job.t_start = time.perf_counter()
        self.fit(job, maxsec=1e9, tracer=Tracer(False, 0.0, self.device),
                 loop={"max_iters": 2}, steps_per_dispatch=2)
        _sync(self.device)
        shutil.rmtree(job.dir)

    def last_state(self, job: Job):
        """(X, value, gradient) of the last point that ``job``'s loop
        evaluated, from its own checkpoint ``optimizer_state.npz``
        (``x_prev``, ``v_prev``, ``g_prev``; ``x`` is the pending proposal,
        whose value nobody computed), or None where it wrote none."""
        path = os.path.join(job.dir, "optimizer_state.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return z["x_prev"].reshape(self.problem.SX.shape), float(z["v_prev"]), z["g_prev"]

    # ---- what the harness reads of the loop ------------------------------------

    @contextlib.contextmanager
    def instrumented(self, tracer: Tracer, kernel_calls: list):
        """The running job's dispatches and checkpoint time, the trace's
        start after the window's first dispatch and, in a traced run only,
        spans around the calls into the program's layers and the shapes of
        the K1-K3 wrapper calls."""
        from gprf_torch.ops import mvn
        from gprf_torch.optim import lbfgs

        traced = tracer.enabled

        def span(name, fn):
            if not traced:
                return fn

            def inner(*args, **kwargs):
                with tracer.span(name):
                    return fn(*args, **kwargs)
            return inner

        def runner(make):
            def inner(*args, **kwargs):
                init_fn, run_fn = make(*args, **kwargs)
                dispatch = span("dispatch", run_fn)

                def counted(carry):
                    self.job.dispatches += 1
                    tracer.before_dispatch()
                    return dispatch(carry)
                return span("init_eval", init_fn), counted
            return inner

        def timed(fn):
            fn = span("checkpoint", fn)

            def inner(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.job.ckpt_s += time.perf_counter() - t0
            return inner

        def shapes(wrapper):
            def wrap(fn):
                def inner(*args):
                    if tracer.active:
                        A = args[0]
                        dy = args[1].shape[-1] if len(args) > 1 else 0
                        kernel_calls.append((wrapper, A.shape[0], A.shape[-1], dy))
                    return fn(*args)
                return inner
            return wrap

        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(lbfgs, "make_scan_lbfgs_runner", runner))
            for name in ("save_step", "save_optimizer_state"):
                stack.enter_context(_patched(lbfgs, name, timed))
            if traced:
                for w in ("chol_inv", "mvn_ll", "tri_inv"):
                    stack.enter_context(_patched(mvn, w, shapes(w)))
            yield


def make_engine(cell, problem, device: torch.device):
    """The engine of ``cell``'s mix: ``make_engine`` of ``traffic/<mix>.py``
    where the mix has one, else :class:`Engine` for ``engine: device``."""
    if cell.traffic_module is not None:
        module = spec.load_module(cell.traffic_module, "gprfbench_mix_" + cell.traffic["name"])
        return module.make_engine(problem, cell.traffic, device)
    if cell.traffic["engine"] != "device":
        raise ValueError("mix %r: engine %r needs traffic/%s.py with make_engine"
                         % (cell.traffic["name"], cell.traffic["engine"], cell.traffic["name"]))
    return Engine(problem, cell.traffic, device)


def run_window(engine: Engine, problem: bdata.Problem, seconds: float, tracer: Tracer,
               root: str) -> Window:
    """Jobs back to back for ``seconds``; the last stops through the
    loop's ``maxsec``."""
    jobs, kernel_calls = [], []
    with engine.instrumented(tracer, kernel_calls):
        _sync(engine.device)
        tracer.start()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            j = len(jobs)
            job = Job(j, problem.x_obs(bdata.JOB, j), os.path.join(root, "job%03d" % j))
            os.makedirs(job.dir)
            job.t_start = time.perf_counter()
            try:
                engine.fit(job, maxsec=deadline - job.t_start, tracer=tracer)
            except (FloatingPointError, RuntimeError, ValueError) as exc:
                job.error = "%s: %s" % (type(exc).__name__, exc)
            _sync(engine.device)
            job.t_end = time.perf_counter()
            job.completed = job.error is None and job.t_end < deadline
            jobs.append(job)
        t_end = time.perf_counter()
        tracer.finish()
    return Window(t_start, t_end, jobs, kernel_calls)
