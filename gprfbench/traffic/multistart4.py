"""The seismic mix's engine: fits of ``gprf_torch.cli.run_seismic
--engine device --multistart R``, built as its ``do_run`` builds them
(``build_problem``, ``build_engine``, ``multistart_thetas``) and run by
``do_optimization_multistart_theta``, each job at its own ``--seed``: its
observation noise and its replicas' jitter.

The compared point is the winner's last evaluated point, value and
gradient (``x_prev``, ``v_prev``, ``g_prev``) of one replica of the one
runner carry that the loop holds after its last dispatch: the carry of its
last ``run_fn`` output, or of a capacity growth after it, which evaluates
again at ``x_prev``.  The winner is the replica the driver returns, the
lowest value among the replicas whose state is finite.  The multistart
driver writes no ``optimizer_state.npz``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import torch

from gprfbench import jobs
from gprfbench.data import JOB, WARM
from gprfbench.trace import Tracer


def winner(carry) -> int:
    """The replica whose state is finite with the lowest value."""
    ok = (torch.isfinite(carry["x"]).all(dim=-1) & torch.isfinite(carry["v"])
          & torch.isfinite(carry["x_prev"]).all(dim=-1))
    v = torch.where(ok, carry["v"].double(), torch.full_like(carry["v"], float("inf")).double())
    return int(torch.argmin(v))


def triple(carry):
    """(x_prev, v_prev, g_prev) of the winner, on the host (float64)."""
    r = winner(carry)
    return (carry["x_prev"][r].double().cpu().numpy(), float(carry["v_prev"][r]),
            carry["g_prev"][r].double().cpu().numpy())


class MultistartEngine(jobs.Engine):
    """``jobs.Engine`` with the seismic command line's build and its
    multistart driver."""

    def __init__(self, problem, traffic: dict, device: torch.device):
        self.problem = problem
        self.traffic = traffic
        self.device = device
        self.m = problem.config["assumed"].get("m")
        self.job = None
        self.carry = None  # the running job's runner carry after its last dispatch

    def _args(self, job_seed: int, data_dir: str):
        from gprf_torch.cli.run_seismic import build_parser

        cfg = self.problem.config
        return build_parser().parse_args([
            "--npts=-1", "--obs_std=%r" % cfg["obs_std"], "--threshold=%r" % cfg["threshold"],
            "--rpc_blocksize=%d" % cfg["rpc_blocksize"], "--task=%s" % cfg["task"],
            "--synth_lscale=%r" % cfg["synth_lscale"], "--engine=device",
            "--multistart=%d" % cfg["replicas"], "--seed=%d" % job_seed,
            "--data_dir=%s" % data_dir])

    def fit(self, job, maxsec: float, tracer: Tracer, loop: dict | None = None,
            steps_per_dispatch: int | None = None):
        """One fit of ``job``, stopping through the loop's ``maxsec``."""
        from gprf_torch.cli.run_seismic import build_engine, build_problem, multistart_thetas
        from gprf_torch.optim.lbfgs import do_optimization_multistart_theta

        self.job, self.carry = job, None
        tag = (JOB, job.index) if job.index >= 0 else (WARM,)
        job_seed = self.problem.job_seed(*tag)
        t_build = time.perf_counter()
        with tracer.span("job_build"):
            args = self._args(job_seed, self.problem.data_dir(job.dir, job_seed))
            p = build_problem(args, device=self.device, dtype=torch.float32)
            if not np.array_equal(p["means"], job.X_obs):
                raise ValueError("the command line observed other locations than the job")
            fused = build_engine(args, p, device=self.device, dtype=torch.float32, m=self.m)
            theta0 = fused.theta0(p["X0"], p["C0"])
            theta0s = multistart_thetas(theta0, args.task, p["means"].size, args.multistart,
                                        args.seed)
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
        theta, _, _ = do_optimization_multistart_theta(
            job.dir, fused, theta0s, maxsec=maxsec - (t_loop - job.t_start), **loop, **kwargs)
        job.x_final = fused.unpack_host(theta)[0]
        job.m_end = fused.m
        job.last = None if self.carry is None else triple(self.carry)
        self.carry = None

    def warm_up(self, root: str):
        """One short fit at the cell's shapes (2 steps, all replicas)."""
        job = jobs.Job(-1, self.problem.x_obs(WARM), os.path.join(root, "warm"))
        os.makedirs(job.dir)
        job.t_start = time.perf_counter()
        self.fit(job, maxsec=1e9, tracer=Tracer(False, 0.0, self.device),
                 loop={"max_iters": 2}, steps_per_dispatch=2)
        jobs._sync(self.device)
        shutil.rmtree(job.dir)

    def last_state(self, job):
        """(theta, value, gradient) of the winner's last evaluated point
        (module docstring), or None where the job ran no dispatch."""
        return getattr(job, "last", None)

    @contextlib.contextmanager
    def instrumented(self, tracer: Tracer, kernel_calls: list):
        """``jobs.Engine.instrumented``, and the runner carry that each
        dispatch and each capacity growth hands back to the driver."""
        from gprf_torch.optim import lbfgs

        def runner(make):
            def inner(*args, **kwargs):
                init_fn, run_fn = make(*args, **kwargs)

                def run(carry):
                    carry, outs = run_fn(carry)
                    self.carry = carry
                    return carry, outs
                return init_fn, run
            return inner

        def grow(orig):
            def inner(runner_, carry, at="x"):
                carry = orig(runner_, carry, at)
                self.carry = carry
                return carry
            return inner

        with super().instrumented(tracer, kernel_calls), \
                jobs._patched(lbfgs, "make_scan_lbfgs_runner", runner), \
                jobs._patched(lbfgs.GrowingRunner, "grow", grow):
            yield


def make_engine(problem, traffic: dict, device: torch.device):
    return MultistartEngine(problem, traffic, device)
