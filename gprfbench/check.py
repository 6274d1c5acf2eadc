"""What decides ``correct``: what the timed path produced, held against the
plain reference (``Problem.ref_loss``, ``reference.py``) once the window
has closed.

The value and gradient at the last point that each job's loop evaluated,
as the engine reads them from the loop's own output (``Engine.last_state``),
for every job of the window, or for six of them drawn from the seed, the
first and the last among them.

Numbers, each the worst over the jobs compared:

- ``loss_gap``: |loss - reference| / |reference|;
- ``grad_gap``: |gradient - reference| / |reference's likelihood
  gradient| (the total gradient vanishes at an optimum, its likelihood part
  does not);
- ``progress``: (reference at X_obs - reference at the job's last point)
  per observed value (n dy), in nats, which a fit that never moves reads
  as 0.  The window's last job is left out of it only where the window cut
  it before its second dispatch.

A number passes when it is at most its limit (``progress``: at least).
The control (``control=True``) computes the reference in TF32 in the
program's place and reads the same gaps against the float64 reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gprfbench import data as bdata
from gprfbench import reference as ref

AT_LEAST = ("progress",)
SAMPLE_JOBS = 6


def _gaps(v, g, r: ref.Loss):
    loss_gap = abs(v - r.value) / abs(r.value)
    g = torch.as_tensor(g, dtype=torch.float64, device=r.grad.device).reshape(-1)
    return {"loss_gap": loss_gap,
            "grad_gap": float(torch.linalg.vector_norm(g - r.grad)) / r.ll_grad_norm}


def _sample(problem, jobs):
    """Every job, or past ``SAMPLE_JOBS`` of them the first and the last
    with others drawn from the seed."""
    if len(jobs) <= SAMPLE_JOBS:
        return jobs
    rng = np.random.default_rng(bdata.stream_seed(problem.seed, bdata.SAMPLE))
    inner = rng.choice(np.arange(1, len(jobs) - 1), size=SAMPLE_JOBS - 2, replace=False)
    return [jobs[i] for i in sorted({0, len(jobs) - 1, *inner.tolist()})]


def _cut_at_start(job, window) -> bool:
    return job is window.jobs[-1] and not job.completed and job.dispatches < 2


def readings(problem, engine, window, control: bool = False, per_job: list | None = None) -> dict:
    """The compared numbers of this window (the control's, with
    ``control``; the control reads no progress).  ``per_job``, where
    given, receives each compared job's numbers."""
    worst = {}

    def keep(name, value, worse=max):
        worst[name] = value if name not in worst else worse(worst[name], value)

    for job in _sample(problem, window.jobs):
        state = engine.last_state(job)
        if state is None:
            continue
        X, v, g = state
        r = problem.ref_loss(X, job.X_obs, grad=True)
        if control:
            c = problem.ref_loss(X, job.X_obs, grad=True, control=True)
            v, g = c.value, c.grad
        numbers = _gaps(v, g, r)
        if not control and not _cut_at_start(job, window):
            start = problem.ref_loss(job.X_obs, job.X_obs, grad=False).value
            numbers["progress"] = (start - r.value) / problem.Y.size
        for k, x in numbers.items():
            keep(k, x, min if k in AT_LEAST else max)
        if per_job is not None:
            per_job.append({"job": job.index, "evals": job.evals, "completed": job.completed,
                            **numbers})
    return worst


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = values.get(name)
        good = value is not None and np.isfinite(value) and (
            value >= limit if name in AT_LEAST else value <= limit)
        ok &= bool(good)
        checks[name] = {"value": None if value is None else float(value), "limit": limit}
    return ok, checks
