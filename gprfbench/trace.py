"""The traced window: ``torch.profiler`` from the window's second dispatch
(so that neither the first job's build nor its first evaluation falls in
it) for ``seconds`` and at least ``MIN_EVALS`` evaluations, stopped at an
evaluation boundary after the device has drained, and its reduction to what
the per-layer readers take.

Device time counts the profiler's kernel events, without copies or memsets
(the reduction of ``gprf_torch/bench.py::kernel_events``); the device is
busy wherever any device operation (kernel, copy or memset) runs.  The host
enqueues work through the CUDA runtime calls counted in ``ENQUEUE``.  An
idle gap is named by what the host was doing when it began: the
benchmark's own span around the call into the program (``bench.*``) and the
innermost host operation inside it.  The profiler is warmed in set-up (its
first start in a process takes seconds) and starts before the window's
clock; its stop falls inside a traced run's window, between ``t_stop`` and
``t_resume``.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

ENQUEUE = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
           "cudaGraphLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
COPY_PREFIXES = ("Memcpy", "Memset")
LABELLED_GAP_US = 50.0  # gaps shorter than this are summed as one entry
TOP = 10
MIN_EVALS = 40  # two dispatches of the device loop: at 80k ~11 s, at 10k under 3 s


class Tracer:
    """Arm with :meth:`start` at the window's start; call
    :meth:`before_dispatch` before each dispatch of the optimizer and
    :meth:`tick` before each evaluation.  The profiler starts before the
    window's second dispatch and stops at the first tick ``seconds`` and
    ``MIN_EVALS`` evaluations after that (or at :meth:`finish`).  A
    disabled tracer does nothing."""

    def __init__(self, enabled: bool, seconds: float, device: torch.device,
                 min_evals: int = MIN_EVALS):
        self.enabled = enabled
        self.seconds = seconds
        self.min_evals = min_evals
        self.device = device
        self.prof = None
        self.armed = False
        self.active = False
        self.dispatches = 0
        self.evals = 0
        self.t_start = self.t_stop = self.t_resume = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop the profiler once in set-up: its first start in a
        process takes seconds."""
        if not self.enabled:
            return
        with self._profile():
            torch.ones(8, device=self.device).sum().item()

    def start(self):
        self.armed = self.enabled

    def before_dispatch(self):
        if not self.armed:
            return
        self.dispatches += 1
        if self.dispatches < 2:
            return
        self.armed = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof = self._profile()
        self.prof.start()
        self.active = True
        self.t_start = time.perf_counter()

    def tick(self):
        if not self.active:
            return
        if (time.perf_counter() - self.t_start >= self.seconds
                and self.evals >= self.min_evals):
            self.finish()
        else:
            self.evals += 1

    def finish(self):
        self.armed = False
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        self.prof.stop()
        self.active = False
        self.t_resume = time.perf_counter()

    def span(self, name: str):
        """A host span visible in the trace (``bench.<name>``)."""
        return torch.profiler.record_function("bench." + name)


def _union(intervals):
    """Merged [start, end] intervals of a start-sorted list."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(tracer: Tracer) -> dict | None:
    """The traced window's summary (times in seconds), or None when nothing
    was traced: ``window_s``, ``busy_s``, ``evals``, ``kernels`` [(name,
    seconds)], ``enqueue_calls``, ``device_ops`` and ``idle_gaps`` (the
    result line's breakdown lists)."""
    if tracer.prof is None or tracer.t_stop is None:
        return None
    events = tracer.prof.events()
    dev_type = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        s, d = e.time_range.start, e.time_range.end - e.time_range.start
        if e.device_type == dev_type and e.name.startswith("bench."):
            continue  # a span's mirror on the device timeline, not work
        if e.device_type == dev_type:
            device.append((s, s + d, e.name))
        else:
            host.append((s, s + d, e.name))
    if not host:
        return None
    device.sort()
    host.sort()
    t0 = min(host[0][0], device[0][0] if device else host[0][0])
    window_us = (tracer.t_stop - tracer.t_start) * 1e6
    t1 = t0 + window_us
    kernels = [(n, (e - s) / 1e6) for s, e, n in device if not n.startswith(COPY_PREFIXES)]
    busy = _union([[s, e] for s, e, _ in device])
    busy_us = sum(e - s for s, e in busy)
    enqueue = sum(1 for _, _, n in host if n.startswith(ENQUEUE))

    by_kernel = defaultdict(float)
    for n, sec in kernels:
        by_kernel[n] += sec
    device_ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]

    # idle gaps, each named by the bench span and innermost host op at its start
    spans = [(s, e, n) for s, e, n in host if n.startswith("bench.")]
    ops = [(s, e, n) for s, e, n in host
           if not n.startswith("bench.") and not n.startswith(ENQUEUE)]
    op_starts = [s for s, _, _ in ops]
    gaps, edge = [], t0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    by_gap = defaultdict(float)
    for g0, g1 in gaps:
        dur = (g1 - g0) / 1e6
        if (g1 - g0) < LABELLED_GAP_US:
            by_gap["gaps under %d us" % LABELLED_GAP_US] += dur
            continue
        span = min((x for x in spans if x[0] <= g0 < x[1]), key=lambda x: x[1] - x[0],
                   default=None)
        k = bisect.bisect_right(op_starts, g0)
        inner = None
        for s, e, n in reversed(ops[max(0, k - 4000):k]):
            if e > g0 and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, n)
        label = "%s: %s" % (span[2] if span else "loop", inner[2] if inner else "no host op")
        by_gap[label] += dur
    idle_gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": window_us / 1e6,
        "busy_s": busy_us / 1e6,
        "evals": tracer.evals,
        "kernels": kernels,
        "enqueue_calls": enqueue,
        "device_ops": [[n, s] for n, s in device_ops],
        "idle_gaps": [[n, s] for n, s in idle_gaps],
    }
