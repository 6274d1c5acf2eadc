"""Profiling and step timing (mirror of ``gprf_tpu/utils/profiling.py``).

:func:`device_trace` records the device timeline with ``torch.profiler``
(where the reference uses ``jax.profiler``) and writes a Chrome trace;
:class:`SectionTimer` accumulates host-side phase times in the drivers.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block, written into ``log_dir`` as
    ``trace-<pid>-<ns>.json`` (Chrome's trace format, which Perfetto
    reads); a no-op for ``log_dir=None``.  It records the CPU, and the CUDA
    kernels where there is a CUDA device."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class SectionTimer:
    """Accumulating named section timer for host-side phase breakdowns."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "; ".join("%s %.3fs/%d" % (k, v, self.counts[k]) for k, v in rows)
