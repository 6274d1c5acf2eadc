"""factor_busy_ms: device milliseconds an evaluation, in the traced window,
of the kernels launched while the program's ``unary_factor`` span was open
(the unary pass's factorization of the blocks: ``chol_inv_split``, or
``cholesky_split`` and the doubling inverse).  Each kernel is placed by the
host time of its launch: the CUDA runtime call that shares its correlation
id, else the start of the operator that launched it.  The backward's
kernels are launched outside the span and are not counted.  None where the
program records no such span."""

import bisect

import torch

from gprfbench.program_spans import _recorded_spans
from gprfbench.trace import COPY_PREFIXES

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def factor_device_ns(events, spans) -> int:
    """Device ns of the kernels among the profiler's ``events`` (kineto
    events) whose launch falls inside one of ``spans`` [(start_ns, end_ns)],
    which do not overlap."""
    spans = sorted(spans)
    starts = [a for a, _ in spans]
    cuda = torch.autograd.DeviceType.CUDA
    launches, ops, kernels = {}, {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith(COPY_PREFIXES):
                kernels.append(e)
        elif name.startswith(LAUNCHES):
            launches[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
    total = 0
    for k in kernels:
        t = launches.get(k.correlation_id())
        if t is None:
            t = ops.get(k.linked_correlation_id())
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            total += k.duration_ns()
    return total


def read(ctx):
    if ctx.trace is None or ctx.tracer is None or ctx.tracer.prof is None:
        return None
    spans = [(s.start_ns, s.end_ns) for s in _recorded_spans() or ()
             if s.name == "unary_factor" and s.end_ns is not None]
    if not spans or not ctx.trace["evals"]:
        return None
    events = ctx.tracer.prof.profiler.kineto_results.events()
    return factor_device_ns(events, spans) / 1e6 / ctx.trace["evals"]
