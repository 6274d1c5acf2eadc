"""The program's own spans in a traced run, for the per-layer metrics that
read them (``metrics/eval_host_ms.py``, ``sync_wait_ms.py``,
``update_host_ms.py``, ``idle_unspanned_share.py``), and the program's
per-fit counters (``metrics/accepted_share.py``).

``gprf_torch.utils.profiling`` records a span (name, start and end on the
Unix epoch clock, parent, fit, evaluation) only while a ``torch.profiler``
records.  The profiler stamps its events on the same clock and gives them
relative to ``kineto_results.trace_start_ns()``, so the spans are put on
the trace's time base with nothing but a subtraction.  The window is the
one ``trace.reduce`` takes: from the first event, ``window_s`` long; a span
is clipped at its edges.

Each device-idle gap of the window (between the profiler's kernel, copy
and memset events, without the ``bench.`` mirrors and user annotations) is
put down to the innermost span open where it begins, every gap at its
length.  A program that records no spans (an earlier commit) reads None,
and so do its metrics; nothing here raises for it.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict

import torch

OUTSIDE = "outside every span"


def _recorded_spans():
    """The program's recorded spans, or None where it records none."""
    try:
        from gprf_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded()


def _busy(events, dev_type):
    """Merged [start, end] intervals (us) of the device's work."""
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == dev_type and not e.name.startswith("bench.")
                    and not getattr(e, "is_user_annotation", False))
    out = []
    for s, e in device:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans, points):
    """For each of the sorted ``points``, the innermost of the nested
    ``spans`` [(start, end, name)] open there (start <= point < end), or
    None."""
    order = sorted(spans, key=lambda x: (x[0], -x[1]))
    stack, k, out = [], 0, []
    for p in points:
        while k < len(order) and order[k][0] <= p:
            while stack and stack[-1][1] <= order[k][0]:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce(tracer, trace) -> dict | None:
    """The program's spans in the traced window: ``evals``, ``spans`` (how
    many), ``span_s`` {name: seconds inside the window}, ``span_n``
    {name: count}, ``idle_s`` and ``idle_by_span`` {innermost span at the
    gap's start: idle seconds}; None where nothing was recorded."""
    recorded = _recorded_spans()
    if not recorded or trace is None or tracer.prof is None:
        return None
    prof = tracer.prof
    base_ns = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    dev_type = torch.autograd.DeviceType.CUDA
    busy = _busy(events, dev_type)
    host0 = min((e.time_range.start for e in events if e.device_type != dev_type), default=None)
    if host0 is None:
        return None
    t0 = min(host0, busy[0][0]) if busy else host0
    t1 = t0 + trace["window_s"] * 1e6

    spans = []
    for s in recorded:
        a = (s.start_ns - base_ns) / 1e3
        b = t1 if s.end_ns is None else (s.end_ns - base_ns) / 1e3
        a, b = max(a, t0), min(b, t1)
        if a < b:
            spans.append((a, b, s.name))
    if not spans:
        return None
    span_s, span_n = defaultdict(float), defaultdict(int)
    for a, b, name in spans:
        span_s[name] += (b - a) / 1e6
        span_n[name] += 1

    gaps, edge = [], t0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, min(s, t1)))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    gaps = [(a, b) for a, b in gaps if a < b]
    idle_by_span = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(spans, [a for a, _ in gaps])):
        idle_by_span[name or OUTSIDE] += (b - a) / 1e6
    return {"evals": trace["evals"], "spans": len(spans), "span_s": dict(span_s),
            "span_n": dict(span_n), "idle_s": sum(idle_by_span.values()),
            "idle_by_span": dict(sorted(idle_by_span.items(), key=lambda kv: -kv[1]))}


def summary(ctx) -> dict | None:
    """:func:`reduce` of ``ctx``'s traced window, computed once a run (and
    written once to standard error as ``program spans: {...}``)."""
    if ctx.trace is None or ctx.tracer is None:
        return None
    if not hasattr(ctx.tracer, "program_spans"):
        ctx.tracer.program_spans = reduce(ctx.tracer, ctx.trace)
        if ctx.tracer.program_spans is not None:
            print("program spans: " + json.dumps(ctx.tracer.program_spans), file=sys.stderr,
                  flush=True)
    return ctx.tracer.program_spans


def per_eval_ms(ctx, *names) -> float | None:
    """Milliseconds an evaluation of the window inside the spans ``names``."""
    s = summary(ctx)
    if s is None or not s["evals"]:
        return None
    return sum(s["span_s"].get(n, 0.0) for n in names) / s["evals"] * 1e3


def fit_counters(ctx) -> list[dict]:
    """The ``counters.json`` of each job of the window that wrote one."""
    out = []
    for job in ctx.window.jobs:
        path = os.path.join(job.dir, "counters.json")
        if os.path.exists(path):
            with open(path) as f:
                out.append(json.load(f))
    return out
