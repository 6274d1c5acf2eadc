"""Tracing of the port's device loop: host spans, counters and the device
trace.

**Spans.** ``with span(name):`` marks a stretch of host time at a layer
boundary (the driver, the runner, the fused loss).  A span is recorded only
while a ``torch.profiler`` records; otherwise :func:`span` returns one
shared null context and reads no clock.  A recorded span (read back as
:class:`Span` objects through :func:`recorded`) is stamped with
``time.time_ns()``, the Unix epoch clock on which the profiler stamps its own events
(``kineto_results.trace_start_ns()`` and each event's ``start_ns()``), so
the spans fall on the device trace's time base.  Its parent is the
innermost recorded span open at its start, across threads: the autograd
engine runs a CUDA backward on a thread of its own while the caller waits
inside its ``backward`` span.  A span that was open when the profiler
started is not recorded, and its children carry no parent.  Spans call no
``record_function``, touch no device and never synchronize, so they add
nothing to the profiler's host or device timelines.

**Counters.** :data:`counters` holds groups of host integers, always on,
that nothing fills by reading a device tensor: ``counters["launches"]``
(``gprf_torch.ops._build.launch_counts``, kernel launches per wrapper:
K1-K5, and the SE kernel matrices' ``se_kernel`` and ``se_kernel_bwd``) and
``counters["fit"]`` (:data:`fit_counts`, the running fit's).  A driver
opens each fit with :func:`fit`, which gives it a new id, zeroes
:data:`fit_counts` and, through :meth:`Fit.write`, puts the fit's counters
into its run directory as ``counters.json``.  Among them, the Schur
objective counts the pair passes, their chunks and their zero-weight dummy
edges where it picks its path, and the multistart driver the replicas it
restarted after they diverged (0 on a single-start fit).

**The device trace.** :func:`device_trace` records the block with
``torch.profiler`` and writes a Chrome trace (Perfetto reads it) with the
recorded spans on a track of their own above the kernels.
:func:`kernel_events` and :func:`device_busy` read the kernels of a few
loss+gradient calls from such a trace, and :func:`splits_at` names the
compositions that split at a block width.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

FIT_COUNTERS = ("evaluations", "steps", "steps_accepted", "dispatches", "host_syncs",
                "capacity_growths", "checkpoints", "pair_passes", "pair_chunks",
                "pair_dummy_edges", "pair_schur_blocked", "replica_restarts")
SPAN_TRACK = "gprf_torch spans"


class Span:
    """One recorded span: ``index`` its place in the record, ``start_ns``
    and ``end_ns`` on the Unix epoch clock (``end_ns`` None while open),
    ``parent`` the index of the innermost recorded span open at its start
    (None where there was none), ``fit`` the id of the running fit and
    ``evaluation`` its evaluation count at the start."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "fit", "evaluation")

    def __init__(self, index, name, start_ns, end_ns, parent, fit, evaluation):
        self.index = index
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.parent = parent
        self.fit = fit
        self.evaluation = evaluation

    def __repr__(self):
        return "Span(%d, %r, %d, %s, parent=%s, fit=%d, evaluation=%d)" % (
            self.index, self.name, self.start_ns, self.end_ns, self.parent, self.fit,
            self.evaluation)


# The record: per span (name, start_ns, parent, fit, evaluation) and its
# end_ns, kept as flat tuples and integers, which the garbage collector
# does not traverse again and again, so that a span stays cheap while many
# are kept; read them as Span objects through recorded().
_starts: list[tuple] = []
_ends: list[int | None] = []
_open: list[int] = []  # indices of the recorded spans open now, innermost last
counters: dict[str, dict[str, int]] = {}


def mark() -> int:
    """The index that the next recorded span will take."""
    return len(_starts)


def recorded(first: int = 0) -> list[Span]:
    """The recorded spans from index ``first`` on."""
    return [Span(i, *_starts[i][:2], _ends[i], *_starts[i][2:])
            for i in range(first, len(_starts))]


def counter_group(name: str, keys) -> dict[str, int]:
    """The group ``name`` of :data:`counters`, made with ``keys`` at 0 on
    first use; the same dict object on every call."""
    return counters.setdefault(name, dict.fromkeys(keys, 0))


fit_counts = counter_group("fit", FIT_COUNTERS)
_fit_id = 0


class _Recording:
    __slots__ = ("name", "index")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.index = len(_starts)
        _starts.append((self.name, time.time_ns(), _open[-1] if _open else None, _fit_id,
                        fit_counts["evaluations"]))
        _ends.append(None)
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        _ends[self.index] = time.time_ns()
        if _open[-1] == self.index:
            _open.pop()
        else:
            _open.remove(self.index)
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records the span ``name`` while a ``torch.profiler``
    records, else the shared null context (module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Recording(name)


class Fit:
    """One driver call's counters: its id, the capacity m at its start and
    the launch counts then; :meth:`write` adds the rest."""

    def __init__(self, m_start: int, replicas: int = 1):
        global _fit_id
        _fit_id += 1
        self.id = _fit_id
        self.m_start = int(m_start)
        self.replicas = int(replicas)
        for k in fit_counts:
            fit_counts[k] = 0
        self.launches0 = dict(counters.get("launches", {}))

    def write(self, d: str, m_end: int):
        """``counters.json`` in the run directory ``d``."""
        launches = counters.get("launches", {})
        record = {"fit": self.id, **fit_counts, "m_start": self.m_start, "m_end": int(m_end),
                  "replicas": self.replicas,
                  "launches": {k: v - self.launches0.get(k, 0) for k, v in launches.items()}}
        with open(os.path.join(d, "counters.json"), "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")


@contextlib.contextmanager
def fit(m_start: int, replicas: int = 1):
    """A new :class:`Fit` for the block, inside the span ``fit``."""
    record = Fit(m_start, replicas)
    with span("fit"):
        yield record


def _chrome_events(spans: list[Span], base_ns: int = 0) -> list[dict]:
    """Chrome trace events of recorded spans on one track of their own
    (``ts`` and ``dur`` in microseconds after ``base_ns``); a span still
    open ends at the last stamp of the others."""
    pid = os.getpid()
    last = max((s.end_ns or s.start_ns for s in spans), default=0)
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": SPAN_TRACK}}]
    for s in spans:
        end = last if s.end_ns is None else s.end_ns
        out.append({"ph": "X", "cat": "gprf_span", "name": s.name, "pid": pid, "tid": 0,
                    "ts": (s.start_ns - base_ns) / 1e3, "dur": (end - s.start_ns) / 1e3,
                    "args": {"fit": s.fit, "evaluation": s.evaluation,
                             "parent": None if s.parent is None else _starts[s.parent][0]}})
    return out


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block, written into ``log_dir`` as
    ``trace-<pid>-<ns>.json`` (Chrome's trace format, which Perfetto
    reads); a no-op for ``log_dir=None``.  It records the CPU, the CUDA
    kernels where there is a CUDA device, and the spans recorded in the
    block (track ``gprf_torch spans``)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = mark()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(_chrome_events(recorded(first),
                                              trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)


def kernel_events(loss, x0, calls=5):
    """(name, device us) of every kernel a ``torch.profiler`` trace records
    over ``calls`` calls of one loss+gradient on a CUDA device, after one
    warm call (copies and memsets left out)."""
    from torch.profiler import ProfilerActivity, profile

    from gprf_torch.optim.lbfgs import value_and_grad

    value_and_grad(loss, x0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            value_and_grad(loss, x0)
        torch.cuda.synchronize()
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no kernel on the device")
    return kernels


def device_busy(loss, x0, calls=5):
    """(device-busy ms, kernel launches) of one loss+gradient on a CUDA
    device: :func:`kernel_events` summed, per call."""
    kernels = kernel_events(loss, x0, calls)
    return sum(us for _, us in kernels) / 1e3 / calls, len(kernels) / calls


def splits_at(m: int, dy: int) -> list[str]:
    """The compositions of :mod:`gprf_torch.ops.split_mvn` that split at
    block width m (their leaves run the kernels on halves)."""
    from gprf_torch.ops import mvn, split_mvn

    caps = {"chol_inv": split_mvn.LEAF_CHOL, "mvn_ll": mvn.mvn_max_m(dy),
            "tri_inv": split_mvn.LEAF_TRI}
    return [name for name, cap in caps.items() if m > cap]
