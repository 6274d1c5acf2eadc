"""gprf_torch's tracing: the spans of the device loop, the per-fit counters
and ``device_trace``'s Chrome trace, on the CPU at a tiny size (no JAX)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.fused import FusedSyntheticGPRF
from gprf_torch.ops import mvn
from gprf_torch.optim import lbfgs
from gprf_torch.partition.grid import Blocker, grid_centers
from gprf_torch.utils import profiling

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
STEPS = 4
LOSS_SPANS = {"reblock", "unary_pass", "pair_pass", "prior"}


def _fused(m=None, pair_chunk=None, n=160, seed=0):
    """A 2 x 2 grid problem (6 edges with the diagonals), dy 3, float64."""
    rng = np.random.default_rng(seed)
    SX = rng.uniform(size=(n, 2))
    X_obs = SX + 0.02 * rng.standard_normal(SX.shape)
    centers = np.asarray(grid_centers(4))
    cov = GPCov.create([1.0], [0.3, 0.3], "euclidean", "se", **F64)
    return FusedSyntheticGPRF(X_obs, rng.standard_normal((n, 3)), Blocker(centers).neighbors(),
                              X_obs, 0.02, cov, 0.01, task="x", centers=centers, m=m,
                              pair_chunk=pair_chunk, **F64)


def _fit(d, fused, max_iters=2 * STEPS):
    return lbfgs.do_optimization_fused(str(d), fused, fused.X0, max_iters=max_iters,
                                       steps_per_dispatch=STEPS, ckpt_every_sec=0.0)


def _recorded(fn):
    """The spans that ``fn()`` records under a running profiler, and the
    name of each one's parent."""
    first = profiling.mark()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    spans = profiling.recorded(first)
    names = {s.index: s.name for s in spans}
    return spans, [names.get(s.parent) for s in spans]


def _counters(d):
    with open(os.path.join(d, "counters.json")) as f:
        return json.load(f)


def test_span_tree_of_a_fit(tmp_path):
    def two_fits():
        for k in range(2):
            os.makedirs(tmp_path / str(k))
            _fit(tmp_path / str(k), _fused())

    recorded, parent = _recorded(two_fits)
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in recorded)
    parents = {"fit": {None}, "build": {None}, "init_eval": {"fit"}, "dispatch": {"fit"},
               "step": {"dispatch"}, "forward": {"step", "init_eval"},
               "backward": {"step", "init_eval"}, "update": {"step"},
               "overflow_check": {"dispatch"}, "sync": {"dispatch", "checkpoint", "fit"},
               "checkpoint": {"fit"}, **{k: {"forward"} for k in LOSS_SPANS}}
    assert {s.name for s in recorded} == set(parents)
    for s, p in zip(recorded, parent):
        assert p in parents[s.name], (s, p)
    fits = [s for s in recorded if s.name == "fit"]
    assert len(fits) == 2 and fits[1].fit == fits[0].fit + 1
    for f in fits:
        inside = [s for s in recorded if s.fit == f.fit and s.name != "build"]
        assert all(f.start_ns <= s.start_ns and s.end_ns <= f.end_ns for s in inside)
        steps = [s for s in inside if s.name == "step"]
        # one init_eval, then one evaluation a step, numbered in order
        assert len(steps) == 2 * STEPS
        assert [s.evaluation for s in steps] == list(range(2, 2 * STEPS + 2))
        for s in steps:
            kids = [c for c in inside if c.parent == s.index]
            assert [c.name for c in kids] == ["forward", "backward", "update"]
            assert all(c.evaluation == s.evaluation for c in kids)


def test_no_profiler_records_nothing(tmp_path):
    assert profiling.span("step") is profiling.span("dispatch") is profiling._NULL
    first = profiling.mark()
    _fit(tmp_path, _fused())
    assert profiling.mark() == first and not profiling._open


def test_a_span_encloses_its_ops_on_the_profilers_clock():
    a = torch.randn(300, 300)
    first = profiling.mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("around"):
            a @ a
    (s,) = profiling.recorded(first)
    kr = prof.profiler.kineto_results
    (mm,) = [e for e in kr.events() if e.name() == "aten::mm"]
    assert kr.trace_start_ns() <= s.start_ns <= mm.start_ns() <= mm.end_ns() <= s.end_ns


def test_pair_pass_runs_again_under_backward_with_pair_chunk():
    fused = _fused(pair_chunk=2)
    loss = fused.loss_fn()
    x = torch.as_tensor(fused.theta0(), dtype=torch.float64)
    recorded, parent = _recorded(lambda: lbfgs.value_and_grad(loss, x))
    pairs = [p for s, p in zip(recorded, parent) if s.name == "pair_pass"]
    # 6 edges in chunks of 2: three chunks forward, recomputed in the backward
    assert sorted(pairs) == ["backward"] * 3 + ["forward"] * 3
    assert [p for s, p in zip(recorded, parent) if s.name == "unary_pass"] == ["forward"]


def test_counters_json_of_a_fit(tmp_path):
    mvn.reset_launch_counts()
    assert mvn.launch_counts is profiling.counters["launches"]
    _fit(tmp_path, _fused(), max_iters=3 * STEPS)
    c = _counters(tmp_path)
    assert set(c) == {"fit", *profiling.FIT_COUNTERS, "m_start", "m_end", "replicas",
                      "launches"}
    assert c["steps"] == c["dispatches"] * STEPS and c["capacity_growths"] == 0
    assert c["steps"] == c["evaluations"] - 1 - c["capacity_growths"]
    assert 0 < c["steps_accepted"] <= c["steps"]
    assert c["m_start"] == c["m_end"] and c["replicas"] == 1
    # a read a dispatch, one at each checkpoint (one a dispatch, and the last)
    assert c["checkpoints"] == c["dispatches"] + 1
    assert c["host_syncs"] == c["dispatches"] + c["checkpoints"]
    assert c["launches"] == dict.fromkeys(mvn.launch_counts, 0)  # the CPU runs the twins


def test_counters_json_across_a_forced_growth(tmp_path):
    fit_m = _fused().m
    fused = _fused(m=fit_m - 16)
    _fit(tmp_path, fused)
    c = _counters(tmp_path)
    assert c["m_start"] == fit_m - 16 and c["m_end"] == fused.m >= fit_m
    assert c["capacity_growths"] == (c["m_end"] - c["m_start"]) // 16 >= 1
    assert c["steps"] == c["evaluations"] - 1 - c["capacity_growths"]
    assert c["steps_accepted"] <= c["steps"]


def test_counters_json_is_written_when_the_fit_raises(tmp_path):
    fused = _fused()
    make = fused.loss_fn
    fused.loss_fn = lambda: (lambda theta: make()(theta) * float("nan"))
    with pytest.raises(FloatingPointError):
        _fit(tmp_path, fused)
    c = _counters(tmp_path)
    assert os.path.exists(tmp_path / "finished")
    assert c["dispatches"] == 1 and c["steps"] == STEPS and c["checkpoints"] == 0


def test_device_trace_shows_the_spans_over_the_ops(tmp_path):
    fused = _fused()
    loss = fused.loss_fn()
    x = torch.as_tensor(fused.theta0(), dtype=torch.float64)
    with profiling.device_trace(str(tmp_path)):
        lbfgs.value_and_grad(loss, x)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "gprf_span"}
    assert set(spans) == {"forward", "backward"} | LOSS_SPANS
    assert spans["reblock"]["args"]["parent"] == "forward"
    # the nearest-centre labels are the re-block's alone
    block = spans["reblock"]
    ops = [e for e in events if e.get("name") == "aten::argmin"]
    assert ops and all(block["ts"] <= e["ts"] and e["ts"] + e["dur"] <= block["ts"] + block["dur"]
                       for e in ops)
