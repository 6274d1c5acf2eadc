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
               "checkpoint": {"fit"}, **{k: {"forward"} for k in LOSS_SPANS},
               "unary_factor": {"unary_pass"}}
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
    assert c["pair_schur_blocked"] == 0
    # a read a dispatch, one at each checkpoint (one a dispatch, and the last)
    assert c["checkpoints"] == c["dispatches"] + 1
    assert c["host_syncs"] == c["dispatches"] + c["checkpoints"]
    assert c["launches"] == dict.fromkeys(mvn.launch_counts, 0)  # the CPU runs the twins


@pytest.mark.parametrize("covs", [False, True])
def test_counters_json_of_a_multistart_fit(tmp_path, covs):
    """The multistart driver reads the card 4 times a dispatch (the values
    with the acceptance, the replicas' health, the overflow flags, the
    values v) and once more for the winner's cov tail where there are
    covs; 2 times a checkpoint (the values v, the winner's point)."""
    if covs:
        fused = _seismic()
        lbfgs.do_optimization_multistart_theta(str(tmp_path), fused, _seismic_thetas(fused, 2),
                                               max_iters=2 * STEPS, steps_per_dispatch=STEPS)
    else:
        fused = _fused()
        X0s = np.stack([fused.X0, fused.X0 + 0.01])
        lbfgs.do_optimization_multistart(str(tmp_path), fused, X0s, max_iters=2 * STEPS,
                                         steps_per_dispatch=STEPS)
    c = _counters(tmp_path)
    assert c["replicas"] == 2 and c["dispatches"] == 2 and c["steps"] == 2 * STEPS
    assert c["steps"] == c["evaluations"] - 1 - c["capacity_growths"]
    assert 0 < c["steps_accepted"] <= 2 * c["steps"] and c["replica_restarts"] == 0
    # the first dispatch on the 10 s cadence, and the last
    assert 2 <= c["checkpoints"] <= c["dispatches"] + 1
    assert c["host_syncs"] == (5 if covs else 4) * c["dispatches"] + 2 * c["checkpoints"]
    assert os.path.exists(tmp_path / "covs.txt") == covs


def test_refine_reads_the_card_twice_a_dispatch(tmp_path):
    """The float64 tail reads the step values with the overflow flag, and
    the point of its step file: 2 reads a dispatch, one more for the point
    it returns, and no checkpoint of the cadence; it leaves no ``finished``
    and no ``counters.json`` (the float32 loop writes them)."""
    fused = _fused()
    lbfgs.refine_f64(str(tmp_path), lambda dtype: fused, fused.theta0(), 0, iters=2 * STEPS,
                     steps_per_dispatch=STEPS)
    c = profiling.fit_counts
    assert c["dispatches"] == 2 and c["steps"] == 2 * STEPS and c["checkpoints"] == 0
    assert c["host_syncs"] == 2 * c["dispatches"] + 1
    assert sorted(os.listdir(tmp_path)) == ["log.txt", "step_00003_X.npy", "step_00007_X.npy"]


@pytest.mark.parametrize("pair_chunk", [None, 4])
def test_counters_json_counts_the_pair_chunks(tmp_path, pair_chunk):
    """One pair pass an evaluation: whole on the CPU's rule at this m, or
    the 6 edges in 2 chunks of 4 with 2 zero-weight dummy edges each."""
    _fit(tmp_path, _fused(pair_chunk=pair_chunk))
    c = _counters(tmp_path)
    assert c["pair_passes"] == c["evaluations"] > 0
    nch, dummies = (1, 0) if pair_chunk is None else (2, 2)
    assert c["pair_chunks"] == nch * c["pair_passes"]
    assert c["pair_dummy_edges"] == dummies * c["pair_passes"]
    assert c["pair_schur_blocked"] == 0  # m under K2's leaf: every S built whole


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
    assert set(spans) == {"forward", "backward", "unary_factor"} | LOSS_SPANS
    assert spans["reblock"]["args"]["parent"] == "forward"
    assert spans["unary_factor"]["args"]["parent"] == "unary_pass"
    # the nearest-centre labels are the re-block's alone
    block = spans["reblock"]
    ops = [e for e in events if e.get("name") == "aten::argmin"]
    assert ops and all(block["ts"] <= e["ts"] and e["ts"] + e["dur"] <= block["ts"] + block["dur"]
                       for e in ops)


# ---- the seismic engine and the multistart driver ---------------------------------

def _seismic(n=120, seed=0):
    """A seismic engine over 4 PD-tree blocks (n events around one arc,
    every block pair an edge), dy 3, float64."""
    from gprf_torch.model.fused_seismic import FusedSeismicGPRF
    from gprf_torch.partition.pdtree import PDTree

    rng = np.random.default_rng(seed)
    X = np.column_stack([140.0 + rng.normal(0, 0.5, n), 10.0 + rng.normal(0, 0.5, n),
                         rng.uniform(5.0, 50.0, n)])
    tree = PDTree(X[:, :2], 40)
    B = len(tree.leaf_idx())
    edges = [(i, j) for i in range(B) for j in range(i)]
    cov = GPCov.create([1.0], [40.0, 40.0], "lld", "matern32", **F64)
    std = 20.0 * np.array([0.01, 0.01, 1.0])
    return FusedSeismicGPRF(X, rng.standard_normal((n, 3)), tree, edges, X, std, cov, 0.1,
                            task="xcov", **F64)


def _seismic_thetas(fused, R):
    theta = fused.theta0(fused.prior_means.numpy(), np.array([[0.1, 1.0, 40.0, 40.0]]))
    rng = np.random.default_rng(1)
    return np.stack([theta + rng.normal(size=theta.shape) * 0.01 * r for r in range(R)])


def test_spans_of_a_seismic_evaluation():
    fused = _seismic()
    x = torch.as_tensor(_seismic_thetas(fused, 2))
    recorded, parent = _recorded(lambda: lbfgs.value_and_grad(fused.loss_fn(), x))
    seen = {s.name: p for s, p in zip(recorded, parent)}
    assert set(seen) == {"forward", "backward", "pdtree_reblock", "unary_pass", "unary_factor",
                         "pair_pass", "prior"}
    assert all(seen[k] == "forward" for k in ("pdtree_reblock", "unary_pass", "pair_pass",
                                             "prior"))
    assert seen["unary_factor"] == "unary_pass"
    assert [s.name for s in recorded].count("pdtree_reblock") == 1


def test_replica_health_spans_a_multistart_dispatch(tmp_path):
    fused = _seismic()
    recorded, parent = _recorded(lambda: lbfgs.do_optimization_multistart_theta(
        str(tmp_path), fused, _seismic_thetas(fused, 2), max_iters=2 * STEPS,
        steps_per_dispatch=STEPS))
    health = [s for s, p in zip(recorded, parent) if s.name == "replica_health"]
    assert len(health) == 2
    assert all(p == "dispatch" for s, p in zip(recorded, parent) if s.name == "replica_health")
    # the health read is one of the dispatch's reads of the card
    syncs = [s for s in recorded if s.name == "sync" and s.parent in {h.index for h in health}]
    assert len(syncs) == 2


def test_replica_restarts_are_counted(tmp_path):
    """0 on a single-start fit and on healthy replicas; one where a replica's
    value is planted non-finite once."""
    _fit(tmp_path, _fused())
    assert _counters(tmp_path)["replica_restarts"] == 0
    fused = _seismic()
    thetas = _seismic_thetas(fused, 3)
    d = tmp_path / "healthy"
    os.makedirs(d)
    lbfgs.do_optimization_multistart_theta(str(d), fused, thetas, max_iters=2 * STEPS,
                                           steps_per_dispatch=STEPS)
    assert _counters(d)["replica_restarts"] == 0

    make = fused.loss_fn
    calls = []

    def planted():
        loss = make()

        def inner(theta):
            v = loss(theta)
            calls.append(1)
            # the first step, which the runner accepts whatever its value
            if len(calls) == 2:
                v = torch.where(torch.arange(v.shape[0]) == 1, float("nan"), v)
            return v
        return inner

    fused.loss_fn = planted
    d = tmp_path / "planted"
    os.makedirs(d)
    lbfgs.do_optimization_multistart_theta(str(d), fused, thetas, max_iters=2 * STEPS,
                                           steps_per_dispatch=STEPS)
    c = _counters(d)
    assert c["replica_restarts"] == 1 and c["replicas"] == 3
