"""A whole run of a cell at a tiny size on the CPU (the check for a CUDA
device is skipped): the result line's form, no JAX, and ``correct`` false
under each fault the cells can have, planted in the program underneath (a
run on one card has no exchange between cards to leave out)."""

import json
import subprocess
import sys
import tempfile

import pytest
import torch

from gprfbench import check, faults, jobs
from gprfbench import data as bdata
from gprfbench.tests.conftest import run_tiny, tiny_cell
from gprfbench.trace import Tracer

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_sound_device_run(device_cell):
    r = run_tiny(device_cell)
    assert set(r) == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"fit_mad", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "progress"}
    json.dumps(r)


def test_traced_run_has_layer_metrics_and_breakdown(device_cell):
    r = run_tiny(device_cell, traced=True)
    assert set(r) == KEYS | {"breakdown"} and list(r)[-1] == "checks"
    assert {"device_idle_share", "eval_mfu", "eval_ms.host_bound"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and len(r["breakdown"]["idle_gaps"]) <= 10


def test_no_jax_in_the_process():
    code = ("import sys, time, torch; from gprfbench.tests.conftest import tiny_cell, run_tiny;"
            "r = run_tiny(tiny_cell(), seconds=1.0); from gprfbench import run;"
            "print(run.forbidden_modules(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(__import__("gprfbench").spec.ROOT)).stdout
    assert out.split("\n")[-2] == "[] True"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from gprfbench import run

    monkeypatch.setitem(sys.modules, "gprf_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gprf_tpu.ops", object())
    assert run.forbidden_modules() == ["gprf_tpu"]


# ---- faults planted in the program --------------------------------------------

@pytest.mark.parametrize("workload", ["synth10k.device_fit", "synth80k.local_fit"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_device_fault_is_not_correct(workload, fault):
    with faults.planted(fault):
        assert run_tiny(tiny_cell(workload))["correct"] is False


@pytest.mark.parametrize("workload", ["synth10k.device_fit", "synth80k.local_fit"])
def test_control_is_not_correct(workload):
    """The TF32 control, read at the points the program evaluated, fails
    the cell's limits."""
    cell = tiny_cell(workload)
    dev = torch.device("cpu")
    problem = bdata.make_problem(cell, 11, dev)
    engine = jobs.make_engine(cell, problem, dev)
    with tempfile.TemporaryDirectory() as tmp:
        window = jobs.run_window(engine, problem, 2.0, Tracer(False, 0, dev), tmp)
        values = check.readings(problem, engine, window, control=True)
    ok, _ = check.judge({**values, "progress": 1.0}, cell.limits)
    assert not ok


@pytest.mark.gpu
def test_card_run(device_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run_tiny(device_cell, device="cuda", traced=True)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and {"device_busy_ms", "launch_calls_per_eval"} <= set(
        r["metrics"])
