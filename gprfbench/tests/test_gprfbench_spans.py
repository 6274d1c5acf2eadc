"""The metrics that read the program's own spans and counters
(``program_spans.py``): a tiny traced run of the 10k cell reads each of
them, an untraced run records no span, and a program without spans reads
None without raising."""

from types import SimpleNamespace

import pytest

from gprfbench import program_spans, spec
from gprfbench.tests.conftest import run_tiny, tiny_cell

NEW = ("eval_host_ms", "sync_wait_ms", "update_host_ms", "accepted_share",
       "idle_unspanned_share")


@pytest.fixture(scope="module")
def traced():
    return run_tiny(tiny_cell("synth10k.device_fit"), traced=True)


def test_a_traced_run_reads_every_new_metric(traced):
    assert traced["correct"] is True
    metrics = traced["metrics"]
    assert set(NEW) <= set(metrics)
    assert metrics["eval_host_ms"]["value"] > metrics["update_host_ms"]["value"] > 0
    assert metrics["sync_wait_ms"]["value"] >= 0
    assert 0 < metrics["accepted_share"]["value"] <= 100
    assert 0 <= metrics["idle_unspanned_share"]["value"] <= 100


def test_the_new_metrics_are_the_benchmarks():
    cell = spec.load_cell("synth10k.device_fit")
    assert set(NEW) <= {m.name for m in cell.metrics_layer}
    for name in ("synth80k.device_fit", "synth80k.local_fit"):
        names = {m.name for m in spec.load_cell(name).metrics_layer}
        assert {"eval_host_ms.device_bound", "sync_wait_ms.device_bound",
                "accepted_share.device_bound"} <= names


def test_an_untraced_run_records_no_span():
    from gprf_torch.utils import profiling

    first = profiling.mark()
    r = run_tiny(tiny_cell("synth10k.device_fit"), seconds=1.0)
    assert r["correct"] is True and profiling.mark() == first


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "_recorded_spans", lambda: None)
    ctx = SimpleNamespace(trace={"window_s": 1.0, "evals": 5},
                          tracer=SimpleNamespace(prof=object()),
                          window=SimpleNamespace(jobs=[SimpleNamespace(dir="/nonexistent")]))
    for name in NEW:
        assert spec.metric_reader(name)(ctx) is None, name


def test_each_gap_goes_to_the_innermost_open_span():
    spans = [(0, 100, "fit"), (10, 50, "dispatch"), (12, 30, "step"), (14, 20, "forward"),
             (50, 60, "checkpoint")]
    points = [0, 11, 13, 15, 25, 30, 55, 70, 100]
    assert program_spans._innermost(spans, points) == [
        "fit", "dispatch", "step", "forward", "step", "dispatch", "checkpoint", "fit", None]
