"""BENCHMARK.json against its required form, and every file it names."""

import json
import re

from gprfbench import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\n\t]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return spec.load_benchmark()


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["gprfbench"] and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["command"]) <= 32 and all(LINE.fullmatch(w) for w in b["command"])
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and LINE.fullmatch(c["source"])
        assert LINE.fullmatch(c["why"])
        assert c["file"].startswith("gprfbench/") and all(NAME.fullmatch(k) for k in c["reduced"])
        config = json.loads((spec.ROOT / c["file"]).read_text())
        assert all(k in config for k in c["reduced"]) and config["reduced"] == c["reduced"]
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    seen = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and LINE.fullmatch(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert (spec.HERE / "traffic" / (w["traffic"] + ".json")).exists()
        assert (spec.HERE / "limits" / (w["name"] + ".json")).exists()
    cells = {w["name"] for w in b["workloads"]}
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.fullmatch(m["layer"])
    for m in metrics:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert (spec.HERE / "metrics" / (m["name"].split(".")[0] + ".py")).exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in bench()["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m.name for m in cell.metrics_e2e}
        assert "setup_s" in names and len(names) >= 2 and cell.metrics_layer


def test_layers_are_named_in_perf_md():
    perf = (spec.ROOT / "PERF.md").read_text()
    for m in bench()["per_layer"]:
        assert "`%s`" % m["layer"] in perf, m["layer"]


def test_readers_load():
    for m in bench()["end_to_end"] + bench()["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
