"""The benchmark's specification, found by name: ``BENCHMARK.json`` at the
root of the checkout, one file per configuration (``configs/<name>.json``),
per traffic mix (``traffic/<name>.json``), per cell's correctness limits
(``limits/<workload>.json``) and per metric reader (``metrics/<name>.py``).
A configuration or a mix that needs code of its own brings a module beside
its file (``configs/<name>.py`` with ``make_problem``, ``traffic/<name>.py``
with ``make_engine``).  Adding any of them is adding a file; nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: tuple[str, ...] | None  # None: every cell that reports what it moves


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics_e2e: tuple[Metric, ...]
    metrics_layer: tuple[Metric, ...]
    bench_dir: Path = HERE
    config_module: Path | None = None  # configs/<name>.py, where there is one
    traffic_module: Path | None = None  # traffic/<mix>.py, where there is one

    @property
    def local_dist(self) -> float:
        """The mix's neighbor threshold, or the configuration's."""
        mix = self.traffic["local_dist"]
        return self.config["local_dist"] if mix is None else mix


def load_benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def _metrics(entries, end_to_end):
    return tuple(Metric(e["name"], e["unit"], e["better"], e["source"], end_to_end,
                        tuple(e["workloads"]) if "workloads" in e else None) for e in entries)


def _beside(path: Path) -> Path | None:
    """The module ``<path without suffix>.py``, where there is one."""
    module = path.with_suffix(".py")
    return module if module.exists() else None


def load_module(path: Path, name: str):
    """The Python module in the file ``path``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, limits and the metrics it reports."""
    bench = load_benchmark(root)
    here = root / HERE.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_file = root / configs[w["config"]]["file"]
    traffic_file = here / "traffic" / f"{w['traffic']}.json"
    config, traffic = _load_json(config_file), _load_json(traffic_file)
    limits = _load_json(here / "limits" / f"{workload}.json")
    e2e = tuple(m for m in _metrics(bench["end_to_end"], True)
                if m.workloads is None or workload in m.workloads)
    e2e_names = {m.name for m in e2e}
    layer = tuple(m for m, e in zip(_metrics(bench["per_layer"], False), bench["per_layer"])
                  if (workload in m.workloads if m.workloads is not None
                      else e["moves"] in e2e_names))
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, layer, here,
                _beside(config_file), _beside(traffic_file))


def metric_reader(name: str, bench_dir: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``, or where there
    is none, of ``metrics/<base>.py`` for a name ``<base>.<regime>``: one
    quantity split by the end-to-end metric it moves has one reader."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "gprfbench_metric_" + name.replace(".", "_")).read
