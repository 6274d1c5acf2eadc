"""A configuration and a traffic mix that bring code of their own are new
files only: planted beside the files of a copy of the benchmark, with
their entries added to its ``BENCHMARK.json``, they run with no edit to a
file that is there."""

import json
import shutil
import time

import torch

from gprfbench import run, spec

CONFIG_MODULE = '''
from pathlib import Path

from gprfbench import data


class Lattice(data.Problem):
    """SX on a jittered lattice instead of uniform draws."""

    def __init__(self, config, local_dist, seed, device):
        super().__init__(config, local_dist, seed, device)
        side = int(round(self.SX.shape[0] ** 0.5))
        grid = torch.stack(torch.meshgrid(torch.arange(side), torch.arange(side),
                                          indexing="ij"), -1).reshape(-1, 2)
        self.SX_dev = (grid.to(self.SX_dev) + 0.5 + 0.1 * (self.SX_dev - 0.5)) / side
        self.SX = self.SX_dev.cpu().numpy()


import torch  # noqa: E402


def make_problem(config, local_dist, seed, device):
    Path(__file__).with_suffix(".ran").write_text("")
    return Lattice(config, local_dist, seed, device)
'''

MIX_MODULE = '''
from pathlib import Path

from gprfbench import jobs


class ShortDispatches(jobs.Engine):
    def fit(self, job, maxsec, tracer, loop=None, steps_per_dispatch=None):
        super().fit(job, maxsec, tracer, loop, steps_per_dispatch or 5)


def make_engine(problem, traffic, device):
    Path(__file__).with_suffix(".ran").write_text("")
    return ShortDispatches(problem, traffic, device)
'''


def test_a_new_configuration_and_mix_with_code_are_new_files(tmp_path):
    root = tmp_path / "checkout"
    here = root / spec.HERE.name
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    config = json.loads((here / "configs" / "synth10k.json").read_text())
    config.update(name="lattice", ntrain=576, nblocks=4, lscale=0.3, obs_std=0.03, yd=3)
    config["assumed"] = {"y_draw": "exact"}  # the program's own start capacity
    (here / "configs" / "lattice.json").write_text(json.dumps(config))
    (here / "configs" / "lattice.py").write_text(CONFIG_MODULE)
    mix = {"name": "short_dispatch", "engine": "short_dispatch", "local_dist": None,
           "loop": {"max_iters": 40, "ftol": 1e-6, "stall_patience": 4}}
    (here / "traffic" / "short_dispatch.json").write_text(json.dumps(mix))
    (here / "traffic" / "short_dispatch.py").write_text(MIX_MODULE)
    shutil.copy(here / "limits" / "synth10k.device_fit.json",
                here / "limits" / "lattice.short_dispatch.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lattice", "source": "a test", "reduced": [],
                             "file": "gprfbench/configs/lattice.json", "why": "a test"})
    bench["workloads"].append({"name": "lattice.short_dispatch", "config": "lattice",
                               "traffic": "short_dispatch", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("lattice.short_dispatch", root)
    r = run.run_cell(cell, 2**32 + 3, 3.0, False, torch.device("cpu"), time.time(),
                     log=lambda msg: None)
    assert r["correct"] is True and r["failed"] == 0 and "setup_s" in r["metrics"]
    assert (here / "configs" / "lattice.ran").exists()
    assert (here / "traffic" / "short_dispatch.ran").exists()
    changed = {p for p, b in before.items() if p.read_bytes() != b}
    assert changed == {root / "BENCHMARK.json"}
