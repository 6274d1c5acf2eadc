"""Shared fixtures of the benchmark's CPU tests: a cell of the real
configuration files, cut to a size the CPU runs in seconds."""

import copy
import dataclasses
import time

import pytest
import torch

from gprfbench import spec

torch.set_num_threads(2)


def tiny_cell(workload="synth10k.device_fit", n=600, nblocks=4, max_iters=40):
    """``workload`` with its own traffic, limits and metrics, at n points,
    a 2 x 2 grid and 3 output columns."""
    cell = spec.load_cell(workload)
    config = copy.deepcopy(cell.config)
    config.update(ntrain=n, nblocks=nblocks, lscale=0.3, obs_std=0.03, yd=3)
    config["assumed"] = dict(config["assumed"], m=208, y_draw="exact")
    traffic = copy.deepcopy(cell.traffic)
    if traffic["loop"]:
        traffic["loop"]["max_iters"] = max_iters
    return dataclasses.replace(cell, config=config, traffic=traffic)


def run_tiny(cell, seed=2**31 + 5, seconds=3.0, traced=False, device="cpu"):
    from gprfbench import run

    return run.run_cell(cell, seed, seconds, traced, torch.device(device), time.time(),
                        trace_seconds=1.0, log=lambda msg: None)


@pytest.fixture
def device_cell():
    return tiny_cell("synth10k.device_fit")


