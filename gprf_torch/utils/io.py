"""Small host-side IO helpers and the step-checkpoint naming protocol of
the drivers (a copy of ``gprf_tpu/utils/io.py``: the file names are the
same, so either package's analysis reads the other's run directory)."""

from __future__ import annotations

import os

import numpy as np


def mkdir_p(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def step_x_path(d: str, step: int) -> str:
    return os.path.join(d, "step_%05d_X.npy" % step)


def step_cov_path(d: str, step: int) -> str:
    return os.path.join(d, "step_%05d_cov.npy" % step)


def save_step(d: str, step: int, X=None, FC=None) -> None:
    if X is not None:
        np.save(step_x_path(d, step), np.asarray(X))
    if FC is not None:
        np.save(step_cov_path(d, step), np.asarray(FC))
