"""Results protocol: per-step metrics recomputed from checkpoints (mirror of
``gprf_tpu/analysis/results.py``).

Writer and reader of the ``results.txt`` format: 12 fixed columns (step,
time, mll, dlscale, mad, xprior, smse_local, smse, msll_local_block,
msll_block, msll_local_diag, msll_diag) plus a final ``trueX`` oracle row
with the objective evaluated at the true latents, the end-to-end
correctness oracle: the optimized objective should approach it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gprf_torch.optim.driver import load_log
from gprf_torch.utils.io import step_cov_path, step_x_path

RESULT_COLS = {
    "step": 0,
    "time": 1,
    "mll": 2,
    "dlscale": 3,
    "mad": 4,
    "xprior": 5,
    "smse_local": 6,
    "smse": 7,
    "msll_local_block": 8,
    "msll_block": 9,
    "msll_local_diag": 10,
    "msll_diag": 11,
}


def analyze_run(d, sdata, local_dist=1.0, predict=False, X0=None, *,
                device: torch.device | str, dtype: torch.dtype):
    """Recompute metrics for every checkpointed step and write results.txt.

    ``X0`` is the run's actual initial or pinned latents, the fallback when
    a row has no X checkpoint (task=cov runs pin X at the true latents and
    never checkpoint X).  ``predict`` fills the six predictive columns
    (:meth:`~gprf_torch.data.sampled.SampledData.prediction_error`, for the
    local GPs and, where ``local_dist < 1``, the GPRF); without it they are
    zeros.  The ``trueX`` row's objective and the predictions are evaluated
    on ``device`` at ``dtype``, the run's own; an error there is raised."""
    steps, times, lls = load_log(d)
    rfname = os.path.join(d, "results.txt")

    def row_metrics(X, FC):
        l1 = sdata.mean_distance(X.flatten())
        c1 = sdata.lscale_error(FC) if FC is not None else 0.0
        l2 = sdata.x_prior(X.flatten())[0]
        if not predict:
            return (c1, l1, l2) + (0.0,) * 6
        smse_local, mlb_local, mld_local = sdata.prediction_error(
            X=X, cov=FC, local_dist=1.0, device=device, dtype=dtype)
        if local_dist < 1.0:
            smse, mlb, mld = sdata.prediction_error(X=X, cov=FC, local_dist=local_dist,
                                                    device=device, dtype=dtype)
        else:
            smse, mlb, mld = smse_local, mlb_local, mld_local
        return c1, l1, l2, smse_local, smse, mlb_local, mlb, mld_local, mld

    # the device loop checkpoints once per dispatch while log.txt has a row
    # per iteration: rows between checkpoints carry the last checkpointed
    # state forward (at first the optimizer's starting point, never the
    # true latents) and reuse its metrics
    with open(rfname, "w") as results:
        prev_X, prev_FC, prev_metrics = None, None, None
        for i, step in enumerate(steps):
            loaded = False
            try:
                X = np.load(step_x_path(d, step))
                loaded = True
            except (IOError, OSError):
                X = prev_X if prev_X is not None else np.asarray(
                    X0 if X0 is not None else sdata.X_obs)
            try:
                FC = np.load(step_cov_path(d, step))
                loaded = True
            except (IOError, OSError):
                FC = prev_FC
            if loaded or prev_metrics is None:
                prev_metrics = row_metrics(X, FC)
                prev_X, prev_FC = X, FC
            results.write("%d %.2f %.2f %.8f %.8f %.8f %.4f %.4f %.4f %.4f %.4f %.4f\n" % (
                (step, times[i], lls[i]) + prev_metrics))

        # oracle row: the objective at the true latents
        metrics = row_metrics(sdata.SX, None)
        results.flush()
        gprf = sdata.build_gprf(X=sdata.SX, local_dist=local_dist, device=device, dtype=dtype)
        ll1 = gprf.llgrad()[0]
        results.write("trueX inf %.2f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f\n" % (
            (ll1,) + metrics))
    return rfname


def load_results(d):
    r = os.path.join(d, "results.txt")
    results = []
    with open(r, "r") as rf:
        for line in rf:
            try:
                results.append([float(x) for x in line.split(" ")])
            except ValueError:
                continue
    return np.asarray(results)


def read_result_line(s):
    r = {}
    parts = s.split(" ")
    for lbl, col in RESULT_COLS.items():
        p = parts[col]
        if p == "trueX":
            continue
        try:
            r[lbl] = int(p)
        except ValueError:
            r[lbl] = float(p)
    return r


def load_final_results(d):
    """(final_row, trueX_row) dicts from a finished run."""
    with open(os.path.join(d, "results.txt"), "r") as rf:
        lines = rf.readlines()
    return read_result_line(lines[-2]), read_result_line(lines[-1])


def max_history(values):
    """Best-so-far envelope."""
    out = []
    best = -np.inf
    for v in values:
        best = max(best, v)
        out.append(best)
    return np.asarray(out)


def compare_seismic_runs(d1, d2, data_dir="."):
    """(mean, median) km distance between the final inferred locations of
    two seismic runs: the last ``step_*_X.npy`` of each run directory,
    point by point."""
    from gprf_torch.data.seismic import mad

    def last_X(d):
        fnames = sorted(f for f in os.listdir(d) if f.startswith("step") and f.endswith("_X.npy"))
        if not fnames:
            raise FileNotFoundError(f"no step checkpoints in {d}")
        return np.load(os.path.join(d, fnames[-1]))

    X1, X2 = last_X(d1), last_X(d2)
    if len(X1) != len(X2):
        raise ValueError("runs have different point counts")
    return mad(X1, X2)
