"""The paper's figure data (mirror of ``gprf_tpu/analysis/paper_figures.py``).

Best-so-far envelopes of the per-step mean location error, the sqrt(n)
rescaling of the mad from unit-square error to the paper's normalized
units, and {method label: series} from a directory of finished runs for
:func:`gprf_torch.analysis.plots.write_plot`.
"""

from __future__ import annotations

import os

import numpy as np

from gprf_torch.analysis.results import RESULT_COLS, load_results, max_history


def error_envelope(results, ntrain=None):
    """(times, best-so-far mad) of a results array; the mad rescaled by
    sqrt(ntrain) when it is given."""
    t = results[:, RESULT_COLS["time"]]
    best = -max_history(-results[:, RESULT_COLS["mad"]])
    if ntrain is not None:
        best = best * np.sqrt(ntrain)
    return t, best


def _finished_runs(exp_base, runs_by_key, name_fn):
    """(label, run, results array) of every run of a suite whose
    results.txt exists and holds a row; a label's last such run wins."""
    for key, run_list in runs_by_key.items():
        for run in run_list:
            d = os.path.join(exp_base, name_fn(run))
            if not os.path.exists(os.path.join(d, "results.txt")):
                continue
            R = load_results(d)
            if len(R):
                yield key, run, R


def suite_series(exp_base, runs_by_key, name_fn, ntrain=None):
    """{label: (times, error envelope)} for every finished run of a suite.
    ``name_fn`` maps a run's parameters to its directory name
    (``gprf_torch.cli.gprfopt.build_run_name``)."""
    return {key: error_envelope(R, ntrain=ntrain or run.get("ntrain"))
            for key, run, R in _finished_runs(exp_base, runs_by_key, name_fn)}


def final_error_vs_time(exp_base, runs_by_key, name_fn):
    """{label: (total time, final mad)}: the paper's accuracy against
    compute."""
    return {key: (float(R[-1, RESULT_COLS["time"]]), float(R[-1, RESULT_COLS["mad"]]))
            for key, _, R in _finished_runs(exp_base, runs_by_key, name_fn)}
