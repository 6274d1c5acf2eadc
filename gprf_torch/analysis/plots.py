"""Visualization: per-step scatter plots and movies (a copy of
``gprf_tpu/analysis/plots.py``).

:func:`vis_points` renders every ``step_*_X.npy`` checkpoint of a run as a
scatter plot, colored by an output dimension, by the per-point location
error (``y_target=-1``) or by block membership (``y_target=-2`` RPC, ``-3``
grid), with the inducing points where present, then stitches a movie with
ffmpeg.  matplotlib is imported lazily; without it each function prints a
message and does nothing.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np


def vis_points(
    d,
    sdata=None,
    y_target: int = 0,
    seed=None,
    blocksize=None,
    highlight_block=None,
    make_movie: bool = True,
):
    try:
        from matplotlib.figure import Figure
        from matplotlib.backends.backend_agg import FigureCanvasAgg  # noqa: F401
    except ImportError:
        print("matplotlib unavailable; skipping vis_points")
        return []

    written = []
    fnames = ["true.xxx"] if sdata is not None else []
    fnames += sorted(os.listdir(d))
    for fname in fnames:
        if fname == "true.xxx":
            X = sdata.SX.copy()
        elif not (fname.startswith("step") and fname.endswith("_X.npy")):
            continue
        else:
            X = np.load(os.path.join(d, fname))

        IX = None
        ix_path = os.path.join(d, fname.replace("_X", "_IX"))
        if os.path.exists(ix_path):
            IX = np.load(ix_path)

        fig = Figure(dpi=144, figsize=(14, 14))
        fig.patch.set_facecolor("white")
        ax = fig.add_subplot(111)
        cmap = "jet"
        sargs = {}
        if y_target == -1 and sdata is not None:
            c = np.sqrt(np.sum((X - sdata.SX) ** 2, axis=1))
            cmap = "hot"
        elif y_target in (-2, -3) and sdata is not None:
            c = np.zeros((X.shape[0],))
            if y_target == -2:
                np.random.seed(seed)
                sdata.cluster_rpc(blocksize)
            else:
                from gprf_torch.partition.grid import grid_centers

                sdata.set_centers(grid_centers(blocksize))
            cmap = "prism"
            if highlight_block is not None:
                block_colors = np.ones((len(sdata.block_idxs),)) * 0.4
                block_colors[highlight_block] = 0.0
            else:
                block_colors = np.linspace(0.0, 1.0, len(sdata.block_idxs))
            for i, idxs in enumerate(sdata.reblock(X)):
                c[idxs] = block_colors[i]
        elif sdata is None:
            c = None
        else:
            c = sdata.SY[:, y_target : y_target + 1].flatten()
            sargs["vmin"] = -3.0
            sargs["vmax"] = 3.0

        npts = len(X)
        xmax = np.sqrt(npts)
        X = X * xmax
        if IX is not None:
            IX = IX * xmax
            ax.scatter(IX[:, 0], IX[:, 1], alpha=1.0, c="black", s=25, marker="o", linewidths=0.0)
        if c is None:
            ax.scatter(X[:, 0], X[:, 1], alpha=1.0, s=70, marker=".", linewidths=0.0, **sargs)
        else:
            ax.scatter(X[:, 0], X[:, 1], alpha=1.0, c=c, cmap=cmap, s=70, marker=".", linewidths=0.0, **sargs)
        ax.set_xlim((0, xmax))
        ax.set_ylim((0, xmax))
        out_name = os.path.join(d, (fname[:-4] if fname != "true.xxx" else "true") + ".png")
        fig.savefig(out_name, bbox_inches="tight")
        written.append(out_name)

    if make_movie and written:
        ffmpeg = shutil.which("ffmpeg") or shutil.which("avconv")
        if ffmpeg:
            cmd = [ffmpeg, "-y", "-f", "image2", "-r", "5", "-i",
                   "step_%05d_X.png", "-qscale", "28", "gprf.mp4"]
            try:
                subprocess.run(cmd, cwd=d, capture_output=True, timeout=600)
            except (subprocess.SubprocessError, OSError):
                pass
    return written


def write_plot(plot_data, out_fname, xlabel="Time (s)", ylabel="", logx=True,
               ylim=None, xlim=None):
    """Multi-series line plot of run trajectories, the shape of the
    paper's figures.  plot_data: {label: (x_array, y_array)}."""
    try:
        from matplotlib.figure import Figure
    except ImportError:
        print("matplotlib unavailable; skipping write_plot")
        return
    fig = Figure(dpi=144, figsize=(8, 6))
    ax = fig.add_subplot(111)
    for label, (x, y) in sorted(plot_data.items()):
        ax.plot(x, y, label=label)
    if logx:
        ax.set_xscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if ylim is not None:
        ax.set_ylim(ylim)
    if xlim is not None:
        ax.set_xlim(xlim)
    ax.legend()
    fig.savefig(out_fname, bbox_inches="tight")
