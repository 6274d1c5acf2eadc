"""Recursive projection clustering with replayable splits (a host NumPy copy
of ``gprf_tpu/partition/rpc.py``).

A point set is split by projecting onto the line through two random member
points and cutting at the median projection, recursing until blocks are
below ``target_size``.  The split tree (direction, origin, children) is
returned so that the same lines replay on updated coordinates
(``fixed_split``): each replay recomputes the median of the node's current
members, so block sizes stay balanced as the latent X moves.

The two split points are drawn from an explicit ``rng``.  A
``np.random.RandomState(seed)`` gives the same ``choice`` stream as the
reference's ``np.random.seed(seed)`` followed by NumPy's global functions,
so the blocks and the tree come out identical.
"""

from __future__ import annotations

import numpy as np


def cluster_rpc(X, idxs, target_size, fixed_split=None,
                rng: np.random.RandomState | None = None):
    """Partition ``idxs`` (into ``X``) into blocks of < target_size points.

    Returns ``(blocks, split_tree)``: blocks is a list of index arrays, and
    ``fixed_split=split_tree`` replays the same splits on new coordinates.
    A fresh split (``fixed_split=None``) draws its points from ``rng``."""
    X = np.asarray(X)
    idxs = np.asarray(idxs)
    n = len(idxs)

    if fixed_split is not None and len(fixed_split) == 0:
        return [idxs], ()

    if fixed_split is None:
        if n < target_size:
            return [idxs], ()
        if rng is None:
            raise ValueError("a fresh split draws its two points from rng; pass a RandomState")
        idx1 = rng.choice(idxs)
        idx2 = idx1
        while np.all(idx2 == idx1):
            idx2 = rng.choice(idxs)
        x1 = X[idx1, :]
        x2 = X[idx2, :]
        cx1 = x1 - x2
        nx1 = cx1 / np.linalg.norm(cx1)
        fs1 = None
        fs2 = None
    else:
        (nx1, x2), fs1, fs2 = fixed_split

    if n > 0:
        alphas = (X[idxs] - x2) @ nx1
        median = np.median(alphas)
        idxs1 = idxs[alphas < median]
        idxs2 = idxs[alphas >= median]
    else:
        idxs1 = idxs
        idxs2 = idxs

    L1, split1 = cluster_rpc(X, idxs1, target_size, fixed_split=fs1, rng=rng)
    L2, split2 = cluster_rpc(X, idxs2, target_size, fixed_split=fs2, rng=rng)
    return L1 + L2, ((nx1, x2), split1, split2)
