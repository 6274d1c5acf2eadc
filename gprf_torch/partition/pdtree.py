"""Principal-direction tree clustering with replayable splits (a copy of
``gprf_tpu/partition/pdtree.py``).

Recursively split a point set at the median of its projection onto the top
eigenvector of the (centered) covariance; ``recluster`` replays the stored
splits on updated coordinates.  ``pdtree_cluster`` wraps (lon, lat) with
the longitude wrap-around ``(lon + 22) % 360 - 22`` so that Pacific-spanning
data does not split at the date line.

The split direction comes from ``np.linalg.eigh``, and the sides are
``a < split`` (left) and ``a >= split`` (right): the eigenvector's sign
decides which child is left, so the blocks are numbered as in the
reference only when the same LAPACK call picks the sign.
"""

from __future__ import annotations

import numpy as np


class _Leaf:
    __slots__ = ("idx", "children")

    def __init__(self, idx):
        self.idx = idx
        self.children = len(idx)


class _Inner:
    __slots__ = ("split_vec", "center", "split", "left", "right", "children")

    def __init__(self, split_vec, center, split, left, right):
        self.split_vec = split_vec
        self.center = center
        self.split = split
        self.left = left
        self.right = right
        self.children = left.children + right.children


class PDTree:
    """PD-tree over X (any dimension); leaves have < minsize points."""

    def __init__(self, X, minsize):
        self.X = np.asarray(X)
        self.tree = self._build(np.arange(len(self.X)), minsize)

    def _build(self, idx, minsize):
        if len(idx) < minsize:
            return _Leaf(idx)
        data = self.X[idx].copy()
        dmean = np.mean(data, axis=0)
        data -= dmean
        ev, evec = np.linalg.eigh(data.T @ data)
        pvec = evec[:, np.argmax(ev)]
        a = data @ pvec
        split = np.median(a)
        idx1 = idx[a < split]
        idx2 = idx[a >= split]
        if len(idx1) == 0 or len(idx2) == 0:
            return _Leaf(idx)  # degenerate (all points identical)
        return _Inner(pvec, dmean, split, self._build(idx1, minsize), self._build(idx2, minsize))

    def leaf_idx(self):
        out = []

        def walk(node):
            if isinstance(node, _Leaf):
                out.append(node.idx)
            else:
                walk(node.left)
                walk(node.right)

        walk(self.tree)
        return out

    def recluster(self, X):
        X = np.asarray(X)

        def walk(node, idx):
            if isinstance(node, _Leaf):
                return [idx]
            a = (X[idx] - node.center) @ node.split_vec
            return walk(node.left, idx[a < node.split]) + walk(node.right, idx[a >= node.split])

        return walk(self.tree, np.arange(len(X)))


def wrap_lon(lons):
    """Longitude wrap to [-22, 338) used by the seismic partitioner."""
    return (np.asarray(lons) + 22.0) % 360.0 - 22.0


def pdtree_cluster(X, blocksize=300):
    """Partition (lon, lat, ...) rows by a PD-tree over wrapped (lon, lat).
    Returns ``(blocks, reblock)``, where ``reblock(X_new)`` replays the
    stored splits."""
    X = np.asarray(X)
    X2 = X[:, :2].copy()
    X2[:, 0] = wrap_lon(X2[:, 0])
    t = PDTree(X2, minsize=blocksize)
    idxs = t.leaf_idx()

    def reblock(XX):
        XX2 = np.asarray(XX)[:, :2].copy()
        XX2[:, 0] = wrap_lon(XX2[:, 0])
        return t.recluster(XX2)

    return idxs, reblock
