"""Nearest-center (Voronoi) partitioning on a grid of block centers.

Host NumPy, a copy of ``gprf_tpu/partition/grid.py`` (importing that module
would import JAX).  Rebuild of the reference ``Blocker``
(``block_clustering.py:7-45``, duplicated at ``gprf.py:33-74``) and
``grid_centers`` (``gprfopt.py:519-523``): points are assigned to the nearest center; two blocks are grid-neighbors when their
center distance is below the smallest diagonal distance (``diag_connections``)
or the smallest axis distance.
"""

from __future__ import annotations

import numpy as np


def pair_distances(Xi: np.ndarray, Xj: np.ndarray) -> np.ndarray:
    """Dense euclidean distance matrix (host-side data prep)."""
    d2 = (
        np.sum(Xi**2, axis=1)[:, None]
        - 2.0 * (Xi @ Xj.T)
        + np.sum(Xj**2, axis=1)[None, :]
    )
    return np.sqrt(np.maximum(d2, 0.0))


def grid_centers(nblocks: int) -> list[np.ndarray]:
    """Centers of a ceil(sqrt(nblocks))^2 grid over the unit square
    (reference ``gprfopt.py:519-523``)."""
    pmax = int(np.ceil(np.sqrt(nblocks)) * 2 + 1)
    pts = np.linspace(0, 1, pmax)[1::2]
    return [np.array((xx, yy)) for xx in pts for yy in pts]


class Blocker:
    """Partition points by nearest block center."""

    def __init__(self, block_centers):
        self.block_centers = np.asarray(block_centers)
        self.n_blocks = len(block_centers)

    def get_block(self, X_new: np.ndarray) -> int:
        dists = np.linalg.norm(X_new - self.block_centers, axis=1)
        return int(np.argmin(dists))

    def block_clusters(self, X: np.ndarray) -> list[np.ndarray]:
        X = np.asarray(X)
        # argmin of squared distance: |x|^2 - 2 x.c + |c|^2, dropping |x|^2
        scores = -2.0 * (X @ self.block_centers.T) + np.sum(
            self.block_centers**2, axis=1
        )
        blocks = np.argmin(scores, axis=1)
        # single argsort split instead of B boolean scans over all of X
        order = np.argsort(blocks, kind="stable")
        bounds = np.searchsorted(blocks[order], np.arange(self.n_blocks + 1))
        return [order[bounds[i] : bounds[i + 1]] for i in range(self.n_blocks)]

    def neighbors(self, diag_connections: bool = True) -> list[tuple[int, int]]:
        """Edges (i, j), i > j, between grid-adjacent blocks.

        Reference semantics (``block_clustering.py:28-45``): connect blocks
        whose center distance is below the second-smallest distinct pairwise
        center distance (+eps) if ``diag_connections``, else the smallest.
        """
        if self.n_blocks <= 1:
            return []
        center_distances = pair_distances(self.block_centers, self.block_centers)
        # the quadratic-expansion distance leaves ~1e-9 roundoff on the
        # diagonal (self-distances), which a `> 0` filter would keep as the
        # "smallest distance" and collapse the diagonal threshold onto the
        # axis one — zero self-distances exactly first
        np.fill_diagonal(center_distances, 0.0)
        cc = center_distances.flatten()
        cc = cc[cc > 0]
        min_dist = np.min(cc) + 1e-6
        diag_dist = np.min(cc[cc > min_dist]) + 1e-6
        connect_dist = diag_dist if diag_connections else min_dist
        out = []
        for i in range(self.n_blocks):
            for j in range(i):
                if center_distances[i, j] < connect_dist:
                    out.append((i, j))
        return out
