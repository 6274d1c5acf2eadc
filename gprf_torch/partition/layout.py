"""Static padded block layout: the bridge from ragged host partitions to
fixed-shape device tensors (mirror of ``gprf_tpu/partition/layout.py``).

A layout holds an ``[B, m]`` assignment matrix (padded with index 0 and a
validity mask), the edge list ``[E, 2]``, per-block neighbor counts, and
the pair gather ``[E, 2m]``; all host NumPy.  :meth:`BlockLayout.device_arrays`
uploads them as tensors.  Block membership is recomputed on the host only
when the partitioner says so.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Padded layout of a partition of n points into B blocks with E edges.

      assignment: [B, m] int32, global point index per slot (0-padded)
      mask:       [B, m] bool, True where the slot holds a real point
      sizes:      [B] int32 true block sizes
      edges:      [E, 2] int32 block-index pairs (i, j), i > j
      neighbor_count: [B] int32, number of edges touching each block
      pair_assignment: [E, 2m] int32 gather for the stacked pair blocks
      pair_mask:  [E, 2m] bool
      n:          number of points
    """

    assignment: np.ndarray
    mask: np.ndarray
    sizes: np.ndarray
    edges: np.ndarray
    neighbor_count: np.ndarray
    pair_assignment: np.ndarray
    pair_mask: np.ndarray
    n: int

    @property
    def n_blocks(self) -> int:
        return self.assignment.shape[0]

    @property
    def block_pad(self) -> int:
        return self.assignment.shape[1]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @staticmethod
    def from_blocks(
        block_idxs: Sequence[np.ndarray],
        n: int,
        edges: Sequence[tuple[int, int]] | np.ndarray | None = None,
        pad_multiple: int = 8,
        pad_to: int | None = None,
    ) -> "BlockLayout":
        """Build a layout from a ragged partition and an edge list.
        ``pad_multiple`` rounds the per-block slot count up; ``pad_to``
        forces an exact slot count."""
        B = len(block_idxs)
        sizes = np.array([len(ix) for ix in block_idxs], dtype=np.int32)
        maxsz = int(sizes.max()) if B else 0
        m = pad_to if pad_to is not None else max(_round_up(max(maxsz, 1), pad_multiple),
                                                  pad_multiple)
        if m < maxsz:
            raise ValueError(f"pad_to={m} smaller than largest block {maxsz}")

        assignment = np.zeros((B, m), dtype=np.int32)
        mask = np.zeros((B, m), dtype=bool)
        for b, ix in enumerate(block_idxs):
            k = len(ix)
            assignment[b, :k] = np.asarray(ix, dtype=np.int32)
            mask[b, :k] = True

        if edges is None:
            edges_arr = np.zeros((0, 2), dtype=np.int32)
        else:
            edges_arr = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        neighbor_count = np.zeros((B,), dtype=np.int32)
        np.add.at(neighbor_count, edges_arr.reshape(-1), 1)

        if len(edges_arr):
            pair_assignment = np.concatenate(
                [assignment[edges_arr[:, 0]], assignment[edges_arr[:, 1]]], axis=1)
            pair_mask = np.concatenate([mask[edges_arr[:, 0]], mask[edges_arr[:, 1]]], axis=1)
        else:
            pair_assignment = np.zeros((0, 2 * m), dtype=np.int32)
            pair_mask = np.zeros((0, 2 * m), dtype=bool)

        return BlockLayout(assignment=assignment, mask=mask, sizes=sizes, edges=edges_arr,
                           neighbor_count=neighbor_count, pair_assignment=pair_assignment,
                           pair_mask=pair_mask, n=n)

    def block_idxs(self) -> list[np.ndarray]:
        """Back to the ragged representation."""
        return [self.assignment[b, : self.sizes[b]].copy() for b in range(self.n_blocks)]

    def unary_weights(self) -> np.ndarray:
        """Per-block weight of the unary term in the GPRF combination,
        ``1 - neighbor_count_i``."""
        return 1.0 - self.neighbor_count.astype(np.float64)

    def device_arrays(self, device: torch.device | str, dtype: torch.dtype,
                      pad_edges_to: int | None = None):
        """The gather, mask and weight tensors of the objective on
        ``device``: int64 indices, bool masks, weights in ``dtype``.

        ``pad_edges_to`` pads the edge batch with zero-weight dummy edges
        pointing at block 0, up to a fixed edge count."""
        pair_assignment, pair_mask, edges = self.pair_assignment, self.pair_mask, self.edges
        E = self.n_edges
        pair_w = np.ones((E,))
        if pad_edges_to is not None and pad_edges_to > E:
            padn = pad_edges_to - E
            m2 = 2 * self.block_pad
            pair_assignment = np.concatenate(
                [pair_assignment, np.zeros((padn, m2), dtype=np.int32)], axis=0)
            pair_mask = np.concatenate([pair_mask, np.zeros((padn, m2), dtype=bool)], axis=0)
            edges = np.concatenate([edges, np.zeros((padn, 2), dtype=np.int32)], axis=0)
            pair_w = np.concatenate([pair_w, np.zeros((padn,))])

        def index(a):
            return torch.as_tensor(a.astype(np.int64), device=device)

        return dict(
            assignment=index(self.assignment),
            mask=torch.as_tensor(self.mask, device=device),
            pair_assignment=index(pair_assignment),
            pair_mask=torch.as_tensor(pair_mask, device=device),
            edges=index(edges),
            unary_weights=torch.as_tensor(self.unary_weights(), dtype=dtype, device=device),
            pair_weights=torch.as_tensor(pair_w, dtype=dtype, device=device),
        )
