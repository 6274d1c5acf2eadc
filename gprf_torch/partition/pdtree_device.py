"""PD-tree replay on the device: block assignment as tensor ops (mirror of
``gprf_tpu/partition/pdtree_device.py``, its packed path).

Each inner node of a host-built :class:`~gprf_torch.partition.pdtree.PDTree`
stores a split direction, a center and a scalar threshold, so re-blocking a
moved point cloud is a root-to-leaf traversal per point: ``depth`` rounds
of ``a = (x - center_v) . vec_v;  v <- left if a < split else right``.  The
nodes are one packed table ``[N, 2d + 3]``, so a level of the (unrolled,
static-depth) traversal is one ``index_select``.  Plain tensor ops, no
custom kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from gprf_torch.partition.pdtree import PDTree, _Leaf


class FlatPDTree:
    """Array form of a PDTree over dim-d coordinates.

    Node arrays (N nodes, node 0 the root): split_vec [N, d], center [N, d],
    split [N], left / right [N] (child ids; self-loops at leaves),
    leaf_block [N] (block id at leaves, -1 at inner nodes); depth is the
    longest root-to-leaf path."""

    def __init__(self, tree: PDTree):
        nodes = []

        def walk(node, depth):
            my_id = len(nodes)
            nodes.append(None)  # placeholder
            if isinstance(node, _Leaf):
                nodes[my_id] = ("leaf", node, depth)
                return my_id, depth
            lid, dl = walk(node.left, depth + 1)
            rid, dr = walk(node.right, depth + 1)
            nodes[my_id] = ("inner", node, depth, lid, rid)
            return my_id, max(dl, dr)

        _, self.depth = walk(tree.tree, 0)
        N = len(nodes)
        d = tree.X.shape[1]
        self.split_vec = np.zeros((N, d))
        self.center = np.zeros((N, d))
        self.split = np.zeros((N,))
        self.left = np.arange(N, dtype=np.int64)
        self.right = np.arange(N, dtype=np.int64)
        self.leaf_block = np.full((N,), -1, dtype=np.int64)
        n_blocks = 0
        for i, rec in enumerate(nodes):
            if rec[0] == "leaf":
                self.leaf_block[i] = n_blocks
                n_blocks += 1
            else:
                _, node, _, lid, rid = rec
                self.split_vec[i] = node.split_vec
                self.center[i] = node.center
                self.split[i] = node.split
                self.left[i] = lid
                self.right[i] = rid
        self.n_blocks = n_blocks

    def device_arrays(self, device: torch.device | str, dtype: torch.dtype):
        """The packed node table [N, 2d + 3] (split_vec, center, split, left,
        right) at ``dtype`` and the leaf-block map, on ``device``."""
        packed = np.concatenate([self.split_vec, self.center, self.split[:, None],
                                 self.left[:, None].astype(np.float64),
                                 self.right[:, None].astype(np.float64)], axis=1)
        return dict(packed=torch.tensor(packed, dtype=dtype, device=device),
                    d=self.split_vec.shape[1],
                    leaf_block=torch.as_tensor(self.leaf_block, device=device))


def assign_blocks_pdtree(X2, arrays, depth: int):
    """Block id per point for dim-matched coordinates X2 [..., n, d] (the
    caller wraps the longitude and selects the columns)."""
    packed, d = arrays["packed"], arrays["d"]
    cur = torch.zeros(X2.shape[:-1], dtype=torch.int64, device=X2.device)
    for _ in range(depth):
        row = packed.index_select(0, cur.reshape(-1)).reshape(*cur.shape, -1)
        a = torch.sum((X2 - row[..., d:2 * d]) * row[..., :d], dim=-1)
        cur = torch.where(a < row[..., 2 * d], row[..., 2 * d + 1], row[..., 2 * d + 2]).long()
    return arrays["leaf_block"][cur]
