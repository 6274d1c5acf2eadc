"""RPC replay on the device: recursive-projection block assignment in torch
(mirror of ``gprf_tpu/partition/rpc_device.py``).

Each inner node of the split tree (:mod:`gprf_torch.partition.rpc`) keeps a
fixed projection line, but the threshold is the median projection of the
node's current members, recomputed at every re-block.  So the replay is not
a root-to-leaf threshold walk: it computes one median per node per level.

The tree is flattened into arrays and replayed level by level: project every
point onto its node's line, sort by (node, projection), read each node's
median out of the sorted order (``np.median``: the mean of the two middle
order statistics), and send ``alpha < median`` left.  Replicas [R, n, d] are
folded into the node ids (replica r's node k is ``r * n_nodes + k``), so one
sort per level serves all R.  Nothing here waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch


class FlatRPCTree:
    """Array form of the nested-tuple split tree of
    :func:`gprf_torch.partition.rpc.cluster_rpc` (and of ``gprf_tpu``'s,
    which has the same form).

    Node arrays (N nodes, node 0 the root): direction [N, d], origin [N, d],
    left / right [N] (child ids; leaves loop to themselves), leaf_block [N]
    (the block id at a leaf, -1 at an inner node); ``depth`` is the longest
    root-to-leaf path.  Leaves are numbered in the host recursion's order
    (left subtree first), so block ids equal the host's list order.
    """

    def __init__(self, split_tree, d: int):
        nodes = []

        def walk(node, depth):
            my_id = len(nodes)
            nodes.append(None)
            if node == () or node is None:
                nodes[my_id] = ("leaf", depth)
                return my_id, depth
            (nx1, x2), fs1, fs2 = node
            lid, dl = walk(fs1, depth + 1)
            rid, dr = walk(fs2, depth + 1)
            nodes[my_id] = ("inner", np.asarray(nx1), np.asarray(x2), lid, rid)
            return my_id, max(dl, dr)

        _, self.depth = walk(split_tree, 0)
        N = len(nodes)
        self.n_nodes = N
        self.direction = np.zeros((N, d))
        self.origin = np.zeros((N, d))
        self.left = np.arange(N, dtype=np.int64)
        self.right = np.arange(N, dtype=np.int64)
        self.leaf_block = np.full((N,), -1, dtype=np.int64)
        n_blocks = 0
        for i, rec in enumerate(nodes):
            if rec[0] == "leaf":
                self.leaf_block[i] = n_blocks
                n_blocks += 1
            else:
                _, nx1, x2, lid, rid = rec
                self.direction[i] = nx1
                self.origin[i] = x2
                self.left[i] = lid
                self.right[i] = rid
        self.n_blocks = n_blocks

    def device_arrays(self, *, device: torch.device | str, dtype: torch.dtype):
        def index(a):
            return torch.as_tensor(a, device=device)

        return dict(direction=torch.as_tensor(self.direction, dtype=dtype, device=device),
                    origin=torch.as_tensor(self.origin, dtype=dtype, device=device),
                    left=index(self.left), right=index(self.right),
                    leaf_block=index(self.leaf_block))


def assign_blocks_rpc(X, arrays, depth: int, n_nodes: int):
    """Block id per point [..., n] of X [..., n, d] by the median replay.

    Mirrors host ``cluster_rpc(X, idxs, ., fixed_split=tree)``: the split at
    each node is the median projection of the node's current members.
    Leading dimensions are replicas, each replayed on its own points."""
    lead = X.shape[:-2]
    n = X.shape[-2]
    Xr = X.reshape(-1, n, X.shape[-1])
    R = Xr.shape[0]
    dev = X.device
    left, right = arrays["left"], arrays["right"]
    offset = torch.arange(R, device=dev)[:, None] * n_nodes  # [R, 1]
    last = R * n - 1
    cur = torch.zeros((R, n), dtype=torch.int64, device=dev)
    for _ in range(depth):  # leaves loop to themselves: depth levels reach every leaf
        alpha = torch.sum((Xr - arrays["origin"][cur]) * arrays["direction"][cur], dim=-1)
        key = (cur + offset).reshape(-1)
        flat = alpha.reshape(-1)
        # sort by (key, alpha): a stable sort by alpha, then a stable one by key
        by_alpha = torch.argsort(flat, stable=True)
        order = by_alpha[torch.argsort(key[by_alpha], stable=True)]
        sa = flat[order]
        counts = torch.zeros(R * n_nodes, dtype=torch.int64, device=dev).scatter_add_(
            0, key, torch.ones_like(key))
        starts = torch.cumsum(counts, 0) - counts
        c = counts.clamp_min(1)
        # an empty node's slots may lie past the end: clamped, its median is unused
        i1 = (starts + (c - 1) // 2).clamp_max(last)
        i2 = (starts + c // 2).clamp_max(last)
        med = 0.5 * (sa[i1] + sa[i2])
        go_left = flat < med[key]
        cur = torch.where(go_left.reshape(R, n), left[cur], right[cur])
    return arrays["leaf_block"][cur].reshape(*lead, n)
