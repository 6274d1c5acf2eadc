#!/usr/bin/env python3
"""Where the float32 RPC median replay parts from the float64 one.

    python3 scripts/torch_rpc_replay_float32.py [--device cuda] [--iters 100] [--ntrain 10000]

Fits the command line's RPC flagship (n = 10,000 + 500, --rpc_blocksize
200, task x, device engine; --ntrain cuts it, with 5% test points) for
--iters iterations into a temporary GPRF_EXPERIMENTS, then replays the split tree at X_obs and at the fit's
final X three ways: on the host in float64 (``cluster_rpc(fixed_split=)``)
and with ``assign_blocks_rpc`` in float64 and in float32.  For each level
of the tree it prints how many points sit at another node in float32 than
in float64, and, at each node where the two first part, the float64 gap
between the node's two middle projections (the median's order statistics)
and float32's spacing there.  One JSON line per point set.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAGS = ["--rpc_blocksize", "200", "--lscale", "0.06", "--obs_std", "0.02", "--local_dist", "0.1",
         "--task", "x", "--engine", "device"]


def node_paths(X, flat, dtype, device):
    """Each point's node id after every level, [depth, n]: the replay with
    every node numbered as its own block."""
    from gprf_torch.partition.rpc_device import assign_blocks_rpc

    arrays = flat.device_arrays(device=device, dtype=dtype)
    arrays["leaf_block"] = torch.arange(flat.n_nodes, device=device)
    Xt = torch.as_tensor(X, dtype=dtype, device=device)
    return np.stack([assign_blocks_rpc(Xt, arrays, k, flat.n_nodes).cpu().numpy()
                     for k in range(1, flat.depth + 1)])


def middle_gap(X, members, flat, node):
    """(float64 gap between the two middle projections of a node's members,
    float32 spacing at the median)."""
    a = np.sort((X[members] - flat.origin[node]) @ flat.direction[node])
    c = len(a)
    lo, hi = a[(c - 1) // 2], a[c // 2]
    return float(hi - lo), float(np.spacing(np.float32(0.5 * (lo + hi))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--ntrain", type=int, default=10000)
    args = parser.parse_args(argv)
    ntest = args.ntrain // 20

    from gprf_torch.cli import gprfopt
    from gprf_torch.data.sampled import sample_data
    from gprf_torch.partition.rpc_device import FlatRPCTree

    with tempfile.TemporaryDirectory() as base:
        os.environ["GPRF_EXPERIMENTS"] = base
        argv = FLAGS + ["--ntrain", str(args.ntrain), "--ntest", str(ntest), "--max_iters",
                        str(args.iters), "--device", args.device]
        d = gprfopt.exp_dir(gprfopt.build_parser().parse_args(argv))
        with contextlib.redirect_stdout(sys.stderr):
            gprfopt.main(argv)
        X_final = np.load(os.path.join(d, "step_%05d_X.npy" % (args.iters - 1)))
        data = sample_data(n=args.ntrain + ntest, ntrain=args.ntrain, lscale=0.06, obs_std=0.02,
                           yd=50, seed=0, centers=None, noise_var=0.01, rpc_blocksize=200)
    flat = FlatRPCTree(data.rpc_splits, d=2)
    for name, X in (("X_obs", data.X_obs), ("X_final", X_final)):
        host = np.empty(len(X), dtype=np.int64)
        for b, ix in enumerate(data.reblock(X)):
            host[ix] = b
        p64 = node_paths(X, flat, torch.float64, args.device)
        p32 = node_paths(X, flat, torch.float32, args.device)
        per_level = [int(np.sum(p32[k] != p64[k])) for k in range(flat.depth)]
        # the nodes where the two first part: same node one level up, other node here
        firsts = []
        for k in range(flat.depth):
            above = np.ones(len(X), bool) if k == 0 else p32[k - 1] == p64[k - 1]
            for node in np.unique(p64[k - 1][above & (p32[k] != p64[k])] if k else
                                  np.zeros(int(np.any(p32[0] != p64[0])), np.int64)):
                members = np.flatnonzero(p64[k - 1] == node) if k else np.arange(len(X))
                gap, spacing = middle_gap(X, members, flat, int(node))
                firsts.append(dict(level=k, node=int(node), members=len(members),
                                   middle_gap_f64=gap, f32_spacing=spacing))
        moved = {f"moved_{k}": int(np.sum(flat.leaf_block[p[-1]] != host))
                 for k, p in (("f32", p32), ("f64", p64))}
        print(json.dumps(dict(points=name, **moved, per_level=per_level, first_parting=firsts)))


if __name__ == "__main__":
    main()
