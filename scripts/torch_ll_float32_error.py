#!/usr/bin/env python3
"""Where the float32 log-likelihood of ``GPRF.llgrad`` leaves float64 on the
card: the kernels and their plain twins, each against the twins in float64.

    python3 scripts/torch_ll_float32_error.py [--noise_var 0.1 0.01]

A small synthetic problem (n = 600, 9 grid blocks, dy = 5, lengthscale 0.12,
the card tests' fixture) per noise variance, ``local`` True and False, before
and after ``update_X`` moves a third of the points into one corner block (a
wider m).  Per case three evaluations on the same device arrays: float32 on
the kernels, float32 on the twins, float64 on the twins.  The leaf calls of
each are recorded, so that each float32 run is laid beside the float64 one
stage by stage (the moved case is 240 wide, where the pair pass splits over
K1 and K2 leaves):

- ``ll_rel``: |ll - ll64| / |ll64| of the whole objective, and ``grad_cosine``;
- ``W_rel``: the unary inverse factors W = L^-1 (K1), normwise;
- ``logdet_abs``: the sum of the unary log-determinants, absolute;
- ``S_rel``: the pair Schur complements K2 is given (products of W), normwise;
- ``pair_abs``: the sum of K2's log-densities, absolute;
- ``k1_alone_rel`` / ``k2_alone_abs``: the unary pass's W and the pair pass's
  sum against the float64 twin on this run's own float32 inputs, which leaves
  out what the inputs carried in.

Also kappa, the largest condition number of a unary block (float64), and
``sum_abs_terms``, the sum of the magnitudes of the weighted terms that
cancel into ll.  Prints one JSON line per case, with the card's name and
power limit.  Needs one CUDA device.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def recording(seen):
    """Keep the arguments and results of the objective's unary pass
    (chol_inv_split) and pair pass (mvn_ll_split), whole: past a kernel's
    cap each is a composition over several leaf launches."""
    from gprf_torch.model import objective

    unary_pass, pair_pass = objective.chol_inv_split, objective.mvn_ll_split

    def chol_inv_split(K, **kw):
        out = unary_pass(K, **kw)
        seen["K"], seen["L"], seen["W"] = K.detach(), out[0].detach(), out[1].detach()
        return out

    def mvn_ll_split(S, rhs, n, **kw):
        out = pair_pass(S, rhs, n, **kw)
        seen["S"], seen["rhs"], seen["n"], seen["pair"] = (S.detach(), rhs.detach(), n.detach(),
                                                           out.detach())
        return out

    objective.chol_inv_split, objective.mvn_ll_split = chol_inv_split, mvn_ll_split
    try:
        yield
    finally:
        objective.chol_inv_split, objective.mvn_ll_split = unary_pass, pair_pass


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def log_diag(L):
    return L.double().diagonal(dim1=1, dim2=2).log()


def logdet_sum(L):
    return float(2.0 * log_diag(L).sum())


def main(argv=None):
    import torch

    from gprf_torch.data.sampled import SampledData
    from gprf_torch.ops import mvn
    from gprf_torch.partition.grid import grid_centers

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--noise_var", nargs="+", type=float, default=[0.1, 0.01])
    parser.add_argument("--device", default="cuda", help="cpu runs the twins three times (a dry run)")
    args = parser.parse_args(argv)
    card = "cpu"
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("torch_ll_float32_error.py: no CUDA device")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    variants = {"kernels": (torch.float32, mvn.KERNEL_OPS), "twins": (torch.float32, mvn.PLAIN_OPS),
                "float64": (torch.float64, mvn.PLAIN_OPS)}
    for noise_var in args.noise_var:
        s = SampledData(n=650, ntrain=600, lscale=0.12, obs_std=0.015, yd=5, seed=3,
                        noise_var=noise_var)
        s.set_centers(grid_centers(9))
        dy = s.SY.shape[1]
        X_moved = s.X_obs.copy()
        X_moved[:200] = X_moved[:200] * 0.3 + 0.02
        for local in (True, False):
            for moved, X in ((False, s.X_obs), (True, X_moved)):
                runs = {}
                for name, (dtype, ops) in variants.items():
                    seen = {}
                    g = s.build_gprf(local_dist=0.1, device=args.device, dtype=dtype, ops=ops)
                    g.update_X(X)
                    with recording(seen):
                        ll, gX, _ = g.llgrad(grad_X=True, local=local)
                    seen.update(ll=ll, gX=gX.reshape(-1), m=g.layout.block_pad)
                    runs[name] = seen
                ref = runs["float64"]
                arrays = g._device_arrays() if local else g._all_pairs_device_arrays()
                # the terms that cancel into ll: weighted unaries and the pairs' Schur parts
                Z = ref["W"] @ (g._Y_dev[arrays["assignment"]] * arrays["mask"][:, :, None])
                nb = arrays["mask"].double().sum(1)
                unary = (-0.5 * (Z * Z).sum((1, 2)) - dy * log_diag(ref["L"]).sum(1)
                         - 0.5 * dy * nb * np.log(2 * np.pi))
                total_w = arrays["unary_weights"].double()
                total_w = total_w.index_add(0, arrays["edges"][:, 0].long(),
                                            arrays["pair_weights"].double())
                record = {
                    "noise_var": noise_var, "local": local, "moved": moved, "m": ref["m"],
                    "edges": int(arrays["edges"].shape[0]), "ll_float64": ref["ll"],
                    "sum_abs_terms": float((total_w * unary).abs().sum() + ref["pair"].abs().sum()),
                    "kappa": float(torch.linalg.cond(ref["K"]).max()), "card": card}
                for name in ("kernels", "twins"):
                    r = runs[name]
                    g32, g64 = r["gX"], ref["gX"]
                    L64, W64 = mvn.chol_inv_plain(r["K"].double())
                    pair64 = mvn.mvn_ll_plain(r["S"].double(), r["rhs"].double(), r["n"].double())[0]
                    record[name] = {
                        "ll": r["ll"], "ll_rel": abs(r["ll"] - ref["ll"]) / abs(ref["ll"]),
                        "grad_cosine": float(g32 @ g64 / (np.linalg.norm(g32) * np.linalg.norm(g64))),
                        "W_rel": rel(r["W"], ref["W"]),
                        "logdet_abs": abs(logdet_sum(r["L"]) - logdet_sum(ref["L"])),
                        "S_rel": rel(r["S"], ref["S"]),
                        "pair_abs": abs(float(r["pair"].double().sum() - ref["pair"].sum())),
                        "k1_alone_rel": rel(r["W"], W64),
                        "k2_alone_abs": abs(float(r["pair"].double().sum() - pair64.sum())),
                    }
                record["kernels_vs_twins_ll_rel"] = (abs(runs["kernels"]["ll"] - runs["twins"]["ll"])
                                                     / abs(runs["twins"]["ll"]))
                print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
