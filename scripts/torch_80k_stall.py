#!/usr/bin/env python3
"""Where the 80k fit on the kernels stalls: the gradient there, by leaf.

    python3 scripts/torch_80k_stall.py [--sampler exact|vecchia] [--iters 60]

On the 80k command's data (``scripts/torch_80k_fit.py``'s draw), runs the
device engine on the kernels for ``--iters`` iterations with no stall
rule, then at the point it reached evaluates one loss+gradient of the
device engine (the objective and the X prior) with each set of leaves:
the kernels, the plain twins in float32 and in float64, and two mixtures
that run one kernel of the pair on its twin (K1's leaves on the kernel and
the pair leaf on its twin, and the other way round).  Prints, for each, the
loss and the gradient's distance to the float64 twins (loss rel, 1 -
cosine, relative norm of the difference), and the float64 loss along
minus each float32 gradient, so that a direction that does not descend
shows.  Then each leaf kernel of that loss (K1, K2 and K3, at every leaf
shape), the kernel and the float32 twin against the float64 twin on the
same float32 inputs (normwise rel err of each output).  Needs one CUDA
device.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = dict(n=80500, ntrain=80000, lscale=0.021213, obs_std=0.007071, yd=50, seed=0,
            noise_var=0.01)


def main(argv=None):
    import numpy as np
    import torch

    from gprf_torch.data.sampled import sample_data
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import do_optimization_fused, value_and_grad
    from gprf_torch.partition.grid import grid_centers

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sampler", choices=["vecchia", "exact"], default="exact")
    parser.add_argument("--iters", type=int, default=60)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_80k_stall.py: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.sampler == "vecchia":
        os.environ["GPRF_SAMPLER"] = "vecchia"
    else:
        os.environ.pop("GPRF_SAMPLER", None)
    with tempfile.TemporaryDirectory() as base:
        os.environ["GPRF_EXPERIMENTS"] = base
        with contextlib.redirect_stdout(sys.stderr):
            data = sample_data(centers=grid_centers(100), **DATA)

        def engine(dtype, ops):
            return FusedSyntheticGPRF(data.X_obs, data.SY, data.neighbors, data.X_obs,
                                      data.obs_std, data.cov, data.noise_var, task="x",
                                      centers=np.asarray(data.centers), device="cuda",
                                      dtype=dtype, acc_dtype=torch.float64, ops=ops)

        fused = engine(torch.float32, mvn.KERNEL_OPS)
        d = os.path.join(base, "run")
        os.makedirs(d)
        with contextlib.redirect_stdout(sys.stderr):
            do_optimization_fused(d, fused, data.X_obs, max_iters=args.iters, ftol=0.0)
        last = max(f for f in os.listdir(d) if f.startswith("step_") and f.endswith("_X.npy"))
        x = np.load(os.path.join(d, last)).reshape(-1)

        leaves = {
            "kernels": (torch.float32, mvn.KERNEL_OPS),
            "twins32": (torch.float32, mvn.PLAIN_OPS),
            "twins64": (torch.float64, mvn.PLAIN_OPS),
            "K1_kernel_pair_twin": (torch.float32, mvn.KERNEL_OPS._replace(
                mvn_ll=mvn.PLAIN_OPS.mvn_ll, tri_inv=mvn.PLAIN_OPS.tri_inv)),
            "K1_twin_pair_kernel": (torch.float32, mvn.KERNEL_OPS._replace(
                chol_inv=mvn.PLAIN_OPS.chol_inv)),
        }
        out = {}
        for name, (dtype, ops) in leaves.items():
            f = engine(dtype, ops)
            f.m = fused.m
            v, g = value_and_grad(f.loss_fn(), torch.as_tensor(x, dtype=dtype, device="cuda"))
            out[name] = (float(v), g.double())
        v64, g64 = out["twins64"]
        loss64 = engine(torch.float64, mvn.PLAIN_OPS)
        loss64.m = fused.m
        loss64 = loss64.loss_fn()
        x64 = torch.as_tensor(x, dtype=torch.float64, device="cuda")
        for name, (v, g) in out.items():
            diff = g - g64
            record = {"what": "gradient", "leaves": name, "iterations": args.iters,
                      "step": last, "m": fused.m, "loss": v, "loss_rel_to_twins64":
                      abs(v - v64) / abs(v64),
                      "one_minus_cosine": float(1 - g @ g64 / (g.norm() * g64.norm())),
                      "rel_norm_diff": float(diff.norm() / g64.norm()),
                      "grad_norm": float(g.norm())}
            # the float64 loss along minus this gradient, at steps of the
            # size L-BFGS's first trial takes (1 / |g|) times these factors
            steps = [1e-4, 1e-3, 1e-2, 1e-1, 1.0]
            with torch.no_grad():
                record["float64_loss_change_along_minus_g"] = [
                    float(loss64(x64 - (t / g.norm()) * g)) - v64 for t in steps]
            record["step_lengths_over_grad_norm"] = steps
            print(json.dumps(dict(record, card=card)), flush=True)

        # the leaves' inputs at this point (first call at each shape), from
        # the float32 twins, and each kernel against float64 on them
        seen = {}

        def recorder(name, fn):
            def f(*a):
                seen.setdefault((name, tuple(tuple(t.shape) for t in a)),
                                tuple(t.detach().clone() for t in a))
                return fn(*a)
            return f

        twins = engine(torch.float32, mvn.Ops(*(recorder(n, fn) for n, fn in
                                               zip(mvn.Ops._fields, mvn.PLAIN_OPS))))
        twins.m = fused.m
        with torch.no_grad():
            twins.loss_fn()(torch.as_tensor(x, dtype=torch.float32, device="cuda"))
        pairs = {"chol_inv": (mvn.chol_inv, mvn.chol_inv_plain),
                 "mvn_ll": (mvn.mvn_ll, mvn.mvn_ll_plain), "tri_inv": (mvn.tri_inv, mvn.tri_inv_plain)}
        for (name, shapes), args in list(seen.items()):
            if name == "mvn_ll":  # K3 inverts K2's factors in the backward
                seen[("tri_inv", shapes[:1])] = (mvn.mvn_ll_plain(*args)[1],)
        for (name, shapes), args in seen.items():
            if name not in pairs:
                continue
            kernel, plain = pairs[name]
            ref = plain(*(a.double() for a in args))
            ref = ref if isinstance(ref, tuple) else (ref,)
            record = {"what": "leaf", "kernel": name, "shapes": shapes}
            for label, fn in (("kernel", kernel), ("twin32", plain)):
                got = fn(*args)
                got = got if isinstance(got, tuple) else (got,)
                record[label + "_rel_err_vs_float64"] = [
                    float((g.double() - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
            print(json.dumps(dict(record, card=card)), flush=True)


if __name__ == "__main__":
    main()
