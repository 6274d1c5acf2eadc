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
same float32 inputs (normwise rel err of each output).

``--terms`` then breaks the gradient's float32 error down by term, at the
stalled X and at X_obs: the objective is the weighted sum of B unary terms
(weight 1 - degree) and E pair terms (weight 1), and each term's gradient
is taken alone (the unary terms at once, their supports being disjoint
blocks; the pair terms a matching of the block graph at a time) four ways:
float32 on the kernels, float32 on the twins, float32 on ``torch.linalg``
unsplit (the twins without the Schur split's glue), and float64 through the
joint form (``_block_term`` at 2m, chunked as ``_auto_chunk`` chunks).  It
prints how many terms carry 90% of the error (each term's share its squared
error norm over the sum of them), and for the ten worst the float64
condition number of the term's K + noise I, the smallest distance between
two of its points and its share.  Then it runs the kernels' fit again with
the pair pass unchunked (a second roundoff order) for ``--iters`` and
prints both fits' objectives and mad.  ``--labels`` counts, at the stalled X and at X_obs, the points
that the float32 and the float64 nearest-centre re-block place in
different blocks and the points within 1e-7 ... 1e-4 of a block boundary,
and compares the float32 kernels' loss and gradient with the float64 loss
on the float32 partition and on its own.  ``--unpin N`` restarts the kernels' fit for N
iterations from the stalled X twice: as it is, and with each point that
lies within 1e-6 of a block boundary moved 1e-5 into its float32 block,
and prints both ends.  ``--f64_iters N`` goes on from the
stalled X in float64 on ``LINALG_OPS`` for N iterations with no stall
rule (the optimizer's memory starts empty, as in ``refine_f64``) and
prints the objective and mad it reaches.  ``--experiments DIR`` keeps the data
there (default: a temporary directory), so that another script can reuse
the draw.  Needs one CUDA device.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = dict(n=80500, ntrain=80000, lscale=0.021213, obs_std=0.007071, yd=50, seed=0,
            noise_var=0.01)


def main(argv=None):
    import numpy as np
    import torch

    from gprf_torch.data.sampled import sample_data
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.ops import mvn
    from gprf_torch.optim.driver import load_log
    from gprf_torch.optim.lbfgs import do_optimization_fused, value_and_grad
    from gprf_torch.partition.grid import grid_centers

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sampler", choices=["vecchia", "exact"], default="exact")
    parser.add_argument("--iters", type=int, default=60)
    parser.add_argument("--terms", action="store_true")
    parser.add_argument("--f64_iters", type=int, default=0)
    parser.add_argument("--labels", action="store_true")
    parser.add_argument("--unpin", type=int, default=0)
    parser.add_argument("--experiments", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_80k_stall.py: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.sampler == "vecchia":
        os.environ["GPRF_SAMPLER"] = "vecchia"
    else:
        os.environ.pop("GPRF_SAMPLER", None)
    with contextlib.ExitStack() as stack:
        base = args.experiments or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(base, exist_ok=True)
        os.environ["GPRF_EXPERIMENTS"] = base
        with contextlib.redirect_stdout(sys.stderr):
            data = sample_data(centers=grid_centers(100), **DATA)

        def engine(dtype, ops):
            return FusedSyntheticGPRF(data.X_obs, data.SY, data.neighbors, data.X_obs,
                                      data.obs_std, data.cov, data.noise_var, task="x",
                                      centers=np.asarray(data.centers), device="cuda",
                                      dtype=dtype, acc_dtype=torch.float64, ops=ops)

        fused = engine(torch.float32, mvn.KERNEL_OPS)
        d = os.path.join(base, "stall_run")
        shutil.rmtree(d, ignore_errors=True)
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
            "linalg32_unsplit": (torch.float32, _unsplit32()),
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

        twins = engine(torch.float32, mvn.PLAIN_OPS.map_leaves(recorder))
        twins.m = fused.m
        with torch.no_grad():
            twins.loss_fn()(torch.as_tensor(x, dtype=torch.float32, device="cuda"))
        pairs = {"chol_inv": (mvn.chol_inv, mvn.chol_inv_plain),
                 "mvn_ll": (mvn.mvn_ll, mvn.mvn_ll_plain), "tri_inv": (mvn.tri_inv, mvn.tri_inv_plain)}
        for (name, shapes), inputs in list(seen.items()):
            if name == "mvn_ll":  # K3 inverts K2's factors in the backward
                seen[("tri_inv", shapes[:1])] = (mvn.mvn_ll_plain(*inputs)[1],)
        for (name, shapes), inputs in seen.items():
            if name not in pairs:
                continue
            kernel, plain = pairs[name]
            ref = plain(*(a.double() for a in inputs))
            ref = ref if isinstance(ref, tuple) else (ref,)
            record = {"what": "leaf", "kernel": name, "shapes": shapes}
            for label, fn in (("kernel", kernel), ("twin32", plain)):
                got = fn(*inputs)
                got = got if isinstance(got, tuple) else (got,)
                record[label + "_rel_err_vs_float64"] = [
                    float((g.double() - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
            print(json.dumps(dict(record, card=card)), flush=True)

        if args.labels:
            record = label_check(data, engine(torch.float64, mvn.LINALG_OPS), fused.m,
                                 x.reshape(data.X_obs.shape), out["kernels"])
            print(json.dumps(dict(record, step=last, card=card)), flush=True)

        if args.unpin:
            for record in unpin(data, engine, fused.m, x.reshape(data.X_obs.shape), base,
                                args.unpin):
                print(json.dumps(dict(record, card=card)), flush=True)

        if args.terms:
            for where, X_np in (("stalled", x.reshape(data.X_obs.shape)), ("X_obs", data.X_obs)):
                print(json.dumps(dict(term_errors(data, X_np, fused.edges), where=where,
                                      step=last if where == "stalled" else None, card=card)),
                      flush=True)
            fits = {"chunk_64": (d, fused)}
            d2 = os.path.join(base, "stall_run_unchunked")
            shutil.rmtree(d2, ignore_errors=True)
            os.makedirs(d2)
            unchunked = engine(torch.float32, mvn.KERNEL_OPS)
            unchunked.pair_chunk = int(unchunked.edges.shape[0])  # one chunk of all edges: none
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                do_optimization_fused(d2, unchunked, data.X_obs, max_iters=args.iters, ftol=0.0)
            unchunked_s = time.perf_counter() - t0
            fits["unchunked"] = (d2, unchunked)
            for name, (fd, f) in fits.items():
                steps, _, values = load_log(fd)
                xs = {int(n[5:10]): n for n in os.listdir(fd)
                      if n.startswith("step_") and n.endswith("_X.npy")}
                mads = {k: data.mean_distance(np.load(os.path.join(fd, v)).reshape(-1))
                        for k, v in sorted(xs.items())}
                at = [i for i in (19, 39, 59, 99, 139, 199, len(steps) - 1) if i < len(steps)]
                print(json.dumps({"what": "fit", "pair_chunk": name, "iterations": len(steps),
                                  "m_end": f.m, "objective_at": {str(i): float(values[i])
                                                                 for i in at},
                                  "mad_at": {str(k): v for k, v in mads.items()},
                                  "seconds": unchunked_s if name == "unchunked" else None,
                                  "card": card}), flush=True)

        if args.f64_iters:
            d3 = os.path.join(base, "stall_run_float64")
            shutil.rmtree(d3, ignore_errors=True)
            os.makedirs(d3)
            f64 = engine(torch.float64, mvn.LINALG_OPS)
            f64.m = fused.m
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                x64 = do_optimization_fused(d3, f64, x.reshape(data.X_obs.shape),
                                            max_iters=args.f64_iters, steps_per_dispatch=10,
                                            ftol=0.0)
            seconds = time.perf_counter() - t0
            steps, _, values = load_log(d3)
            mads = {int(n[5:10]): data.mean_distance(np.load(os.path.join(d3, n)).reshape(-1))
                    for n in sorted(os.listdir(d3)) if n.startswith("step_") and n.endswith("_X.npy")}
            print(json.dumps({"what": "float64_from_the_stalled_x", "from_step": last,
                              "iterations": len(steps), "seconds": seconds,
                              "ms_per_iteration": seconds / len(steps) * 1e3,
                              "objective": [float(values[0]), float(values.max()),
                                            float(values[-1])],
                              "mad_start": data.mean_distance(x),
                              "mad_final": data.mean_distance(x64),
                              "mad_at": {str(k): v for k, v in mads.items()}, "m": f64.m,
                              "card": card}), flush=True)


def label_check(data, f64, m, X_stalled, kernels, dev="cuda"):
    """The float32 and the float64 re-block at the stalled X and at X_obs,
    and the float64 loss on the float32 partition against the kernels'."""
    import numpy as np
    import torch

    from gprf_torch.model.fused import grid_labels
    from gprf_torch.optim.lbfgs import value_and_grad

    f32, f64_t = torch.float32, torch.float64
    c64 = torch.as_tensor(np.asarray(data.centers), dtype=f64_t, device=dev)
    c32 = c64.float()
    record = {"what": "labels", "m": m}
    for where, X_np in (("stalled", X_stalled), ("X_obs", data.X_obs)):
        X = torch.as_tensor(X_np, dtype=f64_t, device=dev)
        differ = grid_labels(X.to(f32), c32) != grid_labels(X, c64)
        gap = boundary_gaps(X, c64)
        record[where] = {"labels_differ": int(differ.sum()),
                         "gap_of_those": [float(g) for g in gap[differ][:20]],
                         "points_within": {t: int((gap < float(t)).sum())
                                           for t in ("1e-7", "1e-6", "1e-5", "1e-4")}}
    x = torch.as_tensor(X_stalled.reshape(-1), dtype=f64_t, device=dev)
    v32, g32 = kernels
    for partition in ("float64", "float32"):
        f64.m = m
        if partition == "float32":
            f64._assign_device = lambda X: grid_labels(X.to(f32), c32)
        v, g = value_and_grad(f64.loss_fn(), x)
        record["float64_loss_on_the_%s_partition" % partition] = {
            "loss": float(v), "kernels_loss_rel": abs(v32 - float(v)) / abs(float(v)),
            "kernels_one_minus_cosine": float(1 - g32 @ g / (g32.norm() * g.norm())),
            "kernels_rel_norm_diff": float((g32 - g).norm() / g.norm())}
    return record


def boundary_gaps(X, centers):
    """Each point's distance to its block's boundary: the second-nearest
    centre's distance less the nearest's (float64)."""
    import torch

    nearest = torch.topk(torch.cdist(X, centers), 2, largest=False).values
    return nearest[:, 1] - nearest[:, 0]


def unpin(data, engine, m, X_stalled, base, iters, dev="cuda"):
    """The kernels' fit restarted from the stalled X as it is, and with the
    points on a block boundary moved off it into their float32 block."""
    import numpy as np
    import torch

    from gprf_torch.model.fused import grid_labels
    from gprf_torch.ops import mvn
    from gprf_torch.optim.driver import load_log
    from gprf_torch.optim.lbfgs import do_optimization_fused

    c64 = torch.as_tensor(np.asarray(data.centers), dtype=torch.float64, device=dev)
    X = torch.as_tensor(X_stalled, dtype=torch.float64, device=dev)
    labels32 = grid_labels(X.float(), c64.float())
    pinned = torch.nonzero(boundary_gaps(X, c64) < 1e-6).reshape(-1)
    toward = c64[labels32[pinned]] - X[pinned]
    moved = X.clone()
    moved[pinned] += 1e-5 * toward / toward.norm(dim=1, keepdim=True)
    for name, X0 in (("restart", X), ("unpinned", moved)):
        d = os.path.join(base, "stall_" + name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        f = engine(torch.float32, mvn.KERNEL_OPS)
        f.m = m
        with contextlib.redirect_stdout(sys.stderr):
            x_end = do_optimization_fused(d, f, X0.cpu().numpy(), max_iters=iters, ftol=0.0)
        _, _, values = load_log(d)
        X_end = torch.as_tensor(x_end.reshape(X_stalled.shape), dtype=torch.float64, device=dev)
        gaps = boundary_gaps(X_end, c64)
        yield {"what": "unpin", "start": name, "points_moved": int(pinned.numel()),
               "iterations": len(values), "objective": [float(values[0]), float(values[-1])],
               "mad_start": data.mean_distance(X0.cpu().numpy().reshape(-1)),
               "mad_end": data.mean_distance(x_end), "m_end": f.m,
               "points_within_1e-7_at_the_end": int((gaps < 1e-7).sum()),
               "points_within_1e-6_at_the_end": int((gaps < 1e-6).sum())}


def _unsplit32():
    """float32 on torch.linalg in whole blocks: the twins without the
    split's glue."""
    from gprf_torch.ops import mvn

    return mvn.PLAIN_OPS._replace(leaf_caps=False)


def matchings(edges):
    """The block graph's edges in classes of which no two share a block
    (greedy colouring): each class's pair gradients have disjoint supports."""
    colour = []
    used = {}
    for i, j in edges:
        c = 0
        while c in used.get(i, set()) or c in used.get(j, set()):
            c += 1
        colour.append(c)
        used.setdefault(i, set()).add(c)
        used.setdefault(j, set()).add(c)
    return colour


def term_errors(data, X_np, edges_t, dev="cuda"):
    """Each term's float32 gradient error against float64, four ways."""
    import numpy as np
    import torch

    from gprf_torch.model.fused import assemble_layout, grid_labels
    from gprf_torch.model.gprf import _auto_chunk
    from gprf_torch.model.objective import (GPRFParams, gprf_value_and_grad,
                                            gprf_value_and_grad_schur)
    from gprf_torch.ops import mvn

    f32, f64 = torch.float32, torch.float64
    B = len(data.centers)
    edges = edges_t.long()
    E = int(edges.shape[0])
    ei, ej = edges[:, 0], edges[:, 1]
    deg = torch.bincount(edges.reshape(-1), minlength=B)
    uw = (1.0 - deg).double()
    centers = torch.as_tensor(np.asarray(data.centers), dtype=f64, device=dev)
    X64 = torch.as_tensor(X_np, dtype=f64, device=dev)
    labels = grid_labels(X64, centers)
    mX = (int(torch.bincount(labels, minlength=B).max()) + 7) // 8 * 8
    assignment, mask, _ = assemble_layout(labels, B, mX)
    Y64 = torch.as_tensor(data.SY, dtype=f64, device=dev)
    cov = data.cov

    def params(dt):
        return GPRFParams(X=X64.to(dt), wfn_params=cov.wfn_params.to(device=dev, dtype=dt),
                          dfn_params=cov.dfn_params.to(device=dev, dtype=dt),
                          noise_var=torch.tensor(data.noise_var, dtype=dt, device=dev))

    colour = matchings(edges.cpu().tolist())
    ncol = max(colour) + 1
    colour_t = torch.tensor(colour, device=dev)
    # the weight vectors of each evaluation: the unary terms, then a matching each
    weightings = [(uw, torch.zeros(E, dtype=f64, device=dev))]
    weightings += [(torch.zeros(B, dtype=f64, device=dev), (colour_t == c).double())
                   for c in range(ncol)]
    pa = torch.cat([assignment[ei], assignment[ej]], 1)
    pm = torch.cat([mask[ei], mask[ej]], 1)
    chunks = dict(unary_chunk=_auto_chunk(B, mX), pair_chunk=_auto_chunk(E, 2 * mX))

    def grads(way, weights=None, pair_chunk=None):
        out = []
        for u, w in weights or weightings:
            if way == "joint64":
                _, g, _ = gprf_value_and_grad(params(f64), Y64, assignment, mask, pa, pm, u, w,
                                              **chunks)
            else:
                ops = {"kernels": mvn.KERNEL_OPS, "twins32": mvn.PLAIN_OPS,
                       "linalg32_unsplit": _unsplit32()}[way]
                _, g, _ = gprf_value_and_grad_schur(params(f32), Y64.to(f32), assignment, mask,
                                                    edges, u.to(f32), w.to(f32),
                                                    acc_dtype=f64, ops=ops, pair_chunk=pair_chunk)
            out.append(g.double())
        return out

    t0 = time.perf_counter()
    ref = grads("joint64")
    joint_s = time.perf_counter() - t0
    # each term's points: block i's, or blocks i and j's
    members = [labels == b for b in range(B)]
    supports = [members[b] for b in range(B)] + [members[i] | members[j]
                                                   for i, j in edges.cpu().tolist()]
    which = [0] * B + [1 + c for c in colour]  # the evaluation each term is read from
    names = ["unary %d (weight %d)" % (b, int(uw[b])) for b in range(B)] + [
        "pair %d-%d" % (i, j) for i, j in edges.cpu().tolist()]
    g64_total = sum(ref)
    record = {"what": "terms", "m": mX, "blocks": B, "edges": E, "matchings": ncol,
              "joint64_seconds": joint_s, "joint_chunks": chunks,
              "grad_norm_float64": float(g64_total.norm())}
    worst_terms = {}
    for way in ("kernels", "twins32", "linalg32_unsplit"):
        got = grads(way)
        diff = [g - r for g, r in zip(got, ref)]
        total = sum(diff)
        errs = torch.stack([diff[w][s].norm() for w, s in zip(which, supports)])
        share = errs ** 2 / (errs ** 2).sum()
        order = torch.argsort(share, descending=True)
        cum = torch.cumsum(share[order], 0)
        k90 = int(torch.searchsorted(cum, torch.tensor(0.9, dtype=cum.dtype, device=dev))) + 1
        top = order[:k90]
        top_sum = sum(diff[which[t]] * supports[t][:, None] for t in top.tolist())
        worst = order[:10].tolist()
        worst_terms[way] = worst
        # the whole gradient in one evaluation, unchunked and (the fit's) in
        # pair chunks of 64 with their (0, 0) dummies and remat
        whole = [(uw, torch.ones(E, dtype=f64, device=dev))]
        whole_err = {str(c): float((grads(way, whole, c)[0] - g64_total).norm()
                                   / g64_total.norm()) for c in (None, 64)}
        record[way] = {
            "rel_norm_error": float(total.norm() / g64_total.norm()),
            "whole_rel_norm_error_by_pair_chunk": whole_err,
            "one_minus_cosine": float(1 - (sum(got).reshape(-1) @ g64_total.reshape(-1))
                                      / (sum(got).norm() * g64_total.norm())),
            "terms_for_90pct": k90, "of_terms": B + E,
            "unary_share": float(share[:B].sum()),
            "top_terms_capture_of_norm": float(1 - (total - top_sum).norm() / total.norm()),
            "worst": [{"term": names[t], "share": float(share[t]),
                       "error_norm": float(errs[t])} for t in worst]}

    # the ten worst terms of the kernels: condition number and the closest points
    for entry, t in zip(record["kernels"]["worst"], worst_terms["kernels"]):
        idx = torch.nonzero(supports[t]).reshape(-1)
        Xt = X64[idx]
        K = cov_matrix(Xt, cov, data.noise_var)
        ev = torch.linalg.eigvalsh(K)
        dist = torch.cdist(Xt, Xt) + torch.eye(len(idx), dtype=f64, device=dev) * 1e9
        entry.update(points=len(idx), cond_float64=float(ev[-1] / ev[0]),
                     min_distance=float(dist.min()),
                     min_distance_over_lengthscale=float(dist.min()
                                                         / float(cov.dfn_params[0])))
    return record


def cov_matrix(X, cov, noise_var):
    import torch

    from gprf_torch.kernels.covfn import cross_kernel_matrix

    c = cov.to(device=X.device, dtype=X.dtype)
    return cross_kernel_matrix(c, X, X) + noise_var * torch.eye(len(X), dtype=X.dtype,
                                                                 device=X.device)


if __name__ == "__main__":
    main()
