#!/usr/bin/env python3
"""Where the SE kernel matrices of the Schur objective spend the card's time.

    python3 scripts/torch_se_kernel.py [--m 896] [--out FILE]

Two measurements, one JSON line each on standard output (and into ``--out``
when given), with the card's name and power limit:

- ``chain``: the kernel-matrix chain of ``_schur_ll`` alone, at the 80k
  cells' shapes (pair [342, m, m], unary [100, m, m]) and the 10k cell's
  ([342, 136, 136], [100, 136, 136]), float32, dx 2: the eager
  composition (``cross_kernel_matrix``, the masks, ``pad_kernel_matrix``)
  forward with autograd recording, and its backward to both point sets
  under a non-symmetric cotangent; where the module exists,
  ``gprf_torch.ops.se_kernel``'s kernel and its plain twin the same way.
  Device ms of each (CUDA events, median of 5 runs of 3 calls), kernel
  launches (``torch.profiler``), the peak memory above what was resident,
  and the kernel's forward and X-gradient against the composition.  For
  the kernel and the twin also each call alone (``se_matrix``,
  ``se_grads`` with no hyperparameter gradient), 10 back to back between
  two events so that the host's launches hide behind the card's work,
  beside the bound: the bytes the call must move (the points, masks and
  hyperparameters read, K written; or G read and the points' gradients
  written) over 3.35 TB/s.
- ``profile``: one loss+grad of the 80k device engine (342 edges, the
  pair pass whole) and of the Local-100 engine (no edges) at capacity
  ``--m`` under ``torch.profiler`` with Python stacks: the device ms of
  every kernel under the outermost operator that launched it, a forward
  operator with its innermost ``gprf_torch`` line and a backward node with
  its forward operator's (matched by the autograd sequence number), where
  this PyTorch's events carry the stack ("?" where not); the 40 largest.

The problem has the 80k benchmark's shapes (80,000 points uniform on the
unit square, 100 grid blocks, the SE kernel at lengthscale 0.021213, noise
0.01, dy 50, Y iid normal, since the work does not depend on it).  Needs
one CUDA device.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LSCALE, OBS_STD, NOISE_VAR = 0.021213, 0.007071, 0.01
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
CHAIN_SHAPES = (("pair", 342, None), ("unary", 100, None), ("pair", 342, 136),
                ("unary", 100, 136))
TOP = 40


def composition(Xi, Xj, mi, mj, sv, ls, nv):
    """The kernel matrices as ``_schur_ll`` composed them eagerly before
    the kernel (here, so that the script runs on that code too): pair mode
    (nv None) mi_a mj_b k(xi_a, xj_b), block mode (Xj is Xi) the padded
    K + nv I."""
    import torch

    from gprf_torch.kernels.covfn import cross_kernel_matrix
    from gprf_torch.kernels.gpcov import GPCov
    from gprf_torch.linalg.masked import pad_kernel_matrix

    R = sv.shape[0]
    cov = GPCov(wfn_params=sv.reshape(R, 1, 1, 1), dfn_params=ls.reshape(R, 1, 1, -1))
    K = cross_kernel_matrix(cov, Xi, Xj)
    if nv is None:
        return K * (mi[..., :, None] * mj[..., None, :])
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return pad_kernel_matrix(K + nv.reshape(R, 1, 1, 1) * eye, mi)


def chain_inputs(mode, N, m, gen):
    """Points of N blocks of width m as the grid gives them: block i's in a
    0.1-wide cell, block j's in the next cell over; the last 0-40 points of
    each block padded."""
    import torch

    dev = "cuda"
    Xi = torch.rand(1, N, m, 2, generator=gen, device=dev) * 0.1
    Xj = Xi if mode == "unary" else torch.rand(1, N, m, 2, generator=gen, device=dev) * 0.1 + \
        torch.tensor([0.1, 0.0], device=dev)
    n_act = m - torch.randint(0, 41, (1, N, 1), generator=gen, device=dev)
    mi = (torch.arange(m, device=dev) < n_act).float()
    mj = mi if mode == "unary" else (torch.arange(m, device=dev) < n_act.flip(1)).float()
    sv = torch.ones(1, device=dev)
    ls = torch.full((1, 2), LSCALE, device=dev)
    nv = torch.full((1,), NOISE_VAR, device=dev) if mode == "unary" else None
    G = torch.randn(1, N, m, m, generator=gen, device=dev)
    return Xi, Xj, mi, mj, sv, ls, nv, G


def device_ms(fn, reps=5, calls=3):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def launches(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


def measure_chain(name, f, inputs):
    """Forward (with autograd recording) and backward of ``f`` on the
    chain's inputs: device ms, launches and peak bytes above the resident."""
    import torch

    Xi, Xj, mi, mj, sv, ls, nv, G = inputs
    xi = Xi.detach().requires_grad_(True)
    xj = xi if Xj is Xi else Xj.detach().requires_grad_(True)
    leaves = [xi] if xj is xi else [xi, xj]

    def fwd():
        return f(xi, xj, mi, mj, sv, ls, nv)

    def both():
        return torch.autograd.grad(fwd(), leaves, G)

    record = {"impl": name}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    out = fwd()
    torch.cuda.synchronize()
    record["fwd_peak_gb"] = (torch.cuda.max_memory_allocated() - resident) / 1e9
    grads = torch.autograd.grad(out, leaves, G)
    torch.cuda.synchronize()
    record["peak_gb"] = (torch.cuda.max_memory_allocated() - resident) / 1e9
    record["fwd_ms"] = device_ms(fwd)
    record["fwd_bwd_ms"] = device_ms(both)
    record["bwd_ms"] = record["fwd_bwd_ms"] - record["fwd_ms"]
    record["fwd_launches"] = launches(fwd)
    record["bwd_launches"] = launches(both) - record["fwd_launches"]
    return record, out.detach(), [g.detach() for g in grads]


def call_bytes(inputs, backward):
    """What one call of the kernel must move, each byte once."""
    Xi, Xj, mi, mj, sv, ls, nv, G = inputs
    ins = [Xi, mi, sv, ls] + ([nv] if nv is not None else [Xj, mj])
    points = sum(a.numel() * a.element_size() for a in ins)
    grads = (1 if nv is not None else 2) * Xi.numel() * Xi.element_size()
    return points + G.numel() * G.element_size() + (grads if backward else 0)


def measure_calls(sk, name, inputs):
    """Device ms of one forward and one backward call of the kernel (or the
    twin) alone, and the kernel's bound."""
    args, G = inputs[:7], inputs[7]
    fwd, bwd = ((sk.se_matrix, sk.se_grads) if name == "kernel"
                else (sk.se_matrix_plain, sk.se_grads_plain))
    hyper = (False, False, False)
    record = {"call_fwd_ms": device_ms(lambda: fwd(*args), calls=10),
              "call_bwd_ms": device_ms(lambda: bwd(G, *args, hyper=hyper), calls=10)}
    if name == "kernel":
        record["bound_fwd_ms"] = call_bytes(inputs, False) / PEAK_BYTES_PER_S * 1e3
        record["bound_bwd_ms"] = call_bytes(inputs, True) / PEAK_BYTES_PER_S * 1e3
        record["share_fwd"] = record["bound_fwd_ms"] / record["call_fwd_ms"]
        record["share_bwd"] = record["bound_bwd_ms"] / record["call_bwd_ms"]
    return record


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def run_chain(args, emit):
    import torch

    impls = {"composition": composition}
    try:
        from gprf_torch.ops import se_kernel as sk
        impls.update(kernel=sk.se_kernel, twin=sk.se_kernel_plain)
    except ImportError:  # the code before the kernel
        sk = None
    gen = torch.Generator(device="cuda").manual_seed(0)
    for mode, N, m in CHAIN_SHAPES:
        m = m or args.m
        inputs = chain_inputs(mode, N, m, gen)
        ref = None
        for name, f in impls.items():
            record, out, grads = measure_chain(name, f, inputs)
            record.update(measure="chain", mode=mode, shape=[N, m, m])
            if ref is None:
                ref = (out, grads)
            else:
                record["fwd_rel"] = rel(out, ref[0])
                record["dX_rel"] = max(rel(g, r) for g, r in zip(grads, ref[1]))
                record.update(measure_calls(sk, name, inputs))
            emit(record)
            del out, grads
        del inputs, ref


OPS = ("aten::", "autograd::engine::evaluate_function")


def _frame_key(name):
    return name[name.index("gprf_torch/"):] if "gprf_torch/" in name else None


def forward_key(evt):
    """The innermost gprf_torch frame above an operator: from its recorded
    stack, or from the Python calls that the profiler records as its
    parents in some versions."""
    for frame in evt.stack or ():
        key = _frame_key(frame)
        if key:
            return key
    e = evt.cpu_parent
    while e is not None:
        key = _frame_key(e.name)
        if key:
            return key
        e = e.cpu_parent
    return "?"


def outermost(evt):
    """The outermost operator (an aten operator or a backward node) at or
    above ``evt``."""
    top, e = evt, evt
    while e is not None:
        if e.name.startswith(OPS):
            top = e
        e = e.cpu_parent
    return top


def attribute(prof):
    """Device ms of every kernel under the outermost operator that launched
    it: a forward operator by its innermost gprf_torch line, a backward node
    by its forward operator's line (the autograd sequence number); a kernel
    launched after the first backward node began, outside any node, counts
    as the backward's."""
    events = prof.events()
    fwd_key = {}
    for e in events:
        if e.sequence_nr >= 0 and e.name.startswith("aten::") and \
                not (e.cpu_parent is not None and e.cpu_parent.name.startswith(OPS)):
            fwd_key.setdefault(e.sequence_nr, forward_key(e))
    starts = [e.time_range.start for e in events if e.name.startswith(OPS[1])]
    bwd_start = min(starts) if starts else float("inf")
    totals = defaultdict(float)
    for e in events:
        us = sum(k.duration for k in e.kernels)
        if not us:
            continue
        top = outermost(e)
        if top.name.startswith(OPS[1]):
            key = f"bwd {top.name.split(': ', 1)[-1]} <- {fwd_key.get(top.sequence_nr, '?')}"
        elif top.time_range.start >= bwd_start:
            key = f"bwd ({top.name}) @ {forward_key(top)}"
        else:
            key = f"fwd {top.name} @ {forward_key(top)}"
        totals[key] += us / 1e3
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def run_profile(args, emit):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gprf_torch.kernels.gpcov import GPCov
    from gprf_torch.model.fused import FusedSyntheticGPRF
    from gprf_torch.ops import mvn
    from gprf_torch.optim.lbfgs import value_and_grad
    from gprf_torch.partition.grid import Blocker, grid_centers

    rng = np.random.default_rng(0)
    n, dy = 80000, 50
    X_obs = rng.uniform(size=(n, 2)) + OBS_STD * rng.standard_normal((n, 2))
    Y = rng.standard_normal((n, dy))
    centers = np.asarray(grid_centers(100))
    for cell, edges in (("80k", Blocker(centers).neighbors(diag_connections=True)),
                        ("local", np.zeros((0, 2), dtype=np.int64))):
        cov = GPCov.create([1.0], [LSCALE, LSCALE], "euclidean", "se", device="cuda",
                           dtype=torch.float32)
        fused = FusedSyntheticGPRF(X_obs, Y, edges, X_obs, OBS_STD, cov, NOISE_VAR, task="x",
                                   centers=centers, m=args.m, device="cuda",
                                   dtype=torch.float32, acc_dtype=torch.float64,
                                   ops=mvn.KERNEL_OPS)
        loss = fused.loss_fn()
        theta = torch.as_tensor(X_obs.reshape(-1), dtype=torch.float32, device="cuda")
        value_and_grad(loss, theta)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            value_and_grad(loss, theta)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        totals = attribute(prof)
        emit({"measure": "profile", "cell": cell, "m": fused.m, "edges": len(edges),
              "device_busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
              "launches": len(kernels), "attributed_ms": sum(totals.values()),
              "top": {k: round(v, 4) for k, v in list(totals.items())[:TOP]}})
        del fused, loss, prof


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--m", type=int, default=896)
    parser.add_argument("--skip", nargs="*", default=[], choices=["chain", "profile"])
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_se_kernel.py: no CUDA device")
    import gprf_torch  # noqa: F401  (precision pins)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None

        def emit(record):
            line = json.dumps(dict(record, card=card))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        if "chain" not in args.skip:
            run_chain(args, emit)
        if "profile" not in args.skip:
            run_profile(args, emit)


if __name__ == "__main__":
    main()
