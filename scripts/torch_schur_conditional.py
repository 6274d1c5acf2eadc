#!/usr/bin/env python3
"""What the pair pass's Gaussian conditional costs on the card, node by node.

    python3 scripts/torch_schur_conditional.py [--N 342] [--m 896] [--dy 50] [--out FILE]

At the 80k cell's pair batch ([N, m, m], dy columns, float32) the pair pass
of ``_schur_ll`` computes

    Bm = Ws[ei] Kij,   S = Kp[ej] - Bm^T Bm,   rhs = Ym[ej] - Bm^T Zs[ei].

One JSON line a measurement on standard output (and into ``--out`` when
given), with the card's name and power limit; device ms by CUDA events, the
median of 5 runs of 3 calls:

- ``nodes``: each autograd node of the eager composition alone, forward
  and backward: ``Ws @ Kij`` (the backward to both operands),
  ``Bm.mT @ Bm`` (``BmmBackward0`` to Bm, both branches and their sum), the
  subtraction ``C - P`` (``sub``, ``SubBackward0``), and the whole
  conditional (S, rhs) from (C, Yj, Bm, Zi), forward and backward.
- ``function``: the same conditional through
  ``gprf_torch.model.objective.SchurConditional`` (its forward builds S in C's
  storage, so each call is given a fresh copy of C, whose time is
  measured alone and taken off), at the split width of the pass; and its
  S (the blocks the split reads), rhs and gradients against the
  composition in float32 and both against the composition in float64
  (normwise relative error, largest entry).

The cotangent of S is non-symmetric, with the block the split does not
read set to zero, as the split's slices leave it.  Needs one CUDA device.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def inputs(N, m, dy, h, dtype, gen):
    """Ws lower triangular, Kij, C = Kp[ej] symmetric, Yj, Zi, and the
    cotangents dS (zero in S[:, :h, h:] where h is not None) and drhs."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float64)

    W = randn(N, m, m).tril() / m ** 0.5
    Kij = randn(N, m, m) / m ** 0.5
    C = randn(N, m, m) / m ** 0.5
    C = C @ C.mT + torch.eye(m, dtype=C.dtype, device=C.device)
    dS = randn(N, m, m)
    if h is not None:
        dS[:, :h, h:] = 0
    out = dict(W=W, Kij=Kij, C=C, Yj=randn(N, m, dy), Zi=randn(N, m, dy), dS=dS,
               drhs=randn(N, m, dy))
    return {k: v.to(dtype) for k, v in out.items()}


def composition(C, Yj, Bm, Zi):
    return C - Bm.mT @ Bm, Yj - Bm.mT @ Zi


def leaves(t, names):
    return [t[k].detach().clone().requires_grad_(True) for k in names]


def run_nodes(t, emit, shape):
    import torch

    rec = {"measure": "nodes", "shape": shape}
    W, Kij = leaves(t, ("W", "Kij"))
    with torch.no_grad():
        Bm0 = W @ Kij
    rec["fwd_WK_ms"] = device_ms(lambda: W @ Kij)
    Bm = W @ Kij
    rec["bwd_WK_ms"] = device_ms(lambda: torch.autograd.grad(Bm, (W, Kij), Bm0,
                                                             retain_graph=True))
    del Bm, W, Kij
    (B,) = leaves({"Bm": Bm0}, ("Bm",))
    rec["fwd_BtB_ms"] = device_ms(lambda: B.mT @ B)
    P = B.mT @ B
    rec["bwd_BtB_ms"] = device_ms(lambda: torch.autograd.grad(P, B, t["dS"], retain_graph=True))
    del P
    C, P = t["C"].clone().requires_grad_(True), (Bm0.mT @ Bm0).requires_grad_(True)
    rec["fwd_sub_ms"] = device_ms(lambda: C - P)
    S = C - P
    rec["bwd_sub_ms"] = device_ms(lambda: torch.autograd.grad(S, (C, P), t["dS"],
                                                              retain_graph=True))
    del C, P, S
    C, Yj, Bm, Zi = leaves(dict(t, Bm=Bm0), ("C", "Yj", "Bm", "Zi"))
    rec["fwd_conditional_ms"] = device_ms(lambda: composition(C, Yj, Bm, Zi))
    S, rhs = composition(C, Yj, Bm, Zi)
    rec["bwd_conditional_ms"] = device_ms(lambda: torch.autograd.grad(
        (S, rhs), (C, Yj, Bm, Zi), (t["dS"], t["drhs"]), retain_graph=True))
    emit(rec)
    return Bm0


def run_function(fn, t, Bm0, h, emit, shape, t64):
    import torch

    names = ("C", "Yj", "Bm", "Zi")
    C, Yj, Bm, Zi = leaves(dict(t, Bm=Bm0), names)
    rec = {"measure": "function", "shape": shape, "h": h}
    clone_ms = device_ms(lambda: C.clone())
    rec["fwd_ms"] = device_ms(lambda: fn(C.clone(), Yj, Bm, Zi, h)) - clone_ms
    rec["clone_ms"] = clone_ms
    S, rhs = fn(C.clone(), Yj, Bm, Zi, h)
    rec["bwd_ms"] = device_ms(lambda: torch.autograd.grad(
        (S, rhs), (C, Yj, Bm, Zi), (t["dS"], t["drhs"]), retain_graph=True))
    grads = torch.autograd.grad((S, rhs), (C, Yj, Bm, Zi), (t["dS"], t["drhs"]))

    def read(M):  # the blocks the split reads
        return M if h is None else torch.cat([M[:, :, :h].flatten(1), M[:, h:, h:].flatten(1)], 1)

    ref = leaves(dict(t, Bm=Bm0), names)
    S32, rhs32 = composition(*ref)
    g32 = torch.autograd.grad((S32, rhs32), ref, (t["dS"], t["drhs"]))
    ref64 = leaves(dict(t64, Bm=Bm0.double()), names)
    S64, rhs64 = composition(*ref64)
    g64 = torch.autograd.grad((S64, rhs64), ref64, (t64["dS"], t64["drhs"]))
    for tag, (Sr, rr, gr) in (("f32", (S32, rhs32, g32)), ("f64", (S64, rhs64, g64))):
        rec[f"S_rel_{tag}"] = rel(read(S), read(Sr))
        rec[f"rhs_rel_{tag}"] = rel(rhs, rr)
        rec[f"dBm_rel_{tag}"] = rel(grads[2], gr[2])
        rec[f"dZi_rel_{tag}"] = rel(grads[3], gr[3])
    rec["composition_S_rel_f64"] = rel(read(S32), read(S64))
    rec["composition_dBm_rel_f64"] = rel(g32[2], g64[2])
    emit(rec)


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--N", type=int, default=342)
    parser.add_argument("--m", type=int, default=896)
    parser.add_argument("--dy", type=int, default=50)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_schur_conditional.py: no CUDA device")
    import gprf_torch  # noqa: F401  (precision pins)
    from gprf_torch.model import objective
    from gprf_torch.ops import split_mvn

    h = split_mvn.mvn_split_width(args.m, args.dy)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None

        def emit(record):
            line = json.dumps(dict(record, card=card, tf32=torch.backends.cuda.matmul.allow_tf32))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        shape = [args.N, args.m, args.m]
        gen = torch.Generator(device="cuda").manual_seed(0)
        t = inputs(args.N, args.m, args.dy, h, torch.float32, gen)
        Bm0 = run_nodes(t, emit, shape)
        gen64 = torch.Generator(device="cuda").manual_seed(0)
        t64 = inputs(args.N, args.m, args.dy, h, torch.float64, gen64)
        run_function(objective.SchurConditional.apply, t, Bm0, h, emit, shape, t64)


if __name__ == "__main__":
    main()
