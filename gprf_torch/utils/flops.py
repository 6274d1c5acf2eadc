"""Analytic FLOP model of the fused GPRF objective+gradient (a copy of
``gprf_tpu/utils/flops.py`` with the card's peak).

This is a *model*: it follows arithmetic-intensity regressions across
changes, it is not a hardware counter.  The counted terms mirror the fused
Schur evaluation (:mod:`gprf_torch.model.objective`).
"""

from __future__ import annotations

# NVIDIA H100 SXM, published peak: float32 outside the tensor cores.  The
# objective computes in full float32 (TF32 off), so this is its roof.
PEAK_F32_FLOPS = 67e12


def model_flops_per_eval(B, m, E, dy, dx, passes=3.0):
    """Analytic FLOP count of one fused Schur objective(+gradient) eval.

    Forward terms (per batch element of width m):
      unary:  kernel build 2 m^2 dx + Cholesky m^3/3 + dy-rhs triangular
              solve m^2 dy
      pair:   Kij build 2 m^2 dx + wide triangular solve m^3 + Schur
              product 2 m^3 + chol(S) m^3/3 + two dy-rhs updates 3 m^2 dy

    ``passes``: 3.0 for objective+gradient (reverse mode costs ~2x
    forward), 1.0 for objective-only.
    """
    unary = B * (m**3 / 3.0 + m * m * dy + 2.0 * m * m * dx)
    pair = E * ((10.0 / 3.0) * m**3 + 3.0 * m * m * dy + 2.0 * m * m * dx)
    return passes * (unary + pair)


def roofline_str(flops, sec):
    """'xx GFLOP/s (y.yy% of the float32 peak)' for a measured wall time."""
    rate = flops / sec
    return "%.0f GFLOP/s (%.2f%% of the float32 peak)" % (
        rate / 1e9, 100.0 * rate / PEAK_F32_FLOPS)
