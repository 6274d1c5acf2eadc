"""The yardstick's arithmetic: the card's published peaks, each kernel's
operations and bytes, and the analytic FLOP count of one objective and
gradient evaluation.  Pure Python; nothing here imports the program.

The kernel counts copy ``chip_smoke.py``'s ``work`` and ``bound``: each
input read once, the [B, m, m] matrix (K or L) only in its lower triangle,
each output written once, whole; a Cholesky or a triangular inverse m^3/3
FLOPs a matrix, a substitution of dy right-hand sides m^2 dy and the
quadratic form 2 m dy.  The evaluation count copies the terms of
``gprf_torch/utils/flops.py``, with each unary and pair term at its blocks'
own sizes rather than at the padded capacity.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
PEAKS = {
    "f32_flops": 67e12,  # float32 outside the tensor cores (the objective runs with TF32 off)
    "hbm_bytes_per_s": 3.35e12,
}

# kernel -> (the program's kernel function, the wrapper of gprf_torch.ops.mvn)
KERNELS = {
    "K1": ("chol_inv_kernel", "chol_inv"),
    "K2": ("mvn_kernel", "mvn_ll"),
    "K3": ("tri_inv_kernel", "tri_inv"),
}


def kernel_work(wrapper: str, B: int, m: int, dy: int = 0, elem: int = 4) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of a kernel wrapper on a [B, m, m] batch
    (and [B, m, dy] right-hand sides and [B] active counts for mvn_ll)."""
    chol, rhs = m**3 / 3, m * m * dy + 2 * m * dy
    flops = {"chol_inv": 2 * chol, "mvn_ll": chol + rhs, "tri_inv": chol,
             "mvn_ll_inv": 2 * chol + rhs, "cholesky": chol}[wrapper]
    out_floats = {"chol_inv": 2 * m * m, "mvn_ll": m * m + 1, "tri_inv": m * m,
                  "mvn_ll_inv": m * m + m * dy + 1, "cholesky": m * m}[wrapper]
    extra_in = (m * dy + 1) * elem if wrapper in ("mvn_ll", "mvn_ll_inv") else 0
    in_bytes = B * (m * (m + 1) // 2 * elem + extra_in)
    return B * flops, in_bytes + B * out_floats * 4


def kernel_bound_s(wrapper: str, B: int, m: int, dy: int = 0) -> float:
    """The least time the card could take for one call, at the peaks."""
    flops, nbytes = kernel_work(wrapper, B, m, dy)
    return max(flops / PEAKS["f32_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def unary_flops(n: int, dy: int, dx: int) -> float:
    """Kernel build 2 n^2 dx, Cholesky n^3/3, dy-column solve n^2 dy."""
    return n**3 / 3.0 + n * n * dy + 2.0 * n * n * dx


def pair_flops(ni: int, nj: int, dy: int, dx: int) -> float:
    """The Schur pair of blocks i (factored in the unary pass) and j: the
    cross kernel 2 ni nj dx, the wide solve W_i K_ij ni^2 nj, the Schur
    product 2 ni nj^2, chol(S) nj^3/3, the two dy-column updates
    2 ni nj dy + nj^2 dy.  At ni = nj = m: (10/3) m^3 + 3 m^2 dy + 2 m^2 dx."""
    return (ni * ni * nj + 2.0 * ni * nj * nj + nj**3 / 3.0 + 2.0 * ni * nj * dy + nj * nj * dy
            + 2.0 * ni * nj * dx)


def eval_flops(sizes, edges, dy: int, dx: int, passes: float = 3.0) -> float:
    """Model FLOPs of one objective+gradient evaluation (``passes`` = 3:
    the reverse pass costs about twice the forward) at block sizes
    ``sizes`` [B] and ``edges`` [(i, j)]."""
    unary = sum(unary_flops(int(n), dy, dx) for n in sizes)
    pair = sum(pair_flops(int(sizes[i]), int(sizes[j]), dy, dx) for i, j in edges)
    return passes * (unary + pair)


def roofline_share(kernel: str, calls, kernels) -> float | None:
    """Percent of its roofline that ``kernel`` ("K1".."K3") reached in a
    traced window: the mean bound of its wrapper's calls ``calls`` [(wrapper,
    B, m, dy)] over the mean device time of its events ``kernels`` [(name,
    seconds)].  None where it did not run."""
    fn, wrapper = KERNELS[kernel]
    bounds = [kernel_bound_s(w, B, m, dy) for w, B, m, dy in calls if w == wrapper]
    times = [s for name, s in kernels if fn in name]
    if not bounds or not times:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times))
