"""Morton (Z-order) sorting for spatial locality (a copy of
``gprf_tpu/partition/morton.py``).

Lays out events so that nearby rows are nearby in memory, which keeps block
partitions nearly contiguous.  Host NumPy: quantize each coordinate to 21
bits and interleave.
"""

from __future__ import annotations

import numpy as np

_BITS = 21


def _spread_bits_3(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are 2 zero bits between each."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def _spread_bits_2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def morton_codes(X: np.ndarray) -> np.ndarray:
    """Z-order codes for 2-d or 3-d coordinates (rows of X)."""
    X = np.asarray(X, dtype=np.float64)
    lo = X.min(axis=0)
    hi = X.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = ((X - lo) / span * (2**_BITS - 1)).astype(np.uint64)
    d = X.shape[1]
    if d == 2:
        return _spread_bits_2(q[:, 0]) | (_spread_bits_2(q[:, 1]) << np.uint64(1))
    elif d == 3:
        return (
            _spread_bits_3(q[:, 0])
            | (_spread_bits_3(q[:, 1]) << np.uint64(1))
            | (_spread_bits_3(q[:, 2]) << np.uint64(2))
        )
    raise ValueError(f"morton codes support 2-d/3-d coords, got {d}-d")


def sort_morton(X: np.ndarray, *arrays):
    """Sort rows of X (and parallel arrays) by Morton order of the coords.
    Returns (X_sorted, *arrays_sorted, perm)."""
    perm = np.argsort(morton_codes(X), kind="stable")
    out = [np.asarray(X)[perm]] + [np.asarray(a)[perm] for a in arrays]
    out.append(perm)
    return tuple(out)
