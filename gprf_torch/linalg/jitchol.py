"""Host-side Cholesky with escalating jitter (a copy of
``gprf_tpu/linalg/jitchol.py``).

Try a plain factorization; on failure start from ``jitter = mean(diag) *
1e-6`` and multiply by 10 up to ``maxtries`` times.  Used where data is
generated (prior sampling), which runs in float64 NumPy on the host.
"""

from __future__ import annotations

import numpy as np


def jitchol(A: np.ndarray, maxtries: int = 5) -> np.ndarray:
    """Lower-triangular L with L L^T = A (+ escalating jitter if needed)."""
    A = np.asarray(A)
    try:
        return np.linalg.cholesky(A)
    except np.linalg.LinAlgError:
        pass
    diagA = np.diag(A)
    if np.any(diagA <= 0.0):
        raise np.linalg.LinAlgError("not pd: non-positive diagonal elements")
    jitter = diagA.mean() * 1e-6
    num_tries = 0
    while num_tries < maxtries and np.isfinite(jitter):
        try:
            return np.linalg.cholesky(A + np.eye(A.shape[0]) * jitter)
        except np.linalg.LinAlgError:
            jitter *= 10
        num_tries += 1
    raise np.linalg.LinAlgError("not positive definite, even with jitter.")
