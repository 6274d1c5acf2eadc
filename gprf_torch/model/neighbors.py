"""GPRF edge (neighbor) discovery (mirror of ``gprf_tpu/model/neighbors.py``).

Every supported covariance profile is a monotone decreasing, nonnegative
function of the scaled distance, so ``max_ab k(x_a, x_b) = profile(min_ab
r2)``: edge discovery is one masked min-distance per block pair, mapped
through the profile and thresholded on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from gprf_torch.kernels.covfn import cov_value
from gprf_torch.kernels.distances import scaled_sq_distance
from gprf_torch.kernels.gpcov import GPCov

_FAR = 1e20  # stands in for +inf so matern's (1 + r) exp(-r) stays finite


def block_pair_max_corr(X, assignment, mask, wfn_params, dfn_params, dfn_str="euclidean",
                        wfn_str="se"):
    """[B, B] matrix of max_{a in i, b in j} k(x_a, x_b) / signal_var, one
    block row (a [B, m, m] batch of distances) at a time."""
    Xb = X[assignment.long()]  # [B, m, dx]
    cov = GPCov(wfn_params=wfn_params, dfn_params=dfn_params, dfn_str=dfn_str, wfn_str=wfn_str)
    far = torch.tensor(_FAR, dtype=X.dtype, device=X.device)
    rows = []
    for i in range(assignment.shape[0]):
        r2 = scaled_sq_distance(dfn_str, Xb[i], Xb, dfn_params)  # [B, m, m]
        valid = mask[i][None, :, None] & mask[:, None, :]
        rows.append(torch.where(valid, r2, far).amin(dim=(1, 2)))
    min_r2 = torch.stack(rows).clamp_max(_FAR)
    return cov_value(cov, min_r2) / wfn_params[0]


def compute_neighbors(X, assignment, mask, cov: GPCov, threshold: float = 1e-3
                      ) -> list[tuple[int, int]]:
    """Edge list [(i, j), i > j] with max cross-correlation above
    ``threshold``; ``threshold == 1.0`` means no edges (pure local GPs)."""
    if threshold == 1.0:
        return []
    with torch.no_grad():
        maxk = block_pair_max_corr(X, assignment, mask, cov.wfn_params, cov.dfn_params,
                                   dfn_str=cov.dfn_str, wfn_str=cov.wfn_str).cpu().numpy()
    B = maxk.shape[0]
    ii, jj = np.tril_indices(B, k=-1)
    keep = maxk[ii, jj] > threshold
    return [(int(i), int(j)) for i, j in zip(ii[keep], jj[keep])]
