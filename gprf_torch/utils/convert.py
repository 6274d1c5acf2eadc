"""Parameters and problem state from numpy arrays.

``gprf_tpu`` keeps its parameters as JAX arrays; ``np.asarray`` of those
(or any host arrays) goes through these helpers into the port's types, so
both packages can be given identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.objective import GPRFParams


def params_from_numpy(X, wfn_params, dfn_params, noise_var, *,
                      device: torch.device | str, dtype: torch.dtype) -> GPRFParams:
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    return GPRFParams(X=t(X), wfn_params=t(wfn_params).reshape(-1),
                      dfn_params=t(dfn_params).reshape(-1), noise_var=t(noise_var).reshape(()))


def cov_from_numpy(wfn_params, dfn_params, dfn_str: str = "euclidean", wfn_str: str = "se",
                   *, device: torch.device | str, dtype: torch.dtype) -> GPCov:
    return GPCov.create(np.asarray(wfn_params, dtype=np.float64),
                        np.asarray(dfn_params, dtype=np.float64), dfn_str, wfn_str,
                        device=device, dtype=dtype)


def sampled_data_from_numpy(SX, SY, Xtest, Ytest, X_obs, cov_row, lscale, obs_std):
    """A :class:`~gprf_torch.data.sampled.SampledData` from another
    package's dataset: its arrays and its full cov row [nv, sv, l1, l2]."""
    from gprf_torch.data.sampled import SampledData

    return SampledData.from_arrays(SX, SY, Xtest, Ytest, X_obs, cov_row, lscale, obs_std)


def layout_from_numpy(assignment, mask, sizes, edges):
    """A :class:`~gprf_torch.partition.layout.BlockLayout` from the arrays
    of another package's layout, at the same padded width."""
    from gprf_torch.partition.layout import BlockLayout

    assignment, sizes = np.asarray(assignment), np.asarray(sizes)
    if not np.array_equal(np.asarray(mask).sum(axis=1), sizes):
        raise ValueError("mask and sizes disagree")
    blocks = [assignment[b, :k] for b, k in enumerate(sizes)]
    n = int(sum(sizes))
    return BlockLayout.from_blocks(blocks, n=n, edges=np.asarray(edges).reshape(-1, 2),
                                   pad_to=assignment.shape[1])


def carry_from_numpy(carry, *, device: torch.device | str):
    """An L-BFGS carry (:mod:`gprf_torch.optim.lbfgs`) from a dict of NumPy
    arrays under the same keys, each at its own dtype (``head`` as int64)."""
    out = {k: torch.tensor(np.asarray(v), device=device) for k, v in carry.items()}
    out["head"] = out["head"].long()
    return out


def carry_to_numpy(carry):
    """The carry as a dict of NumPy arrays, for another package or a file."""
    return {k: v.detach().cpu().numpy() for k, v in carry.items()}
