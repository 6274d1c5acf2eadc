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
