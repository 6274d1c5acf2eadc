"""Kernel hyperparameter container.

``GPCov(wfn_params, dfn_params, dfn_str, wfn_str)``: ``wfn_params =
[signal_var]`` parameterizes the weight (covariance) profile and
``dfn_params = [lengthscales...]`` the distance function, as in
``gprf_tpu/kernels/gpcov.py``.  The parameters are tensors, so
hyperparameter gradients come from autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

DISTANCE_FNS = ("euclidean", "lld")
WEIGHT_FNS = ("se", "matern32")


@dataclasses.dataclass(frozen=True)
class GPCov:
    """Stationary GP covariance ``k(x, x') = wfn(dfn(x, x'))``.

    ``dfn_str``: ``"euclidean"``, per-dimension scaled euclidean distance
    with one lengthscale per input dimension (``"lld"``, the seismic
    great-circle distance, is not ported yet).  ``wfn_str``: ``"se"``,
    ``sv * exp(-r^2)``, or ``"matern32"``, ``sv (1 + sqrt(3) r) exp(-sqrt(3) r)``.
    """

    wfn_params: torch.Tensor  # [1] = [signal_var]
    dfn_params: torch.Tensor  # [k] lengthscales
    dfn_str: str = "euclidean"
    wfn_str: str = "se"

    def __post_init__(self):
        if self.dfn_str not in DISTANCE_FNS:
            raise ValueError(f"unknown distance function {self.dfn_str!r}")
        if self.wfn_str not in WEIGHT_FNS:
            raise ValueError(f"unknown weight function {self.wfn_str!r}")

    @staticmethod
    def create(wfn_params: Sequence[float], dfn_params: Sequence[float],
               dfn_str: str = "euclidean", wfn_str: str = "se", *,
               device: torch.device | str, dtype: torch.dtype) -> "GPCov":
        return GPCov(
            wfn_params=torch.as_tensor(wfn_params, dtype=dtype, device=device).reshape(-1),
            dfn_params=torch.as_tensor(dfn_params, dtype=dtype, device=device).reshape(-1),
            dfn_str=dfn_str,
            wfn_str=wfn_str,
        )

    def to(self, *, device: torch.device | str, dtype: torch.dtype) -> "GPCov":
        return dataclasses.replace(self,
                                   wfn_params=self.wfn_params.to(device=device, dtype=dtype),
                                   dfn_params=self.dfn_params.to(device=device, dtype=dtype))
