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
    with one lengthscale per input dimension, or ``"lld"``, the seismic
    great-circle surface distance with depth, lengthscales [l_h, l_z] km.  ``wfn_str``: ``"se"``,
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

    @property
    def signal_var(self) -> torch.Tensor:
        return self.wfn_params[0]

    @property
    def n_params(self) -> int:
        """Length of a gradCov row: [noise_var, signal_var, *lengthscales]."""
        return 1 + self.wfn_params.numel() + self.dfn_params.numel()

    def with_params(self, wfn_params=None, dfn_params=None) -> "GPCov":
        """The same kernel with other parameters (tensors, or values put on
        the device and at the width of the current ones)."""
        def like(new, old):
            return old if new is None else torch.as_tensor(new, dtype=old.dtype,
                                                            device=old.device).reshape(-1)

        return dataclasses.replace(self, wfn_params=like(wfn_params, self.wfn_params),
                                   dfn_params=like(dfn_params, self.dfn_params))


def full_cov_to_gpcov(FC, dfn_str: str = "euclidean", wfn_str: str = "se"):
    """(GPCov, noise_var) from a full cov row ``[noise_var, signal_var, l1,
    l2, ...]`` (a tensor, kept on its device and at its width)."""
    FC = torch.as_tensor(FC).reshape(-1)
    return GPCov(wfn_params=FC[1:2], dfn_params=FC[2:], dfn_str=dfn_str, wfn_str=wfn_str), FC[0]


def gpcov_to_full_cov(cov: GPCov, noise_var) -> torch.Tensor:
    """The inverse of :func:`full_cov_to_gpcov`: the [1, 2 + k] row."""
    nv = torch.as_tensor(noise_var, dtype=cov.wfn_params.dtype,
                         device=cov.wfn_params.device).reshape(1)
    return torch.cat([nv, cov.wfn_params, cov.dfn_params]).reshape(1, -1)
