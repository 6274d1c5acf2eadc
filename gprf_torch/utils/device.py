"""The device an entry point computes on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device to compute on; a CUDA device that is not there raises
    (nothing carries on on the CPU unless the caller asked for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for, but torch.cuda.is_available() is "
                           "False; pass --device cpu to run on the CPU")
    return device
