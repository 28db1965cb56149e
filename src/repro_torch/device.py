"""The one device rule of the port's entry points, and the one way host
code reads a tensor or an array as numpy."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_numpy"]


def resolve_device(device="cuda") -> torch.device:
    """Entry points run on ``cuda`` unless the caller asks for the CPU.
    A CUDA request without a usable card raises: nothing falls back to the
    CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def to_numpy(x) -> np.ndarray:
    """A host numpy view of a tensor on any device, or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
