"""The one device rule of the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
