"""The one device rule of the port's entry points, the one way host code
reads a tensor or an array as numpy, the f32 rule of the products that
stand for the JAX package's f32 matmuls, and the f32 rule of the sums of
the models' bf16 products."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["resolve_device", "to_numpy", "full_f32", "f32_reductions"]


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


@contextlib.contextmanager
def full_f32():
    """f32 products stay f32: TF32 off for the duration, whatever the
    caller set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def f32_reductions():
    """The sums of bf16 products stay f32, as XLA keeps them in the JAX
    package: cuBLAS's reduced-precision (bf16) split-K reductions off for
    the duration, whatever the caller set.  PyTorch allows them by default;
    with them a decode step's products at M = B were summed otherwise than
    the forward's, and at qwen2-moe-a2.7b's 24 layers the two routes sent
    the last token to other experts from layer 7 on (ROADMAP C9).  Usable
    as a decorator."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
