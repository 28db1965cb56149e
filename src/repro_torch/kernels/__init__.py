"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the wrappers that route between them (counterpart of ``repro.kernels``)."""
