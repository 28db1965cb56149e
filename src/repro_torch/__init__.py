"""PyTorch + CUDA port of the hybrid sparse-dense inner-product search.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``data/``).  Importing this package needs only torch, numpy and scipy: the
CUDA kernels under ``csrc/`` are compiled with nvcc and loaded on their
first launch (``kernels/_build.py``).  Entry points take a ``device``
argument that defaults to ``"cuda"``; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels.
"""
