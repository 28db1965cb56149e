"""LUT16 ADC scan on Hopper: code packing and the launchers of K1 and K2.

K1 (``csrc/lut16.cu:lut16_adc_kernel``) replaces
``repro/kernels/lut16.py:lut16_adc_pallas`` and writes the (Q, N) matrix
``out[q, n] = sum_k lut[q, k, codes[n, k]]``.  K2
(``lut16_topk_partial_kernel`` + ``topk_merge_kernel``) replaces
``lut16_adc_topk_pallas``: per-CTA top-``cbuf`` lists of ``base + scan``
merged pairwise, the (Q, N) matrix never written.  What bounds each and what
the design does about it is noted in the CUDA source.

The launchers here take tensors that ``kernels/ops.py`` has already checked
and shaped: LUT (Q, kl, 16) f32 contiguous, codes (N, Kc) uint8 contiguous.
They allocate outputs and scratch with ``torch.empty`` and launch on the
current stream.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["candidate_buffer_width", "pack_codes", "unpack_codes",
           "lut16_adc_cuda", "lut16_adc_topk_cuda", "topk_half_width",
           "THREADS"]

THREADS = 256       # rows per chunk in csrc/lut16.cu (kThreads)
LUT_WIDTH = 16      # LUT entries per subspace the kernels read

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "lut16_adc_launch": ([_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P], _I),
    "lut16_topk_launch": ([_P, _P, _P, _LL, _P, _P, _P, _P, _LL, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P], _I),
    "lut16_adc_smem_bytes": ([_I, _I, _I], _LL),
    "lut16_topk_smem_bytes": ([_I, _I, _I, _I], _LL),
    "lut16_error_string": ([_I], ctypes.c_char_p),
}


def candidate_buffer_width(k: int) -> int:
    """Candidate-buffer width for a top-``k`` fused select: ``k`` rounded up
    to a multiple of 128 (at least 128), as in the JAX package."""
    return max(-(-k // 128) * 128, 128)


def topk_half_width(cbuf: int) -> int:
    """Per-query sort width of K2's shared-memory buffer (and of its staging
    area): the next power of two >= cbuf, at least one chunk of rows."""
    return max(1 << (cbuf - 1).bit_length(), THREADS)


def pack_codes(codes):
    """(N, K) codes in [0, 16) -> (N, ceil(K/2)) uint8, two codes per byte.

    Subspace 2j sits in the low nibble of byte j, subspace 2j+1 in the high
    nibble (paper §6.1.1's storage).  Odd K is zero-padded with one phantom
    subspace in the last byte's high nibble; the scoring wrappers zero the
    phantom LUT column or slice it off, so the pad contributes nothing.
    Values outside [0, 16) would silently corrupt the neighbouring nibble, so
    they are rejected.  Host-side numpy, as in the JAX package."""
    codes = np.asarray(codes)
    if codes.ndim != 2:
        raise ValueError(f"codes must be 2-D (N, K), got shape {codes.shape}")
    if codes.size and (codes.min() < 0 or codes.max() > 15):
        raise ValueError(
            "pack_codes requires 4-bit codes in [0, 16); got range "
            f"[{int(codes.min())}, {int(codes.max())}]")
    if codes.shape[1] % 2:
        codes = np.pad(codes, ((0, 0), (0, 1)))
    lo = codes[:, 0::2].astype(np.uint8)
    hi = codes[:, 1::2].astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_codes(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(N, Kp) packed bytes -> (N, k) uint8 codes; inverse of pack_codes.

    k is the LOGICAL subspace count: 2*Kp, or 2*Kp - 1 when the trailing
    high nibble is odd-K padding (sliced off here)."""
    packed = torch.as_tensor(packed)
    kp = packed.shape[1]
    if not 0 <= 2 * kp - k <= 1:
        raise ValueError(
            f"(N, {kp}) packed bytes cannot hold {k} subspace codes")
    lo = packed & 0x0F
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=2).reshape(packed.shape[0], 2 * kp)
    return out[:, :k].to(torch.uint8).contiguous()


def _lib() -> ctypes.CDLL:
    return _build.load("lut16", _SIGNATURES)


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({lib.lut16_error_string(code).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def adc_smem_bytes(bq: int, kc: int, kl: int) -> int:
    return int(_lib().lut16_adc_smem_bytes(bq, kc, kl))


def topk_smem_bytes(bq: int, kc: int, kl: int, half: int) -> int:
    return int(_lib().lut16_topk_smem_bytes(bq, kc, kl, half))


def lut16_adc_cuda(codes: torch.Tensor, lut: torch.Tensor, *, packed: bool,
                   bq: int, rows_per_cta: int) -> torch.Tensor:
    """Launch K1: (Q, N) f32 scores."""
    lib = _lib()
    n, kc = codes.shape
    q, kl, _ = lut.shape
    out = torch.empty((q, n), dtype=torch.float32, device=codes.device)
    code = lib.lut16_adc_launch(codes.data_ptr(), lut.data_ptr(),
                                out.data_ptr(), n, kc, q, kl, int(packed), bq,
                                rows_per_cta, _stream(codes))
    _check(lib, code, "lut16_adc")
    return out


def lut16_adc_topk_cuda(codes: torch.Tensor, lut: torch.Tensor,
                        base: torch.Tensor, *, cbuf: int, packed: bool,
                        bq: int, rows_per_cta: int):
    """Launch K2: (Q, cbuf) scores and int32 row ids, best first; slots
    never filled are (-inf, -1).  ``base`` is (Q, N) or (1, N) f32."""
    lib = _lib()
    n, kc = codes.shape
    q, kl, _ = lut.shape
    parts = -(-n // rows_per_cta)
    dev = codes.device
    scratch_a = torch.empty((q, parts, cbuf), dtype=torch.int64, device=dev)
    scratch_b = torch.empty((q, -(-parts // 2), cbuf), dtype=torch.int64,
                            device=dev)
    out_s = torch.empty((q, cbuf), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, cbuf), dtype=torch.int32, device=dev)
    base_qstride = n if base.shape[0] > 1 else 0
    code = lib.lut16_topk_launch(
        codes.data_ptr(), lut.data_ptr(), base.data_ptr(), base_qstride,
        scratch_a.data_ptr(), scratch_b.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), n, kc, q, kl, int(packed), bq, rows_per_cta, cbuf,
        topk_half_width(cbuf), _stream(codes))
    _check(lib, code, "lut16_adc_topk")
    return out_s, out_i
