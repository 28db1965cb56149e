"""LUT16 ADC scan on Hopper: code packing and the launchers of K1 and K2.

K1 (``csrc/lut16.cu:lut16_adc_kernel``) replaces
``repro/kernels/lut16.py:lut16_adc_pallas`` and writes the (Q, N) matrix
``out[q, n] = sum_k lut[q, k, codes[n, k]]``.  K2
(``lut16_topk_partial_kernel`` + ``topk_merge_kernel``) replaces
``lut16_adc_topk_pallas``: per-range top-``cbuf`` lists of ``base + scan``,
pruned by a per-query threshold that all CTAs share and merged 16 lists at a
time, the (Q, N) matrix never written.  What bounds each and what the design
does about it is noted in the CUDA source.

The launchers here take tensors that ``kernels/ops.py`` has already checked
and shaped: LUT (Q, kl, 16) f32 contiguous, codes (N, Kc) uint8 contiguous.
They allocate outputs and scratch with ``torch.empty`` and launch on the
current stream.

K1's launch plan (``plan_adc``), K2's (``plan_topk``), their shared-memory
sizes (``adc_smem_bytes``, ``topk_smem_bytes``) and the query-interleaved LUT
image that both kernels build in shared memory (``lut_image_index``) are
pure Python here, mirrors of ``csrc/lut16.cu``, so the CPU tests reach them;
on the card ``chip_smoke.py`` holds them against the C side's own sizes
(``*_cuda``) and the CUDA occupancy calculator.

Any K plans.  Where a query block's whole LUT image leaves K1 fewer than
``MIN_ADC_WARPS`` warps an SM, or does not fit K2 beside its buffers, the
plan stages the image and the codes in chunks of ``chunk`` code bytes (the
kernels' wide variants); a plan's ``chunk`` is None where the whole image
fits, and those plans are the ones the kernels always had.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build

__all__ = ["candidate_buffer_width", "pack_codes", "unpack_codes",
           "lut16_adc_cuda", "lut16_adc_topk_cuda", "THREADS", "AdcPlan",
           "plan_adc", "wave_rows", "adc_smem_bytes", "TopkPlan", "plan_topk",
           "topk_smem_bytes", "lut_image_index", "query_vec"]

THREADS = 256       # K2's rows per chunk in csrc/lut16.cu (kThreads)
LUT_WIDTH = 16      # LUT entries per subspace the kernels read
MERGE_GROUP = 16    # partial lists one merge CTA reduces (kMergeGroup)
QUERY_VEC = 2       # queries per shared LUT load (kQueryVec)
MAX_ADC_BQ = 16     # K1's largest query block (8 on packed codes)
MAX_ADC_THREADS = 1024    # K1's largest chunk (kMaxAdcThreads)
# Hopper's shared memory: 227 KB a CTA may opt into, 228 KB an SM holds, of
# which 1 KB per resident CTA is the system's.
SMEM_PER_CTA = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_CTA = 1024
# K1 is compiled with __launch_bounds__(1024, 1): at most 64 registers a
# thread, so the 65536 registers of an SM hold 32 of its warps.
ADC_WARPS_PER_SM = 65536 // (64 * 32)
# A plan of one chunk is kept while it holds this many warps on an SM (or
# as many as N has rows for); below it K1 chunks K, and a chunked plan
# takes the widest chunk that keeps ADC_CHUNK_WARPS warps (or as many as
# fit).
MIN_ADC_WARPS = 8
ADC_CHUNK_WARPS = 16
# K2: at most 4 queries a CTA; __launch_bounds__(256, 3), at most 80
# registers a thread, so at most 3 CTAs on an SM.
TOPK_MAX_BQ = 4
TOPK_CTAS_PER_SM = 3

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "lut16_adc_launch": ([_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P], _I),
    "lut16_topk_launch": ([_P, _P, _P, _LL, _P, _P, _P, _P, _P, _LL, _I, _I,
                           _I, _I, _I, _I, _I, _I, _P], _I),
    "lut16_adc_smem_bytes": ([_I, _I, _I, _I, _I], _LL),
    "lut16_adc_ctas_per_sm": ([_I, _I, _I, _I, _I, _I], _I),
    "lut16_topk_smem_bytes": ([_I, _I, _I, _I, _I], _LL),
    "lut16_topk_ctas_per_sm": ([_I, _I, _I, _I, _I, _I], _I),
    "lut16_error_string": ([_I], ctypes.c_char_p),
}


def candidate_buffer_width(k: int) -> int:
    """Candidate-buffer width for a top-``k`` fused select: ``k`` rounded up
    to a multiple of 128 (at least 128), as in the JAX package."""
    return max(-(-k // 128) * 128, 128)


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


def query_vec(bq: int) -> int:
    """Queries per shared LUT load in a query block of ``bq``."""
    return min(bq, QUERY_VEC)


def lut_image_index(bq: int, kl: int, qv: int | None = None) -> np.ndarray:
    """(bq, kl, 16) int array: where LUT entry (query, subspace, code) of a
    query block sits in the kernels' shared-memory image (float index).

    Subspace-major, then the bq / qv query groups, then the 16 codes, then
    the qv queries of a group (``lut_image_index`` in csrc/lut16.cu), so one
    vector load returns qv queries' entries of one (subspace, code)."""
    qv = query_vec(bq) if qv is None else qv
    if bq % qv:
        raise ValueError(f"a query block of {bq} has no groups of {qv}")
    qi = np.arange(bq)[:, None, None]
    k = np.arange(kl)[None, :, None]
    c = np.arange(LUT_WIDTH)[None, None, :]
    return ((k * (bq // qv) + qi // qv) * LUT_WIDTH + c) * qv + qi % qv


def code_stride(kc: int) -> int:
    """Words of one row's slot when codes are staged word-aligned (odd)."""
    return -(-kc // 4) | 1


def adc_stage_bytes(kc: int, threads: int) -> int:
    """One of K1's two code buffers: word-aligned slots when kc % 4 == 0,
    else the chunk's bytes back to back, rounded up to 16, plus 16 bytes
    that a row's last funnel shift may read."""
    if kc % 4 == 0:
        return threads * code_stride(kc) * 4
    return -(-threads * kc // 16) * 16 + 16


def _chunk_bytes(kc: int, chunk: int | None) -> int:
    """A plan's code bytes a chunk; None (or >= kc) is one chunk."""
    return kc if chunk is None else min(chunk, kc)


def adc_smem_bytes(bq: int, kc: int, kl: int, threads: int,
                   chunk: int | None = None) -> int:
    """K1's dynamic shared memory: one chunk, the LUT image and two code
    buffers; a chunk of ``chunk`` < kc code bytes (the wide variant), the
    image of its ``chunk * kl // kc`` subspaces and two buffers of
    word-aligned slots of ``chunk`` bytes (``adc_smem`` in csrc/lut16.cu)."""
    cw = _chunk_bytes(kc, chunk)
    if cw == kc:
        return bq * kl * LUT_WIDTH * 4 + 2 * adc_stage_bytes(kc, threads)
    return (bq * cw * (kl // kc) * LUT_WIDTH * 4
            + 2 * threads * code_stride(cw) * 4)


def topk_smem_bytes(bq: int, kc: int, kl: int, cbuf: int,
                    chunk: int | None = None) -> int:
    """K2's partial kernel's dynamic shared memory: per query a buffer of
    cbuf keys and a 256-key stage, the LUT image (of a chunk's subspaces
    when chunked), 256 code slots and four words (``topk_smem`` in
    csrc/lut16.cu)."""
    cw = _chunk_bytes(kc, chunk)
    wide = cw < kc
    return (bq * (cbuf + THREADS) * 8
            + bq * (cw * (kl // kc) if wide else kl) * LUT_WIDTH * 4
            + THREADS * code_stride(cw) * 4 + bq * 4 * 4)


def _ctas_by_smem(smem: int) -> int:
    return SMEM_PER_SM // (smem + SMEM_RESERVED_PER_CTA)


def _widest_chunk(size, kc: int, budget: int) -> int:
    """The widest chunk (a multiple of 4 code bytes, below kc) whose
    ``size(chunk)`` is within ``budget``, or 0.  ``size`` grows with the
    chunk, so a binary search over the word count finds it."""
    lo, hi = 0, (kc - 1) // 4
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if size(4 * mid) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return 4 * lo


@dataclasses.dataclass(frozen=True)
class AdcPlan:
    """K1's launch: ``bq`` queries per CTA, ``threads`` rows per chunk (a
    row a thread), ``rows_per_cta`` rows per CTA (whole chunks), what the
    plan expects of an SM, and ``chunk``: code bytes a chunk of subspaces
    (the wide variant), None for the whole LUT image at once."""
    bq: int
    threads: int
    rows_per_cta: int
    smem_bytes: int
    ctas_per_sm: int
    chunk: int | None = None

    @property
    def warps_per_sm(self) -> int:
        return self.ctas_per_sm * self.threads // 32

    def grid(self, q: int, n: int) -> tuple[int, int]:
        """(row ranges, query blocks)."""
        return -(-n // self.rows_per_cta), -(-q // self.bq)

    def chunks(self, kc: int) -> int:
        return -(-kc // _chunk_bytes(kc, self.chunk))


@functools.lru_cache(maxsize=256)
def plan_adc(q: int, n: int, kc: int, kl: int, sms: int,
             packed: bool = False) -> AdcPlan:
    """K1's block resolution.

    One chunk: bq, the largest of 16, 8, 4, 2, 1 not above the next power
    of two of Q whose LUT image and smallest chunk fit a CTA; at most 8 on
    packed codes (16 would spill: a packed word's 8 subspaces are
    unrolled).  threads: the chunk (a multiple of 32, at most 1024 and at
    most N rounded up to a warp) that keeps the most warps resident on an
    SM, by shared memory and by registers; among equals, the most CTAs.
    rows_per_cta: whole chunks, sized so that the grid is about one wave of
    CTAs.

    Where that plan holds fewer than ``MIN_ADC_WARPS`` warps an SM (fewer
    than N has rows for, at small N), or no plan of one chunk fits, K is
    chunked (``chunk`` code bytes a chunk, a
    multiple of 4 below kc) at the largest bq: the (threads, CTAs, chunk)
    that keeps ``ADC_CHUNK_WARPS`` warps resident (or the most that fit)
    with the widest chunk.  No choice changes a score: every (query, row)
    sum is taken in subspace order."""
    if kl != kc * (2 if packed else 1):
        raise ValueError(f"a LUT of {kl} subspaces does not match "
                         f"{'packed ' if packed else ''}codes of {kc} bytes")
    top = min(MAX_ADC_BQ // (2 if packed else 1),
              1 << max(q - 1, 0).bit_length())
    warps_cap = max(1, min(MAX_ADC_THREADS // 32, -(-n // 32)))
    whole = None
    bq = top
    while whole is None and bq >= 1:
        for warps in range(1, warps_cap + 1):
            smem = adc_smem_bytes(bq, kc, kl, 32 * warps)
            if smem > SMEM_PER_CTA:
                break
            ctas = min(_ctas_by_smem(smem), ADC_WARPS_PER_SM // warps)
            key = (ctas * warps, ctas)
            if ctas and (whole is None or key > whole[0]):
                whole = (key, bq, warps, smem, ctas, None)
        bq //= 2
    if whole is None or whole[0][0] < min(MIN_ADC_WARPS, warps_cap):
        chunked = None
        for warps in range(1, warps_cap + 1):
            threads = 32 * warps
            for ctas in range(1, ADC_WARPS_PER_SM // warps + 1):
                budget = min(SMEM_PER_CTA,
                             SMEM_PER_SM // ctas - SMEM_RESERVED_PER_CTA)
                cw = _widest_chunk(
                    lambda c: adc_smem_bytes(top, kc, kl, threads, c), kc,
                    budget)
                if not cw:
                    break
                smem = adc_smem_bytes(top, kc, kl, threads, cw)
                got = min(_ctas_by_smem(smem), ADC_WARPS_PER_SM // warps)
                key = (min(got * warps, ADC_CHUNK_WARPS), cw, got * warps,
                       got)
                if chunked is None or key > chunked[0]:
                    chunked = (key, top, warps, smem, got, cw)
        if chunked is not None and (whole is None or
                                    chunked[0][2] > whole[0][0]):
            whole = chunked
    if whole is None:
        raise ValueError(f"K1 fits no plan for K={kl}, Kc={kc}")
    _, bq, warps, smem, ctas, cw = whole
    threads = 32 * warps
    return AdcPlan(bq=bq, threads=threads,
                   rows_per_cta=wave_rows(q, n, bq, threads, ctas, sms),
                   smem_bytes=smem, ctas_per_sm=ctas, chunk=cw)


def wave_rows(q: int, n: int, bq: int, threads: int, ctas_per_sm: int,
              sms: int) -> int:
    """K1's rows per CTA, whole chunks of ``threads``, for about one wave
    of CTAs on ``sms`` SMs holding ``ctas_per_sm`` each."""
    ranges = max(1, sms * ctas_per_sm // -(-q // bq))
    rows = max(1, -(-n // ranges))
    return -(-rows // threads) * threads


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    """K2's partial kernel: ``bq`` queries per CTA of 256 threads, the
    shared memory, the CTAs an SM holds by it and by registers, and
    ``chunk`` as in ``AdcPlan``."""
    bq: int
    smem_bytes: int
    ctas_per_sm: int
    chunk: int | None = None

    @property
    def warps_per_sm(self) -> int:
        return self.ctas_per_sm * THREADS // 32


@functools.lru_cache(maxsize=256)
def plan_topk(q: int, kc: int, kl: int, cbuf: int) -> TopkPlan:
    """K2's query block and chunk.

    One chunk: bq, the largest of 4, 2, 1 not above the next power of two
    of Q whose shared memory fits (one warp merges each query's candidates;
    at K = 100, cbuf = 512 four queries keep three CTAs on an SM).  Where
    not even one query fits, K is chunked at the largest bq: the widest
    chunk (a multiple of 4 code bytes) that keeps the most CTAs, at most
    ``TOPK_CTAS_PER_SM``, on an SM.  Every plan keeps 8 warps or more (a
    CTA is 8 warps)."""
    if kl != kc and kl != 2 * kc:
        raise ValueError(f"a LUT of {kl} subspaces does not match codes of "
                         f"{kc} bytes")
    top = min(TOPK_MAX_BQ, 1 << max(q - 1, 0).bit_length())
    bq = top
    while bq >= 1:
        smem = topk_smem_bytes(bq, kc, kl, cbuf)
        if smem <= SMEM_PER_CTA:
            return TopkPlan(bq=bq, smem_bytes=smem,
                            ctas_per_sm=min(TOPK_CTAS_PER_SM,
                                            _ctas_by_smem(smem)))
        bq //= 2
    for ctas in range(TOPK_CTAS_PER_SM, 0, -1):
        budget = min(SMEM_PER_CTA, SMEM_PER_SM // ctas - SMEM_RESERVED_PER_CTA)
        cw = _widest_chunk(lambda c: topk_smem_bytes(top, kc, kl, cbuf, c),
                           kc, budget)
        if cw:
            smem = topk_smem_bytes(top, kc, kl, cbuf, cw)
            return TopkPlan(bq=top, smem_bytes=smem,
                            ctas_per_sm=min(TOPK_CTAS_PER_SM,
                                            _ctas_by_smem(smem)), chunk=cw)
    raise ValueError(f"K2 fits no plan for K={kl}, cbuf={cbuf}")


def _lib() -> ctypes.CDLL:
    return _build.load("lut16", _SIGNATURES)


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({lib.lut16_error_string(code).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def adc_smem_bytes_cuda(bq: int, kc: int, kl: int, threads: int,
                        chunk: int | None = None) -> int:
    """The C side's K1 shared memory, to hold ``adc_smem_bytes`` against."""
    return int(_lib().lut16_adc_smem_bytes(bq, kc, kl, threads,
                                           _chunk_bytes(kc, chunk)))


def adc_ctas_per_sm(bq: int, packed: bool, kc: int, kl: int, threads: int,
                    chunk: int | None = None) -> int:
    """CTAs of K1 one SM holds at once (the CUDA occupancy calculator)."""
    lib = _lib()
    got = int(lib.lut16_adc_ctas_per_sm(bq, int(packed), kc, kl, threads,
                                        _chunk_bytes(kc, chunk)))
    if got < 0:
        _check(lib, -got, "lut16_adc occupancy")
    return got


def topk_smem_bytes_cuda(bq: int, kc: int, kl: int, cbuf: int,
                         chunk: int | None = None) -> int:
    """The C side's K2 shared memory, to hold ``topk_smem_bytes`` against."""
    return int(_lib().lut16_topk_smem_bytes(bq, kc, kl, cbuf,
                                            _chunk_bytes(kc, chunk)))


@functools.lru_cache(maxsize=None)
def topk_ctas_per_sm(bq: int, packed: bool, kc: int, kl: int, cbuf: int,
                     chunk: int | None = None) -> int:
    """CTAs of K2's partial kernel one SM holds at once (the CUDA occupancy
    calculator, registers and shared memory both counted)."""
    lib = _lib()
    got = int(lib.lut16_topk_ctas_per_sm(bq, int(packed), kc, kl, cbuf,
                                         _chunk_bytes(kc, chunk)))
    if got < 0:
        _check(lib, -got, "lut16_topk occupancy")
    return got


def lut16_adc_cuda(codes: torch.Tensor, lut: torch.Tensor, *, packed: bool,
                   plan: AdcPlan) -> torch.Tensor:
    """Launch K1: (Q, N) f32 scores.  ``codes`` 16-byte aligned."""
    lib = _lib()
    n, kc = codes.shape
    q, kl, _ = lut.shape
    out = torch.empty((q, n), dtype=torch.float32, device=codes.device)
    code = lib.lut16_adc_launch(codes.data_ptr(), lut.data_ptr(),
                                out.data_ptr(), n, kc, q, kl, int(packed),
                                plan.bq, plan.threads, plan.rows_per_cta,
                                _chunk_bytes(kc, plan.chunk), _stream(codes))
    _check(lib, code, "lut16_adc")
    return out


def lut16_adc_topk_cuda(codes: torch.Tensor, lut: torch.Tensor,
                        base: torch.Tensor, *, cbuf: int, packed: bool,
                        bq: int, rows_per_cta: int,
                        chunk: int | None = None):
    """Launch K2: (Q, cbuf) scores and int32 row ids, best first; slots
    never filled are (-inf, -1).  ``base`` is (Q, N) or (1, N) f32;
    ``chunk`` as in ``TopkPlan``."""
    lib = _lib()
    n, kc = codes.shape
    q, kl, _ = lut.shape
    parts = -(-n // rows_per_cta)
    dev = codes.device
    thresholds = torch.zeros((q,), dtype=torch.int32, device=dev)
    scratch_a = torch.empty((q, parts, cbuf), dtype=torch.int64, device=dev)
    scratch_b = torch.empty((q, -(-parts // MERGE_GROUP), cbuf),
                            dtype=torch.int64, device=dev)
    out_s = torch.empty((q, cbuf), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, cbuf), dtype=torch.int32, device=dev)
    base_qstride = n if base.shape[0] > 1 else 0
    code = lib.lut16_topk_launch(
        codes.data_ptr(), lut.data_ptr(), base.data_ptr(), base_qstride,
        thresholds.data_ptr(), scratch_a.data_ptr(), scratch_b.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), n, kc, q, kl, int(packed), bq,
        rows_per_cta, cbuf, _chunk_bytes(kc, chunk), _stream(codes))
    _check(lib, code, "lut16_adc_topk")
    return out_s, out_i
