"""Public wrappers around the three kernels (counterpart of
``repro/kernels/ops.py``).

The rule for every wrapper: a CPU tensor takes the plain PyTorch version
(``kernels/ref.py``); a CUDA tensor launches the hand-written kernel or
raises.  There is no fallback from one to the other.  Before a launch the
wrapper checks device, dtype, shape and contiguity, and after it the C
launcher's ``cudaGetLastError()`` (the launchers raise on a nonzero code).
``LAUNCHES`` counts kernel launches, one per wrapper call that launched.
"""

from __future__ import annotations

import numpy as np
import torch

from .block_sparse import TILE, block_sparse_cuda, dense_to_bcsr
from .lut16 import (LUT_WIDTH, THREADS, adc_smem_bytes, candidate_buffer_width,
                    lut16_adc_cuda, lut16_adc_topk_cuda, pack_codes,
                    topk_half_width, topk_smem_bytes, unpack_codes)
from .ref import (PLAIN_CALLS, block_sparse_plain, lut16_adc_plain,
                  lut16_adc_topk_plain, stable_topk)

__all__ = ["lut16_adc", "lut16_adc_topk", "lut16_adc_onehot",
           "block_sparse_matmul_bcsr", "bcsr_from_head", "pack_codes",
           "unpack_codes", "candidate_buffer_width", "MAX_FUSED_CANDIDATES",
           "LAUNCHES", "reset_counts"]

# Largest top-k the fused scan-and-select serves; above it pass 1
# materialises the scores and sorts them (as in the JAX package).
MAX_FUSED_CANDIDATES = 1024

# Shared memory a block may opt into on Hopper (227 KB).
_SMEM_LIMIT = 232448

LAUNCHES = dict.fromkeys(
    ("lut16_adc", "lut16_adc_topk", "block_sparse_matmul"), 0)


def reset_counts() -> None:
    """Zero the kernel launch counts and the plain-version call counts."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for key in d:
            d[key] = 0


def _resolve_lut16_blocks(q: int, n: int, kc: int, kl: int, device,
                          cbuf: int | None = None) -> tuple[int, int]:
    """One block resolution for both LUT16 kernels: (bq, rows_per_cta).

    bq: queries per CTA, the largest of 8, 4, 2, 1 that is not above the
    next power of two of Q and whose shared memory fits.  rows_per_cta: a
    multiple of the 256-row chunk, sized for about eight CTAs per SM (K1)
    or four (K2, which also keeps at least 8 * cbuf rows per CTA so that the
    partial lists stay far smaller than N).  Neither choice changes a score:
    every (query, row) sum is taken in subspace order whatever the blocks."""
    bq = min(8, 1 << max(q - 1, 0).bit_length())
    while True:
        smem = (adc_smem_bytes(bq, kc, kl) if cbuf is None else
                topk_smem_bytes(bq, kc, kl, topk_half_width(cbuf)))
        if smem <= _SMEM_LIMIT:
            break
        if bq == 1:
            raise ValueError(f"LUT16 kernel needs {smem} bytes of shared "
                             f"memory for K={kl}, more than {_SMEM_LIMIT}")
        bq //= 2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_blocks = -(-q // bq)
    ctas = (8 if cbuf is None else 4) * sms
    rows = -(-n * q_blocks // ctas)
    if cbuf is not None:
        rows = max(rows, 8 * cbuf)
    return bq, max(-(-rows // THREADS) * THREADS, THREADS)


def _validate_packed(kc: int, k: int, l: int, lut: torch.Tensor,
                     packed: bool) -> torch.Tensor:
    """Shared packed-storage validation + odd-K phantom-subspace LUT pad."""
    if packed:
        if l != 16:
            raise ValueError(f"packed codes require l == 16, got l={l}")
        if not 0 <= 2 * kc - k <= 1:
            raise ValueError(
                f"packed codes (N, {kc}) cannot hold a {k}-subspace LUT")
        if k < 2 * kc:                  # odd K: phantom subspace scores zero
            lut = torch.nn.functional.pad(lut, (0, 0, 0, 2 * kc - k))
    elif k != kc:
        raise ValueError(f"codes (N, {kc}) do not match a {k}-subspace LUT")
    return lut


def _check_codes_lut(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Check a CUDA launch's codes and LUT; return the LUT as the kernels
    read it: (Q, kl, 16) f32 contiguous, narrower codebooks zero-padded."""
    if codes.dtype != torch.uint8 or codes.ndim != 2:
        raise TypeError(f"codes must be 2-D uint8, got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    if not codes.is_contiguous() or codes.data_ptr() % 4:
        raise ValueError("codes must be contiguous and 4-byte aligned")
    if lut.device != codes.device:
        raise ValueError(f"lut on {lut.device}, codes on {codes.device}")
    l = lut.shape[2]
    if l > LUT_WIDTH:
        raise ValueError(f"the LUT16 kernels take at most {LUT_WIDTH} "
                         f"codewords per subspace, got l={l}")
    if l < LUT_WIDTH:
        lut = torch.nn.functional.pad(lut, (0, LUT_WIDTH - l))
    return lut.contiguous()


def _normalize(s: torch.Tensor, ids: torch.Tensor):
    return s, torch.where(torch.isfinite(s), ids, torch.full_like(ids, -1))


def lut16_adc(codes: torch.Tensor, lut: torch.Tensor, *,
              packed: bool = False) -> torch.Tensor:
    """LUT16 ADC: codes (N, Kc) uint8, lut (Q, K, l) or (K, l) -> (Q, N).

    packed=True: codes hold two 4-bit subspace codes per byte, shape
    (N, ceil(K/2)) from pack_codes.  Requires l == 16.  Odd K is handled
    here by padding the LUT with a zero phantom subspace, so the pad nibble
    (code 0) scores 0.  On CUDA this launches K1."""
    single = lut.ndim == 2
    if single:
        lut = lut[None]
    lut = lut.float()
    q, k, l = lut.shape
    n, kc = codes.shape
    lut = _validate_packed(kc, k, l, lut, packed)
    if codes.is_cuda:
        lut16 = _check_codes_lut(codes, lut)
        bq, rows = _resolve_lut16_blocks(q, n, kc, lut16.shape[1],
                                         codes.device)
        out = lut16_adc_cuda(codes, lut16, packed=packed, bq=bq,
                             rows_per_cta=rows)
        LAUNCHES["lut16_adc"] += 1
    else:
        out = lut16_adc_plain(codes, lut, packed=packed)
    return out[0] if single else out


def lut16_adc_topk(codes: torch.Tensor, lut: torch.Tensor, k: int, *,
                   bias: torch.Tensor | None = None,
                   row_mask: torch.Tensor | None = None,
                   packed: bool = False, fused: bool = True):
    """Pass-1 scan-and-select: top-k of ``bias + row_mask + codes·lut``.

    codes (N, Kc) uint8 (packed two-per-byte when packed=True), lut
    (Q, K, l) f32, bias optional (Q, N) f32, row_mask optional (N,) f32
    additive mask (0 live / -inf tombstoned).  Returns ``(scores (Q, k) f32,
    ids (Q, k) int32)``, best first, ties toward the lowest row; entries
    whose score is non-finite get id -1 in both paths.

    fused=True with k <= MAX_FUSED_CANDIDATES selects without materialising
    the (Q, N) scores (K2 on CUDA).  Otherwise the scores are materialised
    (K1 on CUDA) and sorted stably.  The bias is added after the full scan
    sum in both, so the two return bit-identical (scores, ids)."""
    lut = lut.float()
    q, kl, l = lut.shape
    n, kc = codes.shape
    if not 0 < k <= n:
        raise ValueError(f"top-k needs 0 < k <= N rows, got k={k}, N={n}")
    lut = _validate_packed(kc, kl, l, lut, packed)
    base = None if bias is None else bias.float()
    if row_mask is not None:
        rm = row_mask.float()[None, :]
        base = rm if base is None else base + rm

    if not (fused and k <= MAX_FUSED_CANDIDATES):
        dense = lut16_adc(codes, lut[:, :kl], packed=packed)
        return _normalize(*stable_topk(dense if base is None else base + dense,
                                       k))
    if not codes.is_cuda:
        return _normalize(*lut16_adc_topk_plain(codes, lut, base, k,
                                                packed=packed))
    lut16 = _check_codes_lut(codes, lut)
    if base is None:
        base = torch.zeros((1, n), dtype=torch.float32, device=codes.device)
    if base.device != codes.device or base.shape not in ((1, n), (q, n)):
        raise ValueError(f"bias must be (1, {n}) or ({q}, {n}) on "
                         f"{codes.device}, got {tuple(base.shape)} on "
                         f"{base.device}")
    cbuf = candidate_buffer_width(k)
    bq, rows = _resolve_lut16_blocks(q, n, kc, lut16.shape[1], codes.device,
                                     cbuf=cbuf)
    s, ids = lut16_adc_topk_cuda(codes, lut16, base.contiguous(), cbuf=cbuf,
                                 packed=packed, bq=bq, rows_per_cta=rows)
    LAUNCHES["lut16_adc_topk"] += 1
    return _normalize(s[:, :k], ids[:, :k])


def lut16_adc_onehot(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """One-hot ADC: codes (N, K) uint8, lut (Q, K, l) or (K, l) -> (Q, N).

    The JAX package's MXU contraction: codes expand to one-hot and contract
    against the bf16-rounded LUT as one matmul with f32 accumulation.  The
    bf16 operands are widened to f32 first, so the products are exact and
    only the sum order differs from the JAX version."""
    single = lut.ndim == 2
    lut3 = lut[None] if single else lut
    n = codes.shape[0]
    l = lut3.shape[-1]
    onehot = (codes.long()[:, :, None] ==
              torch.arange(l, device=codes.device)).to(torch.float32)
    lutb = lut3.reshape(lut3.shape[0], -1).to(torch.bfloat16).to(torch.float32)
    out = lutb @ onehot.reshape(n, -1).T                      # (Q, N)
    return out[0] if single else out


def bcsr_from_head(head):
    """TileSparseHead -> (tiles, tile_ptr, tile_col, max_steps), converted on
    the host and placed on the head block's device."""
    block = head.block.detach().cpu().numpy().astype(np.float32)
    tiles, ptr, col = dense_to_bcsr(block, head.block_rows, head.block_cols)
    max_steps = int(np.max(ptr[1:] - ptr[:-1], initial=1))
    dev = head.block.device
    return (torch.from_numpy(tiles).to(dev), torch.from_numpy(ptr).to(dev),
            torch.from_numpy(col).to(dev), max_steps)


def block_sparse_matmul_bcsr(q_head: torch.Tensor, tiles: torch.Tensor,
                             ptr: torch.Tensor,
                             col: torch.Tensor) -> torch.Tensor:
    """Tile-skipping head scoring over BCSR arrays: q_head (Q, D_pad) ->
    (Q, N_pad) f32.  On CUDA this launches K3 (128 x 128 f32 tiles)."""
    q_head = q_head.float()
    if not q_head.is_cuda:
        return block_sparse_plain(q_head, tiles, ptr, col)
    if tiles.dtype != torch.float32 or tuple(tiles.shape[1:]) != (TILE, TILE):
        raise ValueError(f"K3 takes ({TILE}, {TILE}) f32 tiles, got "
                         f"{tiles.dtype} {tuple(tiles.shape)}")
    if ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("tile_ptr and tile_col must be int32")
    if q_head.shape[1] % TILE:
        raise ValueError(f"q_head width {q_head.shape[1]} is not a multiple "
                         f"of {TILE}")
    for t in (tiles, ptr, col):
        if t.device != q_head.device or not t.is_contiguous():
            raise ValueError("BCSR arrays must be contiguous on "
                             f"{q_head.device}")
    out = block_sparse_cuda(q_head.contiguous(), tiles, ptr, col)
    LAUNCHES["block_sparse_matmul"] += 1
    return out
