"""Public wrappers around the kernels (counterpart of
``repro/kernels/ops.py``).

The rule for every wrapper: a CPU tensor takes the plain PyTorch version
(``kernels/ref.py``); a CUDA tensor launches the hand-written kernel or
raises.  There is no fallback from one to the other.  Before a launch the
wrapper checks device, dtype, shape and contiguity, and after it the C
launcher's ``cudaGetLastError()`` (the launchers raise on a nonzero code).
``LAUNCHES`` counts kernel launches, one per wrapper call that launched
(``ref.bump``, under a lock: servers launch from several threads).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .block_sparse import (TILE, block_sparse_cuda, dense_to_bcsr,
                           inverted_value_forward_cuda)
from .inverted import WINDOW, plan_score_inverted, score_inverted_cuda
from .lut16 import (LUT_WIDTH, SMEM_PER_CTA, THREADS, candidate_buffer_width,
                    lut16_adc_cuda, lut16_adc_topk_cuda, pack_codes, plan_adc,
                    plan_topk, topk_ctas_per_sm, unpack_codes)
from .ref import (PLAIN_CALLS, adc_lut_plain, block_sparse_plain, bump,
                  dense_residual_plain, gathered_dot_plain,
                  inverted_value_forward_plain, lut16_adc_plain,
                  lut16_adc_topk_plain, score_inverted_plain,
                  sparse_residual_plain, stable_topk)
from .residual import (adc_lut_cuda, dense_residual_cuda, gathered_dot_cuda,
                       sparse_residual_cuda)

__all__ = ["lut16_adc", "lut16_adc_topk", "lut16_adc_onehot",
           "block_sparse_matmul", "block_sparse_matmul_bcsr",
           "bcsr_from_head", "dense_scores_materialized",
           "inverted_value_forward", "score_inverted_vf", "adc_lut",
           "dense_residual", "sparse_residual", "gathered_dot", "pack_codes",
           "unpack_codes", "candidate_buffer_width", "MAX_FUSED_CANDIDATES",
           "LAUNCHES", "reset_counts"]

# Largest top-k the fused scan-and-select serves; above it pass 1
# materialises the scores and sorts them (as in the JAX package).
MAX_FUSED_CANDIDATES = 1024

# The grid's largest y dimension (K2's ranges).
_MAX_GRID_Y = 65535

LAUNCHES = dict.fromkeys(
    ("lut16_adc", "lut16_adc_topk", "block_sparse_matmul",
     "inverted_value_forward", "score_inverted_vf", "adc_lut",
     "dense_residual", "sparse_residual", "gathered_dot"), 0)


def reset_counts() -> None:
    """Zero the kernel launch counts and the plain-version call counts."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for key in d:
            d[key] = 0


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _resolve_topk_blocks(q: int, n: int, kc: int, kl: int, packed: bool,
                         cbuf: int, device) -> tuple[int, int, int | None]:
    """K2's block resolution: (bq, rows_per_cta, chunk).

    bq and chunk: ``lut16.plan_topk`` (at most 4 queries per CTA, the
    whole LUT image where one query's fits, else chunks of K).
    rows_per_cta: a multiple of the 256-row chunk such that all CTAs fit
    in one wave on the card (every range then starts at once and the
    slowest sets the time; the CTAs an SM holds from the occupancy
    calculator), at least 8 * cbuf rows (so the partial lists stay far
    smaller than N) and few enough ranges for the grid's y dimension.  No
    choice changes a result: the selection is exact for any ranges, and
    every sum is taken in subspace order."""
    plan = plan_topk(q, kc, kl, cbuf)
    per_sm = topk_ctas_per_sm(plan.bq, packed, kc, kl, cbuf, plan.chunk)
    if per_sm == 0:
        raise ValueError(f"K2 at bq={plan.bq}, K={kl}, cbuf={cbuf} fits no "
                         "CTA on an SM")
    parts = max(1, _sm_count(device) * per_sm // -(-q // plan.bq))
    rows = max(-(-n // parts), 8 * cbuf, -(-n // _MAX_GRID_Y))
    return plan.bq, -(-rows // THREADS) * THREADS, plan.chunk


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
    (code 0) scores 0.  On CUDA this launches K1 (any K: ``plan_adc``
    chunks K where the whole LUT image would leave too few warps)."""
    single = lut.ndim == 2
    if single:
        lut = lut[None]
    lut = lut.float()
    q, k, l = lut.shape
    n, kc = codes.shape
    lut = _validate_packed(kc, k, l, lut, packed)
    if codes.is_cuda:
        lut16 = _check_codes_lut(codes, lut)
        if codes.data_ptr() % 16:
            raise ValueError("K1 copies codes in 16-byte pieces: they must "
                             "be 16-byte aligned")
        plan = plan_adc(q, n, kc, lut16.shape[1], _sm_count(codes.device),
                        packed)
        out = lut16_adc_cuda(codes, lut16, packed=packed, plan=plan)
        bump(LAUNCHES, "lut16_adc")
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
    bq, rows, chunk = _resolve_topk_blocks(q, n, kc, lut16.shape[1], packed,
                                           cbuf, codes.device)
    s, ids = lut16_adc_topk_cuda(codes, lut16, base.contiguous(), cbuf=cbuf,
                                 packed=packed, bq=bq, rows_per_cta=rows,
                                 chunk=chunk)
    bump(LAUNCHES, "lut16_adc_topk")
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


def block_sparse_matmul(q_head: torch.Tensor, head) -> torch.Tensor:
    """Tile-skipping head scoring: q_head (Q, D_pad) x TileSparseHead ->
    (Q, N_pad), through ``bcsr_from_head`` (the reference's wrapper of the
    same name).  On CUDA this launches K3."""
    tiles, ptr, col, _ = bcsr_from_head(head)
    return block_sparse_matmul_bcsr(q_head, tiles, ptr, col)


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
    bump(LAUNCHES, "block_sparse_matmul")
    return out


def inverted_value_forward(ptr: torch.Tensor, rows: torch.Tensor,
                           qidx: torch.Tensor, contrib: torch.Tensor, *,
                           bq: int, bn: int, chunk: int,
                           num_row_blocks: int) -> torch.Tensor:
    """Accumulate a value-forward stream (``build_value_forward_stream``, the
    JAX package's host-planned layout) into (QB * bq, num_row_blocks * bn)
    f32 scores.  On CUDA this launches the stream B4, which no search
    takes: ``score_inverted_vf`` computes the same from the index."""
    kw = dict(bq=bq, bn=bn, chunk=chunk, num_row_blocks=num_row_blocks)
    if not rows.is_cuda:
        return inverted_value_forward_plain(ptr, rows, qidx, contrib, **kw)
    qb, p_pad = rows.shape
    for name, t, dt, shape in (
            ("ptr", ptr, torch.int32, (qb * (num_row_blocks + 1),)),
            ("rows", rows, torch.int32, (qb, p_pad)),
            ("qidx", qidx, torch.int32, (qb, p_pad)),
            ("contrib", contrib, torch.float32, (qb, p_pad))):
        if t.device != rows.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {rows.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {dt} {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if p_pad % chunk or bq * bn * 4 > SMEM_PER_CTA:
        raise ValueError(f"B4 takes P_pad a multiple of chunk={chunk} and a "
                         f"{bq} x {bn} f32 tile in shared memory")
    out = inverted_value_forward_cuda(ptr, rows, qidx, contrib, **kw)
    bump(LAUNCHES, "inverted_value_forward")
    return out


def score_inverted_vf(index, q_dims: torch.Tensor,
                      q_vals: torch.Tensor) -> torch.Tensor:
    """The inverted-index tail of the pass-1 bias,
    ``core.sparse_index.score_inverted(index, q_dims, q_vals)``, bit for bit:
    index a ``PaddedInvertedIndex`` (rows (d, L) int32 with the sentinel N,
    vals (d, L) f32), q_dims (Q, nq) compact ids (pad: any id outside
    [0, d)), q_vals (Q, nq).  Returns (Q, N) f32.

    On CUDA this launches B4 once, with no host planning and no host sync,
    into a contiguous output at ``plan_score_inverted``'s geometry.  q_dims
    other than int32 / int64 are widened and q_vals rounded to f32 first, as
    ``score_inverted`` does."""
    rows, vals, n = index.rows, index.vals, index.num_points
    if not rows.is_cuda:
        return score_inverted_plain(index, q_dims, q_vals)
    if rows.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"B4 takes int32 rows and f32 vals, got {rows.dtype} "
                        f"and {vals.dtype}")
    if rows.ndim != 2 or vals.shape != rows.shape:
        raise ValueError(f"rows {tuple(rows.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (d, L) shape")
    if q_dims.ndim != 2 or q_vals.shape != q_dims.shape:
        raise ValueError(f"q_dims {tuple(q_dims.shape)} and q_vals "
                         f"{tuple(q_vals.shape)} must be one (Q, nq) shape")
    for name, t in (("vals", vals), ("q_dims", q_dims), ("q_vals", q_vals)):
        if t.device != rows.device:
            raise ValueError(f"{name} on {t.device}, rows on {rows.device}")
    if not (rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError("the inverted index must be contiguous")
    d, l = rows.shape
    qn = q_dims.shape[0]
    if n >= 2 ** 31 or l * WINDOW >= 2 ** 31:
        raise ValueError(f"B4 indexes N = {n} rows and a window of {WINDOW} "
                         f"lists of L = {l} in int32")
    if q_dims.dtype not in (torch.int32, torch.int64):
        q_dims = q_dims.long()
    q_dims, q_vals = q_dims.contiguous(), q_vals.float().contiguous()
    if qn == 0 or n == 0:
        return torch.empty((qn, n), dtype=torch.float32, device=rows.device)
    out = score_inverted_cuda(rows, vals, q_dims, q_vals, n,
                              plan_score_inverted(qn, n,
                                                  _sm_count(rows.device)))
    bump(LAUNCHES, "score_inverted_vf")
    return out


def _on_one_device(what: str, *named) -> None:
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, not {dev}")


def _typed(what: str, name: str, t: torch.Tensor, dtype, ndim: int):
    if t.dtype != dtype or t.ndim != ndim:
        raise TypeError(f"{what}: {name} must be {ndim}-D {dtype}, got "
                        f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _candidates(cand: torch.Tensor, n: int) -> torch.Tensor:
    """(Q, C) candidate ids as the kernels read them: int32, contiguous;
    wider ids are clipped into [0, N) first, as the kernels clip."""
    if cand.ndim != 2:
        raise ValueError(f"candidates must be (Q, C), got {tuple(cand.shape)}")
    if cand.dtype != torch.int32:
        cand = cand.long().clamp(0, max(n - 1, 0)).to(torch.int32)
    return cand.contiguous()


def _empty_rows(what: str, n: int) -> None:
    if n == 0:
        raise ValueError(f"{what}: no rows to gather candidates from")


def adc_lut(q_dense: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The ADC lookup table T[q][k][c] = q^(k) . U^(k)_c with each entry's
    p products added in turn from +0: q_dense (Q, K * p), centers (K, l, p)
    -> (Q, K, l) f32.  On CUDA this launches R0."""
    q = q_dense.float()
    k, l, p = centers.shape
    if q.ndim != 2 or q.shape[1] != k * p:
        raise ValueError(f"adc_lut: q_dense {tuple(q.shape)} does not split "
                         f"into {k} subspaces of {p}")
    if not q.is_cuda:
        return adc_lut_plain(q, centers.float())
    _on_one_device("adc_lut", ("q_dense", q), ("centers", centers))
    c = _typed("adc_lut", "centers", centers, torch.float32, 3)
    out = adc_lut_cuda(q.contiguous(), c)
    bump(LAUNCHES, "adc_lut")
    return out


def dense_residual(rows: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, candidates: torch.Tensor,
                   q_dense: torch.Tensor) -> torch.Tensor:
    """Pass 2's term q . (scale * (rows[cand] + 128) + zero) as
    (q * scale) . rows[cand] + 128 * sum(q * scale) + q . zero, each sum in
    the fixed order of ``csrc/residual.cu``: rows (N, d) int8, scale and
    zero (d,) f32, candidates (Q, C) (clipped into [0, N)), q_dense (Q, d)
    -> (Q, C) f32.  On CUDA this launches R1."""
    q = q_dense.float()
    n, d = rows.shape
    _empty_rows("dense_residual", n)
    if q.ndim != 2 or q.shape[1] != d or scale.shape != (d,) \
            or zero.shape != (d,) or candidates.shape[:1] != q.shape[:1]:
        raise ValueError(f"dense_residual: rows {tuple(rows.shape)}, scale "
                         f"{tuple(scale.shape)}, zero {tuple(zero.shape)}, "
                         f"candidates {tuple(candidates.shape)}, q_dense "
                         f"{tuple(q.shape)} do not match")
    if not q.is_cuda:
        return dense_residual_plain(rows, scale.float(), zero.float(),
                                    candidates, q)
    _on_one_device("dense_residual", ("q_dense", q), ("rows", rows),
                   ("scale", scale), ("zero", zero),
                   ("candidates", candidates))
    out = dense_residual_cuda(
        _typed("dense_residual", "rows", rows, torch.int8, 2),
        _typed("dense_residual", "scale", scale, torch.float32, 1),
        _typed("dense_residual", "zero", zero, torch.float32, 1),
        _candidates(candidates, n), q.contiguous())
    bump(LAUNCHES, "dense_residual")
    return out


def gathered_dot(rows: torch.Tensor, candidates: torch.Tensor,
                 q: torch.Tensor, *, bf16_rows: bool = False) -> torch.Tensor:
    """q . rows[cand] in the fixed order of ``csrc/residual.cu``: rows (N, d)
    f32, candidates (Q, C) (clipped into [0, N)), q (Q, d) f32 -> (Q, C)
    f32; ``bf16_rows`` rounds each gathered element to bf16 first.  The PQ
    LM head's exact columns.  On CUDA this launches R3."""
    q = q.float()
    n, d = rows.shape
    _empty_rows("gathered_dot", n)
    if q.ndim != 2 or q.shape[1] != d or candidates.shape[:1] != q.shape[:1]:
        raise ValueError(f"gathered_dot: rows {tuple(rows.shape)}, "
                         f"candidates {tuple(candidates.shape)}, q "
                         f"{tuple(q.shape)} do not match")
    if not q.is_cuda:
        return gathered_dot_plain(rows, candidates, q, bf16_rows)
    _on_one_device("gathered_dot", ("q", q), ("rows", rows),
                   ("candidates", candidates))
    out = gathered_dot_cuda(
        _typed("gathered_dot", "rows", rows, torch.float32, 2),
        _candidates(candidates, n), q.contiguous(), bf16_rows)
    bump(LAUNCHES, "gathered_dot")
    return out


def sparse_residual(cols: torch.Tensor, vals: torch.Tensor,
                    candidates: torch.Tensor,
                    q_cols: torch.Tensor) -> torch.Tensor:
    """Pass 3's term sum_r vals[cand, r] * q_cols[q, cols[cand, r]] in the
    fixed order of ``csrc/residual.cu``: cols (N, R) int32 (pad d_active),
    vals (N, R) f32, candidates (Q, C) (clipped into [0, N)), q_cols
    (Q, d_active + 1) f32 with a zero last slot -> (Q, C) f32.  On CUDA this
    launches R2."""
    n, r = cols.shape
    _empty_rows("sparse_residual", n)
    if vals.shape != cols.shape or q_cols.ndim != 2 \
            or candidates.shape[:1] != q_cols.shape[:1]:
        raise ValueError(f"sparse_residual: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, candidates "
                         f"{tuple(candidates.shape)}, q_cols "
                         f"{tuple(q_cols.shape)} do not match")
    if not q_cols.is_cuda:
        return sparse_residual_plain(cols, vals, candidates, q_cols.float())
    _on_one_device("sparse_residual", ("q_cols", q_cols), ("cols", cols),
                   ("vals", vals), ("candidates", candidates))
    out = sparse_residual_cuda(
        _typed("sparse_residual", "cols", cols, torch.int32, 2),
        _typed("sparse_residual", "vals", vals, torch.float32, 2),
        _candidates(candidates, n),
        _typed("sparse_residual", "q_cols", q_cols, torch.float32, 2))
    bump(LAUNCHES, "sparse_residual")
    return out


class _Float32Outputs(TorchDispatchMode):
    """Records the shape of every float32 tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.shapes.append(tuple(t.shape))
        return out


def dense_scores_materialized(fn, *args) -> bool:
    """Structural check for the fused-select claim (DESIGN.md §2.5): run
    ``fn(*args)`` under a dispatch mode that sees every op's outputs and
    report whether any op PRODUCES a float32 tensor of shape (Q > 1, >= N),
    a full per-query score matrix.  N is the first argument's leading dim
    (the codes' rows).  A (1, N) row mask is allowed.  True for
    materialise-then-select, False for the fused path.

    The reference traces a jaxpr; here the ops run.  A CUDA kernel's
    scratch inside its launcher is allocated through the dispatcher too,
    so K2's (Q, P, cbuf) int64 keys are seen (and are not float32).  On
    CPU tensors the fused path runs ``lut16_adc_topk_plain``, which
    materialises (Q, N) itself: the check then reports True, and it
    answers the question only for CUDA tensors."""
    n = args[0].shape[0]
    with _Float32Outputs() as mode:
        fn(*args)
    return any(len(s) == 2 and s[0] > 1 and s[1] >= n for s in mode.shapes)
