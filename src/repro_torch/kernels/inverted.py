"""The pass-1 tail bias on Hopper: the launch plan and the launcher of B4.

B4 (``csrc/score_inverted.cu:score_inverted_kernel``) replaces
``repro/kernels/block_sparse.py:inverted_value_forward_pallas`` and computes
``core.sparse_index.score_inverted`` from the padded inverted index and the
padded queries as the search holds them, with no host planning: one launch
writes the contiguous (Q, N) f32 scores.  What bounds it and what the design
does about it is noted in the CUDA source.

The launch plan (``plan_score_inverted``: rows a tile holds, tiles a CTA
owns, CTAs a query gets, entries its shared memory keeps) and the walk's
constants are pure Python mirrors of the CUDA source, so the CPU tests reach
them (``tests/test_torch_score_inverted_vf.py`` replays the kernel's order
of adds with them); on the card ``chip_smoke.py`` holds the shared-memory
size against the C side's and reads the CTAs per SM from the occupancy
calculator.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

__all__ = ["THREADS", "WARPS", "WINDOW", "STAGE", "ROW_GRANULE",
           "CTAS_PER_SM", "WAVES", "MAX_ROWS_PER_TILE", "CAP", "InvertedPlan",
           "plan_score_inverted", "smem_bytes", "score_inverted_cuda"]

THREADS = 256            # kThreads: 8 warps
WARPS = THREADS // 32    # each owns a contiguous eighth of a tile's rows
WINDOW = THREADS         # kWindow: query slots compacted at once
STAGE = 2048             # kStage: list entries staged at once
ROW_GRANULE = 256        # rows_per_tile is a multiple of this
# Two CTAs an SM: the largest tile and the resident buffer of CAP entries
# fill half the SM's 228 KB, less the 1 KB the system keeps a CTA.
CTAS_PER_SM = 2
MAX_ROWS_PER_TILE = 12288
CAP = 5888
# CTAs are planned for two waves: CTAs that start apart keep the stores of
# one beside the list work of another (at Q = 128, 0.135 ms against 0.147
# for one wave, H100, PERF.md).
WAVES = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "score_inverted_launch": ([_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _P], _I),
    "score_inverted_smem_bytes": ([_I, _I], _I),
    "score_inverted_ctas_per_sm": ([_I, _I], _I),
    "score_inverted_error_string": ([_I], ctypes.c_char_p),
}


def smem_bytes(rows_per_tile: int, cap: int = CAP) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` in the source): the
    tile with up to 3 floats of shift, the resident buffer of ``cap``
    (row, product) entries, the kept buffer of ``STAGE``, the window's
    compacted dims and values, and the counts of the compactions (96
    ints)."""
    return 4 * (rows_per_tile + 4) + 8 * (cap + STAGE) + 8 * WINDOW + 4 * 96


@dataclasses.dataclass(frozen=True)
class InvertedPlan:
    """B4's launch geometry.  A query's rows are cut into ``tiles`` tiles
    of ``rows_per_tile``; CTA ``(q, g)`` (block ``q * ctas_per_query + g``)
    owns tiles ``[g * tiles_per_cta, (g + 1) * tiles_per_cta)`` of query q
    and keeps up to ``cap`` of the query's entries in its rows resident
    (past that it streams the lists once a tile).  Warp w of a tile owns
    the ``rows_per_warp`` rows from ``w * rows_per_warp`` on."""
    rows_per_tile: int
    tiles: int                     # a query's: ceil(N / rows_per_tile)
    tiles_per_cta: int
    ctas_per_query: int            # ceil(tiles / tiles_per_cta)
    cap: int = CAP

    def __post_init__(self):
        if (self.rows_per_tile < 32 or self.rows_per_tile % 32
                or min(self.tiles, self.tiles_per_cta) < 1 or self.cap < 0
                or self.ctas_per_query
                != -(-self.tiles // self.tiles_per_cta)):
            raise ValueError(f"B4 cannot launch {self}")

    @property
    def rows_per_warp(self) -> int:
        return self.rows_per_tile // WARPS

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.rows_per_tile, self.cap)

    def grid(self, q: int) -> int:
        return q * self.ctas_per_query


def plan_score_inverted(q: int, n: int, sm_count: int) -> InvertedPlan:
    """B4's geometry for Q queries over N rows on ``sm_count`` SMs.

    A query gets ``4 * sm_count // Q`` CTAs (at least one), so that the Q
    queries fill the SMs twice at two CTAs each; its rows are cut into tiles
    of at most ``MAX_ROWS_PER_TILE`` (a multiple of ``ROW_GRANULE``),
    balanced, and the tiles dealt out to its CTAs in contiguous runs.  At
    the slice's N = 524288 on 132 SMs: Q = 1, 512 CTAs of one 1024-row
    tile; Q = 8, 64 CTAs a query of one 8192-row tile; Q = 128, four CTAs
    a query of 11 (the last 10) 12288-row tiles.  Each CTA reads its
    query's lists once (more CTAs, more reads); no choice changes a bit."""
    if q < 1 or n < 1 or sm_count < 1:
        raise ValueError(f"no plan for Q = {q}, N = {n}, {sm_count} SMs")
    groups = max(1, WAVES * CTAS_PER_SM * sm_count // q)
    rows = min(MAX_ROWS_PER_TILE, -(-n // groups))
    tiles = -(-n // rows)
    rows = -(-(-(-n // tiles)) // ROW_GRANULE) * ROW_GRANULE
    tiles = -(-n // rows)
    per_cta = -(-tiles // groups)
    return InvertedPlan(rows_per_tile=rows, tiles=tiles,
                        tiles_per_cta=per_cta,
                        ctas_per_query=-(-tiles // per_cta))


def score_inverted_cuda(rows: torch.Tensor, vals: torch.Tensor,
                        q_dims: torch.Tensor, q_vals: torch.Tensor, n: int,
                        plan: InvertedPlan) -> torch.Tensor:
    """Launch B4 on tensors that ``kernels/ops.py`` has checked: rows (d, L)
    int32, vals (d, L) f32, q_dims (Q, nq) int32 or int64, q_vals (Q, nq)
    f32, all contiguous on one device, at a plan made for these N and Q
    (``plan_score_inverted``'s, or one of its own to try another geometry:
    no plan changes a bit).  Returns (Q, N) f32 contiguous, every element
    written by the kernel."""
    d, l = rows.shape
    qn, nq = q_dims.shape
    if plan.tiles != -(-n // plan.rows_per_tile) or plan.grid(qn) >= 2 ** 31:
        raise ValueError(f"B4 cannot launch {plan} over N = {n}, Q = {qn}")
    lib = _build.load("score_inverted", _SIGNATURES)
    out = torch.empty((qn, n), dtype=torch.float32, device=rows.device)
    code = lib.score_inverted_launch(
        rows.data_ptr(), vals.data_ptr(), q_dims.data_ptr(),
        int(q_dims.dtype == torch.int64), q_vals.data_ptr(), out.data_ptr(),
        n, d, l, qn, nq, plan.rows_per_tile, plan.tiles_per_cta,
        plan.ctas_per_query, plan.cap,
        torch.cuda.current_stream(rows.device).cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"score_inverted launch failed: CUDA error {code} "
            f"({lib.score_inverted_error_string(code).decode()})")
    return out


def c_smem_bytes(plan: InvertedPlan) -> int:
    """The C side's shared memory of one CTA (``chip_smoke.py`` holds
    ``plan.smem_bytes`` against it)."""
    return _build.load("score_inverted", _SIGNATURES).score_inverted_smem_bytes(
        plan.rows_per_tile, plan.cap)


def ctas_per_sm(plan: InvertedPlan) -> int:
    """CTAs an SM holds at ``plan``, from the occupancy calculator."""
    return _build.load("score_inverted",
                       _SIGNATURES).score_inverted_ctas_per_sm(
        plan.rows_per_tile, plan.cap)
