"""Sparse inner-product scoring (paper §2.2, §3.1–3.3).

Counterpart of ``repro.core.sparse_index``.  The builders are numpy copies
of the JAX package's (the same arrays from the same data) that place their
result on a torch device; the scorers are written in torch:

* ``TileSparseHead`` — the most-active ``d_head`` dimensions as a dense
  (N_pad, d_head_pad) block; after cache sorting most 128 x 128 tiles are
  zero, and the BCSR head kernel (K3) skips them.
* ``PaddedInvertedIndex`` — the power-law tail as rectangular (d_active,
  L_max) row-id / value arrays: scoring is a gather + scatter-add.
* ``PaddedSparseRows`` — per-row residual entries for pass 3.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

__all__ = [
    "CompactColumns", "PaddedInvertedIndex", "TileSparseHead",
    "PaddedSparseRows", "build_compact_columns", "build_padded_inverted_index",
    "build_tile_sparse_head", "build_padded_rows", "sparse_queries_to_padded",
    "score_inverted", "score_head_ref", "score_rows",
]


# ---------------------------------------------------------------------------
# Compact column space
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompactColumns:
    """Mapping between global dimension ids and the shard's compact space."""
    global_ids: np.ndarray          # (d_active,) sorted global dim ids

    @property
    def num_active(self) -> int:
        return len(self.global_ids)

    def to_compact(self, global_dims: np.ndarray) -> np.ndarray:
        """Global dim ids -> compact ids; unknown dims -> num_active (sentinel)."""
        pos = np.searchsorted(self.global_ids, global_dims)
        pos = np.clip(pos, 0, len(self.global_ids) - 1)
        hit = self.global_ids[pos] == global_dims
        return np.where(hit, pos, self.num_active).astype(np.int32)


def build_compact_columns(x_sparse: sp.spmatrix) -> tuple[CompactColumns, sp.csr_matrix]:
    xc = x_sparse.tocsc()
    active = np.flatnonzero(np.diff(xc.indptr))
    cols = CompactColumns(global_ids=active)
    remapped = xc[:, active].tocsr()
    return cols, remapped


# ---------------------------------------------------------------------------
# Padded inverted index (tail path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaddedInvertedIndex:
    rows: torch.Tensor   # (d_active, L_max) int32, pad = num_points (dropped)
    vals: torch.Tensor   # (d_active, L_max) float32, pad = 0
    num_points: int


def build_padded_inverted_index(x_compact: sp.csr_matrix,
                                l_max: int | None = None, *,
                                device="cuda") -> PaddedInvertedIndex:
    """x_compact: CSR with compact columns (from build_compact_columns),
    already pruned so each column has <= a few hundred entries."""
    xc = x_compact.tocsc()
    n, d = xc.shape
    lens = np.diff(xc.indptr)
    if l_max is None:
        l_max = max(int(lens.max(initial=1)), 1)
    rows = np.full((d, l_max), n, dtype=np.int32)
    vals = np.zeros((d, l_max), dtype=np.float32)
    for j in range(d):
        lo, hi = xc.indptr[j], xc.indptr[j + 1]
        m = min(hi - lo, l_max)
        if m < hi - lo:
            # keep the largest-magnitude entries if over capacity
            order = np.argsort(-np.abs(xc.data[lo:hi]))[:m]
            rows[j, :m] = xc.indices[lo:hi][order]
            vals[j, :m] = xc.data[lo:hi][order]
        else:
            rows[j, :m] = xc.indices[lo:hi]
            vals[j, :m] = xc.data[lo:hi]
    return PaddedInvertedIndex(rows=torch.from_numpy(rows).to(device),
                               vals=torch.from_numpy(vals).to(device),
                               num_points=n)


def sparse_queries_to_padded(q_sparse: sp.spmatrix, cols: CompactColumns,
                             nq_max: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """(Q, nq_max) compact dim ids (pad = d_active) + values (pad = 0)."""
    qr = q_sparse.tocsr()
    q = qr.shape[0]
    dims = np.full((q, nq_max), cols.num_active, dtype=np.int32)
    vals = np.zeros((q, nq_max), dtype=np.float32)
    for i in range(q):
        lo, hi = qr.indptr[i], qr.indptr[i + 1]
        compact = cols.to_compact(qr.indices[lo:hi])
        keep = compact < cols.num_active
        c, v = compact[keep], qr.data[lo:hi][keep]
        if len(c) > nq_max:                      # keep largest |q_j| on overflow
            order = np.argsort(-np.abs(v))[:nq_max]
            c, v = c[order], v[order]
        dims[i, : len(c)] = c
        vals[i, : len(c)] = v
    return dims, vals


def score_inverted(index: PaddedInvertedIndex, q_dims: torch.Tensor,
                   q_vals: torch.Tensor) -> torch.Tensor:
    """Inverted-index accumulation (paper §2.2) as gather + scatter-add.

    q_dims/q_vals: (Q, nq) compact ids / values.  Returns (Q, N) scores.

    Reproducible on every device: the scatter runs one query slot at a
    time, and inside a slot the rows of one posting list are distinct, so
    no two updates of a call meet on a kept column and no atomic order can
    change a bit.  Pad entries (row id N, value 0) land in an extra column
    that is sliced off, the ``mode="drop"`` of the JAX version."""
    qn, nq = q_dims.shape
    n = index.num_points
    d = index.rows.shape[0]
    q_dims = q_dims.long()
    valid = (q_dims >= 0) & (q_dims < d)
    dims = torch.where(valid, q_dims, torch.zeros_like(q_dims))
    rows_g = torch.where(valid[..., None], index.rows[dims].long(),
                         torch.full((), n, device=dims.device))   # (Q, nq, L)
    vals_g = torch.where(valid[..., None], index.vals[dims],
                         torch.zeros((), device=dims.device))
    contrib = vals_g * q_vals.float()[:, :, None]
    acc = torch.zeros((qn, n + 1), dtype=torch.float32, device=q_dims.device)
    for s in range(nq):
        acc.scatter_add_(1, rows_g[:, s, :], contrib[:, s, :])
    return acc[:, :n]


# ---------------------------------------------------------------------------
# Tile-sorted head block (cache-sorting payoff path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileSparseHead:
    """Dense (N_pad, d_head_pad) block of the most-active dims + tile
    occupancy."""
    block: torch.Tensor        # (N_pad, d_head_pad) float32, cache-sorted rows
    occupancy: torch.Tensor    # (N_pad/block_rows, d_head_pad/block_cols) bool
    head_dims: torch.Tensor    # (d_head_pad,) compact column ids (pad -1)
    block_rows: int
    block_cols: int


def build_tile_sparse_head(x_compact: sp.csr_matrix, head_dims: np.ndarray,
                           block_rows: int = 128, block_cols: int = 128, *,
                           device="cuda") -> TileSparseHead:
    """head_dims: compact column ids (most active).  Rows are assumed already
    permuted by cache_sort (apply pi before calling)."""
    n = x_compact.shape[0]
    d_head = len(head_dims)
    d_head_pad = -(-d_head // block_cols) * block_cols
    n_pad = -(-n // block_rows) * block_rows
    sub = x_compact[:, head_dims].toarray().astype(np.float32)
    block = np.zeros((n_pad, d_head_pad), np.float32)
    block[:n, :d_head] = sub
    occ = (
        block.reshape(n_pad // block_rows, block_rows,
                      d_head_pad // block_cols, block_cols)
        .any(axis=(1, 3))
    )
    dims = np.full(d_head_pad, -1, np.int32)
    dims[:d_head] = head_dims
    return TileSparseHead(block=torch.from_numpy(block).to(device),
                          occupancy=torch.from_numpy(occ).to(device),
                          head_dims=torch.from_numpy(dims).to(device),
                          block_rows=block_rows, block_cols=block_cols)


def score_head_ref(head: TileSparseHead, q_head: torch.Tensor) -> torch.Tensor:
    """Reference head scoring: (Q, d_head_pad) @ block^T -> (Q, N_pad)."""
    return q_head.float() @ head.block.float().T


# ---------------------------------------------------------------------------
# Padded row storage — residual reordering needs per-candidate sparse rows
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaddedSparseRows:
    cols: torch.Tensor    # (N, R_max) int32 compact col ids, pad = d_active
    vals: torch.Tensor    # (N, R_max) float32, pad = 0


def build_padded_rows(x_compact: sp.csr_matrix, r_max: int | None = None, *,
                      device="cuda") -> PaddedSparseRows:
    xr = x_compact.tocsr()
    n, d = xr.shape
    lens = np.diff(xr.indptr)
    if r_max is None:
        r_max = max(int(lens.max(initial=1)), 1)
    cols = np.full((n, r_max), d, dtype=np.int32)
    vals = np.zeros((n, r_max), dtype=np.float32)
    for i in range(n):
        lo, hi = xr.indptr[i], xr.indptr[i + 1]
        m = min(hi - lo, r_max)
        if m < hi - lo:
            order = np.argsort(-np.abs(xr.data[lo:hi]))[:m]
            cols[i, :m] = xr.indices[lo:hi][order]
            vals[i, :m] = xr.data[lo:hi][order]
        else:
            cols[i, :m] = xr.indices[lo:hi]
            vals[i, :m] = xr.data[lo:hi]
    return PaddedSparseRows(cols=torch.from_numpy(cols).to(device),
                            vals=torch.from_numpy(vals).to(device))


def score_rows(rows: PaddedSparseRows, candidates: torch.Tensor,
               q_dense_cols: torch.Tensor) -> torch.Tensor:
    """Exact sparse dot for selected rows (residual reorder pass 3).

    candidates: (Q, C) row ids (clipped into range, as ``mode="clip"``);
    q_dense_cols: (Q, d_active + 1) query scattered into the compact column
    space with one trailing zero pad slot.  Returns (Q, C)."""
    cand = candidates.long().clamp(0, rows.cols.shape[0] - 1)
    cand_cols = rows.cols[cand].long()                          # (Q, C, R)
    cand_vals = rows.vals[cand]
    qn, c, r = cand_cols.shape
    qv = torch.gather(q_dense_cols, 1,
                      cand_cols.reshape(qn, c * r)).reshape(qn, c, r)
    return torch.sum(cand_vals * qv, dim=-1)
