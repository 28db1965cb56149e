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
* ``DeltaPostings`` — the delta shard's append-only inverted index (host).
* ``ValueForwardStream`` — the host-planned (row, query, contribution)
  stream the JAX package's value-forward kernel consumes (the stream B4;
  the search's B4 reads the padded inverted index itself).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..device import to_numpy

__all__ = [
    "CompactColumns", "PaddedInvertedIndex", "TileSparseHead",
    "PaddedSparseRows", "build_compact_columns", "build_padded_inverted_index",
    "build_tile_sparse_head", "build_padded_rows", "sparse_queries_to_padded",
    "score_inverted", "score_head_ref", "queries_head_dense", "score_rows",
    "DeltaPostings",
    "ValueForwardStream", "build_value_forward_stream",
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


class DeltaPostings:
    """Append-only inverted index of a delta shard (DESIGN.md §6).

    Host-side mirror of ``PaddedInvertedIndex`` over the FROZEN compact
    column space of the serving main index: inserting a row appends one
    posting per nonzero dim.  ``l_max`` (the rectangle width) doubles when
    a dim's list overflows, up to ``l_cap``; beyond the cap ``append``
    hands the entries back as SPILL, which the delta shard stores in its
    per-slot residual rows (scored exactly in pass 3).  Tombstoned rows
    keep their postings; the delta's ``valid_mask`` removes their scores.
    A numpy copy of the JAX package's class; only ``to_padded`` places
    tensors on a device."""

    def __init__(self, d_active: int, l_max: int = 4,
                 l_cap: int | None = 16):
        self.d_active = int(d_active)
        self.l_max = max(int(l_max), 1)
        self.l_cap = None if l_cap is None else max(int(l_cap), self.l_max)
        self._rows = np.full((self.d_active, self.l_max), -1, np.int32)
        self._vals = np.zeros((self.d_active, self.l_max), np.float32)
        self._lens = np.zeros(self.d_active, np.int32)

    def append(self, slot: int, dims: np.ndarray,
               vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Add row ``slot``'s postings; dims are compact ids < d_active.
        Returns ``(spill_dims, spill_vals)``: the entries whose dim list is
        at ``l_cap``, which the caller scores through pass 3."""
        spill_d, spill_v = [], []
        for d, v in zip(np.asarray(dims, np.int64), np.asarray(vals)):
            n = int(self._lens[d])
            if self.l_cap is not None and n >= self.l_cap:
                spill_d.append(int(d))
                spill_v.append(float(v))
                continue
            if n == self.l_max:
                grow = self.l_max
                self._rows = np.pad(self._rows, ((0, 0), (0, grow)),
                                    constant_values=-1)
                self._vals = np.pad(self._vals, ((0, 0), (0, grow)))
                self.l_max *= 2
            self._rows[d, n] = slot
            self._vals[d, n] = v
            self._lens[d] = n + 1
        return (np.asarray(spill_d, np.int32),
                np.asarray(spill_v, np.float32))

    def to_padded(self, num_points: int, *, device="cuda") -> PaddedInvertedIndex:
        """Materialise on ``device``: empty cells get the ``num_points``
        sentinel (dropped by score_inverted), like the batch builder's."""
        rows, vals = self.rows_for(np.arange(self.d_active), num_points)
        return PaddedInvertedIndex(rows=torch.from_numpy(rows).to(device),
                                   vals=torch.from_numpy(vals).to(device),
                                   num_points=num_points)

    def rows_for(self, dims: np.ndarray,
                 num_points: int) -> tuple[np.ndarray, np.ndarray]:
        """Padded ``(rows, vals)`` of just the given dims (numpy): the unit
        an insert writes to the device instead of the whole rectangle."""
        d = np.asarray(dims, np.int64)
        rows = np.where(self._rows[d] >= 0, self._rows[d],
                        num_points).astype(np.int32)
        return rows, self._vals[d]


def score_inverted(index: PaddedInvertedIndex, q_dims: torch.Tensor,
                   q_vals: torch.Tensor) -> torch.Tensor:
    """Inverted-index accumulation (paper §2.2) as gather + scatter-add.

    q_dims/q_vals: (Q, nq) compact ids / values.  Returns (Q, N) scores.

    Reproducible on every device: the scatter runs one query slot at a
    time, and inside a slot the rows of one posting list are distinct, so
    no two updates of a call meet on a kept column and no atomic order can
    change a bit.  Pad entries (row id N, value 0) land in an extra column
    that is sliced off, the ``mode="drop"`` of the JAX version.  The
    kernel backends compute the same bits in one launch with B4
    (``kernels.ops.score_inverted_vf``); this is its plain version."""
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


def queries_head_dense(q_dims: np.ndarray, q_vals: np.ndarray,
                       head_dims: np.ndarray, d_head_pad: int) -> np.ndarray:
    """Scatter padded sparse queries into the dense head subspace, on the
    host as in the JAX package.

    q_dims/q_vals: (Q, nq) compact ids/values; head_dims: (d_head_pad,) compact
    ids (pad = -1).  Returns (Q, d_head_pad) float32."""
    lookup = {int(c): i for i, c in enumerate(head_dims) if c >= 0}
    qn, nq = q_dims.shape
    out = np.zeros((qn, d_head_pad), np.float32)
    for i in range(qn):
        for s in range(nq):
            pos = lookup.get(int(q_dims[i, s]))
            if pos is not None:
                out[i, pos] += q_vals[i, s]
    return out


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
    # rows that fit keep their entries in CSR order, all at once; a longer
    # row keeps its r_max largest |values|
    row_of = np.repeat(np.arange(n), lens)
    slot = np.arange(xr.nnz) - np.repeat(xr.indptr[:-1], lens)
    fits = (lens <= r_max)[row_of]
    cols[row_of[fits], slot[fits]] = xr.indices[fits]
    vals[row_of[fits], slot[fits]] = xr.data[fits]
    for i in np.flatnonzero(lens > r_max):
        lo, hi = xr.indptr[i], xr.indptr[i + 1]
        order = np.argsort(-np.abs(xr.data[lo:hi]))[:r_max]
        cols[i] = xr.indices[lo:hi][order]
        vals[i] = xr.data[lo:hi][order]
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


# ---------------------------------------------------------------------------
# Value-forward stream (SINDI-style sparse pass 1; DESIGN.md §2.5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ValueForwardStream:
    """Host-planned posting stream of the value-forward kernel (the stream
    B4).

    The query's postings are flattened into one row-sorted (row, query,
    contribution) stream per (query-block, row-block) pair: q_j is
    multiplied into the posting values once, at plan time, and the kernel
    only accumulates.  The layout is the JAX package's exactly: ``ptr``
    counts CHUNKS, not entries (each segment is padded to a multiple of
    ``chunk``); row ids are local to the row block, and pad entries carry
    row ``bn``; the sort is stable, so per (query, row) the entries keep
    the query's slot order."""
    ptr: torch.Tensor     # (QB*(NB+1),) int32 chunk offsets, CSR per q-block
    rows: torch.Tensor    # (QB, P_pad) int32 block-LOCAL row ids, pad = bn
    qidx: torch.Tensor    # (QB, P_pad) int32 query index within block, pad 0
    contrib: torch.Tensor  # (QB, P_pad) float32 q_val * posting_val, pad 0
    num_points: int
    num_queries: int
    bq: int
    bn: int
    chunk: int
    max_steps: int
    num_row_blocks: int


def build_value_forward_stream(index: PaddedInvertedIndex, q_dims, q_vals, *,
                               bq: int = 8, bn: int = 512,
                               chunk: int = 128) -> ValueForwardStream:
    """Plan the value-forward stream on the host (numpy copy of the JAX
    package's planner): the stream's length depends on the queries'
    nonzeros.  Reads the index to the host; returns tensors on the index's
    device."""
    rows_idx = to_numpy(index.rows)
    vals_idx = to_numpy(index.vals)
    d_active = rows_idx.shape[0]
    n = index.num_points
    q_dims = to_numpy(q_dims)
    q_vals = to_numpy(q_vals)
    qn = q_dims.shape[0]

    n_pad = max(-(-n // bn) * bn, bn)
    nb = n_pad // bn
    qb = max(-(-qn // bq), 1)

    per_block: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    ptr = np.zeros(qb * (nb + 1), np.int32)
    max_steps = 1
    for b in range(qb):
        lo, hi = b * bq, min((b + 1) * bq, qn)
        ent_r: list[np.ndarray] = []
        ent_q: list[np.ndarray] = []
        ent_c: list[np.ndarray] = []
        for i in range(lo, hi):
            dims = q_dims[i]
            keep = dims < d_active
            dims = dims[keep].astype(np.int64)
            qv = q_vals[i][keep]
            if dims.size == 0:
                continue
            r = rows_idx[dims]                              # (nq_i, L_max)
            v = vals_idx[dims]
            live = r < n                                    # drop pad sentinel
            ent_r.append(r[live])
            ent_q.append(np.full(int(live.sum()), i - lo, np.int32))
            ent_c.append((qv[:, None] * v)[live])
        if ent_r:
            r_all = np.concatenate(ent_r)
            q_all = np.concatenate(ent_q)
            c_all = np.concatenate(ent_c).astype(np.float32)
        else:
            r_all = np.zeros(0, np.int64)
            q_all = np.zeros(0, np.int32)
            c_all = np.zeros(0, np.float32)
        order = np.argsort(r_all, kind="stable")
        r_all, q_all, c_all = r_all[order], q_all[order], c_all[order]

        seg_r: list[np.ndarray] = []
        seg_q: list[np.ndarray] = []
        seg_c: list[np.ndarray] = []
        bounds = np.searchsorted(r_all, np.arange(nb + 1) * bn)
        off = 0
        for j in range(nb):
            s0, s1 = int(bounds[j]), int(bounds[j + 1])
            m = s1 - s0
            m_pad = -(-max(m, 0) // chunk) * chunk
            ptr[b * (nb + 1) + j] = off
            if m_pad:
                lr = np.full(m_pad, bn, np.int32)            # pad: no row match
                lq = np.zeros(m_pad, np.int32)
                lc = np.zeros(m_pad, np.float32)
                lr[:m] = r_all[s0:s1] - j * bn               # block-LOCAL ids
                lq[:m] = q_all[s0:s1]
                lc[:m] = c_all[s0:s1]
                seg_r.append(lr)
                seg_q.append(lq)
                seg_c.append(lc)
            off += m_pad // chunk
            max_steps = max(max_steps, m_pad // chunk)
        ptr[b * (nb + 1) + nb] = off
        if seg_r:
            per_block.append((np.concatenate(seg_r), np.concatenate(seg_q),
                              np.concatenate(seg_c)))
        else:
            per_block.append((np.full(chunk, bn, np.int32),
                              np.zeros(chunk, np.int32),
                              np.zeros(chunk, np.float32)))

    p_pad = max(max(pb[0].size for pb in per_block), chunk)
    rows_out = np.full((qb, p_pad), bn, np.int32)
    qidx_out = np.zeros((qb, p_pad), np.int32)
    contrib_out = np.zeros((qb, p_pad), np.float32)
    for b, (pr, pq, pc) in enumerate(per_block):
        rows_out[b, :pr.size] = pr
        qidx_out[b, :pq.size] = pq
        contrib_out[b, :pc.size] = pc

    dev = index.rows.device
    return ValueForwardStream(
        ptr=torch.from_numpy(ptr).to(dev),
        rows=torch.from_numpy(rows_out).to(dev),
        qidx=torch.from_numpy(qidx_out).to(dev),
        contrib=torch.from_numpy(contrib_out).to(dev),
        num_points=n, num_queries=qn, bq=bq, bn=bn, chunk=chunk,
        max_steps=max_steps, num_row_blocks=nb)
