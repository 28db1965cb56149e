"""Streaming mutable index: delta shard + tombstones + compaction
(DESIGN.md §6); counterpart of ``repro.core.streaming``.

The batch build (core/hybrid.py) freezes its artifacts: codebooks, the
residual quantization grid, the compact column space, the cache-sort
order.  Mutation therefore splits into two tiers:

* ``DeltaShard`` — an append-only side index of the rows inserted since
  the last build.  Its tensors are sized to a capacity that doubles as it
  fills; a ``valid_mask`` of additive 0/-inf scores removes dead and
  never-filled slots from every pass's top-k.  New rows are encoded
  against the FROZEN main artifacts: PQ codes through the main codebooks
  (``pq.encode_rows``, packed two per byte when the main index is), the
  int8 residual on the main grid (``pq.scalar_quantize_rows``), and sparse
  entries as capped posting lists (``sparse_index.DeltaPostings``) over the
  frozen column space; entries past the cap spill into per-slot residual
  rows that pass 3 scores exactly.

* ``MutableState`` — the host-side source of truth: the retained corpus,
  per-row alive flags, the delta shard, and the *main tombstones* (external
  ids deleted or superseded while resident in the main generation; the
  search merge drops them).  ``compact()`` folds everything into a new
  index: ``retrain=True`` re-runs the batch build on the survivors (the
  same as a scratch build), ``retrain=False`` (``merge_compact``) keeps the
  frozen artifacts and re-derives only the row-parallel structures.

Where the JAX package writes an insert batch into fresh arrays (a jitted
``dynamic_update_slice`` + row scatter), the port copies it IN PLACE into
the capacity-shaped tensors, and snapshot isolation still holds: a
snapshot pins its own ``valid_mask`` tensor and its ``count``.  An append
writes only slots at or after every held snapshot's ``count``, and posting
cells that held the empty-cell sentinel; those slots are -inf in every held
mask, so no held snapshot's live scores change.  A delete builds a new mask
tensor and leaves the old one to its holders.  Growth (capacity, posting
width, residual width) materialises new tensors, and the held ones keep
the old.

``HybridIndex.build(..., mutable=True)`` attaches a ``MutableState``;
``HybridIndex.insert/delete/compact`` wrap this module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..device import to_numpy
from .cache_sort import cache_sort
from .distributed import ceil16, merge_topk_host
from .engine import IndexArrays, ScoringEngine, tombstone_mask
from .pq import (PQCodebooks, ScalarQuant, encode_rows, pack_codes, pq_decode,
                 scalar_quantize_rows)
from .pruning import prune_split
from .sparse_index import (CompactColumns, DeltaPostings, PaddedSparseRows,
                           build_padded_inverted_index, build_padded_rows,
                           build_tile_sparse_head, sparse_queries_to_padded)

__all__ = ["DeltaShard", "DeltaSnapshot", "MutableState", "search_mutable",
           "plan_overfetch", "fanout_search"]


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A device copy of a host mirror that never aliases it (on the CPU,
    ``torch.from_numpy(a).to("cpu")`` would share the mirror's memory)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


@dataclasses.dataclass(frozen=True)
class DeltaSnapshot:
    """One device-ready view of the delta shard.  A search holds a snapshot
    for its whole lifetime, so mutations never change what it scores."""
    arrays: IndexArrays      # capacity-shaped, valid_mask applied
    ids: np.ndarray          # (capacity,) int64 external ids (-1 = empty)
    count: int               # slots ever filled (dead ones included)
    live: int                # slots filled and not tombstoned
    version: int             # mutation counter at snapshot time

    @property
    def capacity(self) -> int:
        """Padded slot count of the device arrays (== arrays.num_points)."""
        return self.arrays.num_points


class DeltaShard:
    """Append-only device-resident side index (DESIGN.md §6.1).

    Host mirrors (numpy) are the source of truth; ``snapshot()`` lazily
    materialises an ``IndexArrays`` of the full capacity with a tombstone
    ``valid_mask``.  A delete tombstones, an upsert tombstones the old slot
    and appends; slots are reclaimed only by compaction.

    Sparse layout: per-dim posting lists capped at ``postings_cap`` entries
    (pass 1), overflow spilled to per-slot residual rows (pass 3).  The
    serving paths fetch h == capacity from the delta, so every slot is
    refined in pass 3 and the split loses nothing.

    Cost model: an insert copies its rows in place into the device tensors
    (``upload_bytes`` counts what crosses to the device); growth of the
    capacity or of a rectangle re-materialises the shard at the next
    snapshot; a delete swaps in a new (capacity,) mask and nothing else."""

    def __init__(self, *, codebooks: PQCodebooks, cols: CompactColumns,
                 dense_residual: ScalarQuant, d_dense: int, pack: bool,
                 capacity: int = 64, l_max: int = 4,
                 postings_cap: int | None = 16):
        self.codebooks = codebooks
        self.cols = cols
        self.pack = pack
        self.device = codebooks.centers.device
        self._scale = dense_residual.scale.cpu().numpy()
        self._zero = dense_residual.zero.cpu().numpy()
        self._scale_t = dense_residual.scale      # device tensors, shared
        self._zero_t = dense_residual.zero        # with the main generation
        k = codebooks.num_subspaces
        self._kp = (k + 1) // 2 if pack else k
        self.capacity = max(int(capacity), 1)
        self._codes = np.zeros((self.capacity, self._kp), np.uint8)
        self._resq = np.zeros((self.capacity, d_dense), np.int8)
        self._postings = DeltaPostings(cols.num_active, l_max=l_max,
                                       l_cap=postings_cap)
        self._rmax = 1
        self._row_cols = np.full((self.capacity, self._rmax),
                                 cols.num_active, np.int32)
        self._row_vals = np.zeros((self.capacity, self._rmax), np.float32)
        self._ids = np.full(self.capacity, -1, np.int64)
        self._dead = np.zeros(self.capacity, bool)
        self.count = 0
        self.version = 0
        self.dropped_nnz = 0      # sparse entries outside the compact space
        self.upload_bytes = 0     # host->device bytes of structural tensors
        self._snapshot: DeltaSnapshot | None = None
        # structural tensors (everything but the mask); None until the next
        # snapshot after a growth
        self._arrays_struct: IndexArrays | None = None

    @property
    def live_count(self) -> int:
        """Rows that are filled and not tombstoned."""
        return self.count - int(self._dead[: self.count].sum())

    def _grow(self, need: int) -> None:
        cap = self.capacity
        while cap < need:
            cap *= 2
        if cap == self.capacity:
            return
        grow = cap - self.capacity
        self._codes = np.pad(self._codes, ((0, grow), (0, 0)))
        self._resq = np.pad(self._resq, ((0, grow), (0, 0)))
        self._row_cols = np.pad(self._row_cols, ((0, grow), (0, 0)),
                                constant_values=self.cols.num_active)
        self._row_vals = np.pad(self._row_vals, ((0, grow), (0, 0)))
        self._ids = np.pad(self._ids, (0, grow), constant_values=-1)
        self._dead = np.pad(self._dead, (0, grow))
        self.capacity = cap

    def _grow_rmax(self, need: int) -> None:
        rmax = self._rmax
        while rmax < need:
            rmax *= 2
        if rmax == self._rmax:
            return
        grow = rmax - self._rmax
        self._row_cols = np.pad(self._row_cols, ((0, 0), (0, grow)),
                                constant_values=self.cols.num_active)
        self._row_vals = np.pad(self._row_vals, ((0, 0), (0, grow)))
        self._rmax = rmax

    def insert_rows(self, x_sparse: sp.spmatrix, x_dense: np.ndarray,
                    ext_ids: np.ndarray) -> np.ndarray:
        """Append rows, encoding against the frozen main-index artifacts.
        Returns the assigned slot numbers."""
        xs = x_sparse.tocsr()
        xd = np.asarray(x_dense, np.float32)
        m = xs.shape[0]
        assert xd.shape[0] == m == len(ext_ids)
        cap0, lmax0, rmax0 = (self.capacity, self._postings.l_max,
                              self._rmax)
        self._grow(self.count + m)
        # dense: PQ codes + residual against frozen codebooks / frozen grid
        codes_u = encode_rows(xd, self.codebooks, pack=False)
        recon = pq_decode(torch.from_numpy(codes_u).to(self.device),
                          self.codebooks).cpu().numpy()
        resq = scalar_quantize_rows(xd - recon, self._scale, self._zero)
        slots = np.arange(self.count, self.count + m)
        self._codes[slots] = pack_codes(codes_u) if self.pack else codes_u
        self._resq[slots] = resq
        self._ids[slots] = np.asarray(ext_ids, np.int64)
        # sparse: postings in the frozen compact column space; entries past
        # the per-dim cap spill to the slot's pass-3 residual row
        touched: list[int] = []
        for j, slot in enumerate(slots):
            lo, hi = xs.indptr[j], xs.indptr[j + 1]
            compact = self.cols.to_compact(xs.indices[lo:hi])
            keep = compact < self.cols.num_active
            self.dropped_nnz += int((~keep).sum())
            kept = compact[keep]
            touched.extend(int(d) for d in kept)
            sd, sv = self._postings.append(int(slot), kept,
                                           xs.data[lo:hi][keep])
            if len(sd):
                self._grow_rmax(len(sd))
                self._row_cols[slot, : len(sd)] = sd
                self._row_vals[slot, : len(sd)] = sv
        self.count += m
        self.version += 1
        self._snapshot = None
        if (self._arrays_struct is not None and self.capacity == cap0
                and self._postings.l_max == lmax0 and self._rmax == rmax0):
            self._append_in_place(slots, np.unique(
                np.asarray(touched, np.int64)))
        else:
            # shapes changed, or no device copy yet: re-materialise at the
            # next snapshot(), into new tensors
            self._arrays_struct = None
        return slots

    def _append_in_place(self, slots: np.ndarray, dims: np.ndarray) -> None:
        """Copy the rows just appended, and the touched dims' posting rows,
        into the structural tensors in place (see the module docstring for
        why held snapshots are unaffected)."""
        st = self._arrays_struct
        rows = slice(int(slots[0]), int(slots[0]) + len(slots))
        dev = self.device
        for dst, src in ((st.codes, self._codes),
                         (st.dense_residual.q, self._resq),
                         (st.sparse_residual.cols, self._row_cols),
                         (st.sparse_residual.vals, self._row_vals)):
            dst[rows] = torch.from_numpy(src[rows]).to(dev)
            self.upload_bytes += src[rows].nbytes
        if dims.size:
            rows_h, vals_h = self._postings.rows_for(dims, self.capacity)
            d = torch.from_numpy(dims).to(dev)
            st.inv_index.rows[d] = torch.from_numpy(rows_h).to(dev)
            st.inv_index.vals[d] = torch.from_numpy(vals_h).to(dev)
            self.upload_bytes += rows_h.nbytes + vals_h.nbytes

    def tombstone(self, slot: int) -> None:
        """Mark one slot dead; its -inf mask entry removes it from scoring."""
        if not 0 <= slot < self.count:
            raise IndexError(f"slot {slot} outside filled range "
                             f"[0, {self.count})")
        if not self._dead[slot]:
            self._dead[slot] = True
            self.version += 1
            self._snapshot = None

    def snapshot(self) -> DeltaSnapshot:
        """Materialise (and cache) the device view of the current state.
        The structural tensors are reused across tombstone-only mutations:
        a delete swaps in a new (capacity,) mask, nothing else."""
        if self._snapshot is None:
            cap = self.capacity
            dev = self.device
            if self._arrays_struct is None:
                post = self._postings.to_padded(cap, device=dev)
                self.upload_bytes += (
                    self._codes.nbytes + self._resq.nbytes
                    + self._row_cols.nbytes + self._row_vals.nbytes
                    + post.rows.numel() * 4 + post.vals.numel() * 4)
                self._arrays_struct = IndexArrays.build(
                    codebooks=self.codebooks,
                    codes=_upload(self._codes, dev),
                    inv_index=post, head=None,
                    dense_residual=ScalarQuant(q=_upload(self._resq, dev),
                                               scale=self._scale_t,
                                               zero=self._zero_t),
                    # capped-postings spill lives here, refined in pass 3
                    sparse_residual=PaddedSparseRows(
                        cols=_upload(self._row_cols, dev),
                        vals=_upload(self._row_vals, dev)),
                    num_points=cap, d_active=self.cols.num_active,
                    with_bcsr=False, pre_packed=self.pack)
            arrays = dataclasses.replace(
                self._arrays_struct,
                valid_mask=tombstone_mask(cap, self.count, self._dead,
                                          device=dev))
            self._snapshot = DeltaSnapshot(
                arrays=arrays, ids=self._ids.copy(), count=self.count,
                live=self.live_count, version=self.version)
        return self._snapshot


class MutableState:
    """Host-side mutation bookkeeping attached to a ``HybridIndex`` built
    with ``mutable=True`` (DESIGN.md §6): retained corpus, alive flags,
    delta shard, main tombstones, and the monotone mutation version."""

    def __init__(self, index, x_sparse: sp.csr_matrix, x_dense: np.ndarray,
                 ext_ids: np.ndarray | None = None,
                 delta_capacity: int = 64):
        n = x_sparse.shape[0]
        self.params = index.params
        self.x_sparse0 = x_sparse.tocsr()
        self.x_dense0 = np.asarray(x_dense, np.float32)
        self.ids_built = (np.arange(n, dtype=np.int64) if ext_ids is None
                          else np.asarray(ext_ids, np.int64))
        assert len(self.ids_built) == n
        if len(np.unique(self.ids_built)) != n:
            raise ValueError("ext_ids must be unique")
        if n and self.ids_built.min() < 0:
            raise ValueError("external ids must be non-negative (-1 is the "
                             "merge layer's empty-slot sentinel)")
        self.alive0 = np.ones(n, bool)
        # cache-sorted position -> external id, once per generation
        self.id_map = self.ids_built[index.pi]
        # frozen head-dim set (compact ids, pad -1): merge_compact rebuilds
        # the head block over the SAME dims
        self.head_dims0 = np.asarray(index.head_dim_ids)
        # sparse entries outside the frozen column space in the merged MAIN
        # structures; nonzero means only a retrain makes them searchable
        self.main_dropped_nnz = 0
        self.extra_sparse: list[sp.csr_matrix] = []
        self.extra_dense: list[np.ndarray] = []
        self.extra_ids: list[int] = []
        self.extra_alive: list[bool] = []
        self.main_tombstones: set[int] = set()
        self.version = 0
        self.next_id = int(self.ids_built.max(initial=-1)) + 1
        self._loc = {int(e): ("init", i)
                     for i, e in enumerate(self.ids_built)}
        self.delta = DeltaShard(
            codebooks=index.codebooks, cols=index.cols,
            dense_residual=index.dense_residual, d_dense=index.d_dense,
            pack=index.params.resolve_pack(), capacity=delta_capacity)

    # -- mutation ---------------------------------------------------------

    def insert(self, x_sparse, x_dense, ids=None) -> np.ndarray:
        """Insert (or upsert) rows; returns the external ids assigned."""
        xs = sp.csr_matrix(x_sparse)
        if xs.shape[1] != self.x_sparse0.shape[1]:
            raise ValueError(
                f"sparse width {xs.shape[1]} != corpus width "
                f"{self.x_sparse0.shape[1]}")
        xd = np.atleast_2d(np.asarray(x_dense, np.float32))
        if xd.shape[1] != self.x_dense0.shape[1]:
            raise ValueError(
                f"dense width {xd.shape[1]} != corpus width "
                f"{self.x_dense0.shape[1]}")
        m = xs.shape[0]
        if m == 0:
            return np.empty(0, np.int64)
        if ids is None:
            ids = np.arange(self.next_id, self.next_id + m, dtype=np.int64)
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if not (len(ids) == m == xd.shape[0]):
            raise ValueError(
                f"row-count mismatch: {m} sparse, {xd.shape[0]} dense, "
                f"{len(ids)} ids")
        if len(np.unique(ids)) != m:
            raise ValueError("duplicate external ids within one insert batch")
        if ids.min() < 0:
            raise ValueError("external ids must be non-negative (-1 is the "
                             "merge layer's empty-slot sentinel)")
        # encode FIRST, retire old copies after: if encoding raises, the
        # upserted ids' existing rows survive untouched
        slots = self.delta.insert_rows(xs, xd, ids)
        for e in ids:
            self._kill(int(e))            # upsert: retire any existing row
        for j, e in enumerate(ids):
            self.extra_sparse.append(xs[j])
            self.extra_dense.append(xd[j])
            self.extra_ids.append(int(e))
            self.extra_alive.append(True)
            self._loc[int(e)] = ("extra", len(self.extra_ids) - 1)
        self.next_id = max(self.next_id, int(ids.max()) + 1)
        self.version += 1
        return ids

    def _kill(self, ext_id: int) -> bool:
        loc = self._loc.get(ext_id)
        if loc is None:
            return False
        kind, i = loc
        if kind == "init":
            if not self.alive0[i]:
                return False
            self.alive0[i] = False
            self.main_tombstones.add(ext_id)
        else:
            if not self.extra_alive[i]:
                return False
            self.extra_alive[i] = False
            self.delta.tombstone(i)       # slot j == extra index j
        del self._loc[ext_id]
        return True

    def delete(self, ids) -> int:
        """Tombstone rows by external id; returns how many were live."""
        killed = 0
        for e in np.atleast_1d(np.asarray(ids, np.int64)):
            killed += self._kill(int(e))
        if killed:
            self.version += 1
        return killed

    # -- compaction -------------------------------------------------------

    @property
    def live_rows(self) -> int:
        """Logical corpus size: surviving initial rows + live inserts."""
        return int(self.alive0.sum()) + sum(self.extra_alive)

    def survivors(self) -> tuple[sp.csr_matrix, np.ndarray, np.ndarray]:
        """Surviving corpus rows in canonical order (initial order, then
        insertion order): the input a scratch build on the current logical
        contents would receive."""
        keep0 = np.flatnonzero(self.alive0)
        xs_parts = [self.x_sparse0[keep0]]
        xd_parts = [self.x_dense0[keep0]]
        ids = [self.ids_built[keep0]]
        live = [j for j, a in enumerate(self.extra_alive) if a]
        if live:
            xs_parts += [self.extra_sparse[j] for j in live]
            xd_parts.append(np.stack([self.extra_dense[j] for j in live]))
            ids.append(np.asarray([self.extra_ids[j] for j in live],
                                  np.int64))
        xs = sp.vstack(xs_parts, format="csr") if len(xs_parts) > 1 \
            else xs_parts[0]
        return xs, np.concatenate(xd_parts, axis=0), np.concatenate(ids)

    _EMPTY_COMPACT_MSG = (
        "cannot compact an empty corpus: the batch build (k-means, "
        "column space) needs at least one surviving row; keep the "
        "delta serving or insert before compacting")

    def merge_compact(self):
        """Fold delta + tombstones into the FROZEN build artifacts
        (DESIGN.md §6.2): keep the codebooks, residual grid, compact column
        space and head-dim set, and re-derive only the row-parallel
        structures over the survivors — a new cache sort, re-pruned posting
        lists, PQ codes through ``encode_rows``, int8 residuals on the
        existing grid.  Sparse entries outside the frozen column space stay
        in the retained corpus (counted in ``main_dropped_nnz``) until a
        ``compact(retrain=True)``.  Returns a NEW mutable ``HybridIndex``."""
        from .hybrid import HybridIndex, _drop_columns, _remap
        if self.live_rows == 0:
            raise ValueError(self._EMPTY_COMPACT_MSG)
        params, delta = self.params, self.delta
        cols, codebooks, dev = delta.cols, delta.codebooks, delta.device
        xs, xd, ids = self.survivors()
        n = xs.shape[0]
        pi = cache_sort(xs)
        xs_s, xd_s = xs[pi], np.asarray(xd, np.float32)[pi]
        split = prune_split(xs_s, keep_top=params.keep_top)
        idx_compact = _remap(split.index, cols)     # frozen column space
        res_compact = _remap(split.residual, cols)
        dropped = int(xs_s.nnz) - int(idx_compact.nnz) - int(res_compact.nnz)
        head = None
        head_dim_ids = np.empty(0, np.int32)
        tail_index = idx_compact
        hd = self.head_dims0[self.head_dims0 >= 0].astype(np.int32)
        if hd.size and cols.num_active > 0:
            # the same FROZEN head dims, not a re-ranked activity top-n
            head = build_tile_sparse_head(idx_compact, hd,
                                          block_rows=params.block_rows,
                                          block_cols=params.block_cols,
                                          device=dev)
            head_dim_ids = head.head_dims.cpu().numpy()
            tail_index = _drop_columns(idx_compact, hd)
        inv_index = build_padded_inverted_index(tail_index, device=dev)
        sparse_residual = build_padded_rows(res_compact, device=dev)
        codes = torch.from_numpy(encode_rows(xd_s, codebooks)).to(dev)
        recon = pq_decode(codes, codebooks).cpu().numpy()
        resq = scalar_quantize_rows(xd_s - recon, delta._scale, delta._zero)
        dres = ScalarQuant(q=torch.from_numpy(resq).to(dev),
                           scale=delta._scale_t, zero=delta._zero_t)
        backend = params.resolve_backend()
        arrays = IndexArrays.build(
            codebooks=codebooks, codes=codes, inv_index=inv_index, head=head,
            dense_residual=dres, sparse_residual=sparse_residual,
            num_points=n, d_active=cols.num_active,
            with_bcsr=backend.uses_kernels, pack=params.resolve_pack())
        new = HybridIndex(params=params, num_points=n, pi=pi, cols=cols,
                          inv_index=inv_index, head=head,
                          head_dim_ids=head_dim_ids,
                          sparse_residual=sparse_residual,
                          codebooks=codebooks, codes=arrays.codes,
                          dense_residual=dres, d_dense=xd.shape[1],
                          engine=ScoringEngine(arrays=arrays,
                                               backend=backend))
        new.mutable_state = MutableState(new, xs, xd, ext_ids=ids,
                                         delta_capacity=delta.capacity)
        new.mutable_state.next_id = max(new.mutable_state.next_id,
                                        self.next_id)
        new.mutable_state.main_dropped_nnz = self.main_dropped_nnz + dropped
        return new

    def compact(self, retrain: bool | None = None):
        """Fold delta + tombstones down; returns a NEW mutable
        ``HybridIndex`` (this state is untouched; the caller swaps).

        ``retrain=True`` re-runs the batch build on the survivors (new
        codebooks, column space, cache sort): the same as a scratch build.
        ``retrain=False`` merges into the frozen artifacts
        (``merge_compact``).  ``None`` merges unless sparse entries were
        dropped outside the frozen column space."""
        from .hybrid import HybridIndex
        if self.live_rows == 0:
            raise ValueError(self._EMPTY_COMPACT_MSG)
        if retrain is None:
            retrain = (self.delta.dropped_nnz + self.main_dropped_nnz) > 0
        if not retrain:
            return self.merge_compact()
        xs, xd, ids = self.survivors()
        new = HybridIndex.build(xs, xd, self.params, mutable=True,
                                ext_ids=ids, device=self.delta.device)
        # carry the id counter: the fresh state only sees surviving ids, so
        # max+1 could re-mint a deleted id under new content
        new.mutable_state.next_id = max(new.mutable_state.next_id,
                                        self.next_id)
        return new


def plan_overfetch(engines, h: int, deleted) -> list[int]:
    """Per-main-engine fetch depths under pending tombstones (DESIGN.md
    §6.2): every main engine overfetches by the 16-bucketed tombstone count
    so that dropping tombstoned ids at the merge never leaves fewer than h
    live results; overfetch-then-truncate of a deterministic top-k is exact,
    so the mutation-free path equals the plain one."""
    slack = ceil16(len(deleted)) if deleted else 0
    return [min(h + slack, e.num_points) for e in engines]


def fanout_search(engines, h_fetch, offsets, id_map, delta_engine,
                  delta_ids, deleted, qd, qv, qe, *, h: int, alpha: int,
                  beta: int):
    """THE fan-out merge (DESIGN.md §6.2): dispatch every main engine, then
    the delta engine, before any result reaches the host (CUDA launches
    are asynchronous, so the engines' device work queues back to back),
    assemble the per-engine candidates in the common EXTERNAL id space, and
    merge top-h on the host with main-generation tombstones dropped.

    engines/h_fetch/offsets: the main engines, their fetch depths
    (``plan_overfetch``) and each engine's global row offset; ``id_map``
    maps global row positions to external ids (None = identity);
    ``delta_engine`` fetches its whole capacity, with ``delta_ids`` mapping
    slots to external ids.  An engine is anything with
    ``.search(qd, qv, qe, h=, alpha=, beta=) -> (scores, ids, ...)`` and
    ``.num_points``.  Returns ``(scores, ids)`` (Q, h) numpy arrays."""
    outs = [e.search(qd, qv, qe, h=hf, alpha=alpha, beta=beta)
            for e, hf in zip(engines, h_fetch)]
    delta_out = None
    if delta_engine is not None:
        delta_out = delta_engine.search(qd, qv, qe, h=delta_engine.num_points,
                                        alpha=alpha, beta=beta)
    # assemble per-engine parts in a COMMON id space; shards stay in row
    # order so the stable merge breaks ties like a top-k of the whole
    parts = []
    for out, off in zip(outs, offsets):
        ids = to_numpy(out[1]).astype(np.int64) + int(off)
        if id_map is not None:
            ids = np.asarray(id_map)[ids]
        parts.append((to_numpy(out[0]), ids, True))
    if delta_out is not None:
        pos = to_numpy(delta_out[1]).astype(np.int64)
        parts.append((to_numpy(delta_out[0]), delta_ids[pos], False))
    return merge_topk_host(parts, h, drop_ids=deleted)


def search_mutable(index, q_sparse, q_dense, h: int = 20,
                   alpha: int | None = None, beta: int | None = None):
    """Three-pass search over main generation + delta shard with the host
    merge (DESIGN.md §6.2), through ``fanout_search``.  Returns a
    SearchResult whose ids are EXTERNAL ids."""
    from .hybrid import SearchResult

    st = index.mutable_state
    p = index.params
    alpha = p.alpha if alpha is None else alpha
    beta = p.beta if beta is None else beta
    dev = index.device
    q_dims, q_vals = sparse_queries_to_padded(q_sparse, index.cols,
                                              nq_max=p.nq_max)
    qd = torch.from_numpy(q_dims).to(dev)
    qv = torch.from_numpy(q_vals).to(dev)
    qe = torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev)

    h_fetch = plan_overfetch([index.engine], h, st.main_tombstones)
    snap = st.delta.snapshot() if st.delta.live_count else None
    delta_engine = None
    if snap is not None:
        delta_engine = ScoringEngine(arrays=snap.arrays,
                                     backend=index.engine.backend)
    s, ids = fanout_search(
        [index.engine], h_fetch, np.zeros(1, np.int64),
        st.id_map, delta_engine,
        snap.ids if snap is not None else None, st.main_tombstones,
        qd, qv, qe, h=h, alpha=alpha, beta=beta)
    return SearchResult(ids=ids, scores=s)
