"""Host half of the distributed search (counterpart of the host-side
functions of ``repro.core.distributed``): row-sharding one ``IndexArrays``
into per-shard copies, and merging per-shard or per-engine top-k lists.

The merges keep ``lax.top_k``'s order (ties toward the lowest position of
the concatenated candidates), so a search split into contiguous row shards
merges back to the unsharded result bit for bit.  The collective search
across cards (``torch.distributed``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import stable_topk
from .engine import IndexArrays
from .pq import ScalarQuant
from .sparse_index import PaddedInvertedIndex, PaddedSparseRows, TileSparseHead

__all__ = ["merge_topk", "merge_topk_host", "ceil16", "split_index_arrays"]


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge per-shard candidates on the device: (Q, S*k) -> (Q, k)."""
    vals, pos = stable_topk(scores, k)
    return vals, torch.gather(ids, 1, pos.long())


def ceil16(n: int) -> int:
    """Round up to the 16 bucket — the tombstone-overfetch granularity
    (DESIGN.md §6.2)."""
    return -(-n // 16) * 16


def merge_topk_host(parts, h: int, *, drop_ids=None, dedup_upserts=False):
    """Host-side top-h merge over per-engine candidate sets (DESIGN.md
    §5.4, §6.2, §8.2); a numpy copy of the JAX package's merge.

    parts: iterable of ``(scores (Q, k_i), ids (Q, k_i), filtered)``, ids
    already in a COMMON (external) id space; widths may differ.
    ``filtered=True`` parts drop candidates whose id is in ``drop_ids``
    (main-generation tombstones); the delta part passes False so an
    upserted row's new copy survives.  ``filtered`` may instead be an
    explicit collection of ids to drop from THAT part only (a per-shard
    tombstone view).  ``dedup_upserts=True`` also drops, from every
    filtered part, any id that appears with a finite score in an unfiltered
    part.

    A stable descending sort over the parts concatenated in caller order;
    entries with non-finite scores get id -1.  Returns (scores, ids)
    (Q, h)."""
    drop = np.asarray(sorted(drop_ids), np.int64) \
        if drop_ids else np.empty(0, np.int64)
    parts = [(np.asarray(s, np.float32), np.asarray(ids, np.int64), f)
             for s, ids, f in parts]
    delta_live = np.empty(0, np.int64)
    if dedup_upserts:
        live = [ids[np.isfinite(s)] for s, ids, f in parts
                if isinstance(f, bool) and not f]
        if live:
            delta_live = np.unique(np.concatenate([v.ravel() for v in live]))
    ss, ii = [], []
    for s, ids, filtered in parts:
        if isinstance(filtered, bool):
            part_drop = drop if filtered else np.empty(0, np.int64)
        else:                      # explicit per-part tombstone view
            part_drop = np.asarray(sorted(filtered), np.int64)
            filtered = True
        if filtered and delta_live.size:
            part_drop = np.union1d(part_drop, delta_live)
        if part_drop.size:
            s = np.where(np.isin(ids, part_drop), -np.inf, s)
        ss.append(s)
        ii.append(ids)
    ss = np.concatenate(ss, axis=1)
    ii = np.concatenate(ii, axis=1)
    if ss.shape[1] < h:                       # tiny pool: pad to (Q, h)
        pad = h - ss.shape[1]
        ss = np.pad(ss, ((0, 0), (0, pad)), constant_values=-np.inf)
        ii = np.pad(ii, ((0, 0), (0, pad)), constant_values=-1)
    order = np.argsort(-ss, axis=1, kind="stable")[:, :h]
    s_out = np.take_along_axis(ss, order, axis=1)
    i_out = np.take_along_axis(ii, order, axis=1)
    return s_out, np.where(np.isfinite(s_out), i_out, -1)


def split_index_arrays(arrays: IndexArrays, num_shards: int, *,
                       ragged: bool = False
                       ) -> tuple[list[IndexArrays], np.ndarray]:
    """Row-slice one ``IndexArrays`` into per-shard copies + row offsets.

    Each shard is a complete ``IndexArrays`` over rows ``[lo, hi)`` on the
    parent's device, so one ``ScoringEngine`` per shard runs the full
    three-pass search on its rows.  Row-parallel tensors are sliced, the
    inverted index is localised (entries outside the shard re-padded to the
    ``n_local`` sentinel), the head block is re-padded to the tile grid and
    its BCSR form rebuilt when the parent carried one; the column-space
    tensors (codebooks, scales, ``head_pos``) are shared with the parent.

    By default ``num_points % num_shards == 0`` is required; ``ragged=True``
    ceil-splits instead (the first ``n % S`` shards get one extra row).
    Returns ``(shards, row_offsets)``."""
    n = arrays.num_points
    if num_shards < 1 or (n % num_shards and not ragged) or num_shards > n:
        raise ValueError(
            f"cannot split {n} rows into {num_shards} equal shards"
            + (" (pass ragged=True for a ceil-split)"
               if ragged is False and num_shards <= n else ""))
    base, rem = divmod(n, num_shards)
    sizes = np.full(num_shards, base, np.int64)
    sizes[:rem] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    offsets = bounds[:-1].astype(np.int32)

    inv_rows = arrays.inv_index.rows
    inv_vals = arrays.inv_index.vals
    shards: list[IndexArrays] = []
    for s in range(num_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        n_local = hi - lo
        inside = (inv_rows >= lo) & (inv_rows < hi)
        inv_s = PaddedInvertedIndex(
            rows=torch.where(inside, inv_rows - lo,
                             torch.full_like(inv_rows, n_local)),
            vals=torch.where(inside, inv_vals, torch.zeros_like(inv_vals)),
            num_points=n_local)

        head_s = arrays.head
        tiles, ptr, col = arrays.head_tiles, arrays.head_ptr, arrays.head_col
        max_steps = arrays.head_max_steps
        if arrays.head is not None:
            br, bc = arrays.head.block_rows, arrays.head.block_cols
            n_pad = -(-n_local // br) * br
            blk = torch.zeros((n_pad, arrays.head.block.shape[1]),
                              dtype=arrays.head.block.dtype,
                              device=arrays.head.block.device)
            blk[:n_local] = arrays.head.block[lo:hi]
            occ = (blk.reshape(n_pad // br, br, blk.shape[1] // bc, bc) != 0
                   ).any(dim=3).any(dim=1)
            head_s = TileSparseHead(block=blk, occupancy=occ,
                                    head_dims=arrays.head.head_dims,
                                    block_rows=br, block_cols=bc)
            if max_steps > 0:
                tiles, ptr, col, max_steps = ops.bcsr_from_head(head_s)

        dres = arrays.dense_residual
        sres = arrays.sparse_residual
        shards.append(IndexArrays(
            codebooks=arrays.codebooks,
            codes=arrays.codes[lo:hi].contiguous(),
            inv_index=inv_s, head=head_s, head_pos=arrays.head_pos,
            head_tiles=tiles, head_ptr=ptr, head_col=col,
            dense_residual=ScalarQuant(q=dres.q[lo:hi].contiguous(),
                                       scale=dres.scale, zero=dres.zero),
            sparse_residual=PaddedSparseRows(
                cols=sres.cols[lo:hi].contiguous(),
                vals=sres.vals[lo:hi].contiguous()),
            num_points=n_local, d_active=arrays.d_active,
            head_max_steps=max_steps, codes_packed=arrays.codes_packed,
            valid_mask=(arrays.valid_mask[lo:hi].contiguous()
                        if arrays.valid_mask is not None else None)))
    return shards, offsets
