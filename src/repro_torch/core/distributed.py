"""Distributed hybrid search (paper §7.2 "Online Search": 200 servers, one
shard each, merge results); counterpart of ``repro.core.distributed``.

The JAX package maps the fan-out to ``shard_map`` over a mesh axis: one
controller, every device scores its row shard and keeps a local top-k, and
an ``all_gather`` brings the (k x num_shards) candidates together.  Here
the mesh is a list of ``torch.device``s, one per shard (the same device may
repeat): each row shard of the stacked index runs its local pass-1 top-k,
or its whole three-pass search, on its device; its ids are globalized by
its row offset; the parts are gathered onto ``devices[0]`` in shard order
and merged there.  All scoring routes through ``core/engine.py``:

* ``make_sharded_search_fn``  — pass 1 only (approximate scores + merge);
* ``make_sharded_search3_fn`` — the FULL three-pass search per shard (each
  shard refines its own candidates against its local residual rows — the
  paper's per-server reordering), then one merge of the refined top-h.

Also here, the host half of the fan-out: row-sharding one ``IndexArrays``
into per-shard copies (``split_index_arrays``, what ``QueryService`` fans
out over) and merging per-shard or per-engine top-k lists.  The merges keep
``lax.top_k``'s order (ties toward the lowest position of the concatenated
candidates), so a search split into contiguous row shards merges back to
the unsharded result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import stable_topk
from . import residual as res
from .engine import Backend, IndexArrays, adc_scores, tail_scores
from .pq import ScalarQuant
from .sparse_index import (PaddedInvertedIndex, PaddedSparseRows,
                           TileSparseHead)

__all__ = ["sharded_pass1_topk", "make_sharded_search_fn",
           "make_sharded_search3_fn", "sharded_three_pass_topk", "merge_topk",
           "merge_topk_host", "ceil16", "split_index_arrays"]


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


# ---------------------------------------------------------------------------
# Sharded search over a device list (the shard_map fan-out of the reference)
# ---------------------------------------------------------------------------

def _pass1_scores_local(codes, lut, inv_rows, inv_vals, q_dims, q_vals,
                        backend: Backend):
    """Approximate hybrid scores for the local row shard, via the engine.

    For backend CUDA_PACKED, ``codes`` is the packed (N_local, ceil(K/2))
    form: packed codes row-shard exactly like unpacked ones."""
    inv = PaddedInvertedIndex(rows=inv_rows, vals=inv_vals,
                              num_points=codes.shape[0])
    return (adc_scores(codes, lut, backend)
            + tail_scores(inv, q_dims, q_vals, backend))


def _pass1_topk_local(codes, lut, inv_rows, inv_vals, q_dims, q_vals, *,
                      k: int, backend: Backend):
    """Per-shard pass-1 top-k: the fused scan-and-select (K2 on the card)
    on the kernel backends when k fits its candidate buffer, else the scores
    materialised (K1 on the card on the kernel backends) and a stable top-k.
    Both routes give the same bits, so the merge sees the same candidates
    either way."""
    if backend.uses_kernels and k <= ops.MAX_FUSED_CANDIDATES:
        inv = PaddedInvertedIndex(rows=inv_rows, vals=inv_vals,
                                  num_points=codes.shape[0])
        return ops.lut16_adc_topk(
            codes, lut, k, bias=tail_scores(inv, q_dims, q_vals, backend),
            packed=backend is Backend.CUDA_PACKED)
    return stable_topk(_pass1_scores_local(codes, lut, inv_rows, inv_vals,
                                           q_dims, q_vals, backend), k)


def _search3_local(codes, lut, inv_rows, inv_vals, res_q, res_scale, res_zero,
                   sres_cols, sres_vals, q_dims, q_vals, q_dense, q_cols,
                   row_offset: int, *, h: int, alpha: int, beta: int,
                   backend: Backend):
    """One shard's full three-pass search; candidate counts are per shard,
    so every server does the paper's reordering on its own rows.  Returns
    the local top-h with global ids."""
    n_local = codes.shape[0]
    c1 = min(max(alpha * h, h), n_local)
    c2 = min(max(beta * h, h), c1)

    # pass 1: local candidates, overfetch c1 (fused on the kernel backends)
    s1, ids1 = _pass1_topk_local(codes, lut, inv_rows, inv_vals,
                                 q_dims, q_vals, k=c1, backend=backend)

    # pass 2: + local dense residual rows, keep c2
    sq = ScalarQuant(q=res_q, scale=res_scale, zero=res_zero)
    extra_d = res.dense_residual_scores(sq, ids1, q_dense)
    s2, ids2 = res.reorder_pass(s1, ids1, extra_d, c2)

    # pass 3: + local sparse residual rows, local top-h
    rows = PaddedSparseRows(cols=sres_cols, vals=sres_vals)
    extra_s = res.sparse_residual_scores(rows, ids2, q_cols)
    s3, ids3 = res.reorder_pass(s2, ids2, extra_s, h)
    return s3, ids3 + row_offset                       # globalize ids


def _on(x, dev: torch.device) -> torch.Tensor:
    """``x`` (a tensor or an array) on ``dev``, contiguous and 16-byte
    aligned (the LUT16 kernels copy codes in 16-byte pieces; a row slice of
    a shard need not start on such a boundary)."""
    t = torch.as_tensor(x).to(dev).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _shard_devices(devices) -> list[torch.device]:
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a sharded search needs at least one device")
    return devs


def _row_shard(x, s: int, num_shards: int):
    """Shard ``s`` of ``num_shards`` equal row ranges of ``x``."""
    n = x.shape[0]
    if n % num_shards:
        raise ValueError(f"{n} rows do not split into {num_shards} equal "
                         "shards")
    per = n // num_shards
    return x[s * per:(s + 1) * per]


def _gather_merge(parts, dev: torch.device, k: int):
    """The all_gather and merge: the per-shard (scores, ids) parts onto
    ``dev`` in shard order, (Q, S*k), merged to the best k."""
    scores = torch.cat([s.to(dev) for s, _ in parts], dim=1)
    ids = torch.cat([i.to(dev) for _, i in parts], dim=1)
    return merge_topk(scores, ids, k)


def make_sharded_search_fn(devices, *, k: int, adc: str | None = None):
    """Build the sharded pass-1 search over ``devices``, one shard each.

    Index arrays are split on their row axis into len(devices) equal
    shards; queries and LUTs are replicated.  Returns fn(codes, lut,
    inv_rows, inv_vals, q_dims, q_vals, row_offset) -> (scores (Q, k),
    global ids (Q, k)) on ``devices[0]``.

    inv_rows / inv_vals are per-shard stacked: (num_shards * d_active, L),
    each shard's slice holding row ids local to that shard (pad = its
    row count).  row_offset: (num_shards,) — the global row id of each
    shard's first row.  adc: an engine backend name — "ref" / "gather",
    "onehot", "cuda" (K2, or K1 + stable top-k when k > 1024), "cuda-packed"
    (the same over codes packed two per byte), or the JAX package's names
    ("pallas", "pallas-packed", ...); None => "cuda"."""
    backend = Backend.from_name(adc)
    devs = _shard_devices(devices)

    def fn(codes, lut, inv_rows, inv_vals, q_dims, q_vals, row_offset):
        parts = []
        for s, dev in enumerate(devs):
            sl, si = _pass1_topk_local(
                _on(_row_shard(codes, s, len(devs)), dev), _on(lut, dev),
                _on(_row_shard(inv_rows, s, len(devs)), dev),
                _on(_row_shard(inv_vals, s, len(devs)), dev),
                _on(q_dims, dev), _on(q_vals, dev), k=k, backend=backend)
            parts.append((sl, si + int(row_offset[s])))
        return _gather_merge(parts, devs[0], k)
    return fn


def _equal_offsets(n: int, num_shards: int) -> np.ndarray:
    return np.arange(num_shards, dtype=np.int32) * (n // num_shards)


def sharded_pass1_topk(devices, codes, lut, inv_rows, inv_vals, q_dims,
                       q_vals, *, k: int, adc: str | None = None):
    """Convenience wrapper: derives ``row_offset`` from equal row sharding
    and runs the sharded pass-1 search (inv_rows / inv_vals per-shard
    stacked, see ``make_sharded_search_fn``)."""
    devs = _shard_devices(devices)
    fn = make_sharded_search_fn(devs, k=k, adc=adc)
    return fn(codes, lut, inv_rows, inv_vals, q_dims, q_vals,
              _equal_offsets(codes.shape[0], len(devs)))


def make_sharded_search3_fn(devices, *, h: int, alpha: int = 20,
                            beta: int = 5, adc: str | None = None):
    """Build the sharded THREE-pass search over ``devices``, one shard each.

    Row-split: codes (N, K) — or (N, ceil(K/2)) packed two per byte when
    adc is "cuda-packed" — inv_rows / inv_vals (per-shard stacked, see
    ``make_sharded_search_fn``), res_q (N, d^D) int8 dense-residual rows,
    sres_cols / sres_vals (N, R) padded sparse-residual rows.  Replicated:
    lut, res_scale / res_zero, q_dims / q_vals, q_dense (Q, d^D), q_cols
    (Q, d_active + 1) — the padded sparse queries scattered into the
    compact column space (``engine.scatter_queries_compact``).  row_offset:
    (S,).

    Returns fn(...) -> (scores (Q, h), global ids (Q, h)) on
    ``devices[0]``."""
    backend = Backend.from_name(adc)
    devs = _shard_devices(devices)

    def fn(codes, lut, inv_rows, inv_vals, res_q, res_scale, res_zero,
           sres_cols, sres_vals, q_dims, q_vals, q_dense, q_cols, row_offset):
        parts = []
        for s, dev in enumerate(devs):
            def rows(x):
                return _on(_row_shard(x, s, len(devs)), dev)

            parts.append(_search3_local(
                rows(codes), _on(lut, dev), rows(inv_rows), rows(inv_vals),
                rows(res_q), _on(res_scale, dev), _on(res_zero, dev),
                rows(sres_cols), rows(sres_vals), _on(q_dims, dev),
                _on(q_vals, dev), _on(q_dense, dev), _on(q_cols, dev),
                int(row_offset[s]), h=h, alpha=alpha, beta=beta,
                backend=backend))
        return _gather_merge(parts, devs[0], h)
    return fn


def sharded_three_pass_topk(devices, codes, lut, inv_rows, inv_vals,
                            res_q, res_scale, res_zero, sres_cols, sres_vals,
                            q_dims, q_vals, q_dense, q_cols, *, h: int,
                            alpha: int = 20, beta: int = 5,
                            adc: str | None = None):
    """Convenience wrapper: derives ``row_offset`` from equal row sharding
    and runs the full three-pass fan-out search."""
    devs = _shard_devices(devices)
    fn = make_sharded_search3_fn(devs, h=h, alpha=alpha, beta=beta, adc=adc)
    return fn(codes, lut, inv_rows, inv_vals, res_q, res_scale, res_zero,
              sres_cols, sres_vals, q_dims, q_vals, q_dense, q_cols,
              _equal_offsets(codes.shape[0], len(devs)))
