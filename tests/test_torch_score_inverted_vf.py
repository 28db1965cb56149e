"""B4 as redesigned for Hopper (``kernels/inverted.py``,
``csrc/score_inverted.cu``): the pass-1 tail bias in one launch, on the CPU.

The kernel cannot run here.  Its launch geometry is the port's Python
(``plan_score_inverted``), and ``replay`` below walks the kernel's loops in
numpy at that geometry: per CTA (one query, a run of tiles), windows of
256 slots compacted in slot order, lists staged 2048 entries at a time in
(slot, position) order, each product rounded once, the entries in the
CTA's rows kept resident in that order (or, past the buffer, the lists
streamed again for each tile); per tile from +0, the resident entries 2048
at a time, those in the tile's rows kept in order, each warp adding the
kept entries in its own rows 32 at a time, lanes with a repeated row one
after another in lane order, and the shifted tile stored.
The replay must equal the plain version, ``score_inverted``, bit for bit on
every case; both are held to the JAX package's ``score_inverted`` within
rtol 1e-5 / atol 1e-4 (``tests/test_torch_engine.py``'s tolerance: XLA adds
the duplicates of a scatter in its own order).  On the card ``chip_smoke.py``
holds the kernel itself to ``score_inverted`` with ``torch.equal``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from _torch_port_helpers import ATOL, RTOL

from repro.core.sparse_index import PaddedInvertedIndex as JaxInvertedIndex
from repro.core.sparse_index import score_inverted as jax_score_inverted
from repro.data import make_hybrid_dataset
from repro_torch.core import engine
from repro_torch.core.engine import Backend
from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.core.sparse_index import (DeltaPostings, PaddedInvertedIndex,
                                           build_compact_columns,
                                           build_padded_inverted_index,
                                           score_inverted,
                                           sparse_queries_to_padded)
from repro_torch.kernels import inverted, ops, ref


def _occurrence_rank(cells: np.ndarray) -> np.ndarray:
    """For each entry, how many earlier entries hold the same cell."""
    seen: dict[int, int] = {}
    rank = np.empty(len(cells), np.int64)
    for i, c in enumerate(cells.tolist()):
        rank[i] = seen.get(c, 0)
        seen[c] = rank[i] + 1
    return rank


def _walk(tile, brow, bval, r0, ln, rw):
    """Each warp adds the entries in its rows of the tile at r0, in order,
    32 buffer positions a step; lanes with one row in a step add in lane
    order."""
    rl = brow - r0
    for w in range(inverted.WARPS):
        lo, hi = w * rw, min(w * rw + rw, ln)
        mine = np.flatnonzero((rl >= lo) & (rl < hi))
        for step in np.unique(mine // 32):
            at = mine[mine // 32 == step]
            rank = _occurrence_rank(rl[at])
            for kk in range(int(rank.max()) + 1):
                sel = at[rank == kk]
                tile[rl[sel]] = tile[rl[sel]] + bval[sel]


def _pieces(rows, vals, dims, qv, d):
    """A query's staged pieces, in order: per window of 256 slots its valid
    slots, their lists flattened in (slot, position) order, 2048 entries a
    piece, as (global rows, rounded products)."""
    l = rows.shape[1]
    out = []
    for w0 in range(0, len(dims), inverted.WINDOW):
        dd = dims[w0:w0 + inverted.WINDOW]
        keep = (dd >= 0) & (dd < d)
        wdim, wqv = dd[keep], qv[w0:w0 + inverted.WINDOW][keep]
        entries = len(wdim) * l
        for e0 in range(0, entries, inverted.STAGE):
            e = np.arange(e0, min(e0 + inverted.STAGE, entries))
            k, p = e // l, e % l
            out.append((rows[wdim[k], p], vals[wdim[k], p] * wqv[k]))
    return out


def replay(rows, vals, q_dims, q_vals, n: int,
           plan: inverted.InvertedPlan) -> tuple[np.ndarray, int]:
    """numpy walk of ``score_inverted_kernel`` at ``plan``, its order of
    adds kept.  Returns the output (NaN where no CTA stored, so a gap
    shows) and how many CTAs overflowed their resident buffer and
    streamed."""
    rows = np.asarray(rows, np.int64)
    vals = np.asarray(vals, np.float32)
    q_dims = np.asarray(q_dims, np.int64)
    q_vals = np.asarray(q_vals, np.float32)
    d = rows.shape[0]
    qn = q_dims.shape[0]
    r_tile, rw = plan.rows_per_tile, plan.rows_per_warp
    span = plan.tiles_per_cta * r_tile
    out = np.full((qn, n), np.nan, np.float32)
    streamed = 0
    for q in range(qn):
        pieces = _pieces(rows, vals, q_dims[q], q_vals[q], d)
        for g in range(plan.ctas_per_query):
            c0, c1 = g * span, min(n, (g + 1) * span)
            # A. the entries in [c0, c1), resident unless they pass cap
            res_r, res_c, res_n = [], [], 0
            for r, c in pieces:
                kept = (r >= c0) & (r < c1)
                if res_n + kept.sum() > plan.cap:
                    res_n = -1
                    break
                res_r.append(r[kept])
                res_c.append(c[kept])
                res_n += int(kept.sum())
            streamed += res_n < 0
            # B. the tiles
            for r0 in range(c0, c1, r_tile):
                ln = min(r_tile, c1 - r0)
                mis = (q * n + r0) % 4      # the output's offset in floats
                acc = np.zeros(r_tile + 4, np.float32)
                tile = acc[mis:]
                if res_n >= 0:
                    rr = np.concatenate(res_r + [np.zeros(0, np.int64)])
                    rc = np.concatenate(res_c + [np.zeros(0, np.float32)])
                    tile_pieces = [(rr[e0:e0 + inverted.STAGE],
                                    rc[e0:e0 + inverted.STAGE])
                                   for e0 in range(0, res_n, inverted.STAGE)]
                else:
                    tile_pieces = pieces
                for r, c in tile_pieces:
                    kept = (r >= r0) & (r < r0 + ln)
                    _walk(tile, r[kept], c[kept], r0, ln, rw)
                out[q, r0:r0 + ln] = acc[mis:mis + ln]
    return out, streamed


def _index(n, d, *, seed, density=0.02, l_max=None):
    x = sp.random(n, d, density=density, random_state=seed, format="csr",
                  dtype=np.float32)
    cols, xc = build_compact_columns(x)
    return cols, build_padded_inverted_index(xc, l_max, device="cpu")


def _queries(cols, qn, d, *, seed, density=0.05, nq_max=32):
    qs = sp.random(qn, d, density=density, random_state=seed, format="csr",
                   dtype=np.float32)
    return sparse_queries_to_padded(qs, cols, nq_max=nq_max)


def _case(name):
    """(inv, q_dims, q_vals, sm_count, check_jax) of one named case."""
    rng = np.random.default_rng(len(name))
    if name == "delta":
        return _delta_case() + (4, True)
    if name == "delta_repeated_row":
        post = DeltaPostings(40, l_max=2, l_cap=6)
        for slot in range(30):
            dims = rng.choice(40, 5, replace=False)
            if slot % 7 == 3:                  # a row that repeats a dim
                dims = np.concatenate([dims, dims[:2]])
            post.append(slot, dims, rng.normal(size=len(dims)).astype(
                np.float32))
        inv = post.to_padded(33, device="cpu")
        qd = np.tile(np.arange(40, dtype=np.int32), (3, 1))
        qv = rng.normal(size=qd.shape).astype(np.float32)
        return inv, qd, qv, 2, True
    n, d, qn, sms, nq_max = 700, 500, 9, 4, 32
    if name == "q1":
        qn = 1
    if name == "one_tile":                       # N below one granule
        n, d = 50, 80
    if name == "two_windows_many_pieces":        # > 256 slots, > 2048 entries
        n, d, nq_max = 900, 400, 300
    cols, inv = _index(n, d, seed=n + len(name))
    qd, qv = _queries(cols, qn, d, seed=n + 1,
                      density=0.9 if nq_max == 300 else 0.05, nq_max=nq_max)
    d_act = cols.num_active
    rows = inv.rows.clone()
    vals = inv.vals.clone()
    check_jax = True
    if name == "repeated_dim":
        qd[0, 1], qv[0, 1] = qd[0, 0], 0.5
        qd[3, 5], qv[3, 5] = qd[3, 2], -1.25
    elif name == "all_pad_query":
        qd[2, :], qv[2, :] = d_act, 0.0
    elif name == "dims_out_of_range":
        qd[0, 0], qd[1, 3], qd[4, 1] = -1, d_act, d_act + 7
        qd[5, 2] = -3
        check_jax = False                # jnp.take wraps negative ids
    elif name == "sentinel_mid_list":
        # entries dropped in the middle of lists, as a shard's localised
        # index holds them
        drop = rng.random(rows.shape) < 0.3
        rows[torch.from_numpy(drop)] = n
        vals[torch.from_numpy(drop)] = 0.0
    elif name == "one_row_every_slot":
        rows[:, 0], vals[:, 0] = 17, 0.75
        qv[:] = np.where(qd < d_act, rng.normal(size=qv.shape), 0.0)
    elif name == "unsorted_lists":
        perm = torch.from_numpy(rng.permuted(
            np.tile(np.arange(rows.shape[1]), (rows.shape[0], 1)), axis=1))
        rows, vals = rows.gather(1, perm), vals.gather(1, perm)
    elif name == "int64_dims":
        qd = qd.astype(np.int64)
    inv = PaddedInvertedIndex(rows=rows.contiguous(), vals=vals.contiguous(),
                              num_points=n)
    return inv, qd, qv, sms, check_jax


def _delta_case():
    """A delta shard's index after inserts, deletes and a spill: twenty
    copies of one row push its dims past the 16-entry cap."""
    ds = make_hybrid_dataset(num_points=280, num_queries=4, d_sparse=360,
                             d_dense=12, nnz_per_row=12, seed=11)
    idx = HybridIndex.build(ds.x_sparse[:240], ds.x_dense[:240],
                            HybridIndexParams(backend="cuda", keep_top=24,
                                              head_dims=12, kmeans_iters=3),
                            mutable=True, delta_capacity=64, device="cpu")
    idx.insert(ds.x_sparse[240:270], ds.x_dense[240:270])
    rep = sp.vstack([ds.x_sparse[241]] * 20).tocsr()
    idx.insert(rep, np.repeat(ds.x_dense[241:242], 20, axis=0))
    idx.delete([241, 245])
    delta = idx.mutable_state.delta
    assert (delta._row_vals[:delta.count] != 0).any()      # spilled
    inv = delta.snapshot().arrays.inv_index
    qd, qv = sparse_queries_to_padded(
        sp.vstack([ds.q_sparse, ds.x_sparse[241]]).tocsr(), idx.cols,
        nq_max=64)
    return inv, qd, qv


CASES = ["basic", "q1", "one_tile", "two_windows_many_pieces",
         "repeated_dim", "all_pad_query", "dims_out_of_range",
         "sentinel_mid_list", "one_row_every_slot", "unsorted_lists",
         "int64_dims", "delta", "delta_repeated_row"]


@pytest.mark.parametrize("name", CASES)
def test_replay_equals_plain_bit_for_bit(name):
    inv, qd, qv, sms, _ = _case(name)
    n = inv.num_points
    want = score_inverted(inv, torch.from_numpy(qd), torch.from_numpy(qv))
    for cap in (inverted.CAP, inverted.STAGE):
        plan = dataclasses.replace(
            inverted.plan_score_inverted(qd.shape[0], n, sms), cap=cap)
        got, _ = replay(inv.rows.numpy(), inv.vals.numpy(), qd, qv, n, plan)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.numpy().view(np.int32))
    if name == "all_pad_query":
        assert not got[2].any()


@pytest.mark.parametrize("name", [c for c in CASES if c != "dims_out_of_range"])
def test_plain_and_replay_match_jax(name):
    inv, qd, qv, sms, check_jax = _case(name)
    assert check_jax
    n = inv.num_points
    want = np.asarray(jax_score_inverted(
        JaxInvertedIndex(rows=jnp.asarray(inv.rows.numpy()),
                         vals=jnp.asarray(inv.vals.numpy()), num_points=n),
        jnp.asarray(qd), jnp.asarray(qv)))
    got = ops.score_inverted_vf(inv, torch.from_numpy(qd),
                                torch.from_numpy(qv)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plan = inverted.plan_score_inverted(qd.shape[0], n, sms)
    np.testing.assert_allclose(replay(inv.rows.numpy(), inv.vals.numpy(), qd,
                                      qv, n, plan)[0], want, rtol=RTOL,
                               atol=ATOL)


def test_geometry_changes_no_bit():
    """Plans from one CTA a query to one tile a CTA, and a buffer small
    enough that CTAs stream, all walk to the same bits."""
    inv, qd, qv, _, _ = _case("two_windows_many_pieces")
    n, qn = inv.num_points, qd.shape[0]
    want = score_inverted(inv, torch.from_numpy(qd),
                          torch.from_numpy(qv)).numpy()
    plans = {dataclasses.replace(inverted.plan_score_inverted(qn, n, sms),
                                 cap=cap)
             for sms in (1, 4, 16) for cap in (inverted.CAP, inverted.STAGE)}
    plans.add(inverted.InvertedPlan(rows_per_tile=256, tiles=4,
                                    tiles_per_cta=3, ctas_per_query=2,
                                    cap=inverted.STAGE))
    plans.add(inverted.InvertedPlan(rows_per_tile=512, tiles=2,
                                    tiles_per_cta=2, ctas_per_query=1,
                                    cap=0))
    streamed = 0
    for plan in plans:
        got, s = replay(inv.rows.numpy(), inv.vals.numpy(), qd, qv, n, plan)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        streamed += s
    assert len({p.tiles_per_cta for p in plans}) >= 2 and streamed > 0


def test_plan_at_the_slice_shapes():
    """The slice's N = 524288 on the H100's 132 SMs: two waves of two
    CTAs an SM at Q = 1, 8 and 128, two CTAs within an SM's 228 KB, 1 KB
    each kept by the system."""
    n, sms = 524288, 132
    got = {q: inverted.plan_score_inverted(q, n, sms) for q in (1, 8, 128)}
    assert got[1] == inverted.InvertedPlan(1024, 512, 1, 512)
    assert got[8] == inverted.InvertedPlan(8192, 64, 1, 64)
    assert got[128] == inverted.InvertedPlan(12288, 43, 11, 4)
    for q, p in got.items():
        assert p.grid(q) <= 4 * sms
        assert 2 * (p.smem_bytes + 1024) <= 233472


@pytest.mark.parametrize("q", [1, 2, 3, 7, 8, 33, 128, 1000])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 5000, 40961, 524288,
                               1000003])
def test_plan_invariants(q, n):
    p = inverted.plan_score_inverted(q, n, 132)
    r = p.rows_per_tile
    assert r % inverted.ROW_GRANULE == 0 and r % (32 * inverted.WARPS) == 0
    assert inverted.ROW_GRANULE <= r <= inverted.MAX_ROWS_PER_TILE
    assert p.tiles == -(-n // r) and (p.tiles - 1) * r < n <= p.tiles * r
    assert (p.ctas_per_query - 1) * p.tiles_per_cta < p.tiles \
        <= p.ctas_per_query * p.tiles_per_cta
    assert p.grid(q) <= max(q, inverted.WAVES * inverted.CTAS_PER_SM * 132)
    assert p.rows_per_warp * inverted.WARPS == r
    assert inverted.CTAS_PER_SM * (p.smem_bytes + 1024) <= 233472


def test_plan_refuses_what_it_cannot_run():
    for args in ((0, 10, 132), (3, 0, 132), (3, 10, 0)):
        with pytest.raises(ValueError, match="no plan"):
            inverted.plan_score_inverted(*args)
    for bad in (dict(cap=-1), dict(rows_per_tile=48), dict(rows_per_tile=0),
                dict(ctas_per_query=3), dict(tiles_per_cta=0)):
        with pytest.raises(ValueError, match="cannot launch"):
            dataclasses.replace(inverted.InvertedPlan(256, 4, 2, 2), **bad)


@pytest.mark.parametrize("backend", ["ref", "onehot", "cuda", "cuda-packed"])
def test_pass1_bias_routes_by_backend_on_cpu(backend):
    """On CPU tensors every backend's tail bias is the plain bits; only the
    kernel backends go through the wrapper (its plain version, counted),
    and nothing launches."""
    inv, qd, qv, _, _ = _case("basic")
    want = score_inverted(inv, torch.from_numpy(qd), torch.from_numpy(qv))
    ops.reset_counts()
    got = engine.tail_scores(inv, torch.from_numpy(qd), torch.from_numpy(qv),
                             Backend.from_name(backend))
    assert torch.equal(got, want)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    kernels = Backend.from_name(backend).uses_kernels
    assert ref.PLAIN_CALLS["score_inverted_vf"] == int(kernels)
    ops.reset_counts()


def test_pass1_bias_on_cpu_takes_the_plain_tail_once():
    """``pass1_bias`` on the kernel backend, on CPU tensors: the tail
    through the wrapper's plain version once, the head through K3's, and
    their sum; nothing launches."""
    ds = make_hybrid_dataset(num_points=600, num_queries=5, d_sparse=900,
                             d_dense=16, nnz_per_row=14, seed=5)
    idx = HybridIndex.build(ds.x_sparse, ds.x_dense,
                            HybridIndexParams(backend="cuda", keep_top=32,
                                              head_dims=16, kmeans_iters=2),
                            device="cpu")
    qd, qv = sparse_queries_to_padded(ds.q_sparse, idx.cols, nq_max=64)
    qd, qv = torch.from_numpy(qd), torch.from_numpy(qv)
    arrays = idx.engine.arrays
    assert arrays.head is not None and arrays.head_max_steps > 0
    ops.reset_counts()
    got = engine.pass1_bias(arrays, qd, qv, Backend.CUDA)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert ref.PLAIN_CALLS["score_inverted_vf"] == 1
    assert ref.PLAIN_CALLS["block_sparse_matmul"] == 1
    q_head = engine.scatter_head_queries(qd, qv, arrays.head_pos,
                                         arrays.head.block.shape[1])
    head = ops.block_sparse_matmul_bcsr(q_head, arrays.head_tiles,
                                        arrays.head_ptr, arrays.head_col)
    want = score_inverted(arrays.inv_index, qd, qv) + head[:, :600]
    assert torch.equal(got, want)
    ops.reset_counts()
