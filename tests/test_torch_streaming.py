"""The port's mutable index (repro_torch.core.streaming) and its host
helpers (pq rows, DeltaPostings, the host merge, the row split) against the
JAX package's, on the CPU.

One seeded insert / upsert / delete sequence goes through a JAX mutable
index and a port mutable index that serves the same main generation
(``interchange.mutable_index_from_numpy``), both on the ``ref`` backend.
Results must agree under ``assert_topk_match`` (rtol 1e-5, atol 1e-4, ties
up to the tolerance), and delta codes up to near-ties of the encoder (the
two packages sum the distances in different orders).  Host-side numpy
copies must agree exactly.  Inside the port, ``compact(retrain=True)``
equals a scratch build bit for bit and a held delta snapshot is unchanged
by later inserts."""

import numpy as np
import pytest
import torch
from _torch_port_helpers import assert_topk_match, jax_index_state

from repro.core import distributed as jdist
from repro.core import pq as jpq
from repro.core.hybrid import HybridIndex as JaxHybridIndex
from repro.core.hybrid import HybridIndexParams as JaxParams
from repro.core.sparse_index import DeltaPostings as JaxDeltaPostings
from repro.data import make_hybrid_dataset
from repro.kernels.ops import bcsr_from_head as jax_bcsr_from_head
from repro_torch.core import distributed, pq
from repro_torch.core.engine import ScoringEngine
from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.core.sparse_index import (DeltaPostings,
                                           sparse_queries_to_padded)
from repro_torch.core.streaming import fanout_search, plan_overfetch
from repro_torch.interchange import (hybrid_index_from_numpy,
                                     mutable_index_from_numpy)

N0, N_POOL, NQ, D_SPARSE, D_DENSE = 240, 300, 4, 360, 12
PARAMS = dict(keep_top=24, head_dims=12, kmeans_iters=3)
H = 10


@pytest.fixture(scope="module")
def ds():
    return make_hybrid_dataset(num_points=N_POOL, num_queries=NQ,
                               d_sparse=D_SPARSE, d_dense=D_DENSE,
                               nnz_per_row=12, seed=11)


def _codes_match(x, centers, got, want, tol=1e-4):
    """Codes equal, except where the two codewords are a near-tie of the
    squared distance of that subvector."""
    x = np.asarray(x, np.float64)
    centers = np.asarray(centers, np.float64)
    k, _, p = centers.shape
    for r, s in zip(*np.nonzero(np.asarray(got) != np.asarray(want))):
        sub = x[r, s * p:(s + 1) * p]
        d = ((centers[s] - sub) ** 2).sum(-1)
        g, w = d[int(got[r, s])], d[int(want[r, s])]
        assert abs(g - w) <= tol * max(1.0, abs(w)), (r, s, g, w)


# ---------------------------------------------------------------------------
# the replay: one mutation sequence through both packages
# ---------------------------------------------------------------------------

def _steps(ds):
    xs, xd = ds.x_sparse, ds.x_dense
    return [
        ("fresh", None),
        ("insert", lambda i: i.insert(xs[240:260], xd[240:260])),
        ("upsert", lambda i: i.insert(xs[260:265], xd[260:265],
                                      ids=[3, 250, 7, 1000, 1001])),
        ("delete", lambda i: i.delete([10, 245, 12, 1000, 99999])),
        ("grow", lambda i: i.insert(xs[265:300], xd[265:300])),
    ]


@pytest.fixture(scope="module")
def replay(ds):
    jidx = JaxHybridIndex.build(ds.x_sparse[:N0], ds.x_dense[:N0],
                                JaxParams(backend="ref", **PARAMS),
                                mutable=True, delta_capacity=16)
    leaves, scalars = jax_index_state(jidx)
    tidx = mutable_index_from_numpy(
        leaves, scalars, ds.x_sparse[:N0], ds.x_dense[:N0],
        delta_capacity=16, params=HybridIndexParams(backend="ref", **PARAMS),
        device="cpu")
    steps = {}
    for name, op in _steps(ds):
        out = (None, None) if op is None else (op(jidx), op(tidx))
        steps[name] = dict(
            ret=out,
            jax=jidx.search(ds.q_sparse, ds.q_dense, h=H),
            port=tidx.search(ds.q_sparse, ds.q_dense, h=H),
            version=(jidx.delta_version, tidx.delta_version))
    return jidx, tidx, steps


@pytest.mark.parametrize("step", ["fresh", "insert", "upsert", "delete",
                                  "grow"])
def test_replay_search_matches_jax(replay, step):
    _, _, steps = replay
    rec = steps[step]
    j, t = rec["ret"]
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert rec["version"][0] == rec["version"][1]
    assert_topk_match(rec["port"].scores, rec["port"].ids,
                      rec["jax"].scores, rec["jax"].ids)


def test_replay_delta_state_matches_jax(replay, ds):
    jidx, tidx, _ = replay
    jd, td = jidx.mutable_state.delta, tidx.mutable_state.delta
    assert (td.capacity, td.count, td.live_count, td.dropped_nnz,
            td._rmax, td._postings.l_max) == (
        jd.capacity, jd.count, jd.live_count, jd.dropped_nnz, jd._rmax,
        jd._postings.l_max)
    np.testing.assert_array_equal(td._ids, jd._ids)
    np.testing.assert_array_equal(td._dead, jd._dead)
    np.testing.assert_array_equal(td._row_cols, jd._row_cols)
    np.testing.assert_array_equal(td._row_vals, jd._row_vals)
    extra = np.stack(tidx.mutable_state.extra_dense)
    _codes_match(extra, jidx.codebooks.centers, td._codes[:td.count],
                 jd._codes[:jd.count])
    same = (td._codes == jd._codes).all(axis=1)
    np.testing.assert_array_equal(td._resq[same], jd._resq[same])
    ts, js = td.snapshot(), jd.snapshot()
    np.testing.assert_array_equal(ts.arrays.inv_index.rows.numpy(),
                                  np.asarray(js.arrays.inv_index.rows))
    np.testing.assert_array_equal(ts.arrays.inv_index.vals.numpy(),
                                  np.asarray(js.arrays.inv_index.vals))
    np.testing.assert_array_equal(ts.arrays.valid_mask.numpy(),
                                  np.asarray(js.arrays.valid_mask))
    jm, tm = jidx.mutable_state, tidx.mutable_state
    assert tm.main_tombstones == jm.main_tombstones
    assert (tm.next_id, tm.live_rows) == (jm.next_id, jm.live_rows)
    (txs, txd, tids), (jxs, jxd, jids) = tm.survivors(), jm.survivors()
    assert (txs != jxs).nnz == 0
    np.testing.assert_array_equal(txd, jxd)
    np.testing.assert_array_equal(tids, jids)


def test_merge_compact_matches_jax(replay, ds):
    jidx, tidx, _ = replay
    jm, tm = jidx.compact(retrain=False), tidx.compact(retrain=False)
    np.testing.assert_array_equal(tm.pi, jm.pi)
    np.testing.assert_array_equal(tm.head_dim_ids, jm.head_dim_ids)
    for got, want in ((tm.inv_index.rows, jm.inv_index.rows),
                      (tm.inv_index.vals, jm.inv_index.vals),
                      (tm.sparse_residual.cols, jm.sparse_residual.cols),
                      (tm.sparse_residual.vals, jm.sparse_residual.vals),
                      (tm.head.block, jm.head.block)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xd = tm.mutable_state.x_dense0[tm.pi]
    tc, jc = tm.codes.numpy(), np.asarray(jm.codes)
    _codes_match(xd, jidx.codebooks.centers, tc, jc)
    same = (tc == jc).all(axis=1)
    np.testing.assert_array_equal(tm.dense_residual.q.numpy()[same],
                                  np.asarray(jm.dense_residual.q)[same])
    assert (tm.mutable_state.next_id, tm.mutable_state.main_dropped_nnz) == (
        jm.mutable_state.next_id, jm.mutable_state.main_dropped_nnz)
    rt = tm.search(ds.q_sparse, ds.q_dense, h=H)
    rj = jm.search(ds.q_sparse, ds.q_dense, h=H)
    assert_topk_match(rt.scores, rt.ids, rj.scores, rj.ids)


def test_retrain_compact_equals_scratch_build(replay, ds):
    _, tidx, _ = replay
    new = tidx.compact(retrain=True)
    xs, xd, ids = tidx.mutable_state.survivors()
    scratch = HybridIndex.build(xs, xd, tidx.params, mutable=True,
                                ext_ids=ids, device="cpu")
    a = new.search(ds.q_sparse, ds.q_dense, h=H)
    b = scratch.search(ds.q_sparse, ds.q_dense, h=H)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert new.mutable_state.next_id == tidx.mutable_state.next_id


# ---------------------------------------------------------------------------
# the port alone: snapshot isolation, routing and the validation errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grows", [False, True])
def test_held_snapshot_unchanged_by_inserts(ds, grows):
    """In place (room left) or through growth, an insert leaves a held
    snapshot's search bit for bit as it was."""
    idx = HybridIndex.build(ds.x_sparse[:N0], ds.x_dense[:N0],
                            HybridIndexParams(backend="cuda", **PARAMS),
                            mutable=True, delta_capacity=32, device="cpu")
    idx.insert(ds.x_sparse[240:270], ds.x_dense[240:270])
    idx.delete([241])
    delta = idx.mutable_state.delta
    snap = delta.snapshot()
    qd, qv = sparse_queries_to_padded(ds.q_sparse, idx.cols, nq_max=256)
    q = (torch.from_numpy(qd), torch.from_numpy(qv),
         torch.from_numpy(ds.q_dense))
    eng = ScoringEngine(arrays=snap.arrays, backend=idx.engine.backend)
    before = eng.search(*q, h=snap.capacity, alpha=20, beta=5)
    m = 10 if grows else 2
    idx.insert(ds.x_sparse[270:270 + m], ds.x_dense[270:270 + m])
    assert (delta.capacity > snap.capacity) == grows
    if not grows:                  # the insert wrote into the held tensors
        assert delta._arrays_struct.codes is snap.arrays.codes
    after = eng.search(*q, h=snap.capacity, alpha=20, beta=5)
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    found = idx.search(ds.q_sparse[:1], ds.q_dense[:1], h=H)
    assert 241 not in set(found.ids.ravel().tolist())


def test_mutable_routing_and_immutable_refusals(ds):
    p = HybridIndexParams(backend="ref", **PARAMS)
    idx = HybridIndex.build(ds.x_sparse[:N0], ds.x_dense[:N0], p,
                            mutable=True, device="cpu")
    plain = HybridIndex.build(ds.x_sparse[:N0], ds.x_dense[:N0], p,
                              device="cpu")
    a = idx.search(ds.q_sparse, ds.q_dense, h=H)
    b = plain.search(ds.q_sparse, ds.q_dense, h=H)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert idx.delta_version == 0
    with pytest.raises(ValueError, match="return_pass1"):
        idx.search(ds.q_sparse, ds.q_dense, h=H, return_pass1=True)
    with pytest.raises(ValueError, match="immutable"):
        plain.insert(ds.x_sparse[:1], ds.x_dense[:1])
    with pytest.raises(ValueError, match="ext_ids"):
        HybridIndex.build(ds.x_sparse[:N0], ds.x_dense[:N0], p,
                          ext_ids=np.arange(N0), device="cpu")


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_validation_errors_match_jax(replay, ds):
    jidx, tidx, _ = replay
    xs, xd = ds.x_sparse[:2], ds.x_dense[:2]
    for args in ((xs, xd, [5000, 5000]), (xs, xd, [-3, 5001])):
        assert _error(lambda: tidx.insert(*args)) == \
            _error(lambda: jidx.insert(*args))
    # compacting an empty corpus
    small_j = JaxHybridIndex.build(ds.x_sparse[:20], ds.x_dense[:20],
                                   JaxParams(backend="ref", **PARAMS),
                                   mutable=True)
    leaves, scalars = jax_index_state(small_j)
    small_t = mutable_index_from_numpy(
        leaves, scalars, ds.x_sparse[:20], ds.x_dense[:20],
        params=HybridIndexParams(backend="ref", **PARAMS), device="cpu")
    for i in (small_j, small_t):
        i.delete(np.arange(20))
    assert _error(lambda: small_t.compact()) == \
        _error(lambda: small_j.compact())


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def test_scalar_quantize_rows_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    sq = jpq.scalar_quantize(x)
    new = (1.5 * rng.normal(size=(40, 6))).astype(np.float32)  # clamps too
    want = jpq.scalar_quantize_rows(new, np.asarray(sq.scale),
                                    np.asarray(sq.zero))
    got = pq.scalar_quantize_rows(new, torch.from_numpy(np.array(sq.scale)),
                                  torch.from_numpy(np.array(sq.zero)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [6, 3])
def test_encode_rows_matches_jax(ds, k):
    x = ds.x_dense[:N0]
    cb = jpq.train_codebooks(x, k, 16, iters=3, seed=0)
    tcb = pq.PQCodebooks(centers=torch.from_numpy(np.array(cb.centers)))
    new = ds.x_dense[N0:]
    got = pq.encode_rows(new, tcb)
    want = jpq.encode_rows(new, cb)
    _codes_match(new, cb.centers, got, want)
    np.testing.assert_array_equal(pq.encode_rows(new, tcb, pack=True),
                                  pq.pack_codes(got))


def test_whitening_transform_matches_jax(ds):
    got = pq.whitening_transform(ds.x_dense, device="cpu")
    want = jpq.whitening_transform(ds.x_dense)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_delta_postings_match_jax():
    """Growth of the rectangle, the sentinel padding and the spill past the
    cap, over a random append sequence."""
    rng = np.random.default_rng(3)
    got, want = DeltaPostings(7, l_max=2, l_cap=8), JaxDeltaPostings(
        7, l_max=2, l_cap=8)
    for slot in range(30):
        dims = rng.choice(7, size=rng.integers(0, 5), replace=False)
        vals = rng.normal(size=dims.size).astype(np.float32)
        for a, b in zip(got.append(slot, dims, vals),
                        want.append(slot, dims, vals)):
            np.testing.assert_array_equal(a, b)
        assert got.l_max == want.l_max
    np.testing.assert_array_equal(got._lens, want._lens)
    tp, jp = got.to_padded(64, device="cpu"), want.to_padded(64)
    np.testing.assert_array_equal(tp.rows.numpy(), np.asarray(jp.rows))
    np.testing.assert_array_equal(tp.vals.numpy(), np.asarray(jp.vals))
    for a, b in zip(got.rows_for([4, 0, 4], 64), want.rows_for([4, 0, 4], 64)):
        np.testing.assert_array_equal(a, b)


def _parts(seed):
    rng = np.random.default_rng(seed)
    parts = []
    for width, filtered in ((6, True), (5, True), (7, False)):
        s = rng.normal(size=(3, width)).astype(np.float32)
        s[0, :2] = s[0, 2]                             # ties across ids
        s[1, -1] = -np.inf
        ids = rng.choice(20, size=(3, width))
        parts.append((s, ids, filtered))
    return parts


@pytest.mark.parametrize("form", ["drop", "per_part", "dedup", "tiny_pool"])
def test_merge_topk_host_matches_jax(form):
    parts = _parts(1)
    kw, h = dict(drop_ids={1, 4, 9}), 8
    if form == "per_part":
        parts[1] = (parts[1][0], parts[1][1], [2, 3, 5])
    elif form == "dedup":
        kw["dedup_upserts"] = True
    elif form == "tiny_pool":
        h = 25
    for got, want in zip(distributed.merge_topk_host(parts, h, **kw),
                         jdist.merge_topk_host(parts, h, **kw)):
        np.testing.assert_array_equal(got, want)


def test_merge_topk_and_overfetch_match_jax():
    s, ids, _ = _parts(2)[0]
    got = distributed.merge_topk(torch.from_numpy(s), torch.from_numpy(ids),
                                 4)
    want = jdist.merge_topk(s, ids, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [distributed.ceil16(n) for n in (0, 1, 16, 17)] == [0, 16, 16, 32]

    class Eng:
        num_points = 40
    assert plan_overfetch([Eng()], 20, set()) == [20]
    assert plan_overfetch([Eng()], 20, {1, 2}) == [36]
    assert plan_overfetch([Eng()], 30, set(range(17))) == [40]


@pytest.mark.parametrize("shards,ragged", [(4, False), (7, True)])
def test_split_index_arrays_matches_jax(replay, ds, shards, ragged):
    """Shard by shard equal to the JAX split (BCSR rebuilt per shard), and
    the fan-out over the shards equals the unsharded search bit for bit."""
    jidx, _, _ = replay
    leaves, scalars = jax_index_state(jidx)
    port = hybrid_index_from_numpy(
        leaves, scalars, HybridIndexParams(backend="cuda", **PARAMS),
        device="cpu")
    tsh, toff = distributed.split_index_arrays(port.engine.arrays, shards,
                                               ragged=ragged)
    jsh, joff = jdist.split_index_arrays(jidx.engine.arrays, shards,
                                         ragged=ragged)
    np.testing.assert_array_equal(toff, joff)
    for t, j in zip(tsh, jsh):
        assert t.num_points == j.num_points
        for got, want in ((t.codes, j.codes), (t.inv_index.rows,
                                               j.inv_index.rows),
                          (t.inv_index.vals, j.inv_index.vals),
                          (t.dense_residual.q, j.dense_residual.q),
                          (t.sparse_residual.cols, j.sparse_residual.cols),
                          (t.head.block, j.head.block),
                          (t.head.occupancy, j.head.occupancy)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip((t.head_tiles, t.head_ptr, t.head_col),
                             jax_bcsr_from_head(j.head)[:3]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    qd, qv = sparse_queries_to_padded(ds.q_sparse, port.cols, nq_max=256)
    q = (torch.from_numpy(qd), torch.from_numpy(qv),
         torch.from_numpy(ds.q_dense))
    engines = [ScoringEngine(arrays=a, backend=port.engine.backend)
               for a in tsh]
    s, ids = fanout_search(engines, [H] * shards, toff, None, None, None,
                           set(), *q, h=H, alpha=20, beta=5)
    s1, ids1, _ = port.engine.search(*q, h=H, alpha=20, beta=5)
    np.testing.assert_array_equal(ids, ids1.numpy())
    np.testing.assert_array_equal(s, s1.numpy())
