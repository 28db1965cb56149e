"""The port's QueryService (repro_torch.serve) against the JAX package's, on
the CPU, plus the port's own serving invariants.

Both services serve the same main generation: a JAX index on the ``ref``
backend carried across with ``interchange``.  The same ragged request
stream goes through both; results agree under ``assert_topk_match``
(rtol 1e-5, atol 1e-4, ties up to the tolerance), and the cache and
shape-key counters, which depend only on the stream and the fingerprints,
are equal.  Inside the port: the 2-shard fan-out equals one engine when
every row is refined, a refresh from another thread never mixes generations, the donation
hook frees by storage (a shard's view never frees its parent's), and
auto-compaction runs in the background."""

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import assert_topk_match, jax_index_state

from repro.core.distributed import split_index_arrays as jax_split
from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.engine import query_fingerprint as jax_query_fingerprint
from repro.core.hybrid import HybridIndex as JaxHybridIndex
from repro.core.hybrid import HybridIndexParams as JaxParams
from repro.core.sparse_index import sparse_queries_to_padded
from repro.core.streaming import fanout_search as jax_fanout
from repro.data import make_hybrid_dataset
from repro.serve import QueryService as JaxQueryService
from repro_torch.core.distributed import split_index_arrays
from repro_torch.core.engine import (ScoringEngine, query_fingerprint,
                                     release_index_arrays)
from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.core.streaming import fanout_search
from repro_torch.interchange import (hybrid_index_from_numpy,
                                     mutable_index_from_numpy)
from repro_torch.obs import Tracer
from repro_torch.serve import QueryService
from repro_torch.serve.query_service import pad_rows

N, NQ = 800, 16
PARAMS = dict(keep_top=32, head_dims=24, kmeans_iters=3)


@pytest.fixture(scope="module")
def ds():
    return make_hybrid_dataset(num_points=N + 64, num_queries=NQ,
                               d_sparse=1200, d_dense=16, nnz_per_row=16,
                               seed=21)


@pytest.fixture(scope="module")
def served(ds):
    """A JAX index (ref backend) and the port index carried across."""
    jidx = JaxHybridIndex.build(ds.x_sparse[:N], ds.x_dense[:N],
                                JaxParams(backend="ref", **PARAMS))
    leaves, scalars = jax_index_state(jidx)
    tidx = hybrid_index_from_numpy(
        leaves, scalars, params=HybridIndexParams(backend="ref", **PARAMS),
        device="cpu")
    q_dims, q_vals = sparse_queries_to_padded(ds.q_sparse, jidx.cols,
                                              nq_max=jidx.params.nq_max)
    return jidx, tidx, q_dims, q_vals, np.asarray(ds.q_dense, np.float32)


def _info(svc):
    return dataclasses.astuple(svc.cache_info())


def _stream(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, NQ, int(q)) for q in rng.integers(1, 33, 24)]


def test_ragged_stream_matches_reference(served):
    jidx, tidx, q_dims, q_vals, q_dense = served
    kw = dict(h=10, buckets=(1, 8, 32), cache_size=8)
    jsvc = JaxQueryService(jidx.engine, id_map=jidx.pi, **kw)
    tsvc = QueryService(tidx.engine, id_map=tidx.pi, device="cpu", **kw)
    for _ in range(2):                              # cold, then warm
        for rows in _stream(0):
            js, ji = jsvc.search(q_dims[rows], q_vals[rows], q_dense[rows])
            ts, ti = tsvc.search(q_dims[rows], q_vals[rows], q_dense[rows])
            assert ts.shape == js.shape == (len(rows), 10)
            assert_topk_match(ts, ti, js, ji)
    assert _info(tsvc) == _info(jsvc)
    assert tsvc.cache_info().evictions > 0 and tsvc.cache_info().hits > 0
    assert (dataclasses.astuple(tsvc.jit_cache_info())
            == dataclasses.astuple(jsvc.jit_cache_info()))
    assert set(tsvc.jit_cache_info().batch_shapes) <= {1, 8, 32}
    jsvc.close()
    tsvc.close()


@pytest.mark.parametrize("row", [0, 3, 15])
def test_fingerprint_matches_reference(served, row):
    _, _, q_dims, q_vals, q_dense = served
    args = (q_dims[row], q_vals[row], q_dense[row], 10, 20, 5, 0, 3)
    assert query_fingerprint(*args) == jax_query_fingerprint(*args)
    assert query_fingerprint(q_dims[:row + 1], q_vals[:row + 1],
                             q_dense[:row + 1]) == jax_query_fingerprint(
        q_dims[:row + 1], q_vals[:row + 1], q_dense[:row + 1])


def test_sharded_fanout_matches_single_engine(served):
    """With every row refined (alpha * h and beta * h >= N, the condition
    of the JAX package's own test), two row shards give the one engine's
    ids.  At smaller c1 they need not: the shards refine c1 candidates
    each, more than the one engine does."""
    _, tidx, q_dims, q_vals, q_dense = served
    full = -(-N // 10)
    kw = dict(h=10, alpha=full, beta=full, cache_size=0, device="cpu")
    one = QueryService(tidx.engine, id_map=tidx.pi, **kw)
    two = QueryService(tidx.engine, id_map=tidx.pi, num_shards=2, **kw)
    s1, i1 = one.search(q_dims, q_vals, q_dense)
    s2, i2 = two.search(q_dims, q_vals, q_dense)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-5)
    one.close()
    two.close()


def test_fanout_search_options_match_reference(served):
    """``qn``, ``executor``, ``dedup_upserts`` and ``span`` of the
    fan-out merge, over two row shards, against the reference's."""
    jidx, tidx, q_dims, q_vals, q_dense = served
    qn, d_active = 5, tidx.engine.arrays.d_active
    q = (pad_rows(q_dims[:qn], 8, fill=d_active), pad_rows(q_vals[:qn], 8),
         pad_rows(q_dense[:qn], 8))
    jparts, joff = jax_split(jidx.engine.arrays, 2)
    tparts, toff = split_index_arrays(tidx.engine.arrays, 2)
    jeng = [JaxEngine(arrays=a, backend=jidx.engine.backend) for a in jparts]
    teng = [ScoringEngine(arrays=a, backend=tidx.engine.backend)
            for a in tparts]
    kw = dict(h=10, alpha=20, beta=5, qn=qn, dedup_upserts=True)
    js, ji = jax_fanout(jeng, [10, 10], joff, jidx.pi, None, None, {4},
                        *map(jnp.asarray, q), **kw)
    span = Tracer().root("serve.batch")
    ts, ti = fanout_search(teng, [10, 10], toff, tidx.pi, None, None, {4},
                           *map(torch.from_numpy, q), span=span, **kw)
    assert ts.shape == (qn, 10) and set(span.tags) == {"dispatch_s",
                                                       "merge_s"}
    assert [c.name for c in span.children] == [
        "serve.dispatch", "serve.wait", "serve.merge"]
    assert [c.name for c in span.children[0].children] == [
        "engine.pass1", "engine.pass2", "engine.pass3"] * 2
    assert 4 not in ti
    assert_topk_match(ts, ti, js, ji)
    with ThreadPoolExecutor(2) as ex:
        es, ei = fanout_search(teng, [10, 10], toff, tidx.pi, None, None,
                               {4}, *map(torch.from_numpy, q), executor=ex,
                               **kw)
    np.testing.assert_array_equal(ei, ti)
    np.testing.assert_array_equal(es, ts)


def test_service_refuses_engine_on_another_device(served):
    _, tidx, *_ = served
    with pytest.raises(ValueError, match="pass device="):
        QueryService(tidx.engine, device="meta")


@pytest.fixture()
def two_generations(ds):
    """Two port indexes built on the CPU (allocator-owned storages, so the
    donation hook can free them) from different k-means seeds."""
    p = HybridIndexParams(backend="ref", **PARAMS)
    a = HybridIndex.build(ds.x_sparse[:N], ds.x_dense[:N], p, device="cpu")
    b = HybridIndex.build(ds.x_sparse[:N], ds.x_dense[:N],
                          HybridIndexParams(backend="ref", seed=11, **PARAMS),
                          device="cpu")
    q_dims, q_vals = sparse_queries_to_padded(ds.q_sparse, a.cols,
                                              nq_max=p.nq_max)
    return a, b, q_dims, q_vals, np.asarray(ds.q_dense, np.float32)


def test_refresh_mid_stream_from_a_thread(two_generations):
    """Searches submitted around a refresh made from another thread each
    return exactly one generation's results; later ones the new one; the
    retired generation's storages are freed once idle."""
    idx_a, idx_b, q_dims, q_vals, q_dense = two_generations
    ref_a = QueryService(idx_a.engine, h=10, cache_size=0,
                         device="cpu").search(q_dims, q_vals, q_dense)
    ref_b = QueryService(idx_b.engine, h=10, cache_size=0,
                         device="cpu").search(q_dims, q_vals, q_dense)
    assert not np.array_equal(ref_a[0], ref_b[0])
    svc = QueryService(idx_a.engine, h=10, cache_size=64, device="cpu")
    futures = [svc.submit(q_dims, q_vals, q_dense) for _ in range(4)]
    t = threading.Thread(target=svc.refresh, args=(idx_b.engine,))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    futures += [svc.submit(q_dims, q_vals, q_dense) for _ in range(2)]
    results = [f.result(timeout=60) for f in futures]
    for s, ids in results:
        from_a = np.array_equal(s, ref_a[0]) and np.array_equal(ids, ref_a[1])
        from_b = np.array_equal(s, ref_b[0]) and np.array_equal(ids, ref_b[1])
        assert from_a != from_b
    for s, ids in results[4:]:
        np.testing.assert_array_equal(s, ref_b[0])
    svc.close()
    assert idx_a.engine.arrays.codes.untyped_storage().nbytes() == 0
    assert idx_b.engine.arrays.codes.untyped_storage().nbytes() > 0
    assert svc.stats()["refreshes"] == 1


def test_release_index_arrays_by_storage(two_generations):
    """The reference frees a shard's codes while its parent's survive
    (``tests/test_query_service.py::test_release_index_arrays_keep``).
    That cannot hold here: a row slice of a contiguous tensor is already
    contiguous, so a shard's codes, residual rows and mask are VIEWS of the
    parent's storage, and freeing them would free the parent's.  The port
    compares storages: the shard's own storages (its localized inverted
    index, its re-padded head block, made by ``torch.where`` and
    ``torch.zeros``) are freed, the shared ones are kept."""
    idx = two_generations[0]
    arr = idx.engine.arrays
    shards, _ = split_index_arrays(arr, 2)
    sh = shards[1]
    assert (sh.codes.untyped_storage().data_ptr()
            == arr.codes.untyped_storage().data_ptr())
    freed = release_index_arrays(sh, keep=[arr])
    assert freed >= 4
    for own in (sh.inv_index.rows, sh.inv_index.vals, sh.head.block,
                sh.head.occupancy):
        assert own.untyped_storage().nbytes() == 0
    for shared in (arr.codes, arr.dense_residual.q, arr.sparse_residual.cols,
                   arr.codebooks.centers, arr.head_pos, arr.inv_index.rows):
        assert shared.untyped_storage().nbytes() > 0
    assert sh.codes.untyped_storage().nbytes() > 0      # the parent's
    assert release_index_arrays(sh, keep=[arr]) == 0    # nothing left
    # without the parent in keep, its codes storage goes with the shard's
    # view, so the parent must not be served afterwards
    release_index_arrays(shards[0])
    assert arr.codes.untyped_storage().nbytes() == 0


@pytest.fixture()
def mutable_pair(ds):
    """A JAX mutable index (ref backend) and the port's over the same main
    generation and corpus."""
    jidx = JaxHybridIndex.build(ds.x_sparse[:N], ds.x_dense[:N],
                                JaxParams(backend="ref", **PARAMS),
                                mutable=True)
    leaves, scalars = jax_index_state(jidx)
    tidx = mutable_index_from_numpy(
        leaves, scalars, ds.x_sparse[:N], ds.x_dense[:N],
        params=HybridIndexParams(backend="ref", **PARAMS), device="cpu")
    return jidx, tidx


def test_mutation_sequence_matches_reference(ds, mutable_pair):
    jidx, tidx = mutable_pair
    kw = dict(h=10, cache_size=32, auto_compact=False, compact_retrain=False)
    jsvc = JaxQueryService(index=jidx, **kw)
    tsvc = QueryService(index=tidx, device="cpu", **kw)
    xs, xd = ds.x_sparse, ds.x_dense

    def check(step):
        js, ji = jsvc.search_sparse(ds.q_sparse, ds.q_dense)
        ts, ti = tsvc.search_sparse(ds.q_sparse, ds.q_dense)
        assert_topk_match(ts, ti, js, ji)
        jst, tst = jsvc.stats(), tsvc.stats()
        for key in ("delta_rows", "deleted_pending", "compactions",
                    "mutation_version", "version"):
            assert tst[key] == jst[key], (step, key)

    check("fresh")
    for svc in (jsvc, tsvc):
        new = svc.insert(xs[N:N + 40], xd[N:N + 40])
        assert new.tolist() == list(range(N, N + 40))
    check("insert")
    for svc in (jsvc, tsvc):
        assert svc.delete([1, 2, N + 3, N + 7, 99999]) == 4
        svc.insert(xs[N + 40:N + 44], xd[N + 40:N + 44], ids=[5, 6, 7, 8])
    check("delete + upsert")
    for svc in (jsvc, tsvc):
        svc.compact(retrain=False)
    check("merge compaction")
    for svc in (jsvc, tsvc):
        svc.insert(xs[N + 44:N + 64], xd[N + 44:N + 64])
        svc.delete([N + 50])
    check("after compaction")
    assert _info(tsvc) == _info(jsvc)
    jsvc.close()
    tsvc.close()


def test_compaction_frees_the_retired_generation(ds):
    """A merge compaction swaps in the folded generation and frees the
    retired one's storages, except those the new one shares (the frozen
    codebooks and residual grid)."""
    idx = HybridIndex.build(ds.x_sparse[:N], ds.x_dense[:N],
                            HybridIndexParams(backend="ref", **PARAMS),
                            mutable=True, device="cpu")
    svc = QueryService(index=idx, h=5, cache_size=16, auto_compact=False,
                       compact_retrain=False, device="cpu")
    svc.insert(ds.x_sparse[N:N + 8], ds.x_dense[N:N + 8])
    svc.delete([5, 6])
    old = idx.engine.arrays
    v = svc.compact()
    assert v == svc.version > 0
    new = svc._gen.engine.arrays
    assert old.codes.untyped_storage().nbytes() == 0
    assert new.codebooks.centers is old.codebooks.centers
    assert old.codebooks.centers.untyped_storage().nbytes() > 0
    assert old.dense_residual.scale.untyped_storage().nbytes() > 0
    s, ids = svc.search_sparse(ds.q_sparse, ds.q_dense)
    assert 5 not in ids and 6 not in ids and np.isfinite(s).all()
    assert svc.compact() == v                   # nothing left to fold
    svc.close()


def test_auto_compaction_triggers_in_background(ds, mutable_pair):
    _, tidx = mutable_pair
    svc = QueryService(index=tidx, h=5, cache_size=0, auto_compact=True,
                       compact_min_rows=8, compact_ratio=0.0, device="cpu")
    new = svc.insert(ds.x_sparse[N:N + 8],
                     ds.x_dense[N:N + 8] * 0 + ds.q_dense[0])
    deadline = time.time() + 60
    while svc.stats()["compactions"] == 0 and time.time() < deadline:
        svc.search_sparse(ds.q_sparse[:1], ds.q_dense[:1])  # keep serving
        time.sleep(0.02)
    st = svc.stats()
    assert st["compactions"] >= 1 and st["delta_rows"] == 0
    s, ids = svc.search_sparse(ds.q_sparse, ds.q_dense, h=20)
    assert set(new.tolist()) <= set(np.asarray(ids).ravel().tolist())
    svc.close()
    assert svc._compact_thread is None or not svc._compact_thread.is_alive()
