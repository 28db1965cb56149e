"""The port's cluster tier (repro_torch.serve.cluster) on the CPU: a real
local cluster — a primary and two row-sliced scorers, each a process of its
own with ``--device cpu`` — serves results bit-identical (ids AND scores)
to the port's in-process ``QueryService`` on the same state: at every step
of a random insert/upsert/delete interleaving and through compactions,
through healed torn and dropped frames, for two routers that alternate
mutations, and for racing searches coalesced into ``msearch`` frames.  At
this size every row is refined, so the fan-out equals the one-engine
service (the reference's tests/test_cluster.py holds the same).

The non-destructive tests share one cluster (module fixture) and keep one
comparator in step with it; they run in file order."""

import sys
import threading

import numpy as np
import pytest
from _torch_port_helpers import CLUSTER_TIMEOUT_S
from _torch_port_helpers import one_thread_nodes  # noqa: F401

from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.core.sparse_index import sparse_queries_to_padded
from repro_torch.data import make_hybrid_dataset
from repro_torch.serve import QueryService
from repro_torch.serve.cluster import LocalCluster, ShardClient
from repro_torch.serve.query_service import bucket_for, pad_rows

N0, N_POOL, NQ = 96, 160, 3
D_SPARSE, NNZ = 240, 8

DS = make_hybrid_dataset(num_points=N_POOL, num_queries=NQ,
                         d_sparse=D_SPARSE, d_dense=16, nnz_per_row=NNZ,
                         seed=11)


def build(n0=N0):
    return HybridIndex.build(
        DS.x_sparse[:n0], DS.x_dense[:n0],
        HybridIndexParams(keep_top=16, head_dims=8, kmeans_iters=2,
                          pq_subspaces=4), mutable=True, device="cpu")


def comparator():
    return QueryService(index=build(), h=8, cache_size=0,
                        auto_compact=False, device="cpu")


def assert_parity(router, comp, session=None):
    """A 3-row batch (the scorer fan-out) and a single row (the primary's
    direct path) through the router equal the comparator bit for bit."""
    for rows in (slice(0, NQ), slice(1, 2)):
        s_r, i_r = router.search_sparse(DS.q_sparse[rows], DS.q_dense[rows],
                                        session=session)
        s_c, i_c = comp.search_sparse(DS.q_sparse[rows], DS.q_dense[rows])
        np.testing.assert_array_equal(i_r, i_c)
        np.testing.assert_array_equal(s_r, s_c)
    return s_r, i_r


class Pool:
    """Rows not inserted yet, handed out in order across the tests."""
    next = N0

    @classmethod
    def take(cls) -> int:
        cls.next += 1
        assert cls.next <= N_POOL, "the test pool ran dry"
        return cls.next - 1


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cluster"))
    comp = comparator()
    with LocalCluster.launch(build(), root, num_scorers=2,
                             device="cpu") as cluster:
        router = cluster.router(h=8, timeout=CLUSTER_TIMEOUT_S)
        try:
            yield cluster, router, comp, list(range(N0))
        finally:
            router.close()
            comp.close()


def test_fresh_cluster_equals_in_process(env):
    cluster, router, comp, _ = env
    assert_parity(router, comp)
    assert router.stats["direct_reads"] == 1
    assert router.stats["primary_reads"] == NQ + 1


def test_random_interleaving_bit_identical(env):
    """RPC results == in-process results, bit for bit, after EVERY step of
    a random insert/upsert/delete interleaving, through a mid-run and a
    final cluster-orchestrated compaction."""
    cluster, router, comp, live = env
    rng = np.random.default_rng(1004)
    gen0 = router.gen
    for t in range(14):
        if t == 7:                       # mid-run compaction
            assert router.compact() == gen0 + 1
            comp.compact()
        roll = rng.random()
        if roll < 0.55 or len(live) < 4:
            src = Pool.take()
            got_r = router.insert(DS.x_sparse[src], DS.x_dense[src])
            got_c = comp.insert(DS.x_sparse[src], DS.x_dense[src])
            np.testing.assert_array_equal(got_r, got_c)
            live.append(int(got_r[0]))
        elif roll < 0.75:                # upsert a live id
            src = Pool.take()
            ext = int(rng.choice(live))
            router.insert(DS.x_sparse[src], DS.x_dense[src], ids=[ext])
            comp.insert(DS.x_sparse[src], DS.x_dense[src], ids=[ext])
        else:
            ext = int(rng.choice(live))
            assert router.delete([ext]) == comp.delete([ext]) == 1
            live.remove(ext)
        assert_parity(router, comp)
    assert router.compact() == gen0 + 2
    comp.compact()
    assert_parity(router, comp)
    assert router.stats["degraded"] == 0


@pytest.mark.parametrize("mode", ["corrupt_next", "close_next"])
def test_torn_and_dropped_frames_heal(env, mode):
    """A corrupted reply is detected by its crc and a dropped connection
    by the socket; both heal by one reconnect, bits unchanged."""
    cluster, router, comp, live = env
    src = Pool.take()
    live.append(int(router.insert(DS.x_sparse[src], DS.x_dense[src])[0]))
    comp.insert(DS.x_sparse[src], DS.x_dense[src])
    sc = ShardClient("127.0.0.1", cluster.scorers[0].port,
                     timeout=CLUSTER_TIMEOUT_S)
    try:
        sc.call("fault", {"mode": mode})
        before = sum(c.reconnects for c in router.scorers)
        s_r, i_r = router.search_sparse(DS.q_sparse, DS.q_dense)
        s_c, i_c = comp.search_sparse(DS.q_sparse, DS.q_dense)
        np.testing.assert_array_equal(i_r, i_c)
        np.testing.assert_array_equal(s_r, s_c)
        assert sum(c.reconnects for c in router.scorers) == before + 1
    finally:
        sc.close()


def test_two_routers_alternate_and_agree(env):
    """A pipelined router and a lockstep one ALTERNATE mutations over the
    cluster; after every step both equal the comparator.  The lockstep one
    compacts, and the other learns the flip from the wire."""
    cluster, r_pipe, comp, live = env
    r_lock = cluster.router(h=8, lockstep=True, timeout=CLUSTER_TIMEOUT_S)
    rng = np.random.default_rng(905)
    try:
        for t in range(8):
            actor = r_pipe if t % 2 == 0 else r_lock
            if t == 4:
                gen = r_lock.compact()
                comp.compact()
            roll = rng.random()
            if roll < 0.5:
                src = Pool.take()
                got = actor.insert(DS.x_sparse[src], DS.x_dense[src])
                np.testing.assert_array_equal(
                    got, comp.insert(DS.x_sparse[src], DS.x_dense[src]))
                live.append(int(got[0]))
            elif roll < 0.7:             # upsert through one router
                src = Pool.take()
                ext = int(rng.choice(live))
                actor.insert(DS.x_sparse[src], DS.x_dense[src], ids=[ext])
                comp.insert(DS.x_sparse[src], DS.x_dense[src], ids=[ext])
            else:                        # delete through ONE router
                ext = int(rng.choice(live))
                live.remove(ext)
                assert actor.delete([ext]) == comp.delete([ext]) == 1
            assert_parity(r_pipe, comp)
            assert_parity(r_lock, comp)
        assert r_pipe.gen == r_lock.gen == gen
        assert r_lock.stats["direct_reads"] == 0     # lockstep fans out
    finally:
        r_lock.close()


def test_concurrent_searches_coalesce(env):
    """Racing searches through one router return the sequential answer,
    and two searches queued behind an in-flight one ship as ONE
    ``msearch`` frame that demultiplexes to what a solo call returns."""
    cluster, router, comp, _ = env
    want_s, want_i = comp.search_sparse(DS.q_sparse, DS.q_dense)
    results = [None] * 6

    def worker(j):
        results[j] = router.search_sparse(DS.q_sparse, DS.q_dense)
    threads = [threading.Thread(target=worker, args=(j,))
               for j in range(len(results))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(CLUSTER_TIMEOUT_S)
        assert not th.is_alive()
    for s, i in results:
        np.testing.assert_array_equal(i, want_i)
        np.testing.assert_array_equal(s, want_s)

    pin = router._pin()
    qd, qv = sparse_queries_to_padded(DS.q_sparse, pin.cols,
                                      nq_max=router._nq_max)
    b = bucket_for(NQ, router.buckets)
    arrays = {"q_dims": pad_rows(qd, b, fill=pin.d_active),
              "q_vals": pad_rows(qv, b),
              "q_dense": pad_rows(np.asarray(DS.q_dense, np.float32), b)}
    meta = {"part": "main", "gen": pin.gen, "h": 8, "alpha": router.alpha,
            "beta": router.beta}
    c = router.scorers[0]
    _, ref_arr = c.call("search", meta, arrays)
    entries = [c.submit_search(meta, arrays) for _ in range(3)]
    for e in entries:
        _, ra = e.result()
        np.testing.assert_array_equal(ra["ids"], ref_arr["ids"])
        np.testing.assert_array_equal(ra["scores"], ref_arr["scores"])
    assert entries[0].width == 1                 # solo: a plain search
    assert entries[1].width == entries[2].width == 2
    assert {entries[1].slot, entries[2].slot} == {0, 1}


def test_node_replies_carry_reference_types(env):
    """What a reference router reads: f32 scores, int64 ids, the JAX
    package's backend name; and the port's own stats fields."""
    cluster, router, comp, _ = env
    c = ShardClient("127.0.0.1", cluster.primary.port,
                    timeout=CLUSTER_TIMEOUT_S)
    try:
        info, arrays = c.call("info")
        assert info["backend"] == "pallas"         # the port's "cuda"
        assert arrays["cols_global_ids"].dtype == \
            np.asarray(comp._index.cols.global_ids).dtype
        for k in ("main_tombstones", "fully_deleted"):
            assert arrays[k].dtype == np.int64
        pin = router._pin()
        qd, qv = sparse_queries_to_padded(DS.q_sparse[:1], pin.cols,
                                          nq_max=router._nq_max)
        meta, out = c.call(
            "search", {"part": "full", "gen": pin.gen, "h": 8,
                       "alpha": router.alpha, "beta": router.beta},
            {"q_dims": qd, "q_vals": qv,
             "q_dense": np.asarray(DS.q_dense[:1], np.float32)})
        assert out["ms"].dtype == np.float32 and out["mi"].dtype == np.int64
        st, _ = c.call("stats")
        assert st["device"] == "cpu" and st["kernels_built"] == []
        assert set(st["kernel_launches"]) == {
            "lut16_adc", "lut16_adc_topk", "block_sparse_matmul",
            "inverted_value_forward", "score_inverted_vf", "adc_lut",
            "dense_residual", "sparse_residual", "gathered_dot"}
        assert sum(st["kernel_launches"].values()) == 0   # the CPU path
        assert st["score_s_p50"] > 0
    finally:
        c.close()
    sc = ShardClient("127.0.0.1", cluster.scorers[1].port,
                     timeout=CLUSTER_TIMEOUT_S)
    try:
        st, _ = sc.call("stats")
        assert st["generations"] == [router.gen - 1, router.gen]
    finally:
        sc.close()


def test_launch_counts_exact_under_threads():
    """A node searches from several threads; the kernel counters
    (``ops.LAUNCHES``, ``ref.PLAIN_CALLS``) lose no update under them."""
    from repro_torch.kernels.ref import bump
    counts = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [bump(counts, "k") for _ in range(2000)])
            for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(CLUSTER_TIMEOUT_S)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 16 * 2000
