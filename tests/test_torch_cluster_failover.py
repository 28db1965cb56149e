"""The port's cluster tier under the faults that tear its topology down
(the reference's tests/test_cluster.py fault matrix and
tests/test_cluster_failover.py, on the CPU): a scorer killed -9 is served
by a caught-up replica bit for bit, or refused with ``DegradedResultError``
when none is left, never as a shortened top-k; ``failover()`` promotes a
caught-up replica and refuses a lagging one; a deposed primary's acks are
refused with ``StaleTermError``; a replica promoted while its reload of
a compaction waits keeps its own store, log and term.  The tests are
chained on two clusters in the order the faults allow; every result is
held to the port's in-process ``QueryService`` bit for bit."""

import time

import numpy as np
import pytest
from _torch_port_helpers import (CLUSTER_TIMEOUT_S, finished, started,
                                 wait_replica_seq)
from _torch_port_helpers import one_thread_nodes  # noqa: F401

from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.data import make_hybrid_dataset
from repro_torch.serve import QueryService
from repro_torch.serve.cluster import (ClusterRouter, DegradedResultError,
                                       FailoverError, LocalCluster,
                                       RemoteError, ShardClient,
                                       StaleTermError)

N0, N_POOL, NQ = 96, 140, 3

DS = make_hybrid_dataset(num_points=N_POOL, num_queries=NQ, d_sparse=240,
                         d_dense=16, nnz_per_row=8, seed=11)


def build():
    return HybridIndex.build(
        DS.x_sparse[:N0], DS.x_dense[:N0],
        HybridIndexParams(keep_top=16, head_dims=8, kmeans_iters=2,
                          pq_subspaces=4), mutable=True, device="cpu")


def comparator():
    return QueryService(index=build(), h=8, cache_size=0,
                        auto_compact=False, device="cpu")


def search_equal(router, comp, rows=slice(0, NQ), session=None):
    s_r, i_r = router.search_sparse(DS.q_sparse[rows], DS.q_dense[rows],
                                    session=session)
    s_c, i_c = comp.search_sparse(DS.q_sparse[rows], DS.q_dense[rows])
    np.testing.assert_array_equal(i_r, i_c)
    np.testing.assert_array_equal(s_r, s_c)


def mirrored_insert(router, comp, src, **kw):
    got = router.insert(DS.x_sparse[src], DS.x_dense[src], **kw)
    np.testing.assert_array_equal(
        got, comp.insert(DS.x_sparse[src], DS.x_dense[src]))
    return got


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """Cluster A (2 scorers, 1 replica), ingested, compacted, ingested
    again and caught up; the tests below kill its nodes in order."""
    root = str(tmp_path_factory.mktemp("failover"))
    comp = comparator()
    with LocalCluster.launch(build(), root, num_scorers=2, num_replicas=1,
                             device="cpu") as cluster:
        router = cluster.router(h=8, replica_max_lag=10 ** 9,
                                timeout=CLUSTER_TIMEOUT_S)
        sess = router.session()
        try:
            got = router.insert(DS.x_sparse[N0:N0 + 6], DS.x_dense[N0:N0 + 6],
                                session=sess)
            np.testing.assert_array_equal(
                got, comp.insert(DS.x_sparse[N0:N0 + 6],
                                 DS.x_dense[N0:N0 + 6]))
            assert router.compact() == 2
            comp.compact()
            # post-compaction mutations: the replica re-bootstrapped onto
            # the new store must accept these shipped frames
            assert router.delete([5, int(got[1])], session=sess) == \
                comp.delete([5, int(got[1])]) == 2
            mirrored_insert(router, comp, N0 + 6, session=sess)
            router.insert(DS.x_sparse[N0 + 7], DS.x_dense[N0 + 7],
                          ids=[int(got[0])], session=sess)   # an upsert
            comp.insert(DS.x_sparse[N0 + 7], DS.x_dense[N0 + 7],
                        ids=[int(got[0])])
            st = wait_replica_seq(cluster.replicas[0].port, router._last_seq)
            assert st["applied_seq"] == router._last_seq
            search_equal(router, comp, session=sess)
            yield cluster, router, comp, sess
        finally:
            router.close()
            comp.close()


def test_follower_refuses_mutations(killed):
    cluster, router, comp, _ = killed
    rc = ShardClient("127.0.0.1", cluster.replicas[0].port,
                     timeout=CLUSTER_TIMEOUT_S)
    try:
        with pytest.raises(RemoteError, match="NotPrimary"):
            rc.call("delete", arrays={"ids": np.asarray([7], np.int64)})
    finally:
        rc.close()


def test_killed_scorer_served_by_replica(killed):
    """Scorer 0 killed -9 mid-stream: the fan-out fails over to the
    caught-up replica's whole-query parts, bit for bit."""
    cluster, router, comp, sess = killed
    cluster.kill_scorer(0)
    search_equal(router, comp, session=sess)
    assert router.stats["failovers"] >= 1
    assert router.stats["replica_reads"] >= NQ


def test_failover_promotes_caught_up_replica(killed):
    """The primary killed -9, ``failover()`` promotes the replica under
    term 2: every acked mutation is served bit for bit by its direct
    path, it takes new mutations, and the session watermark carries."""
    cluster, router, comp, sess = killed
    cluster.kill_primary()
    assert router.failover() == 2
    st = router.status()
    assert st["promotions"] == 1 and st["term"] == 2
    search_equal(router, comp, rows=slice(1, 2), session=sess)
    mirrored_insert(router, comp, N0 + 8, session=sess)
    assert router.delete([9], session=sess) == comp.delete([9]) == 1
    assert sess.watermark == router._last_seq
    search_equal(router, comp, rows=slice(2, 3), session=sess)
    assert router.stats["direct_reads"] >= 2


def test_dead_scorer_without_replica_is_degraded(killed):
    """Scorer 0 dead and the only replica promoted: a fan-out request is
    refused explicitly, never answered with a shortened top-k."""
    cluster, router, comp, _ = killed
    degraded = router.stats["degraded"]
    with pytest.raises(DegradedResultError, match="refusing"):
        router.search_sparse(DS.q_sparse, DS.q_dense)
    assert router.stats["degraded"] == degraded + 1


def test_lagging_replica_refused_and_zombie_fenced(tmp_path):
    """Cluster B (2 scorers, 2 replicas).  Replica 1 stops shipping and
    falls behind an acked insert.  A failover while the old primary still
    runs promotes replica 0 (the most applied); a router that has seen
    term 2 refuses the zombie's insert ack with ``StaleTermError`` and
    moves nothing.  The promoted primary serves the fan-out bit for bit.
    Killed in turn, it leaves only the laggard, which ``failover()``
    refuses to promote."""
    comp = comparator()
    with LocalCluster.launch(build(), str(tmp_path / "c"), num_scorers=2,
                             num_replicas=2, device="cpu") as cluster:
        r1 = cluster.router(h=8, timeout=CLUSTER_TIMEOUT_S)
        try:
            mirrored_insert(r1, comp, N0)
            for h in cluster.replicas:
                wait_replica_seq(h.port, r1._last_seq)
            r1.replicas[1].call("fault", {"mode": "pause_shipping"})
            mirrored_insert(r1, comp, N0 + 1)          # acked; 1 lags
            wait_replica_seq(cluster.replicas[0].port, r1._last_seq)
            promoted_port = cluster.replicas[0].port
            assert r1.failover() == 2                  # old primary alive
            r2 = ClusterRouter(f"127.0.0.1:{promoted_port}",
                               [s.addr for s in cluster.scorers], [],
                               timeout=CLUSTER_TIMEOUT_S)
            try:
                assert r2.term == 2
                r2.primary.close()
                r2.primary = ShardClient("127.0.0.1", cluster.primary.port,
                                         timeout=CLUSTER_TIMEOUT_S)
                before = r2._last_seq
                with pytest.raises(StaleTermError, match="deposed"):
                    r2.insert(DS.x_sparse[N0 + 2], DS.x_dense[N0 + 2])
                assert r2._last_seq == before      # the ack moved nothing
            finally:
                r2.close()
            search_equal(r1, comp)                 # fan-out, new primary
            search_equal(r1, comp, rows=slice(0, 1))
            mirrored_insert(r1, comp, N0 + 3)      # replica 1 lags further
            cluster.replicas[0].kill()             # the promoted primary
            with pytest.raises(FailoverError, match="lose acked"):
                r1.failover()
        finally:
            r1.close()
            comp.close()


def test_promotion_during_a_held_reload_keeps_the_new_primary(tmp_path):
    """The replica's reload of a compaction held before its swap
    (``hold_reload``, a port-only fault mode) while the replica is
    promoted under term 2 and acks a write: at the release the reload is
    refused, and the promoted primary keeps its generation, term, log and
    writes, and takes more at its term."""
    comp = comparator()
    with LocalCluster.launch(build(), str(tmp_path / "c"), num_scorers=1,
                             num_replicas=1, device="cpu") as cluster:
        r1 = cluster.router(h=8, timeout=CLUSTER_TIMEOUT_S)
        port = cluster.replicas[0].port
        rc = ShardClient("127.0.0.1", port, timeout=CLUSTER_TIMEOUT_S)
        r2 = None
        try:
            mirrored_insert(r1, comp, N0)
            wait_replica_seq(port, r1._last_seq)
            rc.call("fault", {"mode": "hold_reload"})
            flip = started(r1.compact)
            deadline = time.monotonic() + CLUSTER_TIMEOUT_S
            while rc.call("stats")[0]["holding"] != ["reload"]:
                assert time.monotonic() < deadline, "never a held reload"
                time.sleep(0.02)
            rc.call("promote", {"sealed_seq": r1._last_seq, "new_term": 2})
            r2 = ClusterRouter(f"127.0.0.1:{port}",
                               [s.addr for s in cluster.scorers], [], h=8,
                               timeout=CLUSTER_TIMEOUT_S)
            mirrored_insert(r2, comp, N0 + 1)
            acked = r2._last_seq
            rc.call("fault", {"mode": "release_reload"})
            with pytest.raises(RemoteError, match="promoted"):
                finished(*flip, limit=CLUSTER_TIMEOUT_S)
            st = rc.call("status")[0]
            assert (st["role"], st["gen"], st["term"]) == ("primary", 1, 2)
            assert st["applied_seq"] == acked and st["delta_live"] == 2
            mirrored_insert(r2, comp, N0 + 2)      # acked at term 2
            assert r2.term == 2 and r2._last_seq == acked + 1
            for q in range(NQ):                    # the direct read
                search_equal(r2, comp, rows=slice(q, q + 1))
        finally:
            rc.call("fault", {"mode": "release_reload"})
            rc.close()
            if r2 is not None:
                r2.close()
            r1.close()
            comp.close()


def test_node_without_its_device_fails_at_startup(tmp_path):
    """No fallback: a node asked for ``--device cuda`` on a machine
    without a card dies at startup, and the launch says why."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCluster.launch(build(), str(tmp_path / "c"), num_scorers=1,
                            device="cuda")
