"""A port cluster answers every search through a compaction (C10).

Two tests share one local cluster of the port (a primary and two
row-sliced scorers, each a process of its own on the CPU) and one
comparator, the port's in-process ``QueryService`` on the same state; at
this size every row is refined, so the scorer fan-out and the primary's
one-engine read both equal it bit for bit (as in
``tests/test_torch_cluster.py``).  A fault mode that only the port's
nodes have holds one step of a compaction for as long as a test needs:

* ``hold_reload`` on a scorer: the primary has flipped to the new
  generation, the scorer still holds only the old one.  A second router's
  32-row searches, and a fresh router's, are all answered, by the
  primary's full read (``flip_direct``), none refused; after the release
  they fan out again;
* ``hold_fold`` on the primary, between its fold and its swap: ``info``,
  a fan-out with its delta part and a direct read return at the old
  generation, a mutation waits, and after the release the mutation lands
  in the new generation.

A third test, on fake nodes, holds the router's retry budget: a
``StaleGeneration`` that outlasts the old budget of 8 retries (1.4 s) is
retried until it clears, and one that outlasts the client's timeout
surfaces.  Every wait runs under a time limit of its own."""

import time

import numpy as np
import pytest
from _torch_port_helpers import (CLUSTER_TIMEOUT_S, FakeNode, bounded,
                                 finished, stale, started)
from _torch_port_helpers import one_thread_nodes  # noqa: F401

from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.data import make_hybrid_dataset
from repro_torch.serve import QueryService
from repro_torch.serve.cluster import LocalCluster, RemoteError, ShardClient
from repro_torch.serve.cluster.protocol import MSG_RESPONSE
from repro_torch.serve.cluster.router import LAG_PROBE_S, ClusterRouter

N0, N_POOL, NQ, H = 96, 128, 32, 8
STEP_S = 20.0            # a step's own time limit: a search, a join

DS = make_hybrid_dataset(num_points=N_POOL, num_queries=NQ, d_sparse=240,
                         d_dense=16, nnz_per_row=8, seed=11)


def build():
    return HybridIndex.build(
        DS.x_sparse[:N0], DS.x_dense[:N0],
        HybridIndexParams(keep_top=16, head_dims=8, kmeans_iters=2,
                          pq_subspaces=4), mutable=True, device="cpu")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flip"))
    comp = QueryService(index=build(), h=H, cache_size=0,
                        auto_compact=False, device="cpu")
    with LocalCluster.launch(build(), root, num_scorers=2,
                             device="cpu") as cluster:
        router = cluster.router(h=H, timeout=CLUSTER_TIMEOUT_S)
        try:
            yield cluster, router, comp
        finally:
            router.close()
            comp.close()


def node_call(port, cmd, meta=None):
    c = ShardClient("127.0.0.1", port, timeout=CLUSTER_TIMEOUT_S)
    try:
        return c.call(cmd, meta)[0]
    finally:
        c.close()


def wait_for(cond, what):
    deadline = time.monotonic() + STEP_S
    while not cond():
        assert time.monotonic() < deadline, f"never {what}"
        time.sleep(0.02)


def mutate(router, comp, rows, kill):
    """Insert ``rows`` of the pool and delete main row ``kill``, through
    the router and in-process."""
    for r in rows:
        np.testing.assert_array_equal(
            router.insert(DS.x_sparse[r], DS.x_dense[r]),
            comp.insert(DS.x_sparse[r], DS.x_dense[r]))
    assert router.delete([kill]) == comp.delete([kill]) == 1


def same(router, comp, rows):
    """The router's search of ``rows`` (within ``STEP_S``) equals the
    comparator's, ids and scores bit for bit."""
    s_r, i_r = bounded(lambda: router.search_sparse(DS.q_sparse[rows],
                                                    DS.q_dense[rows]),
                       limit=STEP_S)
    s_c, i_c = comp.search_sparse(DS.q_sparse[rows], DS.q_dense[rows])
    np.testing.assert_array_equal(i_r, i_c)
    np.testing.assert_array_equal(s_r, s_c)


def test_searches_answered_while_a_scorer_reload_is_held(env):
    cluster, router, comp = env
    mutate(router, comp, range(N0, N0 + 6), kill=0)
    bg = cluster.router(h=H, timeout=CLUSTER_TIMEOUT_S)
    held = cluster.scorers[0].port
    g0 = node_call(cluster.primary.port, "status")["gen"]
    gens = node_call(held, "stats")["generations"]
    try:
        same(bg, comp, slice(0, NQ))               # a fan-out at g0
        node_call(held, "fault", {"mode": "hold_reload"})
        flip = started(router.compact)
        wait_for(lambda: node_call(held, "stats")["holding"] == ["reload"],
                 "a held reload")
        assert node_call(cluster.primary.port, "status")["gen"] == g0 + 1
        comp.compact()
        for k in range(4):
            same(bg, comp, slice(0, NQ))
            assert bg.stats["flip_direct"] == NQ * (k + 1)
        assert bg.gen == g0 + 1 and bg.stats["direct_reads"] == 0
        fresh = cluster.router(h=H, timeout=CLUSTER_TIMEOUT_S)
        try:                                       # pinned at g0 + 1 first
            same(fresh, comp, slice(0, NQ))
            assert fresh.stats["flip_direct"] == NQ
        finally:
            fresh.close()
        assert node_call(held, "stats")["generations"] == gens
        node_call(held, "fault", {"mode": "release_reload"})
        assert finished(*flip, limit=STEP_S) == g0 + 1
        # the next search after a probe interval finds every scorer at
        # generation g0 + 1 and fans out
        time.sleep(LAG_PROBE_S)
        before = dict(bg.stats)
        same(bg, comp, slice(0, NQ))
        assert bg.stats["flip_direct"] == before["flip_direct"]
        assert bg.stats["primary_reads"] == before["primary_reads"] + NQ
    finally:
        node_call(held, "fault", {"mode": "release_reload"})
        bg.close()


def test_reads_answered_while_the_primary_fold_is_held(env):
    cluster, router, comp = env
    mutate(router, comp, range(N0 + 6, N0 + 12), kill=1)
    bg = cluster.router(h=H, timeout=CLUSTER_TIMEOUT_S)
    primary = cluster.primary.port
    st = node_call(primary, "status")
    g0, live0 = st["gen"], st["delta_live"]
    assert live0 > 0
    try:
        node_call(primary, "fault", {"mode": "hold_fold"})
        fold = started(router.compact)
        wait_for(lambda: node_call(primary, "stats")["holding"] == ["fold"],
                 "a held fold")
        info = bounded(lambda: node_call(primary, "info"), limit=STEP_S)
        assert info["gen"] == g0 and info["delta_live"] == live0
        same(bg, comp, slice(0, NQ))               # scorers + delta part
        same(bg, comp, slice(3, 4))                # the direct read
        assert bg.gen == g0 and bg.stats["direct_reads"] == 1
        src = N0 + 12
        insert = started(lambda: bg.insert(DS.x_sparse[src],
                                           DS.x_dense[src]))
        time.sleep(0.5)
        assert insert[0].is_alive(), "a mutation was acked mid-fold"
        node_call(primary, "fault", {"mode": "release_fold"})
        assert finished(*fold, limit=STEP_S) == g0 + 1
        comp.compact()
        np.testing.assert_array_equal(
            finished(*insert, limit=STEP_S),
            comp.insert(DS.x_sparse[src], DS.x_dense[src]))
        # the insert waited for the swap: it is the new delta's one row
        st = node_call(primary, "status")
        assert st["gen"] == g0 + 1 and st["delta_live"] == 1
        same(bg, comp, slice(0, NQ))
        same(bg, comp, slice(3, 4))
        assert bg.gen == g0 + 1
    finally:
        node_call(primary, "fault", {"mode": "release_fold"})
        bg.close()


def test_stale_generation_retried_until_the_timeout():
    """A fake primary refuses its own generation 2 for ``refuse_s``: a
    direct read is retried past the old budget of 1.4 s and answered;
    with ``refuse_s`` beyond the client's timeout it surfaces."""
    state = {"until": 0.0}

    def primary(cmd, meta, arrays):
        if cmd == "info":
            return (MSG_RESPONSE, {
                "gen": 2, "alpha": 4, "beta": 2, "num_points": 16,
                "d_active": 8, "nq_max": 4, "term": 1, "epoch": 1,
                "delta_live": 0, "applied_seq": 0},
                {"cols_global_ids": np.arange(8, dtype=np.int64),
                 "main_tombstones": np.zeros(0, np.int64),
                 "fully_deleted": np.zeros(0, np.int64)}, 0.0)
        assert cmd == "search" and meta["part"] == "full", (cmd, meta)
        if time.monotonic() < state["until"]:
            return stale("primary", 1, meta["gen"])
        q = arrays["q_dims"].shape[0]
        ids = np.broadcast_to(np.arange(15, 15 - H, -1), (q, H))
        return (MSG_RESPONSE, {"gen": 2, "applied_seq": 0, "term": 1,
                               "delta_live": 0},
                {"ms": np.broadcast_to(np.linspace(1.0, 0.5, H, dtype=
                                               np.float32), (q, H)),
                 "mi": ids.astype(np.int64),
                 "main_tombstones": np.zeros(0, np.int64)}, 0.0)

    node = FakeNode(primary)
    q = (np.zeros((1, 4), np.int32), np.zeros((1, 4), np.float32),
         np.zeros((1, 4), np.float32))
    try:
        router = ClusterRouter(node.addr, [node.addr], h=H, timeout=4.0)
        try:
            state["until"] = time.monotonic() + 2.0
            t0 = time.monotonic()
            _, ids = bounded(lambda: router.search(*q), limit=STEP_S)
            assert time.monotonic() - t0 >= 2.0
            np.testing.assert_array_equal(ids[0], np.arange(15, 15 - H, -1))
            assert router.stats["stale_retries"] > 8
            state["until"] = time.monotonic() + 60.0
            t0 = time.monotonic()
            with pytest.raises(RemoteError, match="StaleGeneration"):
                bounded(lambda: router.search(*q), limit=STEP_S)
            assert 4.0 <= time.monotonic() - t0 < 4.0 + 1.0
        finally:
            router.close()
    finally:
        node.close()
