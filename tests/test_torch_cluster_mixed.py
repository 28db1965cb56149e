"""Mixed clusters: the two packages' cluster tiers talk to each other over
the one wire format.  A port ``ClusterRouter`` drives a JAX-package
``LocalCluster``, and a JAX-package ``ClusterRouter`` drives a port
``LocalCluster`` (``--device cpu``).  The router only routes and merges on
the host, so each mixed cluster equals, bit for bit, the in-process
``QueryService`` of the package whose nodes score; against the other
package's in-process service its ids agree up to neighbour swaps and its
scores within rtol 1e-5 / atol 1e-4 (``assert_topk_match``).  Both hold
through inserts, an upsert, deletes and one merge compaction.  Both
services serve the same main generation: the JAX build, carried across
with ``interchange``."""

import numpy as np
import pytest
from _torch_port_helpers import (CLUSTER_TIMEOUT_S, assert_topk_match,
                                 jax_index_state)
from _torch_port_helpers import one_thread_nodes  # noqa: F401

from repro.core.hybrid import HybridIndex as JaxHybridIndex
from repro.core.hybrid import HybridIndexParams as JaxParams
from repro.data import make_hybrid_dataset
from repro.serve import QueryService as JaxQueryService
from repro.serve.cluster import ClusterRouter as JaxClusterRouter
from repro.serve.cluster import LocalCluster as JaxLocalCluster
from repro_torch.core.hybrid import HybridIndexParams
from repro_torch.interchange import mutable_index_from_numpy
from repro_torch.serve import QueryService
from repro_torch.serve.cluster import ClusterRouter, LocalCluster

N0, N_POOL, NQ = 96, 140, 3
PARAMS = dict(keep_top=16, head_dims=8, kmeans_iters=2, pq_subspaces=4)
SVC = dict(h=8, cache_size=0, auto_compact=False, compact_retrain=False)

DS = make_hybrid_dataset(num_points=N_POOL, num_queries=NQ, d_sparse=240,
                         d_dense=16, nnz_per_row=8, seed=11)


@pytest.fixture(scope="module", autouse=True)
def _jax_nodes_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_PLATFORMS", "cpu")
        yield


def pair():
    """The JAX mutable index (ref backend) and the port's over the same
    main generation and corpus (the kernel backend, plain versions here)."""
    jidx = JaxHybridIndex.build(DS.x_sparse[:N0], DS.x_dense[:N0],
                                JaxParams(backend="ref", **PARAMS),
                                mutable=True)
    leaves, scalars = jax_index_state(jidx)
    tidx = mutable_index_from_numpy(
        leaves, scalars, DS.x_sparse[:N0], DS.x_dense[:N0],
        params=HybridIndexParams(backend="cuda", **PARAMS), device="cpu")
    return jidx, tidx


def drive(router, same, other):
    """Mutations mirrored to the router and both in-process services;
    after each step the router equals ``same`` bit for bit and ``other``
    within the tolerance, on a fan-out batch and a one-row request."""
    xs, xd = DS.x_sparse, DS.x_dense

    def check():
        for rows in (slice(0, NQ), slice(2, 3)):
            s_r, i_r = router.search_sparse(DS.q_sparse[rows],
                                            DS.q_dense[rows])
            s_s, i_s = same.search_sparse(DS.q_sparse[rows],
                                          DS.q_dense[rows])
            s_o, i_o = other.search_sparse(DS.q_sparse[rows],
                                           DS.q_dense[rows])
            np.testing.assert_array_equal(i_r, i_s)
            np.testing.assert_array_equal(s_r, s_s)
            assert_topk_match(s_r, i_r, s_o, i_o)

    check()
    new = router.insert(xs[N0:N0 + 6], xd[N0:N0 + 6])
    for svc in (same, other):
        np.testing.assert_array_equal(svc.insert(xs[N0:N0 + 6],
                                                 xd[N0:N0 + 6]), new)
    check()
    assert router.delete([3, int(new[1])]) == 2
    router.insert(xs[N0 + 6], xd[N0 + 6], ids=[int(new[0])])
    for svc in (same, other):
        assert svc.delete([3, int(new[1])]) == 2
        svc.insert(xs[N0 + 6], xd[N0 + 6], ids=[int(new[0])])
    check()
    assert router.compact(retrain=False) == 2
    for svc in (same, other):
        svc.compact(retrain=False)
    check()
    router.insert(xs[N0 + 7:N0 + 9], xd[N0 + 7:N0 + 9])
    router.delete([int(new[2])])
    for svc in (same, other):
        svc.insert(xs[N0 + 7:N0 + 9], xd[N0 + 7:N0 + 9])
        svc.delete([int(new[2])])
    check()
    assert router.stats["degraded"] == 0 and router.stats["direct_reads"] > 0


def test_port_router_over_reference_nodes(tmp_path):
    jidx, tidx = pair()
    with JaxLocalCluster.launch(jidx, str(tmp_path / "c"), num_scorers=2,
                                backend="ref") as cluster:
        router = ClusterRouter(cluster.primary.addr,
                               [s.addr for s in cluster.scorers], h=8,
                               timeout=CLUSTER_TIMEOUT_S)
        jsvc = JaxQueryService(index=jidx, **SVC)
        tsvc = QueryService(index=tidx, device="cpu", **SVC)
        try:
            drive(router, jsvc, tsvc)
        finally:
            router.close()
            jsvc.close()
            tsvc.close()


def test_reference_router_over_port_nodes(tmp_path):
    jidx, tidx = pair()
    # the nodes take the JAX package's backend name too
    with LocalCluster.launch(tidx, str(tmp_path / "c"), num_scorers=2,
                             backend="pallas", device="cpu") as cluster:
        router = JaxClusterRouter(cluster.primary.addr,
                                  [s.addr for s in cluster.scorers], h=8,
                                  timeout=CLUSTER_TIMEOUT_S)
        jsvc = JaxQueryService(index=jidx, **SVC)
        tsvc = QueryService(index=tidx, device="cpu", **SVC)
        try:
            drive(router, tsvc, jsvc)
        finally:
            router.close()
            jsvc.close()
            tsvc.close()
