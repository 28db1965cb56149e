"""The port's three-pass search (repro_torch.core.engine) against the JAX
package's, on the CPU.

A JAX ``HybridIndex`` is built and carried across with
``hybrid_index_from_numpy``; the port then searches the same arrays with
each backend.  Ids must match the JAX ``ref`` backend up to near-ties and
scores within rtol 1e-5, atol 1e-4 (the two packages sum in different
orders); ``onehot`` rounds the LUT to bf16 and gets the loose tolerance of
tests/test_engine.py.  Inside the port, fused and materialised pass 1 are
bit-identical."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import assert_topk_match, jax_index_state

from repro.core import engine as jengine
from repro.core.hybrid import HybridIndex as JaxHybridIndex
from repro.core.hybrid import HybridIndexParams as JaxParams
from repro.core.sparse_index import score_inverted as jax_score_inverted
from repro_torch.core import engine
from repro_torch.core.engine import Backend, ScoringEngine
from repro_torch.core.hybrid import HybridIndexParams
from repro_torch.core.pq import PQCodebooks
from repro_torch.core.sparse_index import (score_inverted,
                                           sparse_queries_to_padded)
from repro_torch.interchange import hybrid_index_from_numpy
from repro_torch.kernels import ops

PARAMS = dict(keep_top=48, head_dims=48, kmeans_iters=6)


@pytest.fixture(scope="module")
def jax_ref(small_hybrid):
    ds = small_hybrid
    return JaxHybridIndex.build(ds.x_sparse, ds.x_dense, JaxParams(**PARAMS))


def _port(jidx, backend, **kw):
    leaves, scalars = jax_index_state(jidx)
    return hybrid_index_from_numpy(
        leaves, scalars, HybridIndexParams(backend=backend, **PARAMS, **kw),
        device="cpu")


def _queries(ds, idx):
    d, v = sparse_queries_to_padded(ds.q_sparse, idx.cols, nq_max=256)
    return (torch.from_numpy(d), torch.from_numpy(v),
            torch.from_numpy(ds.q_dense))


@pytest.mark.parametrize("h,alpha,beta", [(20, 20, 5), (60, 20, 5)])
@pytest.mark.parametrize("backend", ["ref", "cuda", "cuda-packed"])
def test_search_matches_jax_ref(small_hybrid, jax_ref, backend, h, alpha,
                                beta):
    """c1 = 400 takes the fused pass 1 on the kernel backends, c1 = 1200
    the materialised one."""
    ds = small_hybrid
    want = jax_ref.search(ds.q_sparse, ds.q_dense, h=h, alpha=alpha, beta=beta)
    got = _port(jax_ref, backend).search(ds.q_sparse, ds.q_dense, h=h,
                                          alpha=alpha, beta=beta)
    assert_topk_match(got.scores, got.ids, want.scores, want.ids)


def test_onehot_backend_close_to_jax_ref(small_hybrid, jax_ref):
    ds = small_hybrid
    want = jax_ref.search(ds.q_sparse, ds.q_dense, h=10, alpha=20, beta=5)
    got = _port(jax_ref, "onehot").search(ds.q_sparse, ds.q_dense, h=10,
                                           alpha=20, beta=5)
    assert (got.ids == want.ids).mean() > 0.9
    np.testing.assert_allclose(np.sort(got.scores), np.sort(want.scores),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("packed", [False, True])
def test_pallas_index_carried_across(small_hybrid, packed):
    """An index the JAX package built for its Pallas backends (BCSR head,
    maybe packed codes) searches the same on the port's kernel backends."""
    ds = small_hybrid
    backend = "pallas-packed" if packed else "pallas"
    jidx = JaxHybridIndex.build(ds.x_sparse, ds.x_dense,
                                JaxParams(backend=backend, **PARAMS))
    want = jidx.search(ds.q_sparse, ds.q_dense, h=20, alpha=20, beta=5)
    tidx = _port(jidx, backend)
    assert tidx.engine.backend.uses_kernels
    assert tidx.engine.arrays.codes_packed is packed
    assert tidx.engine.arrays.head_max_steps > 0
    got = tidx.search(ds.q_sparse, ds.q_dense, h=20, alpha=20, beta=5)
    assert_topk_match(got.scores, got.ids, want.scores, want.ids)


@pytest.mark.parametrize("backend", ["cuda", "cuda-packed"])
def test_fused_and_materialised_search_bit_identical(small_hybrid, jax_ref,
                                                     backend):
    ds = small_hybrid
    arrays = _port(jax_ref, backend).engine.arrays
    q = _queries(ds, _port(jax_ref, "ref"))
    ops.reset_counts()
    a = ScoringEngine(arrays, Backend.from_name(backend), fused=True).search(
        *q, h=20, alpha=20, beta=5)
    b = ScoringEngine(arrays, Backend.from_name(backend), fused=False).search(
        *q, h=20, alpha=20, beta=5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # CPU tensors: the plain versions ran, no kernel launched
    assert all(v == 0 for v in ops.LAUNCHES.values())
    ops.reset_counts()


def test_valid_mask_order_matches_jax(small_hybrid, jax_ref):
    """A tombstone mask folded into pass 1 (before the dense term) gives
    the JAX package's results, and no tombstoned row surfaces."""
    ds = small_hybrid
    n = jax_ref.num_points
    dead = np.zeros(n, bool)
    dead[::7] = True
    jmask = jengine.tombstone_mask(n, n, dead)
    jarr = dataclasses.replace(jax_ref.engine.arrays, valid_mask=jmask)
    tidx = _port(jax_ref, "cuda")
    tmask = engine.tombstone_mask(n, n, dead, device="cpu")
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    tarr = dataclasses.replace(tidx.engine.arrays, valid_mask=tmask)
    qd, qv, qdense = _queries(ds, tidx)
    ws, wids, _ = jengine.three_pass_search(
        jarr, jnp.asarray(qd.numpy()), jnp.asarray(qv.numpy()),
        jnp.asarray(qdense.numpy()), h=20, c1=400, c2=100,
        backend=jengine.Backend.REF)
    outs = [engine.three_pass_search(tarr, qd, qv, qdense, h=20, c1=400,
                                     c2=100, backend=b, fused=f)
            for b, f in ((Backend.REF, True), (Backend.CUDA, True),
                         (Backend.CUDA, False))]
    for s, ids, _ in outs:
        assert_topk_match(s.numpy(), ids.numpy(), np.asarray(ws),
                          np.asarray(wids))
        assert not dead[ids.numpy()].any()
    for x, y in zip(outs[1], outs[2]):
        assert torch.equal(x, y)


def test_pass1_pieces_match_jax(small_hybrid, jax_ref):
    ds = small_hybrid
    tidx = _port(jax_ref, "cuda")
    qd, qv, qdense = _queries(ds, tidx)
    got = score_inverted(tidx.inv_index, qd, qv)
    want = jax_score_inverted(jax_ref.inv_index, jnp.asarray(qd.numpy()),
                              jnp.asarray(qv.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    jarr = jax_ref.engine.arrays
    np.testing.assert_allclose(
        engine.pass1_bias(tidx.engine.arrays, qd, qv, Backend.CUDA).numpy(),
        np.asarray(jengine.pass1_bias(jarr, jnp.asarray(qd.numpy()),
                                      jnp.asarray(qv.numpy()))),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        engine.scatter_queries_compact(qd, qv, tidx.cols.num_active).numpy(),
        np.asarray(jengine.scatter_queries_compact(
            jnp.asarray(qd.numpy()), jnp.asarray(qv.numpy()),
            tidx.cols.num_active)))


def test_packed_engine_rejects_small_codebooks(jax_ref):
    """l != 16 with packed codes is refused when the engine is built."""
    arrays = _port(jax_ref, "cuda-packed").engine.arrays
    small = dataclasses.replace(
        arrays, codebooks=PQCodebooks(arrays.codebooks.centers[:, :8]))
    with pytest.raises(ValueError, match="l == 16"):
        ScoringEngine(small, Backend.CUDA_PACKED)
    ScoringEngine(small, Backend.REF)          # the ref path takes it


def test_backend_names():
    assert Backend.from_name(None) is Backend.CUDA
    for alias, want in (("pallas", Backend.CUDA), ("lut16", Backend.CUDA),
                        ("pallas-packed", Backend.CUDA_PACKED),
                        ("onehot-mxu", Backend.ONEHOT),
                        ("ref", Backend.REF)):
        assert Backend.from_name(alias) is want
    with pytest.raises(ValueError):
        Backend.from_name("tpu")


def test_head_free_index_carried_across(small_hybrid):
    ds = small_hybrid
    jidx = JaxHybridIndex.build(
        ds.x_sparse, ds.x_dense,
        JaxParams(keep_top=48, kmeans_iters=4, use_head_block=False))
    want = jidx.search(ds.q_sparse, ds.q_dense, h=10, alpha=10, beta=3)
    leaves, scalars = jax_index_state(jidx)
    assert scalars["head.block_rows"] is None
    got = hybrid_index_from_numpy(leaves, scalars, HybridIndexParams(),
                                  device="cpu").search(
        ds.q_sparse, ds.q_dense, h=10, alpha=10, beta=3)
    assert_topk_match(got.scores, got.ids, want.scores, want.ids)
