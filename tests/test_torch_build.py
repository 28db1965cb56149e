"""The port's index build (repro_torch) against the JAX package's, on the
CPU.

The host-side stages are copies of the JAX package's numpy code, so on the
same data they must give the same arrays exactly.  k-means cannot: the port
draws its initial centers from a torch.Generator.  Given the JAX package's
centers, encoding agrees up to near-ties, and quantization of the same
residual agrees exactly.  The port's own build is held to the recall floor
of tests/test_recall.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import pq as jpq
from repro.core.cache_sort import cache_sort as jax_cache_sort
from repro.core.hybrid import HybridIndex as JaxHybridIndex
from repro.core.hybrid import HybridIndexParams as JaxParams
from repro.core.pruning import prune_split as jax_prune_split
from repro.data import make_hybrid_dataset as jax_make_dataset
from repro.kernels.ops import bcsr_from_head as jax_bcsr_from_head
from repro_torch.core import pq
from repro_torch.core.baselines import exact_topk as port_exact_topk
from repro_torch.core.baselines import recall_at_h
from repro_torch.core.cache_sort import cache_sort
from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.core.pruning import prune_split
from repro_torch.data import make_hybrid_dataset
from repro_torch.kernels.ops import bcsr_from_head

PARAMS = dict(keep_top=48, head_dims=48, kmeans_iters=6)   # test_recall.py
FLOOR_FRESH = 0.97                                         # test_recall.py


def _same_csr(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("related", [True, False])
def test_make_hybrid_dataset_identical(related):
    kw = dict(num_points=700, num_queries=9, d_sparse=3000, d_dense=12,
              nnz_per_row=25, alpha=1.8, dense_weight=2.0,
              related_queries=related, seed=5)
    got, want = make_hybrid_dataset(**kw), jax_make_dataset(**kw)
    _same_csr(got.x_sparse, want.x_sparse)
    _same_csr(got.q_sparse, want.q_sparse)
    np.testing.assert_array_equal(got.x_dense, want.x_dense)
    np.testing.assert_array_equal(got.q_dense, want.q_dense)


def test_cache_sort_and_prune_split_identical(small_hybrid):
    xs = small_hybrid.x_sparse
    pi = cache_sort(xs)
    np.testing.assert_array_equal(pi, jax_cache_sort(xs))
    got, want = prune_split(xs[pi], keep_top=48), jax_prune_split(xs[pi],
                                                                  keep_top=48)
    _same_csr(got.index, want.index)
    _same_csr(got.residual, want.residual)
    np.testing.assert_array_equal(got.eta, want.eta)


@pytest.fixture(scope="module")
def both_builds(small_hybrid):
    ds = small_hybrid
    jidx = JaxHybridIndex.build(ds.x_sparse, ds.x_dense,
                                JaxParams(backend="pallas", **PARAMS))
    tidx = HybridIndex.build(ds.x_sparse, ds.x_dense,
                             HybridIndexParams(backend="cuda", **PARAMS),
                             device="cpu")
    return ds, jidx, tidx


def test_sparse_structures_identical(both_builds):
    """pi, compact columns, inverted index, head block, BCSR and residual
    rows: equal arrays."""
    _, jidx, tidx = both_builds
    np.testing.assert_array_equal(tidx.pi, jidx.pi)
    np.testing.assert_array_equal(tidx.cols.global_ids, jidx.cols.global_ids)
    pairs = [
        (tidx.inv_index.rows, jidx.inv_index.rows),
        (tidx.inv_index.vals, jidx.inv_index.vals),
        (tidx.head.block, jidx.head.block),
        (tidx.head.occupancy, jidx.head.occupancy),
        (tidx.head.head_dims, jidx.head.head_dims),
        (tidx.sparse_residual.cols, jidx.sparse_residual.cols),
        (tidx.sparse_residual.vals, jidx.sparse_residual.vals),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tidx.inv_index.num_points == jidx.inv_index.num_points
    np.testing.assert_array_equal(tidx.head_dim_ids, jidx.head_dim_ids)
    ta, ja = tidx.engine.arrays, jidx.engine.arrays
    for got, want in zip(bcsr_from_head(tidx.head)[:3],
                         jax_bcsr_from_head(jidx.head)[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ta.head_tiles.numpy(),
                                  np.asarray(ja.head_tiles))
    np.testing.assert_array_equal(ta.head_pos.numpy(), np.asarray(ja.head_pos))
    assert ta.head_max_steps == ja.head_max_steps


def test_pq_encode_with_jax_centers(both_builds):
    """Same centers -> same codes, except where two codewords are (nearly)
    equidistant: then the distance gap must be below 1e-5 relative."""
    ds, jidx, tidx = both_builds
    xd = ds.x_dense[tidx.pi]
    centers = np.array(jidx.codebooks.centers)
    got = pq.pq_encode(torch.from_numpy(xd),
                       pq.PQCodebooks(torch.from_numpy(centers)),
                       chunk=1000).numpy()
    want = np.asarray(jidx.codes)
    diff = np.argwhere(got != want)
    assert len(diff) <= 0.001 * got.size
    subs = xd.reshape(xd.shape[0], centers.shape[0], -1)
    for n, k in diff:
        d = ((subs[n, k][None] - centers[k]) ** 2).sum(-1)
        a, b = d[got[n, k]], d[want[n, k]]
        assert abs(a - b) <= 1e-5 * max(abs(a), abs(b), 1e-12)


def test_scalar_quantize_and_decode_match_jax(both_builds):
    ds, jidx, tidx = both_builds
    xd = ds.x_dense[tidx.pi]
    cb = pq.PQCodebooks(torch.from_numpy(np.array(jidx.codebooks.centers)))
    codes = torch.from_numpy(np.array(jidx.codes))
    recon = pq.pq_decode(codes, cb).numpy()
    np.testing.assert_array_equal(
        recon, np.asarray(jpq.pq_decode(jidx.codes, jidx.codebooks)))
    resid = xd - recon
    got = pq.scalar_quantize(torch.from_numpy(resid))
    want = jpq.scalar_quantize(jnp.asarray(resid))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.zero.numpy(), np.asarray(want.zero))
    np.testing.assert_array_equal(jidx.dense_residual.q, want.q)
    np.testing.assert_allclose(pq.scalar_dequantize(got).numpy(),
                               np.asarray(jpq.scalar_dequantize(want)),
                               rtol=1e-6, atol=1e-6)


def test_adc_lut_and_scores_match_jax(both_builds):
    ds, jidx, _ = both_builds
    cb = pq.PQCodebooks(torch.from_numpy(np.array(jidx.codebooks.centers)))
    lut = pq.adc_lut(torch.from_numpy(ds.q_dense), cb)
    jlut = jpq.adc_lut(jnp.asarray(ds.q_dense), jidx.codebooks)
    np.testing.assert_allclose(lut.numpy(), np.asarray(jlut), rtol=1e-5,
                               atol=1e-5)
    codes = np.array(jidx.codes)
    np.testing.assert_allclose(
        pq.adc_scores_ref(torch.from_numpy(codes), lut).numpy(),
        np.asarray(jpq.adc_scores_ref(jnp.asarray(codes), jlut)),
        rtol=1e-5, atol=1e-4)


def test_train_codebooks_deterministic_and_sane():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3000, 8)).astype(np.float32))
    a = pq.train_codebooks(x, 4, 16, iters=5, seed=3, sample=2000)
    b = pq.train_codebooks(x, 4, 16, iters=5, seed=3, sample=2000)
    assert a.centers.shape == (4, 16, 2)
    assert torch.equal(a.centers, b.centers)
    recon = pq.pq_decode(pq.pq_encode(x, a), a)
    assert ((x - recon) ** 2).mean() < 0.5 * (x ** 2).mean()


def test_port_build_recall_floor(small_hybrid, exact_topk):
    """The port's own build (torch k-means) holds test_recall.py's fresh
    floor, and the port's exact search agrees with the fixture's."""
    ds = small_hybrid
    _, exact_ids = exact_topk
    idx = HybridIndex.build(ds.x_sparse, ds.x_dense,
                            HybridIndexParams(**PARAMS), device="cpu")
    r = idx.search(ds.q_sparse, ds.q_dense, h=20)
    assert recall_at_h(r.ids, exact_ids) >= FLOOR_FRESH
    ids, _ = port_exact_topk(ds.q_sparse, ds.q_dense, ds.x_sparse,
                             ds.x_dense, 20, device="cpu")
    assert recall_at_h(ids, exact_ids) >= 0.99


def test_build_params_and_unported_paths(small_hybrid):
    ds = small_hybrid
    assert HybridIndexParams().resolve_backend().value == "cuda"
    assert HybridIndexParams(backend="pallas-packed").resolve_pack()
    mutable = HybridIndex.build(ds.x_sparse[:300], ds.x_dense[:300],
                                mutable=True, device="cpu")
    assert mutable.mutable_state.live_rows == 300
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        HybridIndex.load("nowhere")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HybridIndex.build(ds.x_sparse[:10], ds.x_dense[:10])
    p = dataclasses.replace(HybridIndexParams(), backend="nonsense")
    with pytest.raises(ValueError, match="unknown backend"):
        p.resolve_backend()
