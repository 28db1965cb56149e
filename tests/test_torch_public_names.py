"""The JAX package's public names in the modules the port already has, each
held to the reference on the same inputs: ``queries_head_dense``,
``core.pq.unpack_codes``, ``ops.block_sparse_matmul`` (the TileSparseHead
wrapper), ``ops.dense_scores_materialized`` (the structural check of the
fused pass 1), the oracles ``lut16_adc_ref``, ``block_sparse_ref`` and
``bcsr_to_dense_ref``, and ``repro_torch.serve``'s ``CacheInfo`` and
``JitCacheInfo``."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from _torch_port_helpers import ATOL, RTOL

import repro.core.pq as jpq
import repro.core.sparse_index as jsi
import repro.kernels.ops as jops
import repro.kernels.ref as jref
import repro.serve as jserve
import repro_torch.core.pq as tpq
import repro_torch.core.sparse_index as tsi
import repro_torch.kernels.ops as tops
import repro_torch.kernels.ref as tref
import repro_torch.serve as tserve
from repro.kernels.block_sparse import dense_to_bcsr


def _block_sparse(rng, n, d, br, bc, density):
    x = rng.normal(size=(n, d)).astype(np.float32)
    mask = rng.random((n // br, d // bc)) < density
    return x * np.kron(mask, np.ones((br, bc), np.float32))


def test_queries_head_dense_equals_reference():
    rng = np.random.default_rng(0)
    q_dims = rng.integers(0, 60, (5, 12)).astype(np.int32)
    q_vals = rng.normal(size=(5, 12)).astype(np.float32)
    q_dims[:, -2:] = 60                     # padding slots: no head column
    head_dims = np.full(32, -1, np.int32)
    head_dims[:20] = rng.permutation(60)[:20]
    got = tsi.queries_head_dense(q_dims, q_vals, head_dims, 32)
    want = jsi.queries_head_dense(q_dims, q_vals, head_dims, 32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [6, 7])
def test_pq_unpack_codes_equals_reference(k):
    codes = np.random.default_rng(k).integers(0, 16, (30, k)).astype(np.uint8)
    packed = tpq.pack_codes(codes)
    np.testing.assert_array_equal(packed, jpq.pack_codes(codes))
    got = tpq.unpack_codes(torch.from_numpy(packed), k)
    want = np.asarray(jpq.unpack_codes(jnp.asarray(packed), k))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, codes)


def test_block_sparse_matmul_through_head_equals_reference():
    rng = np.random.default_rng(1)
    xm = _block_sparse(rng, 256, 256, 128, 128, 0.4)
    heads = [m.build_tile_sparse_head(sp.csr_matrix(xm), np.arange(256),
                                      block_rows=128, block_cols=128, **kw)
             for m, kw in ((jsi, {}), (tsi, {"device": "cpu"}))]
    q = rng.normal(size=(5, heads[0].block.shape[1])).astype(np.float32)
    want = np.asarray(jops.block_sparse_matmul(jnp.asarray(q), heads[0]))
    got = tops.block_sparse_matmul(torch.from_numpy(q), heads[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_dense_scores_materialized_agrees_with_reference():
    """The materialising pass 1 produces a float32 (Q > 1, >= N) tensor in
    both packages, with or without a (1, N) row mask, and the reference's
    fused pass 1 produces none.  The port's fused pass 1 is compared with
    the reference only on the card (chip_smoke.py holds K2 to it at the
    slice's shapes): on CPU tensors it runs the plain selection,
    ``lut16_adc_topk_plain``, which sorts the whole (Q, N) score matrix,
    so there the check sees that matrix and reports True."""
    rng = np.random.default_rng(2)
    n = 512
    codes = rng.integers(0, 16, (n, 4)).astype(np.uint8)
    lut = rng.normal(size=(3, 4, 16)).astype(np.float32)
    mask = np.zeros(n, np.float32)
    for kwargs in ({"fused": True}, {"fused": True, "row_mask": True},
                   {"fused": False}, {"fused": False, "row_mask": True}):
        if kwargs.pop("row_mask", False):
            jk, tk = {"row_mask": jnp.asarray(mask)}, {
                "row_mask": torch.from_numpy(mask)}
        else:
            jk, tk = {}, {}
        want = jops.dense_scores_materialized(
            functools.partial(jops.lut16_adc_topk, k=32, **kwargs, **jk),
            jnp.asarray(codes), jnp.asarray(lut))
        got = tops.dense_scores_materialized(
            functools.partial(tops.lut16_adc_topk, k=32, **kwargs, **tk),
            torch.from_numpy(codes), torch.from_numpy(lut))
        assert want == (not kwargs["fused"]), kwargs
        assert got, kwargs
        if not kwargs["fused"]:
            assert got == want, kwargs


def test_oracles_equal_reference():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 12, (50, 9)).astype(np.int32)
    lut = rng.normal(size=(4, 9, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tref.lut16_adc_ref(torch.from_numpy(codes), torch.from_numpy(lut)),
        np.asarray(jref.lut16_adc_ref(jnp.asarray(codes), jnp.asarray(lut))),
        rtol=RTOL, atol=ATOL)
    q = rng.normal(size=(6, 40)).astype(np.float32)
    x = rng.normal(size=(30, 40)).astype(np.float32)
    np.testing.assert_allclose(
        tref.block_sparse_ref(torch.from_numpy(q), torch.from_numpy(x)),
        np.asarray(jref.block_sparse_ref(jnp.asarray(q), jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)
    xm = _block_sparse(rng, 256, 256, 64, 64, 0.4)
    tiles, ptr, col = dense_to_bcsr(xm, 64, 64)
    got = tref.bcsr_to_dense_ref(torch.from_numpy(tiles),
                                 torch.from_numpy(ptr),
                                 torch.from_numpy(col), 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.bcsr_to_dense_ref(tiles, ptr, col, 256)))
    np.testing.assert_array_equal(got.numpy(), xm)


def test_serve_exports_cache_infos():
    for name in ("CacheInfo", "JitCacheInfo", "HybridLMHead",
                 "HybridHeadParams"):
        assert name in tserve.__all__
    for name in ("CacheInfo", "JitCacheInfo"):
        fields = [f.name for f in dataclasses.fields(getattr(tserve, name))]
        assert fields == [f.name for f in dataclasses.fields(
            getattr(jserve, name))]
    info = tserve.CacheInfo(hits=3, misses=1, evictions=0, size=1, capacity=4)
    assert info.hit_rate == jserve.CacheInfo(3, 1, 0, 1, 4).hit_rate == 0.75
