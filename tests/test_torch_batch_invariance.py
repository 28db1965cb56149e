"""A query's search result does not depend on its batch: the fixed-order
kernels R0-R3 (``csrc/residual.cu``) through their plain versions on the
CPU.

* ``ref.fixed_order_sum`` against a numpy walk of the kernels' order (lane
  j adds terms j, j + 32, ... from +0, then the xor butterfly), bit for
  bit;
* R0-R2's plain versions against the JAX package's ``adc_lut``,
  ``dense_residual_scores`` and ``sparse_residual_scores`` (rtol 1e-5 /
  atol 1e-4: the two sum in different orders), at d or R of 1, 31, 33
  and 200, C = 1, pad entries, candidate ids of -1 and >= N (clipped);
  R3's against an f32 and a bf16 einsum;
* each plain version's rows at Q = 1 against the same rows at Q = 7 and in
  a zero-padded bucket of 8, bit for bit;
* on the ``cuda`` and ``cuda-packed`` backends over CPU tensors: a lone
  query's three-pass result against its row of the batch (fused and
  materialised), ``QueryService``'s scores and ids (buckets 1, 8, 32)
  against the engine's bit for bit (the reference's own test asks
  allclose), and the PQ head's ``approx_topk_bucketed`` against
  ``approx_topk`` bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import ATOL, RTOL

from repro.core.pq import PQCodebooks as JaxCodebooks
from repro.core.pq import ScalarQuant as JaxScalarQuant
from repro.core.pq import adc_lut as jax_adc_lut
from repro.core.residual import dense_residual_scores as jax_dense_residual
from repro.core.residual import sparse_residual_scores as jax_sparse_residual
from repro.core.sparse_index import PaddedSparseRows as JaxRows
from repro_torch.core.engine import Backend, ScoringEngine
from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
from repro_torch.core.sparse_index import sparse_queries_to_padded
from repro_torch.data import make_hybrid_dataset
from repro_torch.kernels import ops, ref
from repro_torch.serve import HybridLMHead, QueryService

WIDTHS = [1, 31, 33, 200]


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _walk(x: np.ndarray) -> np.float32:
    """The kernels' order, one f32 add at a time."""
    lanes = [np.float32(0.0)] * 32
    for i, v in enumerate(x):
        lanes[i % 32] = np.float32(lanes[i % 32] + v)
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [np.float32(a + b) for a, b in zip(lanes[:half],
                                                    lanes[half:])]
    return lanes[0]


@pytest.mark.parametrize("length", [1, 31, 32, 33, 64, 200])
def test_fixed_order_sum_walks_the_kernel_order(length):
    rng = np.random.default_rng(length)
    x = _f32(rng, 5, length) * np.float32(10.0) ** rng.integers(
        -3, 4, (5, length)).astype(np.float32)
    x[0, 0] = -0.0
    got = ref.fixed_order_sum(torch.from_numpy(x)).numpy()
    want = np.array([_walk(r) for r in x], np.float32)
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()


@pytest.mark.parametrize("d,k", [(1, 1), (31, 31), (31, 1), (33, 11),
                                 (200, 100)])
def test_adc_lut_plain_matches_jax(d, k):
    rng = np.random.default_rng(d + k)
    q, centers = _f32(rng, 5, d), _f32(rng, k, 16, d // k)
    got = ops.adc_lut(torch.from_numpy(q), torch.from_numpy(centers))
    want = jax_adc_lut(jnp.asarray(q), JaxCodebooks(jnp.asarray(centers)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _dense_case(d, c, seed=0, n=40, q=5):
    rng = np.random.default_rng(seed + d + c)
    rows = rng.integers(-128, 128, (n, d)).astype(np.int8)
    scale = (rng.random(d) * 0.02 + 1e-3).astype(np.float32)
    zero = _f32(rng, d)
    cand = rng.integers(0, n, (q, c)).astype(np.int32)
    cand[0, 0] = -1
    cand[-1, -1] = n + 3
    return rows, scale, zero, cand, _f32(rng, q, d)


@pytest.mark.parametrize("c", [1, 9])
@pytest.mark.parametrize("d", WIDTHS)
def test_dense_residual_plain_matches_jax(d, c):
    rows, scale, zero, cand, q = _dense_case(d, c)
    got = ops.dense_residual(*map(torch.from_numpy, (rows, scale, zero, cand,
                                                      q)))
    want = jax_dense_residual(
        JaxScalarQuant(jnp.asarray(rows), jnp.asarray(scale),
                       jnp.asarray(zero)), jnp.asarray(cand), jnp.asarray(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _sparse_case(r, c, seed=0, n=40, d_active=300, q=5):
    rng = np.random.default_rng(seed + r + c)
    cols = rng.integers(0, d_active, (n, r)).astype(np.int32)
    vals = _f32(rng, n, r)
    pad = rng.random((n, r)) < 0.3
    cols[pad], vals[pad] = d_active, 0.0
    cols[1] = d_active                                  # an all-pad row
    vals[1] = 0.0
    cand = rng.integers(0, n, (q, c)).astype(np.int32)
    cand[0, 0] = -1
    cand[-1, -1] = n
    q_cols = _f32(rng, q, d_active + 1)
    q_cols[:, d_active] = 0.0
    return cols, vals, cand, q_cols


@pytest.mark.parametrize("c", [1, 9])
@pytest.mark.parametrize("r", WIDTHS)
def test_sparse_residual_plain_matches_jax(r, c):
    cols, vals, cand, q_cols = _sparse_case(r, c)
    got = ops.sparse_residual(*map(torch.from_numpy, (cols, vals, cand,
                                                       q_cols)))
    want = jax_sparse_residual(JaxRows(jnp.asarray(cols), jnp.asarray(vals)),
                               jnp.asarray(cand), jnp.asarray(q_cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_gathered_dot_plain_matches_einsum(d, bf16):
    rng = np.random.default_rng(d)
    rows, q = _f32(rng, 40, d), _f32(rng, 5, d)
    cand = rng.integers(-2, 43, (5, 9)).astype(np.int32)
    got = ops.gathered_dot(torch.from_numpy(rows), torch.from_numpy(cand),
                           torch.from_numpy(q), bf16_rows=bf16)
    r = rows[np.clip(cand, 0, 39)]
    if bf16:
        r = np.asarray(jnp.asarray(r).astype(jnp.bfloat16).astype(
            jnp.float32))
    want = np.einsum("qd,qcd->qc", q.astype(np.float64), r.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _calls(d):
    """Each plain version as fn(query rows) -> its (Q, ...) output, on
    arrays of width d, candidates (Q, 9) that repeat for every query."""
    rows, scale, zero, cand, _ = _dense_case(d, 9, q=1)
    cols, vals, _, _ = _sparse_case(d, 9, q=1)
    cand = torch.from_numpy(cand)
    k = {1: 1, 31: 31, 33: 11, 200: 100}[d]
    centers = torch.from_numpy(_f32(np.random.default_rng(1), k, 16, d // k))
    f_rows = torch.from_numpy(_f32(np.random.default_rng(2), 40, d))
    rows, scale, zero = map(torch.from_numpy, (rows, scale, zero))
    cols, vals = torch.from_numpy(cols), torch.from_numpy(vals)
    return {
        "adc_lut": lambda q: ops.adc_lut(q, centers),
        "dense_residual": lambda q: ops.dense_residual(
            rows, scale, zero, cand.expand(q.shape[0], -1), q),
        "gathered_dot": lambda q: ops.gathered_dot(
            f_rows, cand.expand(q.shape[0], -1), q),
        "sparse_residual": lambda q: ops.sparse_residual(
            cols, vals, cand.expand(q.shape[0], -1),
            torch.nn.functional.pad(q, (0, 300 + 1 - d))),
    }


@pytest.mark.parametrize("d", WIDTHS)
def test_rows_alone_equal_rows_in_a_batch(d):
    q = torch.from_numpy(_f32(np.random.default_rng(d), 7, d))
    bucket = torch.cat([q[:1], torch.zeros((7, d))])
    for name, fn in _calls(d).items():
        batch = fn(q)
        for i in range(7):
            assert torch.equal(fn(q[i:i + 1])[0], batch[i]), (name, i)
        assert torch.equal(fn(bucket)[0], batch[0]), name


@pytest.fixture(scope="module")
def slice_index():
    ds = make_hybrid_dataset(num_points=3000, num_queries=16, d_sparse=5000,
                             d_dense=32, nnz_per_row=30, seed=1)
    params = HybridIndexParams(keep_top=64, head_dims=32, kmeans_iters=4,
                               nq_max=64, backend="cuda")
    idx = HybridIndex.build(ds.x_sparse, ds.x_dense, params, device="cpu")
    qd, qv = sparse_queries_to_padded(ds.q_sparse, idx.cols, nq_max=64)
    return idx, (qd, qv, np.asarray(ds.q_dense, np.float32))


KW = dict(h=10, alpha=10, beta=4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "materialised"])
@pytest.mark.parametrize("backend", ["cuda", "cuda-packed"])
def test_three_pass_alone_equals_its_batch_row(slice_index, backend, fused):
    idx, queries = slice_index
    arrays = idx.engine.arrays
    if backend == "cuda-packed":
        arrays = dataclasses.replace(arrays, codes=torch.from_numpy(
            ops.pack_codes(arrays.codes.numpy())), codes_packed=True)
    eng = ScoringEngine(arrays=arrays, backend=Backend.from_name(backend),
                        fused=fused)
    qd, qv, qe = map(torch.from_numpy, queries)
    ops.reset_counts()
    batch = eng.search(qd, qv, qe, **KW)
    assert all(ref.PLAIN_CALLS[k] == 1 for k in (
        "adc_lut", "dense_residual", "sparse_residual"))
    for i in range(qd.shape[0]):
        alone = eng.search(qd[i:i + 1], qv[i:i + 1], qe[i:i + 1], **KW)
        for got, want in zip(alone, batch):
            assert torch.equal(got[0], want[i]), (backend, i)


def test_query_service_equals_the_engine_bit_for_bit(slice_index):
    idx, (qd, qv, qe) = slice_index
    want_s, want_i, _ = idx.engine.search(
        *map(torch.from_numpy, (qd, qv, qe)), **KW)
    want_s, want_i = want_s.numpy(), idx.pi[want_i.numpy()]
    svc = QueryService(idx.engine, id_map=idx.pi, buckets=(1, 8, 32),
                       cache_size=64, device="cpu", **KW)
    rng = np.random.default_rng(5)
    try:
        for size in (1, 3, 8, 9, 16, 1, 5):
            rows = rng.integers(0, qd.shape[0], size)
            s, i = svc.search(qd[rows], qv[rows], qe[rows])
            np.testing.assert_array_equal(s, want_s[rows])
            np.testing.assert_array_equal(i, want_i[rows])
        assert set(svc.jit_cache_info().batch_shapes) <= {1, 8, 32}
    finally:
        svc.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["cuda", "cuda-packed"])
def test_head_bucketed_equals_plain_calls(backend, dtype):
    import types
    rng = np.random.default_rng(3)
    d, v = 48, 400
    head = HybridLMHead(types.SimpleNamespace(dtype=dtype), backend=backend)
    hp = head.build(torch.from_numpy(_f32(rng, d, v) / np.float32(7.0)),
                    iters=3, device="cpu")
    hidden = torch.from_numpy(_f32(rng, 40, d))
    for b in (1, 3, 20, 40):
        want = head.approx_topk(hp, hidden[:b], None, 10, 8)
        got = head.approx_topk_bucketed(hp, hidden[:b], None, 10, 8)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        alone = head.approx_topk(hp, hidden[b - 1:b], None, 10, 8)
        assert torch.equal(alone[0][0], want[0][-1])
        assert torch.equal(alone[1][0], want[1][-1])
