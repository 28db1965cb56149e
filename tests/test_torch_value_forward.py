"""The port's value-forward sparse scoring against the JAX package's, on
the CPU: repro_torch.kernels.ops.score_inverted_vf, and the stream it was
first ported as (the planner ``build_value_forward_stream`` and the stream
op ``ops.inverted_value_forward``).

The planner is a numpy copy, so its arrays must equal the JAX planner's
exactly.  The JAX kernel runs in Pallas interpret mode (as
tests/test_kernels.py runs it) and sums a chunk at a time on its one-hot
product: rtol 1e-5, atol 1e-5, the JAX package's own tolerance against
``score_inverted``.  The port's ``score_inverted_vf`` takes each (query,
row) sum in slot order, as the port's ``score_inverted`` does (on CPU
tensors it is that function), so those two must be equal bit for bit; so
must the planned stream through the stream op's plain version, which sums
in stream order (both kernels are held to the same on the card by
chip_smoke.py)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core.sparse_index import (
    build_compact_columns as jax_build_compact_columns)
from repro.core.sparse_index import (
    build_padded_inverted_index as jax_build_padded_inverted_index)
from repro.core.sparse_index import \
    build_value_forward_stream as jax_build_stream
from repro.kernels.ops import score_inverted_vf as jax_score_inverted_vf
from repro_torch.core.sparse_index import (PaddedInvertedIndex,
                                           build_value_forward_stream,
                                           score_inverted,
                                           sparse_queries_to_padded)
from repro_torch.kernels import ops, ref


def _problem(n, d, qn, *, seed, nq_max=32):
    """The toy problem of tests/test_kernels.py, built once by the JAX
    package and carried to the port as tensors."""
    x = sp.random(n, d, density=0.01, random_state=seed, format="csr")
    cols, xc = jax_build_compact_columns(x)
    jinv = jax_build_padded_inverted_index(xc)
    qs = sp.random(qn, d, density=0.02, random_state=seed + 1, format="csr")
    qd, qv = sparse_queries_to_padded(qs, cols, nq_max=nq_max)
    inv = PaddedInvertedIndex(rows=torch.from_numpy(np.array(jinv.rows)),
                              vals=torch.from_numpy(np.array(jinv.vals)),
                              num_points=jinv.num_points)
    return jinv, inv, qd, qv


def _vf_both(jinv, inv, qd, qv):
    """The JAX op, the port's op and its stream, each held to the JAX op
    within 1e-5 and to the port's ``score_inverted`` bit for bit; returns
    the port's op, the JAX op and ``score_inverted``."""
    want = np.asarray(jax_score_inverted_vf(jinv, qd, qv))
    got = ops.score_inverted_vf(inv, torch.from_numpy(qd),
                                torch.from_numpy(qv))
    si = score_inverted(inv, torch.from_numpy(qd), torch.from_numpy(qv))
    st = build_value_forward_stream(inv, qd, qv)
    streamed = ops.inverted_value_forward(
        st.ptr, st.rows, st.qidx, st.contrib, bq=st.bq, bn=st.bn,
        chunk=st.chunk, num_row_blocks=st.num_row_blocks)
    streamed = streamed[:st.num_queries, :st.num_points]
    assert tuple(streamed.shape) == want.shape
    np.testing.assert_allclose(streamed.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(streamed, si)
    return got, want, si


@pytest.mark.parametrize("n,d,qn,bq,bn,chunk", [
    (700, 500, 9, 8, 256, 64),
    (700, 500, 9, 8, 512, 128),
    (50, 80, 3, 4, 64, 16),
])
def test_planner_matches_jax(n, d, qn, bq, bn, chunk):
    jinv, inv, qd, qv = _problem(n, d, qn, seed=n + bn)
    want = jax_build_stream(jinv, qd, qv, bq=bq, bn=bn, chunk=chunk)
    got = build_value_forward_stream(inv, qd, qv, bq=bq, bn=bn, chunk=chunk)
    for name in ("ptr", "rows", "qidx", "contrib"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("num_points", "num_queries", "bq", "bn", "chunk",
                 "max_steps", "num_row_blocks"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("n,d,qn", [
    (700, 500, 9),         # N not a multiple of bn, Q not a multiple of bq
    (512, 200, 8),         # exact multiples
    (50, 80, 3),           # a single row block
])
def test_score_inverted_vf_matches_jax(n, d, qn):
    jinv, inv, qd, qv = _problem(n, d, qn, seed=n)
    ops.reset_counts()
    got, want, si = _vf_both(jinv, inv, qd, qv)
    assert ref.PLAIN_CALLS["score_inverted_vf"] == 1
    assert ref.PLAIN_CALLS["inverted_value_forward"] == 1
    assert ops.LAUNCHES["score_inverted_vf"] == 0           # CPU: plain
    assert ops.LAUNCHES["inverted_value_forward"] == 0
    assert tuple(got.shape) == want.shape == (qn, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, si)


def test_duplicate_dims_and_empty_query():
    """A query repeating a dim accumulates twice, in slot order; an all-pad
    query scores exactly zero everywhere."""
    jinv, inv, qd, qv = _problem(300, 150, 4, seed=9)
    qd[0, 1] = qd[0, 0]
    qv[0, 1] = 0.5
    qd[2, :] = inv.rows.shape[0]
    qv[2, :] = 0.0
    got, want, si = _vf_both(jinv, inv, qd, qv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, si)
    assert bool((got[2] == 0.0).all())


def test_plain_version_sums_in_stream_order_with_empty_segments():
    """A hand-made stream: row blocks with no entries score zero, pad
    entries (row bn) add nothing, and repeated (query, row) entries are
    added in stream order from +0."""
    bq, bn, chunk, nb = 2, 4, 4, 3
    # q-block 0: block 0 empty, block 1 one chunk, block 2 empty
    rows = torch.tensor([[1, 1, 1, 3, bn, bn, bn, bn]], dtype=torch.int32)
    qidx = torch.tensor([[0, 0, 0, 1, 0, 0, 0, 0]], dtype=torch.int32)
    contrib = torch.tensor([[1.0, 1e8, -1e8, 2.5, 9.0, 0, 0, 0]])
    ptr = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    out = ref.inverted_value_forward_plain(ptr, rows, qidx, contrib, bq=bq,
                                           bn=bn, chunk=chunk,
                                           num_row_blocks=nb)
    want = torch.zeros((bq, nb * bn))
    want[1, bn + 3] = 2.5          # and want[0, bn + 1] == (1 + 1e8) - 1e8
    assert torch.equal(out, want)
