"""The port's baselines (repro_torch.core.baselines) and
``HybridIndex.exact_scores`` against the JAX package's, on the CPU.

The same numpy inputs go through both.  The reference's top-k orders equal
scores arbitrarily (``np.argpartition`` + a non-stable sort) and the two
packages sum in different orders, so scores are held within rtol 1e-5,
atol 1e-4 and ids tie-aware (``assert_topk_match``), except where the
arithmetic is the same: ``sparse_inverted_index`` takes the reference's
float32 adds in its order, so its scores are equal bit for bit.  Random
draws are the reference's: ``hamming512`` draws its signs from the same
numpy generator, and ``dense_pq_reorder`` is fed the JAX package's
codebooks."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from _torch_port_helpers import ATOL, RTOL, assert_topk_match

from repro.core import baselines as jbl
from repro.core import pq as jpq
from repro.core.hybrid import HybridIndex as JaxHybridIndex
from repro.core.sparse_index import build_padded_rows as jax_padded_rows
from repro_torch.core import baselines as bl
from repro_torch.core.hybrid import HybridIndex
from repro_torch.core.pq import PQCodebooks
from repro_torch.core.sparse_index import build_padded_rows
from repro_torch.data import make_hybrid_dataset

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ds():
    return make_hybrid_dataset(num_points=2400, num_queries=12,
                               d_sparse=4000, d_dense=32, nnz_per_row=30,
                               seed=11)


def _args(ds):
    return ds.q_sparse, ds.q_dense, ds.x_sparse, ds.x_dense


def _check(got, want):
    assert got.name == want.name
    assert got.ids.shape == want.ids.shape and got.ids.dtype == np.int64
    assert got.scores.dtype == np.float32
    assert got.seconds > 0 and got.build_seconds >= 0
    assert_topk_match(got.scores, got.ids, want.scores, want.ids)


def test_result_fields_extend_the_reference():
    want = [f.name for f in dataclasses.fields(jbl.BaselineResult)]
    got = [f.name for f in dataclasses.fields(bl.BaselineResult)]
    assert got[:len(want)] == want and got[len(want):] == ["build_seconds"]
    for name in jbl.__all__:
        assert callable(getattr(bl, name)), name


def test_hybrid_as_sparse_equals_reference(ds):
    """The same CSR, entry for entry, with zeros in the dense block
    dropped as scipy drops them."""
    xd = ds.x_dense.copy()
    xd[::7, 3] = 0.0
    xd[5] = 0.0
    got = bl._hybrid_as_sparse(ds.x_sparse, xd, device="cpu")
    want = jbl._hybrid_as_sparse(ds.x_sparse, xd)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.crow_indices().numpy(), want.indptr)
    assert np.array_equal(got.col_indices().numpy(), want.indices)
    assert np.array_equal(got.values().numpy(), want.data)


@pytest.mark.parametrize("block", [None, 120])
def test_dense_rows_equal_toarray(monkeypatch, block):
    """Densifying in row blocks (block = 120 elements: 2 rows of 51 at a
    time) gives scipy's toarray(), duplicated entries summed."""
    if block:
        monkeypatch.setattr(bl, "_DENSE_BLOCK", block)
    x = sp.random(37, 50, density=0.2, format="csr", dtype=np.float32,
                  random_state=1)
    coo = x.tocoo()
    rows = np.r_[coo.row, 3, 3]                # row 3: col 7 twice more
    order = np.argsort(rows, kind="stable")
    dup = sp.csr_matrix(
        (np.r_[coo.data, 1.5, 2.5][order], np.r_[coo.col, 7, 7][order],
         np.r_[0, np.cumsum(np.bincount(rows, minlength=37))]),
        shape=x.shape)
    assert not dup.has_canonical_format
    got = bl._dense_rows(bl._upload_csr(dup, CPU), pad=True).numpy()
    assert np.array_equal(got[:, :50], dup.toarray())
    assert not got[:, 50].any()


@pytest.mark.parametrize("r_max", [None, 20])
def test_build_padded_rows_equals_reference(ds, r_max):
    """The rerank's padded rows; r_max = 20 truncates the longer rows to
    their largest values, as the reference does."""
    got = build_padded_rows(ds.x_sparse, r_max, device="cpu")
    want = jax_padded_rows(ds.x_sparse, r_max)
    assert np.array_equal(got.cols.numpy(), np.asarray(want.cols))
    assert np.array_equal(got.vals.numpy(), np.asarray(want.vals))


@pytest.mark.parametrize("name", ["dense_brute_force", "sparse_brute_force",
                                  "sparse_inverted_index"])
def test_exact_baselines_match_reference(ds, name):
    got = getattr(bl, name)(*_args(ds), 20, device="cpu")
    want = getattr(jbl, name)(*_args(ds), 20)
    _check(got, want)
    true_ids, _ = bl.exact_topk(*_args(ds), 20, device="cpu")
    assert bl.recall_at_h(got.ids, true_ids) == 1.0
    if name == "sparse_inverted_index":
        assert torch.equal(torch.from_numpy(got.scores),
                           torch.from_numpy(want.scores))


def _reference_hamming_index(ds, bits=512, seed=0):
    """The reference's hamming512 index side, line for line."""
    rng = np.random.default_rng(seed)
    r_s = rng.choice([-1.0, 1.0], size=(ds.x_sparse.shape[1], bits)
                     ).astype(np.float32)
    r_d = rng.choice([-1.0, 1.0], size=(ds.x_dense.shape[1], bits)
                     ).astype(np.float32)
    xp = np.asarray(ds.x_sparse @ r_s) + np.asarray(ds.x_dense,
                                                    np.float32) @ r_d
    med = np.median(xp, axis=0)
    qp = np.asarray(ds.q_sparse @ r_s) + ds.q_dense @ r_d
    return xp, med, np.packbits(xp > med, axis=1), qp


def test_hamming_sign_bits_match_reference(ds):
    """The bits equal the reference's, except at projections within 1e-5
    relative of the median (the two packages sum the projection in
    different orders)."""
    xp, med, want_bits, _ = _reference_hamming_index(ds)
    _, got_med, got_bits = bl._hamming_index(ds.x_sparse, ds.x_dense, 512, 0,
                                             CPU)
    np.testing.assert_allclose(got_med.numpy(), med, rtol=1e-5, atol=1e-6)
    diff = np.unpackbits(got_bits.numpy() ^ want_bits, axis=1).astype(bool)
    near = np.abs(xp - med) <= 1e-5 * np.maximum(np.abs(med), np.abs(xp))
    assert not (diff & ~near).any()


@pytest.mark.parametrize("n,bits", [(2399, 64), (2400, 61)])
def test_pack_bits_and_median_equal_numpy(n, bits):
    """np.packbits' bit order (a last byte padded with zero bits); np.median's
    mean of the two middle values for an even count."""
    x = np.random.default_rng(n).normal(size=(n, bits)).astype(np.float32)
    med = bl._median_rows(torch.from_numpy(x)).numpy()
    assert np.array_equal(med, np.median(x, axis=0))
    bits = x > med
    assert np.array_equal(bl._pack_bits(torch.from_numpy(bits)).numpy(),
                          np.packbits(bits, axis=1))


def test_hamming_distances_equal_reference(ds):
    _, med, x_bits, qp = _reference_hamming_index(ds)
    q_bits = np.packbits(qp > med, axis=1)
    want = np.unpackbits(x_bits[None] ^ q_bits[:, None], axis=2).sum(axis=2)
    got = bl._hamming(torch.from_numpy(x_bits), torch.from_numpy(q_bits))
    assert np.array_equal(got.numpy(), want)


def test_rerank_exact_equals_reference(ds):
    cand = np.random.default_rng(3).choice(
        ds.x_sparse.shape[0], size=(ds.q_sparse.shape[0], 500))
    want = jbl._rerank_exact(cand, *_args(ds), 20)
    rows, dense = bl._rerank_index(ds.x_sparse, ds.x_dense, CPU)
    got = bl._rerank_exact(torch.from_numpy(cand), ds.q_sparse, ds.q_dense,
                           rows, dense, 20)
    assert_topk_match(got[1].numpy(), got[0].numpy(), want[1], want[0])


@pytest.mark.parametrize("overfetch", [None, 400])
def test_hamming512_matches_reference(ds, overfetch):
    """Every row overfetched (overfetch >= N): the candidates are the whole
    corpus in both, so the final ids are equal (tie-aware).  At 400 the
    candidates cut through Hamming-distance ties, which the reference orders
    arbitrarily: the port's result is held to an exact rerank of its own
    candidates."""
    n = ds.x_sparse.shape[0]
    got = bl.hamming512(*_args(ds), 20, overfetch=overfetch or n,
                        device="cpu")
    if overfetch is None:
        _check(got, jbl.hamming512(*_args(ds), 20, overfetch=n))
        return
    exact = np.asarray((ds.q_sparse @ ds.x_sparse.T).todense()) \
        + ds.q_dense @ ds.x_dense.T
    np.testing.assert_allclose(got.scores,
                               np.take_along_axis(exact, got.ids, 1),
                               rtol=RTOL, atol=ATOL)
    assert (np.diff(got.scores, axis=1) <= 0).all()


def test_dense_pq_reorder_matches_reference(ds, monkeypatch):
    """Fed the JAX package's codebooks, as the build tests feed the
    reference's k-means draws.  Four subspaces of 8 dims (the reference's
    ``subspaces`` argument): its k-means compiles once per subspace."""
    k = 4
    centers = np.array(jpq.train_codebooks(
        np.asarray(ds.x_dense, np.float32), k, 16, seed=0).centers)

    def reference_codebooks(x, num_subspaces, num_codes=16, **kw):
        assert (num_subspaces, num_codes) == (k, 16)
        return PQCodebooks(centers=torch.from_numpy(centers).to(x.device))

    monkeypatch.setattr(bl, "train_codebooks", reference_codebooks)
    got = bl.dense_pq_reorder(*_args(ds), 20, overfetch=600, subspaces=k,
                              device="cpu")
    _check(got, jbl.dense_pq_reorder(*_args(ds), 20, overfetch=600,
                                     subspaces=k))


@pytest.mark.parametrize("overfetch", [None, 300])
def test_sparse_only_matches_reference(ds, overfetch):
    got = bl.sparse_only(*_args(ds), 20, overfetch=overfetch, device="cpu")
    _check(got, jbl.sparse_only(*_args(ds), 20, overfetch=overfetch))


def test_exact_scores_match_reference(ds):
    """``HybridIndex.exact_scores``: q·x in original row order, numpy, on
    the index's device; the reference's method reads nothing of its
    index."""
    n = 400
    xs, xd = ds.x_sparse[:n], ds.x_dense[:n]
    idx = HybridIndex.build(xs, xd, device="cpu")
    got = idx.exact_scores(ds.q_sparse, ds.q_dense, xs, xd)
    want = JaxHybridIndex.exact_scores(None, ds.q_sparse, ds.q_dense, xs, xd)
    assert isinstance(got, np.ndarray) and got.shape == (12, n)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ids, _ = bl.exact_topk(ds.q_sparse, ds.q_dense, xs, xd, 5, device="cpu")
    assert np.array_equal(np.sort(ids, axis=1),
                          np.sort(np.argsort(-got, axis=1)[:, :5], axis=1))


def test_baselines_refuse_cuda_without_a_card(ds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bl.sparse_only(*_args(ds), 20)
