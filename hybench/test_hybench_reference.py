"""The plain reference held to ``repro_torch`` at a tiny size on the CPU.
The test imports both; ``hybench/reference.py`` imports neither."""

import numpy as np
import scipy.sparse as sp
import torch

from hybench import reference
from hybench.conftest import TINY_QUERYSIM, TINY_SHARD
from hybench.makers import querysim, shard
from repro_torch.core.engine import (Backend, IndexArrays, ScoringEngine)
from repro_torch.core.pq import (PQCodebooks, ScalarQuant, pq_encode,
                                 scalar_dequantize, scalar_quantize)
from repro_torch.core.pruning import prune_split
from repro_torch.core.sparse_index import (PaddedInvertedIndex,
                                           PaddedSparseRows)


def _ids_scores_close(ref_s, ref_i, got_s, got_i):
    assert np.array_equal(np.sort(ref_i, 1), np.sort(got_i, 1))
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-5, atol=1e-5)


def test_shard_reference_matches_the_engine(bench):
    cfg = {**bench.cell("shard1b-batch32").config, **TINY_SHARD}
    a = shard.draw_shard(cfg, 123, "cpu")
    q = shard.draw_queries(cfg, 123, 12, "cpu")
    n = cfg["num_points"]
    arrays = IndexArrays.build(
        codebooks=PQCodebooks(centers=a["centers"]), codes=a["codes"],
        inv_index=PaddedInvertedIndex(rows=a["inv_rows"],
                                      vals=a["inv_vals"], num_points=n),
        head=None, dense_residual=ScalarQuant(
            q=a["res_q"], scale=a["res_scale"], zero=a["res_zero"]),
        sparse_residual=PaddedSparseRows(cols=a["sres_cols"],
                                         vals=a["sres_vals"]),
        num_points=n, d_active=cfg["d_active"], with_bcsr=False)
    eng = ScoringEngine(arrays=arrays, backend=Backend.CUDA)
    s, i, _ = eng.search(q["dims"], q["vals"], q["dense"], h=cfg["h"],
                         alpha=cfg["alpha"], beta=cfg["beta"])
    data = reference.ShardData(**{k: a[k] for k in (
        "codes", "centers", "inv_rows", "inv_vals", "res_q", "res_scale",
        "res_zero", "sres_cols", "sres_vals")})
    sc = reference.ShardScorer(data, q["dims"], q["vals"], q["dense"], "f64")
    c1, c2 = eng.candidate_counts(cfg["h"], cfg["alpha"], cfg["beta"])
    rs, ri = reference.three_pass(sc, h=cfg["h"], c1=c1, c2=c2,
                                  block=1000)[:2]
    _ids_scores_close(rs.numpy(), ri.numpy(), s.numpy(), i.numpy())
    got = reference.judge(sc, i.long(), s, h=cfg["h"], c1=c1, c2=c2,
                          block=3000)
    assert got["rank_gap"] == 0.0 and got["score_err"] < 1e-6
    bad = i.long().clone()
    bad[:, 0] = -1
    assert reference.judge(sc, bad, s, h=cfg["h"], c1=c1, c2=c2,
                           block=3000)["rank_gap"] == float("inf")


def test_pruning_and_quantization_match_the_build():
    rng = np.random.default_rng(4)
    x = sp.random(600, 50, density=0.3, random_state=5, format="csr",
                  dtype=np.float32)
    x.data = rng.lognormal(-3, 1.1, x.nnz).astype(np.float32)
    split = prune_split(x, keep_top=40)
    coo = x.tocoo()
    keep = reference.prune_mask(torch.from_numpy(coo.col.astype(np.int64)),
                                torch.from_numpy(coo.data), 50, 40)
    want = np.asarray(split.index[coo.row, coo.col]).ravel() != 0
    assert np.array_equal(keep.numpy(), want)
    dense = torch.randn(300, 12)
    assert torch.equal(reference.scalar_dequantized(dense),
                       scalar_dequantize(scalar_quantize(dense)))


def test_codes_far_sees_wrong_codes():
    x = torch.randn(500, 8)
    centers = torch.randn(4, 16, 2)
    codes = pq_encode(x, PQCodebooks(centers=centers))
    assert reference.codes_far(x, codes, centers) == 0
    wrong = codes.clone()
    wrong[:50, 0] = (wrong[:50, 0] + 1) % 16
    assert reference.codes_far(x, wrong, centers) == 50


def test_querysim_reference_matches_the_service(later_bench):
    from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
    from repro_torch.core.sparse_index import sparse_queries_to_padded
    cfg = {**later_bench.cell("querysim524k-ragged1").config, **TINY_QUERYSIM}
    n, d = cfg["num_points"], cfg["d_sparse"]
    c = querysim.draw_corpus(cfg, 31, 10, "cpu")
    idx = HybridIndex.build(
        querysim._csr(c["indptr"], c["cols"], c["vals"], (n, d)),
        c["x_dense"].numpy(),
        HybridIndexParams(keep_top=cfg["keep_top"],
                          head_dims=cfg["head_dims"], kmeans_iters=4),
        device="cpu")
    qs = querysim._csr(c["q_indptr"], c["q_cols"], c["q_vals"], (10, d))
    dims, vals = sparse_queries_to_padded(qs, idx.cols, nq_max=256)
    s, i, _ = idx.engine.search(torch.from_numpy(dims),
                                torch.from_numpy(vals), c["q_dense"],
                                h=cfg["h"], alpha=cfg["alpha"],
                                beta=cfg["beta"])
    ids = idx.pi[i.numpy()]
    codes = torch.empty_like(idx.codes)
    codes[torch.from_numpy(idx.pi)] = idx.codes
    data = reference.RawData.derive(c["indptr"], c["cols"], c["vals"],
                                    c["x_dense"], d, cfg["keep_top"], codes,
                                    idx.codebooks.centers)
    sc = reference.RawScorer(data, c["q_indptr"], c["q_cols"], c["q_vals"],
                             c["q_dense"], "f64")
    c1, c2 = idx.engine.candidate_counts(cfg["h"], cfg["alpha"],
                                         cfg["beta"])
    rs, ri = reference.three_pass(sc, h=cfg["h"], c1=c1, c2=c2,
                                  block=700)[:2]
    _ids_scores_close(rs.numpy(), ri.numpy(), s.numpy(), ids)


def test_rounding_to_a_precision():
    x = torch.randn(1000) * 100
    for prec, bits in (("tf32", 10), ("bf16", 7)):
        r = reference.rounded(x, prec)
        assert r.dtype == torch.float32
        rel = ((r - x).abs() / x.abs()).max()
        assert 0 < rel <= 2.0 ** -(bits + 1)
    assert reference.rounded(x, "f64").dtype == torch.float64


class _Terms:
    """A scorer of one query over 6 rows with given pass terms."""

    def __init__(self, a, d, s):
        self.a, self.d, self.s = (torch.tensor(x, dtype=torch.float64)
                                  for x in (a, d, s))
        self.n, self.q, self.lut = len(a), 1, self.a

    def approx(self, lo, hi):
        return self.a[None, lo:hi].clone()

    def dense(self, ids):
        return self.d[ids]

    def sparse(self, ids):
        return self.s[ids]


def test_near_ties_at_a_cut_go_either_way():
    # rows 2 and 3 tie at the pass-1 cut (c1 = 3); row 3 wins after pass 2
    sc = _Terms([10, 9, 8, 8, 1, 0], [0, 0, 0, 5, 0, 0], [0] * 6)
    for row, score in ((0, 10.0), (3, 13.0)):
        got = reference.judge(sc, torch.tensor([[row]]),
                              torch.tensor([[score]]), h=1, c1=3, c2=2,
                              block=4)
        assert got["rank_gap"] == 0.0 and got["score_err"] == 0.0
    got = reference.judge(sc, torch.tensor([[1]]), torch.tensor([[9.0]]),
                          h=1, c1=3, c2=2, block=4)
    assert got["rank_gap"] >= 0.07           # (10 - 9) over 10 or 13
    assert [w.tolist() for w in reference._ways(
        torch.tensor([5.0, 4.0, 3.0, 3.0, 2.0]), 3, 1e-3)] == [[0, 1, 2],
                                                               [0, 1, 3]]


def test_a_repeated_id_is_not_an_answer():
    # the best row returned twice and the second dropped: every returned
    # score is its id's true score and at or above the reference's
    sc = _Terms([10, 9, 8, 7, 1, 0], [0] * 6, [0] * 6)
    kw = dict(h=2, c1=4, c2=3, block=4)
    got = reference.judge(sc, torch.tensor([[0, 1]]),
                          torch.tensor([[10.0, 9.0]]), **kw)
    assert got["rank_gap"] == 0.0 and got["score_err"] == 0.0
    got = reference.judge(sc, torch.tensor([[0, 0]]),
                          torch.tensor([[10.0, 10.0]]), **kw)
    assert got["rank_gap"] == float("inf")
    assert got["score_err"] == float("inf")
    assert reference.repeats(torch.tensor([[4, 2, 4, -1, -1, 2]])).tolist() \
        == [[False, False, True, False, True, True]]
