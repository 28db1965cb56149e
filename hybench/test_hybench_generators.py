"""The data makers' generators: deterministic by seed, at the configured
shapes and with the configured statistics."""

import numpy as np
import torch

from hybench.conftest import TINY_QUERYSIM, TINY_SHARD
from hybench.makers import querysim, shard


def _cfg(bench, name, tiny):
    return {**bench.cell(name).config, **tiny}


def test_shard_arrays_by_seed(bench):
    cfg = _cfg(bench, "shard1b-batch32", TINY_SHARD)
    a = shard.draw_shard(cfg, 2**33 + 3, "cpu")
    b = shard.draw_shard(cfg, 2**33 + 3, "cpu")
    c = shard.draw_shard(cfg, 2**33 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["codes"], c["codes"])
    n, k, d = cfg["num_points"], cfg["pq_subspaces"], cfg["d_dense"]
    assert a["codes"].shape == (n, k) and a["codes"].dtype == torch.uint8
    assert int(a["codes"].max()) < cfg["pq_codes"]
    assert a["centers"].shape == (k, cfg["pq_codes"], d // k)
    assert a["inv_rows"].shape == (cfg["d_active"], cfg["l_max"])
    assert 0 <= int(a["inv_rows"].min()) and int(a["inv_rows"].max()) < n
    assert a["res_q"].dtype == torch.int8 and a["res_q"].shape == (n, d)
    assert a["sres_cols"].shape == (n, cfg["r_max"])
    assert int(a["sres_cols"].max()) <= cfg["d_active"]


def test_shard_queries_distinct_dims(bench):
    cfg = _cfg(bench, "shard1b-batch32", TINY_SHARD)
    q = shard.draw_queries(cfg, 77, 300, "cpu", chunk=128)
    assert torch.equal(q["dims"], shard.draw_queries(cfg, 77, 300, "cpu",
                                                     chunk=128)["dims"])
    dims = q["dims"].numpy()
    assert dims.shape == (300, cfg["nq"])
    assert all(len(set(r)) == cfg["nq"] for r in dims)
    assert dims.min() >= 0 and dims.max() < cfg["d_active"]


def test_querysim_corpus_by_seed(later_bench):
    cfg = _cfg(later_bench, "querysim524k-ragged1", TINY_QUERYSIM)
    a = querysim.draw_corpus(cfg, 2**33 + 9, 200, "cpu")
    b = querysim.draw_corpus(cfg, 2**33 + 9, 200, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    n, d = cfg["num_points"], cfg["d_sparse"]
    ip = a["indptr"]
    assert ip.shape == (n + 1,) and int(ip[-1]) == a["cols"].numel()
    x = querysim._csr(a["indptr"], a["cols"], a["vals"], (n, d))
    assert x.has_sorted_indices and x.sum_duplicates() is None
    # mean entries a row: the sum of the capped activity probabilities
    pj = np.arange(1, d + 1, dtype=np.float64) ** -cfg["alpha_powerlaw"]
    pj = np.minimum(pj * cfg["nnz_per_row"] / pj.sum(), 1.0)
    want = pj[pj > 1e-7].sum()
    assert abs(x.nnz / n - want) < 0.05 * want
    med = float(np.median(x.data))
    assert abs(med - cfg["value_median"]) < 0.1 * cfg["value_median"]
    assert a["x_dense"].shape == (n, cfg["d_dense"])
    q = querysim._csr(a["q_indptr"], a["q_cols"], a["q_vals"], (200, d))
    assert q.has_sorted_indices and q.nnz >= 200
    assert a["q_dense"].shape == (200, cfg["d_dense"])
