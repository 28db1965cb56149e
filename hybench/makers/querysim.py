"""A corpus with the paper's QuerySim statistics (§7.1.2), built by
``HybridIndex.build`` and served through ``QueryService``.

The corpus and the queries are drawn on the device from the seed with the
distributions of the paper's synthetic data (the JAX package's
``make_hybrid_dataset``): sparse dimension j active with probability
P_j ∝ j^-alpha (scaled to ``nnz_per_row`` and capped at 1), log-normal
values (median 0.054, sigma 1.1); dense vectors a rank-16 Gaussian mixing
plus noise, scaled by ``dense_weight``; each query a perturbed copy of a
random row (values times U(0.7, 1.3), dense noise 0.2) plus power-law
entries of its own at 0.3 of the row density.  The arrays differ from the
host generator's, the distributions do not.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from hybench import reference
from hybench.built import Built, Pools
from hybench.costs import SearchShape, candidate_counts
from hybench.makers import serving


def powerlaw_rows(g, n: int, d: int, alpha: float, target_nnz: float,
                  median: float, sigma: float, device,
                  chunk_elems: int = 1 << 28):
    """(rows, cols, vals) of an (n, d) matrix with dimension j active with
    probability min(1, c·j^-alpha) (dims with probability <= 1e-7 never),
    sorted by row then column; values log-normal."""
    pj = torch.arange(1, d + 1, dtype=torch.float64) ** -alpha
    pj = torch.clamp(pj * (target_nnz / pj.sum()), max=1.0)
    act = torch.nonzero(pj > 1e-7).flatten()
    p = pj[act].float().to(device)
    act = act.to(device)
    step = max(1, chunk_elems // max(n, 1))
    rows, cols = [], []
    for s in range(0, act.numel(), step):
        hit = torch.rand((n, min(step, act.numel() - s)), generator=g,
                         device=device) < p[s:s + step]
        r, c = hit.nonzero(as_tuple=True)
        rows.append(r)
        cols.append(act[s + c])
    rows = torch.cat(rows)
    cols = torch.cat(cols)
    order = torch.argsort(rows * d + cols)
    vals = torch.exp(math.log(median) + sigma * torch.randn(
        rows.numel(), generator=g, device=device))
    return rows[order], cols[order], vals


def indptr_of(rows: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=torch.long, device=rows.device),
                      torch.cumsum(torch.bincount(rows, minlength=n), 0)])


def draw_corpus(cfg: dict, seed: int, queries: int, device) -> dict:
    """The corpus (CSR on the device, dense vectors) and ``queries``
    related queries (CSR, dense)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    n, d, dd = cfg["num_points"], cfg["d_sparse"], cfg["d_dense"]
    a, med, sig = cfg["alpha_powerlaw"], cfg["value_median"], \
        cfg["value_sigma"]
    rows, cols, vals = powerlaw_rows(g, n, d, a, cfg["nnz_per_row"], med,
                                     sig, device)
    w = cfg["dense_weight"] / math.sqrt(dd)
    basis = torch.randn((cfg["dense_rank"], dd), generator=g, device=device)
    coef = torch.randn((n, cfg["dense_rank"]), generator=g, device=device)
    noise = torch.randn((n, dd), generator=g, device=device)
    x_dense = (coef.double() @ basis.double() + 0.3 * noise).float() * w
    indptr = indptr_of(rows, n)

    src = torch.randperm(n, generator=g, device=device)[:queries]
    lens = indptr[src + 1] - indptr[src]
    qrow = torch.repeat_interleave(torch.arange(queries, device=device),
                                   lens)
    first = torch.repeat_interleave(indptr[src], lens)
    within = torch.arange(qrow.numel(), device=device) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens)
    ent = first + within
    qv = vals[ent] * (0.7 + 0.6 * torch.rand(ent.numel(), generator=g,
                                             device=device))
    er, ec, ev = powerlaw_rows(g, queries, d, a, cfg["nnz_per_row"] * 0.3,
                               med, sig, device)
    key = torch.cat([qrow * d + cols[ent], er * d + ec])
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    qsum = torch.zeros(uniq.numel(), dtype=torch.float32, device=device)
    qsum.index_add_(0, inv, torch.cat([qv, ev]))
    q_dense = x_dense[src] + 0.2 * w * torch.randn(
        (queries, dd), generator=g, device=device)
    return {"indptr": indptr, "cols": cols, "vals": vals,
            "x_dense": x_dense, "q_indptr": indptr_of(uniq // d, queries),
            "q_cols": uniq % d, "q_vals": qsum, "q_dense": q_dense}


def _csr(indptr, cols, vals, shape):
    return sp.csr_matrix((vals.cpu().numpy(), cols.cpu().numpy(),
                          indptr.cpu().numpy()), shape=shape)


def build(cfg: dict, mix: dict, seed: int, device, trace: bool) -> Built:
    from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
    from repro_torch.core.sparse_index import sparse_queries_to_padded

    n, d = cfg["num_points"], cfg["d_sparse"]
    fresh_n, hot_n, warm_n = cfg["fresh_pool"], cfg["hot_pool"], \
        cfg["warm_rows"]
    nq_all = fresh_n + hot_n + warm_n
    c = draw_corpus(cfg, seed, nq_all, device)
    x_sparse = _csr(c["indptr"], c["cols"], c["vals"], (n, d))
    index = HybridIndex.build(
        x_sparse, c["x_dense"].cpu().numpy(),
        HybridIndexParams(keep_top=cfg["keep_top"],
                          head_dims=cfg["head_dims"],
                          kmeans_iters=cfg["kmeans_iters"],
                          nq_max=cfg["nq_max"], pq_codes=cfg["pq_codes"],
                          backend=cfg["backend"], seed=cfg["kmeans_seed"]),
        device=device)
    q_sparse = _csr(c["q_indptr"], c["q_cols"], c["q_vals"], (nq_all, d))
    dims, vals = sparse_queries_to_padded(q_sparse, index.cols,
                                          nq_max=cfg["nq_max"])
    widest = int((dims < index.cols.num_active).sum(1).max())
    if widest >= cfg["nq_max"]:
        raise ValueError(f"a query has {widest} active dims, at or past "
                         f"nq_max {cfg['nq_max']}: it would be cut")
    dense = c["q_dense"].cpu().numpy()
    cut = np.cumsum([0, fresh_n, hot_n, warm_n])
    fresh, hot, warm = (Pools(dims[a:b], vals[a:b], dense[a:b])
                        for a, b in zip(cut[:-1], cut[1:]))

    engine = index.engine
    hooks = serving.serve(engine, cfg, device, trace, index.pi)
    c1, c2 = candidate_counts(n, cfg["h"], cfg["alpha"], cfg["beta"])

    # the reference's view: the raw corpus, and of the build only the PQ
    # (centers, each row's codes) and the row order, put back in raw order
    k = index.codebooks.centers.shape[0]
    codes = index.codes
    if engine.arrays.codes_packed:
        codes = torch.stack([codes & 15, codes >> 4], -1).reshape(n, -1)
        codes = codes[:, :k]
    pi = torch.from_numpy(np.asarray(index.pi, np.int64)).to(device)
    order_ok = bool(torch.equal(torch.sort(pi).values,
                                torch.arange(n, device=device)))
    codes_raw = torch.empty_like(codes)
    codes_raw[pi] = codes
    centers = index.codebooks.centers.clone()
    data = reference.RawData.derive(
        c["indptr"], c["cols"], c["vals"], c["x_dense"], d, cfg["keep_top"],
        codes_raw, centers)

    def scorer(rows, precision):
        rows = np.asarray(rows)
        idx = np.where(rows >= 0, rows, fresh_n + (-1 - rows))
        sel = torch.from_numpy(idx).to(device)
        lo, hi = c["q_indptr"][sel], c["q_indptr"][sel + 1]
        lens = hi - lo
        ent = torch.repeat_interleave(lo, lens) + torch.arange(
            int(lens.sum()), device=device) - torch.repeat_interleave(
            torch.cumsum(lens, 0) - lens, lens)
        return reference.RawScorer(
            data, indptr_of(torch.repeat_interleave(
                torch.arange(len(idx), device=device), lens), len(idx)),
            c["q_cols"][ent], c["q_vals"][ent], c["q_dense"][sel], precision)

    def checks():
        far = reference.codes_far(c["x_dense"], codes_raw, centers)
        return {"build_faults": far + (0 if order_ok else n)}

    kept_per_col = torch.bincount(data.cols[data.kept.ne(0)],
                                  minlength=d + 1)
    qrows = c["q_indptr"][:fresh_n + 1]
    post = kept_per_col[c["q_cols"][:int(qrows[-1])]].double().sum()
    resid_nnz = float(data.resid.ne(0).sum())
    shape = SearchShape(
        n=n, k=k, l=cfg["pq_codes"], p=cfg["d_dense"] // k,
        d_dense=cfg["d_dense"], nq=cfg["nq_max"], h=cfg["h"], c1=c1, c2=c2,
        postings_per_row=float(post) / fresh_n,
        residual_per_row=resid_nnz / n)
    return Built(
        fresh=fresh, hot=hot, warm=warm, shape=shape, h=cfg["h"], c1=c1,
        c2=c2, buckets=tuple(cfg["buckets"]), scorer=scorer,
        ref_ids=lambda ids: torch.from_numpy(ids).to(device),
        prog_ids=lambda ids: ids, checks=checks, **hooks)

