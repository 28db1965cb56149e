"""Synthetic hybrid (sparse ⊕ dense) datasets matching the paper's data model.

Verbatim copy of ``repro.data.hybrid_synth``: the same seed gives the same
arrays in both packages.

QuerySim statistics reproduced (paper §7.1.2, Fig. 5):
  * sparse dimension activity follows a power law  P_j ∝ j^-alpha  (Fig. 5a);
  * nonzero values are heavy-tailed positive (log-normal), median ≈ 0.054,
    long tail (Fig. 5b);
  * dense components are low-dimensional embeddings; we draw them from a
    correlated Gaussian (random low-rank mixing) so PQ has structure to learn,
    and scale sparse/dense contributions to comparable magnitude (the paper
    fine-tunes this relative weight on ROC — we expose it as `dense_weight`).

Queries are drawn from the same process (paper Prop. 1-3 assume this), plus an
optional "related query" mode that perturbs dataset points so that planted
neighbors exist.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

__all__ = ["HybridDataset", "make_hybrid_dataset"]


@dataclasses.dataclass
class HybridDataset:
    x_sparse: sp.csr_matrix      # (N, d_sparse)
    x_dense: np.ndarray          # (N, d_dense) float32
    q_sparse: sp.csr_matrix      # (Q, d_sparse)
    q_dense: np.ndarray          # (Q, d_dense)
    alpha: float

    @property
    def num_points(self) -> int:
        return self.x_sparse.shape[0]


def _sparse_powerlaw(rng, n, d, alpha, target_nnz, value_median=0.054,
                     value_sigma=1.1):
    """Rows with power-law column activity and log-normal values."""
    pj = np.arange(1, d + 1, dtype=np.float64) ** (-alpha)
    pj *= target_nnz / pj.sum()
    pj = np.minimum(pj, 1.0)
    cols_all, rows_all = [], []
    # sample per-dimension Bernoulli column-wise (vectorized over rows)
    for j in np.flatnonzero(pj > 1e-7):
        hits = np.flatnonzero(rng.random(n) < pj[j])
        rows_all.append(hits)
        cols_all.append(np.full(len(hits), j, np.int32))
    rows = np.concatenate(rows_all) if rows_all else np.empty(0, np.int64)
    cols = np.concatenate(cols_all) if cols_all else np.empty(0, np.int32)
    mu = np.log(value_median)
    vals = rng.lognormal(mu, value_sigma, size=len(rows)).astype(np.float32)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, d))


def make_hybrid_dataset(num_points: int = 20000, num_queries: int = 64,
                        d_sparse: int = 30000, d_dense: int = 64,
                        alpha: float = 2.0, nnz_per_row: float = 64.0,
                        dense_weight: float = 1.0, dense_rank: int = 16,
                        related_queries: bool = True,
                        seed: int = 0) -> HybridDataset:
    rng = np.random.default_rng(seed)
    x_sparse = _sparse_powerlaw(rng, num_points, d_sparse, alpha, nnz_per_row)

    # correlated dense embeddings: low-rank mixing + noise
    basis = rng.normal(size=(dense_rank, d_dense)).astype(np.float32)
    coef = rng.normal(size=(num_points, dense_rank)).astype(np.float32)
    x_dense = (coef @ basis + 0.3 * rng.normal(size=(num_points, d_dense))
               ).astype(np.float32)
    x_dense *= dense_weight / np.sqrt(d_dense)

    if related_queries:
        # queries = perturbed copies of random datapoints => planted neighbors
        src = rng.choice(num_points, size=num_queries, replace=False)
        q_sparse = x_sparse[src].copy()
        q_sparse.data *= rng.uniform(0.7, 1.3, size=q_sparse.nnz).astype(np.float32)
        extra = _sparse_powerlaw(rng, num_queries, d_sparse, alpha,
                                 nnz_per_row * 0.3)
        q_sparse = (q_sparse + extra).tocsr()
        q_dense = (x_dense[src]
                   + 0.2 * dense_weight / np.sqrt(d_dense)
                   * rng.normal(size=(num_queries, d_dense))).astype(np.float32)
    else:
        q_sparse = _sparse_powerlaw(rng, num_queries, d_sparse, alpha, nnz_per_row)
        coefq = rng.normal(size=(num_queries, dense_rank)).astype(np.float32)
        q_dense = ((coefq @ basis
                    + 0.3 * rng.normal(size=(num_queries, d_dense)))
                   * dense_weight / np.sqrt(d_dense)).astype(np.float32)

    return HybridDataset(x_sparse=x_sparse, x_dense=x_dense,
                         q_sparse=q_sparse.tocsr(),
                         q_dense=q_dense.astype(np.float32), alpha=alpha)
