"""Cache sorting (paper Algorithm 1).

Numpy copy of ``repro.core.cache_sort`` (Algorithm 1 only; the cost model
stays in the JAX package).  The paper's observation: accumulator memory is
moved in fixed-size blocks of B slots (64-byte cache-lines on x86; the
128-row head tiles of the block-sparse kernel here).
For every (dimension j, row-block b) pair, the block must be touched iff any of
its B datapoints is nonzero in dimension j.  Cache sorting finds a permutation
pi of datapoint order that clusters nonzeros of the most active dimensions into
contiguous runs, minimizing the number of touched blocks.

Algorithm 1 is equivalent to sorting the per-point activity indicator vectors
(dimensions ordered most→least active) in decreasing lexicographic order; we
implement it as the paper describes — recursive stable partitioning — with an
explicit work stack, O(N log N) average.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["cache_sort", "dimension_activity"]


def _as_csc(x) -> sp.csc_matrix:
    if sp.issparse(x):
        return x.tocsc()
    return sp.csc_matrix(np.asarray(x))


def dimension_activity(x_sparse) -> np.ndarray:
    """nnz per dimension (column), the paper's ``nnz_j``."""
    xc = _as_csc(x_sparse)
    return np.diff(xc.indptr)


def cache_sort(x_sparse, max_dims: int | None = None, min_segment: int = 2) -> np.ndarray:
    """Paper Algorithm 1: returns a permutation ``pi`` of datapoint indices.

    ``x_sparse``: (N, d^S) scipy sparse (or dense ndarray) of the sparse component.
    ``max_dims``: partition on at most this many most-active dimensions.  Beyond
        ~log2(N) dimensions segments have length < 2 and partitioning is a no-op;
        the default covers that automatically via ``min_segment``.
    ``min_segment``: stop partitioning ranges shorter than this.

    Only CSC index structure is used (value magnitudes are irrelevant), matching
    the paper's 16-bytes-per-datapoint prefix-sorting implementation note.
    """
    xc = _as_csc(x_sparse)
    n, d = xc.shape
    nnz = np.diff(xc.indptr)
    # eta: dimensions sorted most→least active; ties broken by dim id for determinism.
    eta = np.lexsort((np.arange(d), -nnz))
    if max_dims is None:
        # Partitioning depth beyond ~log2(N)+constant can't split further.
        max_dims = min(d, max(2 * int(np.ceil(np.log2(max(n, 2)))) + 8, 16))
    eta = eta[: max_dims]
    eta = eta[nnz[eta] > 0]

    pi = np.arange(n, dtype=np.int64)
    # Explicit stack of (start, end, j) replacing the paper's recursion.
    stack = [(0, n, 0)]
    # Pre-extract row-index sets per partition dimension as boolean bitmaps.
    # Memory: len(eta) * N bits ~ fine for the N we build on one host shard.
    indicator = {}
    for j_rank, j in enumerate(eta):
        col = np.zeros(n, dtype=bool)
        col[xc.indices[xc.indptr[j]: xc.indptr[j + 1]]] = True
        indicator[j_rank] = col

    while stack:
        start, end, j = stack.pop()
        if end - start < min_segment or j >= len(eta):
            continue
        seg = pi[start:end]
        active = indicator[j][seg]
        n_active = int(active.sum())
        if n_active == 0 or n_active == end - start:
            # No split; recurse on the next dimension over the same range.
            stack.append((start, end, j + 1))
            continue
        # Stable partition: actives first (paper puts nonzero block contiguous).
        order = np.argsort(~active, kind="stable")
        pi[start:end] = seg[order]
        pivot = start + n_active
        stack.append((start, pivot, j + 1))
        stack.append((pivot, end, j + 1))
    return pi
