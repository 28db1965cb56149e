"""Per-dimension magnitude pruning of the sparse component (paper §4.2, §6).

Numpy copy of ``repro.core.pruning``: the build must split exactly as the
JAX package does.

Two-level split (paper Eq. 6 / Eq. 7):
  data index      keeps entries with |x_j| >= eta_j   (hyper-sparse, fast scan)
  residual index  keeps entries with eta_j > |x_j| >= eps_j
  dropped         entries below eps_j (bounded error, Proposition 3)

eta_j is set so only the top ``keep_top`` magnitudes per dimension survive
(paper §6.1.2: "only top 100s of nonzero values in dimension j are kept"); eps_j
keeps "most" of the rest (we default to keeping everything: eps_j = 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

__all__ = ["PruneSplit", "per_dim_thresholds", "prune_split"]


@dataclasses.dataclass
class PruneSplit:
    index: sp.csr_matrix      # Prune(x; eta)        — first-pass data index
    residual: sp.csr_matrix   # Prune(R(x); eps)     — residual index
    dropped_mass: float       # fraction of L1 mass below eps (diagnostic)
    eta: np.ndarray           # (d,) thresholds
    eps: np.ndarray           # (d,)


def per_dim_thresholds(x_sparse, keep_top: int) -> np.ndarray:
    """eta_j = magnitude of the ``keep_top``-th largest |value| in dimension j
    (0 if the dimension has fewer nonzeros — everything kept)."""
    xc = x_sparse.tocsc()
    d = xc.shape[1]
    eta = np.zeros(d, dtype=np.float64)
    data = np.abs(xc.data)
    for j in range(d):
        lo, hi = xc.indptr[j], xc.indptr[j + 1]
        vals = data[lo:hi]
        if len(vals) > keep_top:
            # threshold = keep_top-th largest; strictly-greater entries survive
            # alongside ties at the threshold (>= in Eq. 6).
            eta[j] = np.partition(vals, len(vals) - keep_top)[len(vals) - keep_top]
    return eta


def prune_split(x_sparse, keep_top: int = 256,
                eps_quantile: float = 0.0) -> PruneSplit:
    """Split X^S into (data index, residual index) per paper §6 step (1)."""
    xr = x_sparse.tocsr().astype(np.float32)
    eta = per_dim_thresholds(xr, keep_top)

    coo = xr.tocoo()
    mag = np.abs(coo.data)
    in_index = mag >= eta[coo.col]

    if eps_quantile > 0.0 and (~in_index).any():
        rest = mag[~in_index]
        eps_val = np.quantile(rest, eps_quantile)
    else:
        eps_val = 0.0
    eps = np.full(xr.shape[1], eps_val, dtype=np.float64)
    in_resid = (~in_index) & (mag >= eps[coo.col])

    def pick(mask):
        return sp.csr_matrix(
            (coo.data[mask], (coo.row[mask], coo.col[mask])), shape=xr.shape
        )

    total = mag.sum() + 1e-30
    dropped = mag[(~in_index) & (~in_resid)].sum() / total
    return PruneSplit(index=pick(in_index), residual=pick(in_resid),
                      dropped_mass=float(dropped), eta=eta, eps=eps)
