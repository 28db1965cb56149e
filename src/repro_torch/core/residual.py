"""Residual reordering passes (paper §5); counterpart of
``repro.core.residual``.

q·x = q·x̃ + q·(x - x̃): first-pass approximate scores from the lossy data
indices are refined for a small overfetched candidate set by adding
query·residual terms, restoring (near-)exact inner products at O(h) cost.

Every top-k here breaks ties toward the lowest index, as ``lax.top_k``
does: ``torch.topk`` promises no order among equal values, so the passes
use a stable descending sort.

``fixed_order=True`` (the kernel backends) takes the residual terms from
``kernels/ops.py``'s fixed-order wrappers (R1, R2 on the card): each
score's sums are taken in an order that depends only on d or R, so a
query's scores do not depend on the batch it is searched in.  The default
keeps the JAX package's form (an einsum, ``torch.sum``), whose order of
adds on the card may change with the shape.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.ref import stable_topk
from .pq import ScalarQuant
from .sparse_index import PaddedSparseRows, score_rows

__all__ = ["topk_candidates", "dense_residual_scores", "reorder_pass",
           "sparse_residual_scores"]


def topk_candidates(scores: torch.Tensor, k: int):
    """(Q, N) -> ((Q, k) scores, (Q, k) int32 ids)."""
    return stable_topk(scores, k)


def dense_residual_scores(sq: ScalarQuant, candidates: torch.Tensor,
                          q_dense: torch.Tensor, *,
                          fixed_order: bool = False) -> torch.Tensor:
    """q^D · residual[cand] with int8 rows dequantized on the fly.

    candidates: (Q, C) (clipped into range, as ``mode="clip"``); q_dense:
    (Q, d^D).  Returns (Q, C).  The affine dequantization is folded into
    the dot, term for term as in the JAX package:
      q·(s*(r+128)+z) = (q*s)·r + 128*(q·s) + q·z
    """
    if fixed_order:
        return ops.dense_residual(sq.q, sq.scale, sq.zero, candidates,
                                  q_dense)
    cand = candidates.long().clamp(0, sq.q.shape[0] - 1)
    rows = sq.q[cand]                                             # (Q, C, d)
    q_dense = q_dense.float()
    qs = q_dense * sq.scale[None, :]                              # (Q, d)
    base = 128.0 * torch.sum(qs, dim=-1) + q_dense @ sq.zero      # (Q,)
    dot = torch.einsum("qcd,qd->qc", rows.float(), qs)
    return dot + base[:, None]


def reorder_pass(prev_scores: torch.Tensor, prev_ids: torch.Tensor,
                 extra_scores: torch.Tensor, keep: int):
    """Refine candidate scores with a residual term and shrink the set.

    prev_scores/prev_ids: (Q, C); extra_scores: (Q, C) residual
    contribution.  Returns ((Q, keep) scores, (Q, keep) ids)."""
    vals, pos = stable_topk(prev_scores + extra_scores, keep)
    return vals, torch.gather(prev_ids, 1, pos.long())


def sparse_residual_scores(rows: PaddedSparseRows, candidates: torch.Tensor,
                           q_cols_dense: torch.Tensor, *,
                           fixed_order: bool = False) -> torch.Tensor:
    """Pass 3's sparse residual term (``score_rows`` on the candidates)."""
    if fixed_order:
        return ops.sparse_residual(rows.cols, rows.vals, candidates,
                                   q_cols_dense)
    return score_rows(rows, candidates, q_cols_dense)
