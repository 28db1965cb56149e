"""Exact search and recall (counterpart of two functions of
``repro.core.baselines``): the yardstick the three-pass search's recall is
measured against."""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device

__all__ = ["exact_topk", "recall_at_h"]


def exact_topk(q_sparse, q_dense, x_sparse, x_dense, h: int, *,
               device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Brute-force top-``h`` of q·x over the hybrid vectors on ``device``.

    Returns ``(ids, scores)``, each (Q, h), best first.  The sparse product
    runs as a CSR matrix times the densified query block."""
    dev = resolve_device(device)
    xs = sp.csr_matrix(x_sparse, dtype=np.float32)
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        x_csr = torch.sparse_csr_tensor(
            torch.from_numpy(xs.indptr.astype(np.int64)),
            torch.from_numpy(xs.indices.astype(np.int64)),
            torch.from_numpy(xs.data), size=xs.shape,
            check_invariants=True).to(dev)
    qs = torch.from_numpy(np.asarray(q_sparse.toarray(), np.float32)).to(dev)
    qd = torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev)
    xd = torch.from_numpy(np.asarray(x_dense, np.float32)).to(dev)
    scores = (x_csr @ qs.T).T + qd @ xd.T                       # (Q, N)
    s, ids = torch.topk(scores, h, dim=1)
    return ids.cpu().numpy(), s.cpu().numpy()


def recall_at_h(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    hits = 0
    for f, t in zip(found_ids, true_ids):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / true_ids.size
