"""Carry an index built by the JAX package across to the port.

``hybrid_index_from_numpy`` takes the reference's arrays as numpy, under
the leaf names of its snapshot format (``repro/persist/snapshot.py``), and
assembles a port ``HybridIndex`` through the port's own
``IndexArrays.build`` (which derives the head scatter table and BCSR).
``mutable_index_from_numpy`` also attaches a port ``MutableState`` over the
corpus the reference index was built from, so both packages serve the same
main generation.  Reading a snapshot directory from disk is
``persist.snapshot.load_snapshot`` (``persist.recover`` with the WAL),
which assembles the index through ``hybrid_index_from_numpy`` under the
same leaf names.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.engine import IndexArrays, ScoringEngine
from .core.hybrid import HybridIndex, HybridIndexParams
from .core.pq import PQCodebooks, ScalarQuant
from .core.sparse_index import (CompactColumns, PaddedInvertedIndex,
                                PaddedSparseRows, TileSparseHead)
from .core.streaming import MutableState
from .device import resolve_device

__all__ = ["LEAVES", "SCALARS", "hybrid_index_from_numpy",
           "mutable_index_from_numpy"]

LEAVES = ("pi", "cols_global_ids", "inv_rows", "inv_vals", "head_block",
          "head_occupancy", "head_dims", "res_cols", "res_vals", "centers",
          "codes", "dres_q", "dres_scale", "dres_zero")
SCALARS = ("num_points", "inv_num_points", "head.block_rows",
           "head.block_cols", "codes_packed")


def hybrid_index_from_numpy(leaves: dict, scalars: dict,
                            params: HybridIndexParams = HybridIndexParams(),
                            device="cuda") -> HybridIndex:
    """Build a port ``HybridIndex`` on ``device`` from reference arrays.

    leaves: the names in ``LEAVES`` (the three ``head_*`` leaves only when
    the index has a head block); scalars: the names in ``SCALARS``, with
    ``head.block_rows`` None or absent for an index without a head block.
    ``params`` picks the backend; codes stored packed stay packed, unpacked
    codes are packed when ``params.resolve_pack()`` asks for it."""
    dev = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.array(leaves[name], order="C")).to(dev)

    cols = CompactColumns(global_ids=np.asarray(leaves["cols_global_ids"]))
    inv_index = PaddedInvertedIndex(rows=t("inv_rows"), vals=t("inv_vals"),
                                    num_points=int(scalars["inv_num_points"]))
    head = None
    head_dim_ids = np.empty(0, np.int32)
    if scalars.get("head.block_rows") is not None:
        head = TileSparseHead(block=t("head_block"),
                              occupancy=t("head_occupancy"),
                              head_dims=t("head_dims"),
                              block_rows=int(scalars["head.block_rows"]),
                              block_cols=int(scalars["head.block_cols"]))
        head_dim_ids = np.asarray(leaves["head_dims"])
    sparse_residual = PaddedSparseRows(cols=t("res_cols"), vals=t("res_vals"))
    codebooks = PQCodebooks(centers=t("centers"))
    dres = ScalarQuant(q=t("dres_q"), scale=t("dres_scale"),
                       zero=t("dres_zero"))
    packed = bool(scalars["codes_packed"])
    backend = params.resolve_backend()
    arrays = IndexArrays.build(
        codebooks=codebooks, codes=t("codes"), inv_index=inv_index,
        head=head, dense_residual=dres, sparse_residual=sparse_residual,
        num_points=int(scalars["num_points"]), d_active=cols.num_active,
        with_bcsr=backend.uses_kernels, pre_packed=packed,
        pack=not packed and params.resolve_pack())
    k, _, p = codebooks.centers.shape
    return HybridIndex(
        params=params, num_points=int(scalars["num_points"]),
        pi=np.asarray(leaves["pi"]), cols=cols, inv_index=inv_index,
        head=head, head_dim_ids=head_dim_ids, sparse_residual=sparse_residual,
        codebooks=codebooks, codes=arrays.codes, dense_residual=dres,
        d_dense=k * p, engine=ScoringEngine(arrays=arrays, backend=backend))


def mutable_index_from_numpy(leaves: dict, scalars: dict, x_sparse, x_dense, *,
                             ext_ids=None, delta_capacity: int = 64,
                             params: HybridIndexParams = HybridIndexParams(),
                             device="cuda") -> HybridIndex:
    """``hybrid_index_from_numpy``, then a port ``MutableState`` over the
    corpus ``(x_sparse, x_dense)`` the reference index was built from, with
    the same external ids (default: build-row positions)."""
    idx = hybrid_index_from_numpy(leaves, scalars, params=params,
                                  device=device)
    idx.mutable_state = MutableState(idx, x_sparse, x_dense, ext_ids=ext_ids,
                                     delta_capacity=delta_capacity)
    return idx
