"""HybridIndex — the paper's full indexing + search pipeline (paper §6).

Counterpart of ``repro.core.hybrid``.

Build:
  1. cache-sort datapoints (Algorithm 1) — all row-parallel structures below
     store rows in sorted order; search maps ids back at the end.
  2. sparse data index: eta-prune (top ``keep_top`` per dim), split into the
     tile-sorted head block (most-active dims) + padded inverted index (tail).
  3. sparse residual index: remaining entries as padded rows (eps = 0 default).
  4. dense data index: PQ, K_U = d^D/2 subspaces, l = 16 (LUT16 kernel path).
  5. dense residual index: int8 scalar quantization (K_V = d^D, l = 256).
Steps 1-3 run on the host in numpy (copies of the JAX package's builders);
steps 4-5 run on ``device``.

Search converts queries to the padded layout, runs the engine's three-pass
search on the device and maps result positions back to original ids.  An
index built with ``mutable=True`` also takes ``insert`` / ``delete`` /
``compact`` (core/streaming.py), and its search merges the main engine
with the delta shard; ``save`` / ``load`` write and recover a durable
store (persist/).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from . import baselines
from .cache_sort import cache_sort, dimension_activity
from .engine import Backend, IndexArrays, ScoringEngine
from .pq import (PQCodebooks, ScalarQuant, pq_decode, pq_encode,
                 scalar_quantize, train_codebooks)
from .pruning import prune_split
from .sparse_index import (CompactColumns, PaddedInvertedIndex,
                           PaddedSparseRows, TileSparseHead,
                           build_compact_columns, build_padded_inverted_index,
                           build_padded_rows, build_tile_sparse_head,
                           sparse_queries_to_padded)
from .streaming import MutableState, search_mutable

__all__ = ["HybridIndexParams", "HybridIndex", "SearchResult"]


@dataclasses.dataclass(frozen=True)
class HybridIndexParams:
    # sparse side
    keep_top: int = 256          # eta: entries kept per dim in the data index
    head_dims: int = 128         # most-active dims served by the tile block
    block_rows: int = 128        # tile height of the head block
    block_cols: int = 128
    nq_max: int = 256            # padded query nnz
    use_head_block: bool = True
    # dense side
    pq_subspaces: int | None = None   # default d^D // 2  (paper §6.1.1)
    pq_codes: int = 16
    kmeans_iters: int = 12
    seed: int = 0
    # search
    alpha: int = 20              # overfetch multiplier (pass 1)
    beta: int = 5                # keep multiplier (pass 2)
    # the JAX package's alias for backend="pallas" (its field, so that its
    # params cross over as HybridIndexParams(**asdict(theirs))).  Here it
    # changes nothing: backend=None serves on the kernels (cuda) either way,
    # where the JAX package's None with False means its ref backend.
    use_lut16_kernel: bool = False
    # engine backend: ref | onehot | cuda | cuda-packed, or the JAX
    # package's names (pallas, pallas-packed, onehot-mxu, ...); None => cuda
    backend: str | None = None
    # store PQ codes packed two-per-byte.  None => pack iff the backend is
    # cuda-packed; True also works with ref/onehot (they unpack first).
    pack_codes: bool | None = None

    def resolve_backend(self) -> Backend:
        return Backend.from_name(self.backend)

    def resolve_pack(self) -> bool:
        if self.pack_codes is not None:
            return self.pack_codes
        return self.resolve_backend() is Backend.CUDA_PACKED


@dataclasses.dataclass
class SearchResult:
    ids: np.ndarray        # (Q, h) original datapoint ids
    scores: np.ndarray     # (Q, h) refined inner products
    # diagnostics
    pass1_ids: np.ndarray | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class HybridIndex:
    params: HybridIndexParams
    num_points: int
    pi: np.ndarray                     # sorted position -> original id
    cols: CompactColumns
    inv_index: PaddedInvertedIndex     # tail dims of the pruned data index
    head: TileSparseHead | None        # head dims of the pruned data index
    head_dim_ids: np.ndarray           # compact ids in the head block (pad -1)
    sparse_residual: PaddedSparseRows
    codebooks: PQCodebooks
    codes: torch.Tensor                # the engine's codes (maybe packed)
    dense_residual: ScalarQuant
    d_dense: int
    engine: ScoringEngine              # device-resident three-pass scorer
    # wall seconds of each build stage (empty for an index carried across)
    build_seconds: dict = dataclasses.field(default_factory=dict)
    # present iff built with mutable=True: the retained corpus, the delta
    # shard and the tombstones behind insert()/delete()/compact()
    mutable_state: MutableState | None = None

    @property
    def device(self) -> torch.device:
        return self.codes.device

    # -- build -------------------------------------------------------------
    @classmethod
    def build(cls, x_sparse: sp.spmatrix, x_dense: np.ndarray,
              params: HybridIndexParams = HybridIndexParams(), *,
              mutable: bool = False, ext_ids: np.ndarray | None = None,
              delta_capacity: int = 64, device="cuda") -> "HybridIndex":
        """Build the index on ``device``.  ``mutable=True`` attaches a
        ``MutableState`` whose rows carry ``ext_ids`` (default: build-row
        positions) and whose delta shard starts at ``delta_capacity`` slots
        (doubling past it)."""
        if ext_ids is not None and not mutable:
            raise ValueError("ext_ids only applies with mutable=True")
        dev = resolve_device(device)
        seconds = {}
        t = time.perf_counter()

        def stage(name):
            nonlocal t
            _sync(dev)
            now = time.perf_counter()
            seconds[name] = now - t
            t = now

        x_sparse = x_sparse.tocsr()
        n = x_sparse.shape[0]
        x_dense = np.asarray(x_dense, np.float32)
        if x_dense.shape[0] != n:
            raise ValueError(f"{n} sparse rows but {x_dense.shape[0]} dense")

        # 1. cache sort; permute every row-parallel structure once.
        pi = cache_sort(x_sparse)
        xs = x_sparse[pi]
        xd = x_dense[pi]
        stage("cache_sort")

        # 2-3. prune + compact columns over the FULL sparse matrix so data
        # index and residual share one column space.
        split = prune_split(xs, keep_top=params.keep_top)
        cols, _ = build_compact_columns(xs)
        idx_compact = _remap(split.index, cols)
        res_compact = _remap(split.residual, cols)
        stage("prune")

        head = None
        head_dim_ids = np.empty(0, np.int32)
        tail_index = idx_compact
        if params.use_head_block and cols.num_active > 0:
            activity = dimension_activity(idx_compact)
            n_head = min(params.head_dims, cols.num_active)
            head_compact = np.sort(np.argsort(-activity)[:n_head]).astype(np.int32)
            head = build_tile_sparse_head(
                idx_compact, head_compact, block_rows=params.block_rows,
                block_cols=params.block_cols, device=dev)
            head_dim_ids = head.head_dims.cpu().numpy()
            tail_index = _drop_columns(idx_compact, head_compact)
        inv_index = build_padded_inverted_index(tail_index, device=dev)
        sparse_residual = build_padded_rows(res_compact, device=dev)
        stage("sparse_index")

        # 4. dense PQ data index
        d_dense = xd.shape[1]
        k_u = params.pq_subspaces or max(d_dense // 2, 1)
        xd_t = torch.from_numpy(xd).to(dev)
        cb = train_codebooks(xd_t, k_u, params.pq_codes,
                             iters=params.kmeans_iters, seed=params.seed)
        stage("kmeans")
        codes = pq_encode(xd_t, cb)

        # 5. dense residual index (int8)
        dres = scalar_quantize(xd_t - pq_decode(codes, cb))
        stage("encode")

        backend = params.resolve_backend()
        arrays = IndexArrays.build(
            codebooks=cb, codes=codes, inv_index=inv_index, head=head,
            dense_residual=dres, sparse_residual=sparse_residual,
            num_points=n, d_active=cols.num_active,
            with_bcsr=backend.uses_kernels, pack=params.resolve_pack())
        stage("arrays")
        idx = cls(params=params, num_points=n, pi=pi, cols=cols,
                  inv_index=inv_index, head=head, head_dim_ids=head_dim_ids,
                  sparse_residual=sparse_residual, codebooks=cb,
                  codes=arrays.codes, dense_residual=dres, d_dense=d_dense,
                  engine=ScoringEngine(arrays=arrays, backend=backend),
                  build_seconds=seconds)
        if mutable:
            idx.mutable_state = MutableState(idx, x_sparse, x_dense,
                                             ext_ids=ext_ids,
                                             delta_capacity=delta_capacity)
        return idx

    # -- persistence (thin wrappers over repro_torch/persist, DESIGN.md §7)
    @classmethod
    def load(cls, root: str, *, backend=None,
             device="cuda") -> "HybridIndex":
        """Recover a mutable index from a durable store (the JAX package's
        format too) onto ``device``: committed snapshot (checksum-verified
        leaf blobs) + WAL-tail replay through the streaming machinery —
        bit-identical, ids and scores, to the index at its last
        durably-acked mutation on the same device.  ``backend`` overrides
        the recorded engine backend (any backend serves any snapshot)."""
        from ..persist import recover
        rec = recover(root, backend=backend, device=device)
        rec.durability.close()       # load-only: no appends from here
        return rec.index

    def save(self, root: str) -> str:
        """Bootstrap a durable store for this freshly built mutable index
        (initial snapshot + empty WAL) without keeping a WAL handle open.
        Serving with durability goes through
        ``QueryService(persist_dir=…)`` instead."""
        from ..persist import bootstrap
        bootstrap(root, self).close()
        return root

    # -- streaming mutation (thin wrappers over core/streaming.py) ---------
    def _mutable(self):
        if self.mutable_state is None:
            raise ValueError("index is immutable; build with "
                             "HybridIndex.build(..., mutable=True)")
        return self.mutable_state

    def insert(self, x_sparse, x_dense, ids=None) -> np.ndarray:
        """Insert (or upsert) rows into the delta shard (DESIGN.md §6),
        encoded against the frozen build artifacts.  Returns external ids."""
        return self._mutable().insert(x_sparse, x_dense, ids=ids)

    def delete(self, ids) -> int:
        """Tombstone rows by external id; returns how many were live."""
        return self._mutable().delete(ids)

    def compact(self, retrain: bool | None = None) -> "HybridIndex":
        """Fold the delta + tombstones down; returns the NEW mutable index
        (this one is untouched).  ``retrain=True`` re-runs the batch build,
        ``retrain=False`` merges into the frozen artifacts, ``None`` merges
        unless out-of-column-space entries force a retrain (DESIGN.md
        §6.2)."""
        return self._mutable().compact(retrain=retrain)

    @property
    def delta_version(self) -> int:
        """Monotone mutation counter (0 for an untouched mutable index)."""
        return self._mutable().version

    # -- search ------------------------------------------------------------
    def search(self, q_sparse: sp.spmatrix, q_dense: np.ndarray, h: int = 20,
               alpha: int | None = None, beta: int | None = None,
               return_pass1: bool = False) -> SearchResult:
        """Pad queries to the device layout, run the engine's three-pass
        search, map positions back to original ids.

        A mutable index routes through ``search_mutable`` (main engine +
        delta shard, host merge) and returns EXTERNAL ids, which default to
        build-row positions, so the two paths agree until the first
        mutation."""
        if self.mutable_state is not None:
            if return_pass1:
                raise ValueError("return_pass1 is a diagnostic of the "
                                 "single-engine path; not available on a "
                                 "mutable index")
            return search_mutable(self, q_sparse, q_dense, h=h, alpha=alpha,
                                  beta=beta)
        p = self.params
        alpha = p.alpha if alpha is None else alpha
        beta = p.beta if beta is None else beta
        dev = self.device
        q_dims_np, q_vals_np = sparse_queries_to_padded(
            q_sparse, self.cols, nq_max=p.nq_max)
        s3, ids3, ids1 = self.engine.search(
            torch.from_numpy(q_dims_np).to(dev),
            torch.from_numpy(q_vals_np).to(dev),
            torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev),
            h=h, alpha=alpha, beta=beta)
        orig = self.pi[ids3.cpu().numpy()]
        return SearchResult(
            ids=orig, scores=s3.cpu().numpy(),
            pass1_ids=self.pi[ids1.cpu().numpy()] if return_pass1 else None)

    def exact_scores(self, q_sparse: sp.spmatrix, q_dense: np.ndarray,
                     x_sparse: sp.spmatrix, x_dense: np.ndarray) -> np.ndarray:
        """Brute-force q·x for validation (original row order), computed on
        the index's device.  (Q, N) numpy."""
        return baselines.exact_scores(q_sparse, q_dense, x_sparse, x_dense,
                            device=self.device).cpu().numpy()


def _remap(x: sp.spmatrix, cols: CompactColumns) -> sp.csr_matrix:
    return x.tocsc()[:, cols.global_ids].tocsr()


def _drop_columns(x: sp.csr_matrix, columns: np.ndarray) -> sp.csr_matrix:
    """``x`` without the entries of ``columns``: the same matrix as the JAX
    package's lil-assign-zero + ``eliminate_zeros``, without the lil round
    trip."""
    out = x.copy()
    out.data[np.isin(out.indices, columns)] = 0
    out.eliminate_zeros()
    return out
