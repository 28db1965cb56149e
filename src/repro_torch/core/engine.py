"""Device-resident three-pass scoring engine (the paper's full search loop).

Counterpart of ``repro.core.engine``:

* ``IndexArrays`` — a frozen dataclass of every tensor search needs: PQ
  codes + codebooks, the padded inverted index, the head block both dense
  (ref path) and in BCSR form (kernel path), the int8 dense residual and the
  padded sparse residual.
* ``three_pass_search`` — pass 1 approximate sparse+dense scores → pass 2
  dense residual → pass 3 sparse residual, with a top-k between passes, all
  on the arrays' device with no host round trip.
* ``Backend`` — which implementation scores pass 1:
    ref          torch gather ADC + dense head matmul
    onehot       one-hot ADC with bf16 LUT (kernels/ops.lut16_adc_onehot)
    cuda         LUT16, block-sparse and inverted-index kernels (kernels/ops);
                 pass 1 selects through the fused scan-and-select when
                 c1 <= 1024
    cuda-packed  the same over codes packed two per byte
  On CPU tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib

import numpy as np
import torch

from ..kernels import ops
from . import residual as res
from .pq import PQCodebooks, ScalarQuant, adc_lut, adc_scores_ref
from .sparse_index import (PaddedInvertedIndex, PaddedSparseRows,
                           TileSparseHead, score_head_ref, score_inverted)

__all__ = [
    "Backend", "IndexArrays", "ScoringEngine", "adc_scores",
    "scatter_queries_compact", "scatter_head_queries", "tail_scores",
    "pass1_bias",
    "pass1_scores", "three_pass_search", "tombstone_mask",
    "query_fingerprint", "release_index_arrays",
]


class Backend(enum.Enum):
    """Which implementation scores pass 1 (dense ADC + head block)."""
    REF = "ref"
    ONEHOT = "onehot"
    CUDA = "cuda"
    CUDA_PACKED = "cuda-packed"

    @classmethod
    def from_name(cls, name: "Backend | str | None") -> "Backend":
        """None resolves to the kernel backend ``cuda``; the JAX package's
        names (``pallas``, ``lut16``, ``pallas-packed``, ...) are aliases."""
        if name is None:
            return cls.CUDA
        if isinstance(name, Backend):
            return name
        aliases = {"ref": cls.REF, "gather": cls.REF,
                   "onehot": cls.ONEHOT, "onehot-mxu": cls.ONEHOT,
                   "cuda": cls.CUDA, "pallas": cls.CUDA, "lut16": cls.CUDA,
                   "cuda-packed": cls.CUDA_PACKED,
                   "pallas-packed": cls.CUDA_PACKED,
                   "packed": cls.CUDA_PACKED,
                   "lut16-packed": cls.CUDA_PACKED}
        try:
            return aliases[name]
        except KeyError:
            raise ValueError(
                f"unknown backend {name!r}; expected one of {sorted(aliases)}"
            ) from None

    @property
    def uses_kernels(self) -> bool:
        return self in (Backend.CUDA, Backend.CUDA_PACKED)


def adc_scores(codes: torch.Tensor, lut: torch.Tensor,
               backend: Backend = Backend.CUDA, *,
               packed: bool | None = None) -> torch.Tensor:
    """Dense ADC scan codes × (Q, K, l) LUT -> (Q, N), by backend.

    packed: codes hold two 4-bit subspace codes per byte, (N, ceil(K/2)).
    None => packed iff backend is CUDA_PACKED.  The kernel backends unpack
    in registers; ref/onehot unpack first and then score exactly like the
    unpacked path."""
    if packed is None:
        packed = backend is Backend.CUDA_PACKED
    if backend.uses_kernels:
        return ops.lut16_adc(codes, lut, packed=packed)
    if packed:
        codes = ops.unpack_codes(codes, lut.shape[-2])
    if backend is Backend.ONEHOT:
        return ops.lut16_adc_onehot(codes, lut)
    return adc_scores_ref(codes, lut)


# ---------------------------------------------------------------------------
# IndexArrays — everything search needs, resident on one device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IndexArrays:
    codebooks: PQCodebooks             # LUT-ready PQ codebooks (K, l, p)
    codes: torch.Tensor                # (N, K) uint8 PQ codes, or
                                       # (N, ceil(K/2)) when codes_packed
    inv_index: PaddedInvertedIndex     # tail dims of the pruned data index
    head: TileSparseHead | None        # head dims (None => no head block)
    head_pos: torch.Tensor             # (d_active+1,) compact dim -> head slot
    head_tiles: torch.Tensor           # BCSR tiles (T, Br, Bc) of the head
    head_ptr: torch.Tensor             # (N_pad/Br + 1,) int32
    head_col: torch.Tensor             # (T,) int32
    dense_residual: ScalarQuant        # int8 residual of the dense component
    sparse_residual: PaddedSparseRows  # eps-pruned sparse residual rows
    num_points: int
    d_active: int
    head_max_steps: int                # 0 => built without BCSR
    codes_packed: bool = False
    # (N,) float32 additive row mask: 0 for live rows, -inf for tombstoned
    # or not-yet-filled slots.  None (the batch build) means all live.
    valid_mask: torch.Tensor | None = None

    @classmethod
    def build(cls, *, codebooks: PQCodebooks, codes: torch.Tensor,
              inv_index: PaddedInvertedIndex, head: TileSparseHead | None,
              dense_residual: ScalarQuant, sparse_residual: PaddedSparseRows,
              num_points: int, d_active: int,
              with_bcsr: bool = True, pack: bool = False,
              pre_packed: bool = False) -> "IndexArrays":
        """Host-side assembly on the codes' device: derives the head query
        scatter table and the BCSR form once, so search never leaves the
        device.

        with_bcsr=False skips the BCSR conversion for engines that never
        take the kernel head path.  pack=True stores the PQ codes packed two
        per byte (the only resident copy); pre_packed=True declares that
        ``codes`` already are.  Packing needs l <= 16 codewords."""
        dev = codes.device
        pos = np.full(d_active + 1, 0, np.int32)
        tiles = torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
        ptr = torch.zeros((2,), dtype=torch.int32, device=dev)
        col = torch.zeros((1,), dtype=torch.int32, device=dev)
        max_steps = 0
        if head is not None:
            d_head_pad = head.block.shape[1]
            pos = np.full(d_active + 1, d_head_pad, np.int32)
            hd = head.head_dims.cpu().numpy()
            valid = np.flatnonzero(hd >= 0)
            pos[hd[valid]] = valid.astype(np.int32)
            if with_bcsr:
                tiles, ptr, col, max_steps = ops.bcsr_from_head(head)
        if pack and pre_packed:
            raise ValueError("pass pack=True (pack now) or pre_packed=True "
                             "(already packed), not both")
        if (pack or pre_packed) and codebooks.num_codes > 16:
            raise ValueError(
                "packed codes need l <= 16 codewords (4 bits), got "
                f"l={codebooks.num_codes}")
        if pack:
            codes = torch.from_numpy(
                ops.pack_codes(codes.cpu().numpy())).to(dev)
        return cls(codebooks=codebooks, codes=codes.contiguous(),
                   inv_index=inv_index, head=head,
                   head_pos=torch.from_numpy(pos).to(dev), head_tiles=tiles,
                   head_ptr=ptr, head_col=col, dense_residual=dense_residual,
                   sparse_residual=sparse_residual, num_points=num_points,
                   d_active=d_active, head_max_steps=max_steps,
                   codes_packed=pack or pre_packed)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def scatter_queries_compact(q_dims: torch.Tensor, q_vals: torch.Tensor,
                            d_active: int) -> torch.Tensor:
    """(Q, nq) padded sparse queries -> (Q, d_active + 1) dense w/ pad slot.

    A query's dims are distinct, so only pad entries (value 0) share a
    column: the scatter is reproducible."""
    qn = q_dims.shape[0]
    idx = q_dims.long()
    inside = (idx >= 0) & (idx <= d_active)
    idx = torch.where(inside, idx, torch.full_like(idx, d_active))
    vals = torch.where(inside, q_vals.float(), torch.zeros_like(q_vals).float())
    out = torch.zeros((qn, d_active + 1), dtype=torch.float32,
                      device=q_dims.device)
    out.scatter_add_(1, idx, vals)
    out[:, d_active] = 0.0
    return out


def scatter_head_queries(q_dims: torch.Tensor, q_vals: torch.Tensor,
                         head_pos: torch.Tensor, d_head_pad: int) -> torch.Tensor:
    """Scatter padded sparse queries into the dense head subspace.

    head_pos maps compact dim ids (plus the pad sentinel d_active) to head
    slots; non-head dims map to the trailing pad slot, sliced off.  Each
    kept slot receives at most one value per query."""
    qn = q_dims.shape[0]
    pos = head_pos[q_dims.long().clamp(0, head_pos.shape[0] - 1)].long()
    out = torch.zeros((qn, d_head_pad + 1), dtype=torch.float32,
                      device=q_dims.device)
    out.scatter_add_(1, pos, q_vals.float())
    return out[:, :d_head_pad]


def _head_scores(arrays: IndexArrays, q_head: torch.Tensor,
                 backend: Backend) -> torch.Tensor:
    # head_max_steps == 0 marks arrays built without BCSR: the dense matmul
    if backend.uses_kernels and arrays.head_max_steps > 0:
        return ops.block_sparse_matmul_bcsr(q_head, arrays.head_tiles,
                                            arrays.head_ptr, arrays.head_col)
    return score_head_ref(arrays.head, q_head)


def tail_scores(inv: PaddedInvertedIndex, q_dims: torch.Tensor,
                q_vals: torch.Tensor, backend: Backend) -> torch.Tensor:
    """The inverted-index tail of the pass-1 bias, (Q, N): B4 through
    ``ops.score_inverted_vf`` on the kernel backends, ``score_inverted``
    otherwise (the same bits)."""
    if backend.uses_kernels:
        return ops.score_inverted_vf(inv, q_dims, q_vals)
    return score_inverted(inv, q_dims, q_vals)


def pass1_bias(arrays: IndexArrays, q_dims: torch.Tensor, q_vals: torch.Tensor,
               backend: Backend = Backend.CUDA) -> torch.Tensor:
    """The sparse half of pass 1: inverted-index tail + head block.  (Q, N).

    The per-(query, row) bias the fused scan-and-select folds into its
    select step; the dense ADC term and the row mask are NOT included."""
    sparse = tail_scores(arrays.inv_index, q_dims, q_vals, backend)
    if arrays.head is not None:
        q_head = scatter_head_queries(q_dims, q_vals, arrays.head_pos,
                                      arrays.head.block.shape[1])
        head_s = _head_scores(arrays, q_head, backend)
        sparse = sparse + head_s[:, : arrays.num_points]
    return sparse


def pass1_scores(arrays: IndexArrays, q_dims: torch.Tensor,
                 q_vals: torch.Tensor, lut: torch.Tensor,
                 backend: Backend = Backend.CUDA) -> torch.Tensor:
    """Pass-1 approximate hybrid scores over the full shard: inverted-index
    sparse + head-block sparse + LUT ADC dense.  (Q, N).

    A ``valid_mask`` is folded into the sparse bias BEFORE the dense term
    (the order of the JAX package): adding 0.0 is exact and -inf absorbs,
    and it matches the fused kernel's bias-at-select order."""
    bias = pass1_bias(arrays, q_dims, q_vals, backend)
    if arrays.valid_mask is not None:
        bias = bias + arrays.valid_mask[None, :]
    dense = adc_scores(arrays.codes, lut, backend, packed=arrays.codes_packed)
    return bias + dense


def tombstone_mask(capacity: int, count: int, dead: np.ndarray | None = None,
                   *, device="cuda") -> torch.Tensor:
    """(capacity,) additive row mask: 0 for live slots, -inf for tombstoned
    slots and slots at/after ``count`` (never filled).  ``dead``: optional
    (capacity,) bool of tombstoned slots."""
    live = np.arange(capacity) < count
    if dead is not None:
        live &= ~np.asarray(dead, bool)
    return torch.from_numpy(
        np.where(live, 0.0, -np.inf).astype(np.float32)).to(device)


def _use_fused_pass1(backend: Backend, fused: bool, k: int) -> bool:
    """Routing for pass 1: only the kernel backends have the fused
    scan-and-select, and k must fit its candidate buffer."""
    return fused and backend.uses_kernels and k <= ops.MAX_FUSED_CANDIDATES


def _fused_pass1_topk(arrays: IndexArrays, q_dims: torch.Tensor,
                      q_vals: torch.Tensor, lut: torch.Tensor, k: int,
                      backend: Backend):
    """Pass-1 top-k through the fused scan-and-select: the (Q, N) dense
    scores are never written; bit-identical to pass1_scores + top-k."""
    bias = pass1_bias(arrays, q_dims, q_vals, backend)
    return ops.lut16_adc_topk(arrays.codes, lut, k, bias=bias,
                              row_mask=arrays.valid_mask,
                              packed=arrays.codes_packed)


def three_pass_search(arrays: IndexArrays, q_dims: torch.Tensor,
                      q_vals: torch.Tensor, q_dense: torch.Tensor, *, h: int,
                      c1: int, c2: int, backend: Backend = Backend.CUDA,
                      fused: bool = True):
    """The paper's full search on the arrays' device.  Returns (scores
    (Q, h), ids (Q, h), pass-1 ids (Q, c1)); ids are positions in
    cache-sorted row order (callers map through pi).

    ``fused`` routes pass 1 through the fused scan-and-select on the kernel
    backends whenever c1 fits its buffer: the same bits, minus the (Q, N)
    round trip through device memory."""
    lut = adc_lut(q_dense, arrays.codebooks)

    # pass 1: approximate scores on the full shard, overfetch c1
    if _use_fused_pass1(backend, fused, c1):
        s1, ids1 = _fused_pass1_topk(arrays, q_dims, q_vals, lut, c1, backend)
    else:
        approx = pass1_scores(arrays, q_dims, q_vals, lut, backend)
        s1, ids1 = res.topk_candidates(approx, c1)

    # pass 2: + dense residual, keep c2
    extra_d = res.dense_residual_scores(arrays.dense_residual, ids1, q_dense)
    s2, ids2 = res.reorder_pass(s1, ids1, extra_d, c2)

    # pass 3: + sparse residual, return h
    q_cols = scatter_queries_compact(q_dims, q_vals, arrays.d_active)
    extra_s = res.sparse_residual_scores(arrays.sparse_residual, ids2, q_cols)
    s3, ids3 = res.reorder_pass(s2, ids2, extra_s, h)
    return s3, ids3, ids1


# ---------------------------------------------------------------------------
# ScoringEngine — thin stateful façade over the search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScoringEngine:
    """Owns the device-resident index + backend choice.  ``fused`` (default
    on) lets the kernel backends take the fused scan-and-select pass 1;
    turn it off to force materialise-then-select."""
    arrays: IndexArrays
    backend: Backend = Backend.CUDA
    fused: bool = True

    def __post_init__(self):
        # fail at construction, not at the first search deep inside the
        # kernel wrapper: the packed LUT16 kernel reads 16 codewords
        if (self.backend is Backend.CUDA_PACKED and self.arrays.codes_packed
                and self.arrays.codebooks.num_codes != 16):
            raise ValueError(
                "Backend.CUDA_PACKED requires l == 16 codewords, got "
                f"l={self.arrays.codebooks.num_codes}; scan packed codes "
                "with smaller codebooks via the ref/onehot backends")

    @property
    def num_points(self) -> int:
        return self.arrays.num_points

    def candidate_counts(self, h: int, alpha: int, beta: int) -> tuple[int, int]:
        c1 = min(max(alpha * h, h), self.num_points)
        c2 = min(max(beta * h, h), c1)
        return c1, c2

    def search(self, q_dims: torch.Tensor, q_vals: torch.Tensor,
               q_dense: torch.Tensor, *, h: int, alpha: int, beta: int):
        """Three-pass device search.  Returns (scores, ids, pass1_ids) in
        cache-sorted row positions."""
        c1, c2 = self.candidate_counts(h, alpha, beta)
        return three_pass_search(self.arrays, q_dims, q_vals, q_dense,
                                 h=h, c1=c1, c2=c2, backend=self.backend,
                                 fused=self.fused)

    def pass1_topk(self, q_dims: torch.Tensor, q_vals: torch.Tensor,
                   lut: torch.Tensor, k: int):
        """Pass-1-only local top-k (the distributed fan-out building block):
        the same route, and the same bits, as pass 1 of ``search``."""
        if _use_fused_pass1(self.backend, self.fused, k):
            return _fused_pass1_topk(self.arrays, q_dims, q_vals, lut, k,
                                     self.backend)
        scores = pass1_scores(self.arrays, q_dims, q_vals, lut, self.backend)
        return res.topk_candidates(scores, k)


# ---------------------------------------------------------------------------
# Serving hooks (DESIGN.md §5): result-cache fingerprints and the donation
# hook for double-buffered IndexArrays swaps
# ---------------------------------------------------------------------------

def query_fingerprint(q_dims, q_vals, q_dense, *extra) -> str:
    """Content hash of one query (or query batch) for result caching; a
    copy of the JAX package's, so the same bytes give the same key.

    Hashes the raw bytes of the padded sparse query (dims + vals), the dense
    query, and any extra context (search params, index generation) — two
    requests collide only if every input byte agrees, so a cache keyed on
    this digest can never serve a stale or mismatched result.  Host-side
    numpy; meant to run once per request on arrays that are already on host.
    """
    h = hashlib.blake2b(digest_size=16)
    for a in (q_dims, q_vals, q_dense):
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    for e in extra:
        h.update(repr(e).encode())
    return h.hexdigest()


def _tensors(tree):
    """Every tensor reachable through nested dataclasses, lists, tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


def _storage_key(t: torch.Tensor) -> tuple:
    st = t.untyped_storage()
    return (t.device, st.data_ptr())


def release_index_arrays(arrays: IndexArrays, *, keep=()) -> int:
    """Donation hook for double-buffered index swaps (DESIGN.md §5).

    Frees the storages of a RETIRED ``IndexArrays`` copy so their device
    memory goes back to the caching allocator at once, while other Python
    references may still exist: ``untyped_storage().resize_(0)``, the
    counterpart of JAX's ``Array.delete()``.  Each tensor of ``arrays``
    whose storage is freed (now, or already by an earlier call through
    another view) is then set to an empty tensor, so a later use of a
    retired leaf fails on its shape instead of reading freed memory.

    A storage that any tensor of the ``keep`` trees also uses is skipped.
    The comparison is by STORAGE, not by tensor object: a shard of
    ``split_index_arrays`` holds views of its parent's codes and residual
    rows (a row slice is already contiguous), and freeing a view's storage
    would free the parent's.  Storages that do not own their memory are
    skipped too (a CPU tensor made by ``torch.from_numpy`` borrows the
    array's; it goes when its last reference does).  Returns the number of
    storages freed.  Callers must
    ensure no in-flight computation still reads ``arrays`` (QueryService
    refcounts generations for exactly this); work already queued on the
    same stream is safe, since the allocator hands the block out again
    only to work queued after it."""
    keep_keys = {_storage_key(t) for tree in keep for t in _tensors(tree)}
    freed = 0
    for t, key in [(t, _storage_key(t)) for t in _tensors(arrays)]:
        st = t.untyped_storage()
        if key in keep_keys or not st.resizable():
            continue
        if st.nbytes():
            st.resize_(0)
            freed += 1
        t.set_()
    return freed
