"""The paper's §7.2 baselines on a torch device (counterpart of
``repro.core.baselines``).

Every baseline returns (ids, scores) of shape (Q, h) as numpy plus wall
time, as the reference does:

  * dense_brute_force          — sparse padded to dense, full f32 matmul
  * sparse_brute_force         — dense appended to sparse, exact CSR product
  * sparse_inverted_index      — same conversion, exact inverted-index scan
  * hamming512                 — 512 Rademacher sign bits, Hamming scan,
                                 overfetch 5000, exact rerank
  * dense_pq_reorder           — PQ over the dense component only, overfetch,
                                 exact rerank
  * sparse_only                — inverted index over the sparse component only,
                                 optional exact rerank

The index-side tensors are made on ``device`` before the timed window, as
the reference makes its index-side arrays before ``t0``.  The window starts
and ends with a device synchronize and covers what the reference's covers:
the host query arrays go in, the numpy (ids, scores) come out.
``BaselineResult.build_seconds`` is the wall time of the index-side work
before it.  Every top-k breaks ties toward the lowest index
(``kernels.ref.stable_topk``), where the reference's order among equal
scores is unspecified.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..device import full_f32, resolve_device
from ..kernels.ref import stable_topk
from .engine import Backend, adc_scores
from .pq import adc_lut, pq_encode, train_codebooks
from .sparse_index import PaddedSparseRows, build_padded_rows, score_rows

__all__ = [
    "BaselineResult", "dense_brute_force", "sparse_brute_force",
    "sparse_inverted_index", "hamming512", "dense_pq_reorder", "sparse_only",
    "exact_topk", "exact_scores", "recall_at_h",
]

# popcount of every byte value, the Hamming scan's lookup table
_POPCOUNT = np.array([bin(v).count("1") for v in range(256)], np.uint8)
# bit weights of one packed byte, first bit in the high bit (np.packbits)
_BIT_WEIGHTS = 1 << np.arange(7, -1, -1)
# elements of the (queries, N, bytes) XOR block the Hamming scan holds at once
_HAMMING_BLOCK = 1 << 27
# elements of the row blocks a sparse matrix is densified in (32-bit indexing)
_DENSE_BLOCK = (1 << 31) - 1


@dataclasses.dataclass
class BaselineResult:
    name: str
    ids: np.ndarray
    scores: np.ndarray
    seconds: float
    # wall seconds of the index-side work made before the timed window
    build_seconds: float = 0.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Window:
    """The timed window: a synchronize at both ends; ``build_seconds``
    spans from the window's creation to its start."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.t_build = time.perf_counter()

    def __enter__(self):
        _sync(self.dev)
        self.t0 = time.perf_counter()
        self.build_seconds = self.t0 - self.t_build
        return self

    def __exit__(self, *exc):
        _sync(self.dev)
        self.seconds = time.perf_counter() - self.t0
        return False

    def result(self, name, ids, scores) -> BaselineResult:
        return BaselineResult(name, ids, scores, self.seconds,
                              self.build_seconds)


def _topk(scores: torch.Tensor, h: int):
    """Top-h along dim 1, best first, ties toward the lowest index.
    Returns (int64 ids, scores)."""
    vals, idx = stable_topk(scores, min(h, scores.shape[1]))
    return idx.long(), vals


def _numpy(ids: torch.Tensor, scores: torch.Tensor):
    return ids.cpu().numpy(), scores.cpu().numpy()


def _csr_tensor(crow, col, val, shape) -> torch.Tensor:
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, val, size=shape)


def _upload_csr(x, dev: torch.device) -> torch.Tensor:
    """A scipy CSR matrix as a torch sparse CSR tensor (int64 indices, f32
    values) on ``dev``, entries in the same order."""
    xs = sp.csr_matrix(x, dtype=np.float32)
    return _csr_tensor(
        torch.from_numpy(xs.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(xs.indices.astype(np.int64)).to(dev),
        torch.from_numpy(xs.data).to(dev), xs.shape)


def _hybrid_as_sparse(x_sparse, x_dense, *, device="cuda") -> torch.Tensor:
    """The hybrid rows [x_sparse | x_dense] as one sparse CSR tensor on
    ``device``, built there: each row holds its sparse entries in their CSR
    order, then its nonzero dense entries in column order at d_sparse + j,
    the entries of the reference's ``sp.hstack(...).tocsr()``."""
    dev = resolve_device(device)
    xs = sp.csr_matrix(x_sparse, dtype=np.float32)
    n, d_s = xs.shape
    xd = torch.from_numpy(np.asarray(x_dense, np.float32)).to(dev)
    d_d = xd.shape[1]
    ptr_s = torch.from_numpy(xs.indptr.astype(np.int64)).to(dev)
    len_s = ptr_s[1:] - ptr_s[:-1]
    nz_r, nz_c = torch.nonzero(xd, as_tuple=True)           # row-major order
    len_d = torch.bincount(nz_r, minlength=n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(len_s + len_d, 0, out=crow[1:])
    nnz = int(crow[-1])
    col = torch.empty(nnz, dtype=torch.int64, device=dev)
    val = torch.empty(nnz, dtype=torch.float32, device=dev)
    # a sparse entry e of row r goes to crow[r] + (e - ptr_s[r]); the k-th
    # dense nonzero of the matrix, in row r, to crow[r] + len_s[r] + (k -
    # its row's first k)
    rows_s = torch.repeat_interleave(torch.arange(n, device=dev), len_s)
    pos_s = crow[rows_s] + torch.arange(xs.nnz, device=dev) - ptr_s[rows_s]
    col[pos_s] = torch.from_numpy(xs.indices.astype(np.int64)).to(dev)
    val[pos_s] = torch.from_numpy(xs.data).to(dev)
    first_d = torch.cumsum(len_d, 0) - len_d
    pos_d = (crow[nz_r] + len_s[nz_r]
             + torch.arange(nz_r.shape[0], device=dev) - first_d[nz_r])
    col[pos_d] = nz_c + d_s
    val[pos_d] = xd[nz_r, nz_c]
    return _csr_tensor(crow, col, val, (n, d_s + d_d))


def _dense_rows(x_csr: torch.Tensor, pad: bool = False) -> torch.Tensor:
    """A sparse CSR tensor as a dense (rows, d) block, or (rows, d + 1) with
    a trailing zero column (the pad slot of ``score_rows``).  Filled in row
    blocks of under 2^31 elements (a densified corpus may hold billions)."""
    n, d = x_csr.shape
    width = d + int(pad)
    out = torch.zeros((n, width), dtype=torch.float32, device=x_csr.device)
    crow, col, val = x_csr.crow_indices(), x_csr.col_indices(), x_csr.values()
    step = max(1, _DENSE_BLOCK // max(width, 1))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        lo, hi = int(crow[r0]), int(crow[r1])
        rows = torch.repeat_interleave(
            torch.arange(r1 - r0, device=out.device),
            crow[r0 + 1:r1 + 1] - crow[r0:r1])
        # accumulate: a duplicated entry sums, as scipy's toarray() does
        out[r0:r1].index_put_((rows, col[lo:hi]), val[lo:hi],
                              accumulate=True)
    return out


def _scores_csr(x_csr: torch.Tensor, q_dense: torch.Tensor) -> torch.Tensor:
    """(N, d) sparse CSR x (Q, d) dense queries -> (Q, N) scores."""
    return (x_csr @ q_dense.T).T


def exact_scores(q_sparse, q_dense, x_sparse, x_dense, *,
                 device="cuda") -> torch.Tensor:
    """Brute-force q·x over the hybrid vectors, (Q, N) on ``device``, in
    full f32: the sparse part as a CSR matrix times the densified query
    block, plus the dense product."""
    dev = resolve_device(device)
    x_csr = _upload_csr(x_sparse, dev)
    qs = _dense_rows(_upload_csr(q_sparse, dev))
    qd = torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev)
    xd = torch.from_numpy(np.asarray(x_dense, np.float32)).to(dev)
    with full_f32():
        return _scores_csr(x_csr, qs) + qd @ xd.T


def exact_topk(q_sparse, q_dense, x_sparse, x_dense, h: int, *,
               device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Brute-force top-``h`` of q·x over the hybrid vectors on ``device``.

    Returns ``(ids, scores)``, each (Q, h), best first."""
    scores = exact_scores(q_sparse, q_dense, x_sparse, x_dense,
                          device=device)
    s, ids = torch.topk(scores, h, dim=1)
    return ids.cpu().numpy(), s.cpu().numpy()


def recall_at_h(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    hits = 0
    for f, t in zip(found_ids, true_ids):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / true_ids.size


# ---------------------------------------------------------------------------

def dense_brute_force(q_sparse, q_dense, x_sparse, x_dense, h: int = 20, *,
                      device="cuda"):
    """Pad 0's to the sparse component; everything dense.  The data block
    is densified on the device (the reference densifies on the host)."""
    dev = resolve_device(device)
    win = _Window(dev)
    xd = _dense_rows(_hybrid_as_sparse(x_sparse, x_dense, device=dev))
    qd = _dense_rows(_hybrid_as_sparse(q_sparse, q_dense, device="cpu"))
    with win, full_f32():
        scores = qd.to(dev) @ xd.T
        ids, sc = _numpy(*_topk(scores, h))
    return win.result("dense_brute_force", ids, sc)


def sparse_brute_force(q_sparse, q_dense, x_sparse, x_dense, h: int = 20, *,
                       device="cuda"):
    """Append dense dims to the sparse representation; exact CSR product
    (the CSR data matrix times the densified query block)."""
    dev = resolve_device(device)
    win = _Window(dev)
    x_all = _hybrid_as_sparse(x_sparse, x_dense, device=dev)
    q_all = _hybrid_as_sparse(q_sparse, q_dense, device="cpu")
    with win:
        scores = _scores_csr(x_all, _dense_rows(q_all.to(dev)))
        ids, sc = _numpy(*_topk(scores, h))
    return win.result("sparse_brute_force", ids, sc)


def sparse_inverted_index(q_sparse, q_dense, x_sparse, x_dense, h: int = 20,
                          *, device="cuda"):
    """Exact accumulation over inverted lists (CSC), the paper's exact
    inverted-index baseline (dense dims become full lists — the pathology the
    paper calls out).

    One query at a time, its lists in slot order, each added as
    ``acc.index_add_(0, rows, data * qv)``: the rows of one list are
    distinct, so every (query, row) sum takes the reference's float32 adds
    in the reference's order, bit for bit."""
    dev = resolve_device(device)
    win = _Window(dev)
    x_all = _hybrid_as_sparse(x_sparse, x_dense, device=dev)
    n, d = x_all.shape
    # CSC: the CSR entries stably sorted by column, so each list keeps its
    # rows in row order (scipy's tocsc)
    crow = x_all.crow_indices()
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   crow[1:] - crow[:-1])
    cols, order = torch.sort(x_all.col_indices(), stable=True)
    list_rows = rows[order]
    list_data = x_all.values()[order]
    col_ptr = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(cols, minlength=d), 0, out=col_ptr[1:])
    col_ptr = col_ptr.cpu().numpy()
    q_all = _hybrid_as_sparse(q_sparse, q_dense, device="cpu")
    q_ptr = q_all.crow_indices().numpy()
    q_cols = q_all.col_indices().numpy()
    q_data = q_all.values().numpy()
    with win:
        qn = q_all.shape[0]
        out_ids = torch.zeros((qn, h), dtype=torch.int64, device=dev)
        out_sc = torch.zeros((qn, h), dtype=torch.float32, device=dev)
        for i in range(qn):
            acc = torch.zeros(n, dtype=torch.float32, device=dev)
            for j, qv in zip(q_cols[q_ptr[i]:q_ptr[i + 1]],
                             q_data[q_ptr[i]:q_ptr[i + 1]]):
                lo, hi = col_ptr[j], col_ptr[j + 1]
                acc.index_add_(0, list_rows[lo:hi],
                               list_data[lo:hi] * float(qv))
            ids, sc = _topk(acc[None], h)
            out_ids[i], out_sc[i] = ids[0], sc[0]
        ids, sc = _numpy(out_ids, out_sc)
    return win.result("sparse_inverted_index", ids, sc)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(M, B) bool -> (M, ceil(B/8)) uint8, first bit in the high bit of
    each byte (``np.packbits(..., axis=1)``)."""
    m, b = bits.shape
    v = torch.nn.functional.pad(bits.int(), (0, -b % 8))
    w = torch.from_numpy(_BIT_WEIGHTS.astype(np.int32)).to(bits.device)
    return (v.reshape(m, -1, 8) * w).sum(-1, dtype=torch.int32).to(
        torch.uint8)


def _median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0, as ``np.median``: the mean of the two middle
    values for an even count (``torch.median`` returns the lower one)."""
    n = x.shape[0]
    upper = torch.kthvalue(x, n // 2 + 1, dim=0).values
    if n % 2:
        return upper
    return (torch.kthvalue(x, n // 2, dim=0).values + upper) / 2


def _hamming(x_bits: torch.Tensor, q_bits: torch.Tensor) -> torch.Tensor:
    """(Q, N) Hamming distances of packed bit rows: XOR, then a 256-entry
    popcount table, a block of queries at a time so that the (Q, N, bytes)
    XOR is never held whole."""
    n, nb = x_bits.shape
    table = torch.from_numpy(_POPCOUNT).to(x_bits.device)
    step = max(1, _HAMMING_BLOCK // (n * nb))
    out = []
    for s in range(0, q_bits.shape[0], step):
        xor = x_bits[None] ^ q_bits[s:s + step, None]
        out.append(table[xor.int()].sum(-1, dtype=torch.int32))
    return torch.cat(out)


def _hamming_index(x_sparse, x_dense, bits: int, seed: int,
                   dev: torch.device):
    """The hashing baseline's index side on ``dev``: the reference's
    Rademacher draws ``(r_s, r_d)``, the per-bit median of the data's
    projections and the data's packed sign bits (N, bits / 8)."""
    rng = np.random.default_rng(seed)
    d_s = x_sparse.shape[1]
    d_d = x_dense.shape[1]
    r_s = rng.choice([-1.0, 1.0], size=(d_s, bits)).astype(np.float32)
    r_d = rng.choice([-1.0, 1.0], size=(d_d, bits)).astype(np.float32)
    r_s = torch.from_numpy(r_s).to(dev)
    r_d = torch.from_numpy(r_d).to(dev)
    xd = torch.from_numpy(np.asarray(x_dense, np.float32)).to(dev)
    with full_f32():
        xp = _upload_csr(x_sparse, dev) @ r_s + xd @ r_d
    med = _median_rows(xp)
    return (r_s, r_d), med, _pack_bits(xp > med)


def hamming512(q_sparse, q_dense, x_sparse, x_dense, h: int = 20,
               bits: int = 512, overfetch: int = 5000, seed: int = 0, *,
               device="cuda"):
    """Paper's hashing baseline: project on `bits` Rademacher vectors, median
    threshold, Hamming scan, exact rerank of `overfetch`.  The reference's
    draws, moved to the device; the projections, the median and the data's
    bits are made before the window, as in the reference."""
    dev = resolve_device(device)
    win = _Window(dev)
    (r_s, r_d), med, x_bits = _hamming_index(x_sparse, x_dense, bits, seed,
                                             dev)
    with full_f32():
        qp = (_upload_csr(q_sparse, dev) @ r_s
              + torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev) @ r_d)
    x_rows, x_dense_t = _rerank_index(x_sparse, x_dense, dev)
    with win:
        q_bits = _pack_bits(qp > med)
        pop = _hamming(x_bits, q_bits)
        cand, _ = _topk(-pop.float(), min(overfetch, x_bits.shape[0]))
        ids, sc = _numpy(*_rerank_exact(cand, q_sparse, q_dense, x_rows,
                                        x_dense_t, h))
    return win.result("hamming512", ids, sc)


def _rerank_index(x_sparse, x_dense, dev: torch.device):
    """The index side of the exact rerank on ``dev``: the sparse rows padded
    (``PaddedSparseRows``, pad column d_sparse) and the dense rows."""
    return (build_padded_rows(sp.csr_matrix(x_sparse, dtype=np.float32),
                              device=dev),
            torch.from_numpy(np.asarray(x_dense, np.float32)).to(dev))


def _rerank_exact(cand: torch.Tensor, q_sparse, q_dense,
                  x_rows: PaddedSparseRows, x_dense: torch.Tensor, h: int):
    """Exact hybrid scores of each query's candidates, then their top-h.
    cand: (Q, C) row ids on the device of ``x_rows`` / ``x_dense``
    (``_rerank_index``).  Returns (ids (Q, h), scores (Q, h))."""
    dev = cand.device
    qs = _dense_rows(_upload_csr(q_sparse, dev), pad=True)      # (Q, d_s + 1)
    qd = torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev)
    sc = (score_rows(x_rows, cand, qs)
          + torch.einsum("qcd,qd->qc", x_dense[cand], qd))
    pos, s = _topk(sc, h)
    return torch.gather(cand, 1, pos), s


def dense_pq_reorder(q_sparse, q_dense, x_sparse, x_dense, h: int = 20,
                     overfetch: int = 10000, subspaces: int | None = None,
                     seed: int = 0, *, device="cuda"):
    """Paper baseline 'Dense PQ, Reordering 10k': PQ over the dense component
    only, overfetch, exact hybrid rerank.  Codebooks from the port's
    ``train_codebooks``; the scan is the engine's ADC on the kernel backend
    (K1 on the card, its plain version on the CPU)."""
    dev = resolve_device(device)
    win = _Window(dev)
    xd = torch.from_numpy(np.asarray(x_dense, np.float32)).to(dev)
    k = subspaces or max(x_dense.shape[1] // 2, 1)
    cb = train_codebooks(xd, k, 16, seed=seed)
    codes = pq_encode(xd, cb)
    x_rows, x_dense_t = _rerank_index(x_sparse, x_dense, dev)
    with win:
        lut = adc_lut(torch.from_numpy(np.asarray(q_dense, np.float32)).to(dev),
                      cb)
        scores = adc_scores(codes, lut, Backend.CUDA)
        cand, _ = _topk(scores, min(overfetch, scores.shape[1]))
        ids, sc = _numpy(*_rerank_exact(cand, q_sparse, q_dense, x_rows,
                                        x_dense_t, h))
    return win.result("dense_pq_reorder", ids, sc)


def sparse_only(q_sparse, q_dense, x_sparse, x_dense, h: int = 20,
                overfetch: int | None = None, *, device="cuda"):
    """Paper baselines 'Sparse Inverted Index, No Reordering / Reordering 20k'."""
    dev = resolve_device(device)
    win = _Window(dev)
    x_s = _upload_csr(x_sparse, dev)
    if overfetch is not None:
        x_rows, x_dense_t = _rerank_index(x_sparse, x_dense, dev)
    with win:
        scores = _scores_csr(x_s, _dense_rows(_upload_csr(q_sparse, dev)))
        if overfetch is None:
            ids, sc = _topk(scores, h)
            name = "sparse_only_no_reorder"
        else:
            cand, _ = _topk(scores, min(overfetch, scores.shape[1]))
            ids, sc = _rerank_exact(cand, q_sparse, q_dense, x_rows,
                                    x_dense_t, h)
            name = f"sparse_only_reorder{overfetch}"
        ids, sc = _numpy(ids, sc)
    return win.result(name, ids, sc)
