"""Plain reference of the three-pass hybrid search, the judge of ``correct``.

Plain PyTorch on whatever device its tensors are on.  It imports nothing
of the program under test nor of the JAX package; the harness hands it
the benchmark's own inputs as plain tensors.

The search (paper §5-§6) scores every row x of the index for a query q in
three passes, each keeping the best of the last:

* pass 1, over all N rows: the PQ approximation of the dense part (the sum
  of K LUT entries, LUT[k, c] = q_dense^(k) · centers[k, c]) plus the
  sparse part that the pruned data index holds; keep c1;
* pass 2: plus q_dense · the dequantized int8 dense residual; keep c2;
* pass 3: plus the sparse residual (the entries the pruning left out);
  keep h.

A row's final score is the sum of the three terms whichever pass it came
through.  ``judge`` computes everything in float64 and reads two numbers
from the program's answer rows (ids and scores):

* ``score_err``: the widest gap between a returned score and the float64
  final score of the returned id, over the reference's best score;
* ``rank_gap``: the widest amount, over the reference's best score, by
  which the j-th best of the returned ids' float64 scores lies below the
  reference's own j-th best answer.  Float32 sums can break a near tie at
  a pass's cut the other way and swap one candidate for another, which
  can change the answer as much as a fault would; so where the gap passes
  ``TIE``, the passes are run again with each way the cuts may fall among
  candidates within ``TIE`` of the cut (of the reference's best score),
  and the least gap counts.  A wrong or missing id leaves a gap of the
  size of the scores, and so does a repeated one: every repeat of an id
  within a row counts as an invalid id, of score -inf, which also makes
  ``score_err`` infinite.

Two forms of data share the passes.  ``ShardData`` is an index drawn
directly (the codes, posting lists and residual rows are the inputs);
``RawData`` holds a raw hybrid corpus (sparse rows and dense vectors) and
derives the pruned split and the int8 residual from it as the paper's
build does, taking from the build it judges only what has no independent
reference: the trained PQ codebooks, each row's codes and the row order.

``precision`` is ``f64`` for the judge and ``f32``, ``tf32`` or ``bf16``
for a control: every float input of a product rounded to that precision
and sums taken in float32, the reference put in the program's place one
precision lower.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

PRECISIONS = ("f64", "f32", "tf32", "bf16")


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` in the precision's accumulation dtype (float64 for ``f64``,
    float32 otherwise), its mantissa rounded to the precision's width."""
    if precision == "f64":
        return x.double()
    x = x.float()
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if precision == "f32":
        return x
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def _lut(q_dense: torch.Tensor, centers: torch.Tensor,
         precision: str) -> torch.Tensor:
    """(Q, K, l) LUT from (Q, K·p) dense queries and (K, l, p) centers, by
    products and sums (no matrix unit, so no TF32 setting changes it)."""
    k, _, p = centers.shape
    qd = rounded(q_dense, precision).reshape(q_dense.shape[0], k, p)
    lut = (qd[:, :, None, :] * rounded(centers, precision)[None]).sum(-1)
    return rounded(lut, precision)


def _adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, nb) sums of LUT entries for ``codes`` (nb, K) uint8."""
    acc = torch.zeros((lut.shape[0], codes.shape[0]), dtype=lut.dtype,
                      device=lut.device)
    for k in range(codes.shape[1]):
        acc += lut[:, k, :].index_select(1, codes[:, k].long())
    return acc


# ---------------------------------------------------------------------------
# an index drawn directly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardData:
    """A drawn index shard: codes (N, K) uint8; centers (K, l, p); posting
    lists inv_rows (D, L) int32 (ids >= N or < 0 are padding) and inv_vals
    (D, L); the int8 dense residual res_q (N, d) with res_scale and
    res_zero (d,) (value = scale·(q + 128) + zero); the sparse residual
    rows sres_cols (N, R) int32 in [0, D] (D: padding) and sres_vals."""
    codes: torch.Tensor
    centers: torch.Tensor
    inv_rows: torch.Tensor
    inv_vals: torch.Tensor
    res_q: torch.Tensor
    res_scale: torch.Tensor
    res_zero: torch.Tensor
    sres_cols: torch.Tensor
    sres_vals: torch.Tensor

    @property
    def n(self) -> int:
        return self.codes.shape[0]


class ShardScorer:
    """The three terms of ``ShardData``'s rows for Q sparse queries given
    as (Q, nq) dims in [0, D) (others are padding) with values, and (Q, d)
    dense queries."""

    def __init__(self, data: ShardData, q_dims: torch.Tensor,
                 q_vals: torch.Tensor, q_dense: torch.Tensor,
                 precision: str):
        self.data, self.precision = data, precision
        self.n, self.q = data.n, q_dims.shape[0]
        self.q_dense = rounded(q_dense, precision)
        self.lut = _lut(q_dense, data.centers, precision)
        d_act = data.inv_rows.shape[0]
        dims = q_dims.long()
        valid = (dims >= 0) & (dims < d_act)
        dims = torch.where(valid, dims, torch.zeros_like(dims))
        qv = rounded(q_vals, precision) * valid
        rows = data.inv_rows[dims].long()                   # (Q, nq, L)
        vals = rounded(data.inv_vals[dims], precision) * qv[..., None]
        keep = valid[..., None] & (rows >= 0) & (rows < self.n)
        qidx = torch.arange(self.q, device=dims.device)[:, None, None]
        self.post_q = qidx.expand_as(rows)[keep]
        self.post_row = rows[keep]
        self.post_val = vals[keep]
        self.q_cols = torch.zeros((self.q, d_act + 1), dtype=qv.dtype,
                                  device=dims.device)
        self.q_cols.scatter_add_(1, dims, qv)
        self.q_cols[:, d_act] = 0

    def approx(self, lo: int, hi: int) -> torch.Tensor:
        nb = hi - lo
        acc = _adc(self.lut, self.data.codes[lo:hi])
        sel = (self.post_row >= lo) & (self.post_row < hi)
        acc.view(-1).index_add_(
            0, self.post_q[sel] * nb + self.post_row[sel] - lo,
            self.post_val[sel])
        return acc

    def dense(self, ids: torch.Tensor) -> torch.Tensor:
        d = self.data
        deq = rounded((d.res_q[ids].double() + 128.0)
                      * d.res_scale.double() + d.res_zero.double(),
                      self.precision)
        return (deq * self.q_dense[:, None, :]).sum(-1)

    def sparse(self, ids: torch.Tensor) -> torch.Tensor:
        cols = self.data.sres_cols[ids].long()              # (Q, C, R)
        vals = rounded(self.data.sres_vals[ids], self.precision)
        g = self.q_cols.gather(1, cols.reshape(self.q, -1)).view(cols.shape)
        return (vals * g).sum(-1)


# ---------------------------------------------------------------------------
# a raw corpus, with the build's pruning and quantization worked out again
# ---------------------------------------------------------------------------

def prune_mask(cols: torch.Tensor, vals: torch.Tensor, d: int,
               keep_top: int) -> torch.Tensor:
    """The paper's per-dimension magnitude pruning (§4.2, Eq. 6): in each
    column the entries whose |value| is at least the keep_top-th largest
    |value| of that column (all of a column with fewer entries)."""
    mag = vals.abs()
    order = torch.argsort(mag, descending=True, stable=True)
    order = order[torch.argsort(cols[order], stable=True)]
    counts = torch.bincount(cols, minlength=d)
    start = torch.cumsum(counts, 0) - counts
    kth = start + keep_top - 1
    thr = torch.zeros(d, dtype=mag.dtype, device=mag.device)
    big = counts > keep_top
    thr[big] = mag[order[kth[big]]]
    return mag >= thr[cols]


def scalar_dequantized(x: torch.Tensor) -> torch.Tensor:
    """Per-dimension affine int8 quantization of (N, d) float32 ``x`` and
    back (paper §6.1.1, K_V = d, l = 256): scale = range·f32(1/255), codes
    round((x - min) / scale) clamped to [0, 255]."""
    x = x.float()
    lo = x.min(dim=0).values
    scale = torch.clamp_min(x.max(dim=0).values - lo, 1e-12) * torch.tensor(
        1.0 / 255.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round((x - lo) / scale), 0, 255)
    return q * scale + lo


@dataclasses.dataclass
class RawData:
    """A raw hybrid corpus in its own row order, padded to W entries a row
    (``cols`` padded with ``d_sparse``): ``kept`` the pruned data index's
    values (0 elsewhere), ``resid`` the sparse residual's; ``codes`` (N, K)
    and ``centers`` the build's PQ (rows in this order); ``deq`` the
    dense residual dequantized."""
    cols: torch.Tensor
    kept: torch.Tensor
    resid: torch.Tensor
    codes: torch.Tensor
    centers: torch.Tensor
    deq: torch.Tensor
    d_sparse: int

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @classmethod
    def derive(cls, indptr: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor, x_dense: torch.Tensor, d_sparse: int,
               keep_top: int, codes: torch.Tensor,
               centers: torch.Tensor) -> "RawData":
        """From CSR rows (``indptr``, ``cols``, ``vals``), the dense
        vectors, and the build's codes and centers."""
        n = indptr.shape[0] - 1
        lens = indptr[1:] - indptr[:-1]
        width = max(int(lens.max()), 1) if n else 1
        row = torch.repeat_interleave(torch.arange(n, device=cols.device),
                                      lens)
        slot = torch.arange(cols.shape[0], device=cols.device) - indptr[row]
        keep = prune_mask(cols, vals, d_sparse, keep_top)
        pc = torch.full((n, width), d_sparse, dtype=torch.long,
                        device=cols.device)
        pk = torch.zeros((n, width), dtype=torch.float32, device=cols.device)
        pr = torch.zeros_like(pk)
        pc[row, slot] = cols.long()
        pk[row, slot] = torch.where(keep, vals.float(), 0.0)
        pr[row, slot] = torch.where(keep, 0.0, vals.float())
        k, _, p = centers.shape
        decoded = centers[torch.arange(k, device=codes.device)[None, :],
                          codes.long()].reshape(n, k * p)
        deq = scalar_dequantized(x_dense.float() - decoded)
        return cls(cols=pc, kept=pk, resid=pr, codes=codes, centers=centers,
                   deq=deq, d_sparse=d_sparse)


class RawScorer:
    """The three terms of ``RawData``'s rows for Q sparse queries given as
    CSR rows over the raw columns, and (Q, d) dense queries."""

    def __init__(self, data: RawData, q_indptr: torch.Tensor,
                 q_cols: torch.Tensor, q_vals: torch.Tensor,
                 q_dense: torch.Tensor, precision: str):
        self.data, self.precision = data, precision
        self.n, self.q = data.n, q_indptr.shape[0] - 1
        self.q_dense = rounded(q_dense, precision)
        self.lut = _lut(q_dense, data.centers, precision)
        lens = q_indptr[1:] - q_indptr[:-1]
        row = torch.repeat_interleave(
            torch.arange(self.q, device=q_cols.device), lens)
        self.qmat = torch.zeros((self.q, data.d_sparse + 1),
                                dtype=self.q_dense.dtype,
                                device=q_cols.device)
        self.qmat.index_put_((row, q_cols.long()),
                             rounded(q_vals, precision), accumulate=True)
        self.qmat[:, data.d_sparse] = 0
        self.kept = rounded(data.kept, precision)
        self.resid = rounded(data.resid, precision)
        self.deq = rounded(data.deq, precision)

    def approx(self, lo: int, hi: int) -> torch.Tensor:
        acc = _adc(self.lut, self.data.codes[lo:hi])
        cols = self.data.cols[lo:hi]
        g = self.qmat[:, cols.reshape(-1)].view(self.q, *cols.shape)
        return acc + (g * self.kept[lo:hi][None]).sum(-1)

    def dense(self, ids: torch.Tensor) -> torch.Tensor:
        return (self.deq[ids] * self.q_dense[:, None, :]).sum(-1)

    def sparse(self, ids: torch.Tensor) -> torch.Tensor:
        cols = self.data.cols[ids]                          # (Q, C, W)
        g = self.qmat.gather(1, cols.reshape(self.q, -1)).view(cols.shape)
        return (self.resid[ids] * g).sum(-1)


def codes_far(x_dense: torch.Tensor, codes: torch.Tensor,
              centers: torch.Tensor, rows: int = 1 << 16) -> int:
    """Rows whose code lies farther than the nearest codeword in some
    subspace by more than 1e-4 of the squared norms: the check of the PQ
    encoding, the build stage whose codes the reference takes as given."""
    k, _, p = centers.shape
    c = centers.double()
    far = 0
    for lo in range(0, codes.shape[0], rows):
        x = x_dense[lo:lo + rows].double().reshape(-1, k, p)
        d2 = ((x[:, :, None, :] - c[None]) ** 2).sum(-1)    # (n, K, l)
        got = d2.gather(2, codes[lo:lo + rows].long()[..., None])[..., 0]
        tol = 1e-4 * ((x ** 2).sum(-1) + (c ** 2).sum(-1).max(-1).values)
        far += int((got > d2.min(-1).values + tol + 1e-12).any(-1).sum())
    return far


# ---------------------------------------------------------------------------
# the passes and the judge
# ---------------------------------------------------------------------------

TIE = 1e-5          # a near tie at a cut: within this share of the best
SPARE = 16          # pass-1 candidates kept past c1 to find near ties
_MAX_WAYS = 64      # resolutions of one cut tried at most


def three_pass(scorer, *, h: int, c1: int, c2: int, block: int,
               extra: torch.Tensor | None = None, spare: int = 0):
    """The reference search: (scores (Q, h), ids (Q, h)) best first; the
    pass-1 scores of the (Q, E) row ids ``extra`` (None: not asked); and
    pass 1's best c1 + ``spare`` (scores, ids), best first."""
    keep = c1 + spare
    best_s = best_i = None
    extra_a = None
    if extra is not None:
        extra_a = torch.full(extra.shape, float("nan"),
                             dtype=scorer.lut.dtype, device=extra.device)
    for lo in range(0, scorer.n, block):
        hi = min(scorer.n, lo + block)
        a = scorer.approx(lo, hi)
        if extra is not None:
            inside = (extra >= lo) & (extra < hi)
            got = a.gather(1, (extra - lo).clamp(0, hi - lo - 1))
            extra_a = torch.where(inside, got, extra_a)
        s, i = a.topk(min(keep, hi - lo), dim=1)
        i = i + lo
        if best_s is not None:
            s, pos = torch.cat([best_s, s], 1).topk(
                min(keep, best_s.shape[1] + s.shape[1]), dim=1)
            i = torch.cat([best_i, i], 1).gather(1, pos)
        best_s, best_i = s, i
    s1, ids1 = best_s[:, :c1], best_i[:, :c1]
    s2, pos = (s1 + scorer.dense(ids1)).topk(c2, dim=1)
    ids2 = ids1.gather(1, pos)
    s3, pos = (s2 + scorer.sparse(ids2)).topk(h, dim=1)
    return s3, ids2.gather(1, pos), extra_a, (best_s, best_i)


def _ways(scores: torch.Tensor, keep: int, eps: float) -> list:
    """The ways a cut keeping ``keep`` of ``scores`` (best first) may fall
    when the scores within ``eps`` of the keep-th may go either way: each an
    index tensor into ``scores``."""
    t = float(scores[keep - 1])
    sure = torch.nonzero(scores > t + eps).flatten()
    maybe = torch.nonzero((scores - t).abs() <= eps).flatten().tolist()
    need = keep - sure.numel()
    return [torch.cat([sure, torch.tensor(c, dtype=torch.long,
                                          device=scores.device)])
            for c in itertools.islice(
                itertools.combinations(maybe, need), _MAX_WAYS)]


def _row(term, q: int, nq: int, ids: torch.Tensor) -> torch.Tensor:
    """A scorer term (``dense`` or ``sparse``) for query ``q`` alone."""
    return term(ids[None].expand(nq, -1))[q]


def _tie_resolved_gap(scorer, q: int, p1, got: torch.Tensor, scale,
                      *, h: int, c1: int, c2: int) -> float:
    """Query ``q``'s least rank gap over the ways its pass-1 and pass-2 cuts
    may fall among near ties (``TIE``)."""
    a, ids = p1[0][q], p1[1][q]
    eps = TIE * float(scale)
    best = float("inf")
    for w1 in _ways(a, min(c1, a.numel()), eps):
        ids1 = ids[w1]
        s2 = a[w1] + _row(scorer.dense, q, scorer.q, ids1)
        s2, order = s2.sort(descending=True)
        ids1 = ids1[order]
        for w2 in _ways(s2, c2, eps):
            s3 = s2[w2] + _row(scorer.sparse, q, scorer.q, ids1[w2])
            ref = s3.topk(h).values
            best = min(best, float(((ref - got) / scale).clamp_min(0).max()))
    return best


def repeats(ids: torch.Tensor) -> torch.Tensor:
    """(Q, h) bool: True at every occurrence of an id in its row but the
    first."""
    srt, order = ids.sort(dim=1, stable=True)
    again = torch.zeros_like(srt, dtype=torch.bool)
    again[:, 1:] = srt[:, 1:] == srt[:, :-1]
    return torch.zeros_like(again).scatter(1, order, again)


def judge(scorer, ids: torch.Tensor, scores: torch.Tensor, *, h: int,
          c1: int, c2: int, block: int) -> dict:
    """Hold answer rows (ids (Q, h) in the scorer's row space, -1 or any id
    outside it, or a repeat of an id already in the row, for an invalid
    one; scores (Q, h)) to the float64 search of ``scorer``.  Returns ``score_err`` and ``rank_gap`` (see the module's
    docstring) and the per-row values behind them.  A row whose rank gap
    passes ``TIE`` is searched again with each way its cuts may fall among
    near ties, and keeps the least gap."""
    valid = (ids >= 0) & (ids < scorer.n) & ~repeats(ids)
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    ref_s, _, a, p1 = three_pass(scorer, h=h, c1=c1, c2=c2, block=block,
                                 extra=safe, spare=SPARE)
    final = a + scorer.dense(safe) + scorer.sparse(safe)
    final = torch.where(valid, final, torch.full_like(final, -float("inf")))
    scale = ref_s[:, :1].abs().clamp_min(1e-300)
    inf = float("inf")
    err = ((scores.double() - final).abs() / scale).nan_to_num(
        nan=inf, posinf=inf)
    got = final.sort(dim=1, descending=True).values
    gap = ((ref_s - got) / scale).clamp_min(0).nan_to_num(
        nan=inf, posinf=inf).max(1).values
    for q in torch.nonzero((gap > TIE) & torch.isfinite(gap)).flatten():
        q = int(q)
        gap[q] = _tie_resolved_gap(scorer, q, p1, got[q], scale[q, 0], h=h,
                                   c1=c1, c2=c2)
    return {"score_err": float(err.max()), "rank_gap": float(gap.max()),
            "score_err_rows": err.max(1).values.cpu(),
            "rank_gap_rows": gap.cpu()}
