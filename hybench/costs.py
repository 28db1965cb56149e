"""The least work of a three-pass search and of its pass 1, from shapes.

A search of Q query rows over N rows of K PQ codes (paper §4.1, §5, §6)
needs, whatever kernels implement it:

* pass 1: the LUT (Q·K·l·p multiply-adds from the dense queries and the
  codebooks), the ADC (Q·N·K adds, one LUT entry a subspace a row), the
  sparse bias (one multiply-add a posting that the query's dims hold), and
  the selection of c1 candidates; bytes: the codes once (N·K·code_bytes),
  the codebooks, the postings that the queries touch once (8 B each: a row
  id and a value), the queries, and c1 (score, id) pairs a row out;
* pass 2: C1 = c1 int8 dense-residual rows gathered (Q·c1·d adds, c1·d
  bytes a row) and the residual's scale and zero;
* pass 3: c2 sparse-residual rows gathered (Q·c2·r adds, 8 B an entry);
* the answer: h (score, id) pairs a row.

Each input byte is counted once, each output byte once; the (Q, N) bias
or score matrix that an implementation may write is not required work.
The least time is the larger of the adds at 33.5 T/s (f32 outside the
tensor cores: 67 TFLOP/s, an add and a multiply a cycle) and the bytes at
3.35 TB/s (HBM3), the H100 SXM's published peaks at 700 W.  The same
arithmetic gave the kernels' bounds before this benchmark existed; here
the bias and the codes are counted by what the inputs hold, not by an
implementation's buffers.
"""

from __future__ import annotations

import dataclasses

ADDS_PER_S = 33.5e12
BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class SearchShape:
    """The shapes a search's least work follows from.

    ``postings_per_row``: the postings a query row's sparse dims hold in the
    pass-1 index (mean over the traffic's rows); ``residual_per_row``: the
    mean sparse-residual entries of a row of the index."""
    n: int
    k: int
    l: int
    p: int
    d_dense: int
    nq: int
    h: int
    c1: int
    c2: int
    postings_per_row: float
    residual_per_row: float
    code_bytes: float = 1.0


@dataclasses.dataclass(frozen=True)
class Work:
    adds: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.adds + other.adds, self.bytes + other.bytes)

    @property
    def least_s(self) -> float:
        return max(self.adds / ADDS_PER_S, self.bytes / BYTES_PER_S)


def candidate_counts(n: int, h: int, alpha: int, beta: int) -> tuple:
    """(c1, c2) as the paper sets them: alpha·h and beta·h, at least h,
    c1 at most the rows and c2 at most c1."""
    c1 = min(max(alpha * h, h), n)
    return c1, min(max(beta * h, h), c1)


def pass1_work(s: SearchShape, q: int) -> Work:
    lut = Work(adds=q * s.k * s.l * s.p,
               bytes=4 * (q * s.d_dense + s.k * s.l * s.p))
    adc = Work(adds=q * s.n * s.k, bytes=s.n * s.k * s.code_bytes)
    bias = Work(adds=q * s.postings_per_row,
                bytes=8 * q * (s.nq + s.postings_per_row))
    out = Work(adds=0.0, bytes=8 * q * s.c1)
    return lut + adc + bias + out


def search_work(s: SearchShape, q: int) -> Work:
    pass2 = Work(adds=q * s.c1 * s.d_dense,
                 bytes=q * s.c1 * s.d_dense + 8 * s.d_dense)
    pass3 = Work(adds=q * s.c2 * s.residual_per_row,
                 bytes=8 * q * s.c2 * s.residual_per_row)
    out = Work(adds=0.0, bytes=8 * q * s.h)
    return pass1_work(s, q) + pass2 + pass3 + out
