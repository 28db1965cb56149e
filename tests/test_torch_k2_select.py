"""K2's selection (csrc/lut16.cu, lut16_topk_partial_kernel +
topk_merge_kernel) emulated on the CPU.

The CUDA kernel runs only on the card, so this file replays the selection
it runs, step by step, on exact scores: row ranges walked in chunks of 256
rows, a row staged only if its score beats the range's own cbuf-th
buffered score (strictly) and reaches the query's shared threshold (not
strictly), the staged keys merged into the range's sorted buffer, the
threshold published (raised, never lowered) once a buffer holds cbuf real
keys, and the ranges' lists reduced 16 at a time after dropping the keys
below the final threshold.  The ranges' chunks are interleaved in seeded
orders, including ones in which the last range publishes first, and each
range sees the threshold as it stood when its chunk began (a stale read).

The inputs attack the shared threshold: scores rising with the row id,
every score equal, ties at the cbuf-th score planted in every range (and a
whole buffer of them in the last range, which can then publish exactly
that score), and -inf on all but k - 1 rows.  The emulated selection must give
``ref.stable_topk``'s ids and bit-identical scores, and agree with the JAX
package's Pallas kernel (interpret mode) within the kernel tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import assert_topk_match

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

CHUNK = 256          # rows per chunk (kThreads)
MERGE_GROUP = 16     # lists one merge CTA reduces (kMergeGroup)
EMPTY = (1 << 64) - 1


def _ordered(s: np.ndarray) -> np.ndarray:
    """float_to_ordered: u32 whose unsigned order is the floats' order."""
    u = np.asarray(s, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _keys(s: np.ndarray, rows: np.ndarray) -> list[int]:
    """make_key: ascending key order is score descending, then row
    ascending."""
    hi = (~_ordered(s)) & 0xFFFFFFFF
    return [int(h) << 32 | int(r) for h, r in zip(hi, rows)]


def _key_score(key: int) -> np.float32:
    o = np.uint64(~(key >> 32) & 0xFFFFFFFF)
    u = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o & 0xFFFFFFFF)
    return np.array([u], np.uint64).astype(np.uint32).view(np.float32)[0]


def _schedule(n_ranges: int, chunks: list[int], order: str,
              rng: np.random.Generator) -> list[int]:
    """The order in which the ranges' chunks run (a range's own chunks stay
    in row order, as inside a CTA)."""
    if order == "forward":
        return [p for p in range(n_ranges) for _ in range(chunks[p])]
    if order == "last_first":
        return [p for p in reversed(range(n_ranges)) for _ in range(chunks[p])]
    steps = [p for p in range(n_ranges) for _ in range(chunks[p])]
    rng.shuffle(steps)
    return steps


def k2_select(scores: np.ndarray, cbuf: int, rows_per_range: int,
              order: str, seed: int = 0):
    """The kernel's selection on exact (Q, N) f32 scores.  Returns (Q, cbuf)
    scores and int32 ids, unfilled slots (-inf, -1), and the final shared
    thresholds (ordered u32)."""
    q, n = scores.shape
    starts = list(range(0, n, rows_per_range))
    chunks = [-(-(min(n, s + rows_per_range) - s) // CHUNK) for s in starts]
    rng = np.random.default_rng(seed)
    thresholds = np.zeros(q, np.uint64)
    out_s = np.full((q, cbuf), -np.inf, np.float32)
    out_i = np.full((q, cbuf), -1, np.int32)
    for qi in range(q):
        buf = [[] for _ in starts]              # sorted keys per range
        own = [-np.inf] * len(starts)           # own cbuf-th score
        seen = [0] * len(starts)                # threshold as last read
        done = [0] * len(starts)                # chunks run
        for p in _schedule(len(starts), chunks, order, rng):
            read = int(thresholds[qi])          # read as the chunk begins
            if done[p] == 0:                    # and as the range begins
                seen[p] = read
            r0 = starts[p] + CHUNK * done[p]
            r1 = min(starts[p] + rows_per_range, n, r0 + CHUNK)
            s = scores[qi, r0:r1]
            with np.errstate(invalid="ignore"):
                take = (s > own[p]) & (_ordered(s) >= seen[p])
            rows = np.arange(r0, r1)[take]
            if len(rows):
                buf[p] = sorted(buf[p] + _keys(s[take], rows))[:cbuf]
                if len(buf[p]) == cbuf:
                    own[p] = _key_score(buf[p][-1])
                    thresholds[qi] = max(int(thresholds[qi]),
                                         int(_ordered(np.float32([own[p]]))[0]))
            seen[p] = max(seen[p], read)
            done[p] += 1
        # the merge rounds: drop keys below the final threshold, then keep
        # the best cbuf of each group of 16 lists
        limit = min(EMPTY - 1, (~int(thresholds[qi]) & 0xFFFFFFFF) << 32
                    | 0xFFFFFFFF)
        lists = buf
        while True:
            lists = [sorted(k for lst in lists[g:g + MERGE_GROUP]
                            for k in lst if k <= limit)[:cbuf]
                     for g in range(0, len(lists), MERGE_GROUP)]
            if len(lists) == 1:
                break
        for j, key in enumerate(lists[0]):
            out_s[qi, j] = _key_score(key)
            out_i[qi, j] = key & 0xFFFFFFFF
    return out_s, out_i, thresholds


def _inputs(kind: str, n: int, q: int, k: int, seed: int):
    """codes (N, K) u8, lut (Q, K, 16) f32 and the additive base (Q, N) f32
    of one attack on the threshold."""
    rng = np.random.default_rng(seed)
    k_sub = 8
    codes = rng.integers(0, 16, (n, k_sub)).astype(np.uint8)
    lut = rng.normal(size=(q, k_sub, 16)).astype(np.float32)
    cbuf = ops.candidate_buffer_width(k)
    if kind == "rising":           # every row beats every threshold
        base = np.broadcast_to(256.0 * np.arange(n, dtype=np.float32),
                               (q, n)).copy()
    elif kind == "all_equal":      # identical codes, no bias: all rows tie
        codes[:] = codes[0]
        base = np.zeros((q, n), np.float32)
    elif kind == "planted_ties":   # integer scores below 0; 0 in the last
        lut[:] = 0.0               # cbuf rows and in rows spread over the
        base = -1.0 - np.floor(20 * rng.random((q, n))).astype(np.float32)
        base[:, n - cbuf:] = 0.0   # other ranges: the last range alone can
        base[:, 37::n // 64] = 0.0  # publish the cbuf-th score, 0
    else:                          # -inf on all but k - 1 rows
        base = np.full((q, n), -np.inf, np.float32)
        base[:, rng.choice(n, size=k - 1, replace=False)] = 0.0
    return codes, lut, base


def _scores(codes, lut, base) -> np.ndarray:
    """What the kernel holds for each (query, row): base + the scan."""
    scan = ref.lut16_adc_plain(torch.from_numpy(codes), torch.from_numpy(lut))
    return (torch.from_numpy(base) + scan).numpy()


KINDS = ["rising", "all_equal", "planted_ties", "neginf"]


@pytest.mark.parametrize("order", ["forward", "last_first", "interleaved"])
@pytest.mark.parametrize("kind", KINDS)
def test_k2_selection_equals_stable_topk(kind, order):
    """Exact at the boundaries the shared threshold creates: ids equal to
    the stable sort's, scores bit for bit, whatever the order of the
    ranges; the final threshold never exceeds the true cbuf-th score."""
    n, q, k = 4096, 9, 100
    cbuf = ops.candidate_buffer_width(k)
    codes, lut, base = _inputs(kind, n, q, k, seed=1)
    scores = _scores(codes, lut, base)
    want_s, want_i = ops._normalize(*ref.stable_topk(torch.from_numpy(scores),
                                                     k))
    for rows_per_range, seed in ((768, 2), (128, 3)):   # 6 or 32 ranges
        s, i, thr = k2_select(scores, cbuf, rows_per_range, order, seed)
        got_s, got_i = ops._normalize(torch.from_numpy(s[:, :k]),
                                      torch.from_numpy(i[:, :k]))
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_s, want_s)
        cth = np.sort(scores, axis=1)[:, ::-1][:, cbuf - 1]
        finite = np.isfinite(cth)
        assert (thr[finite] <= _ordered(cth[finite])).all()


@pytest.mark.parametrize("kind", KINDS)
def test_k2_selection_matches_jax(kind):
    """The emulated selection against the JAX package's fused Pallas kernel
    (interpret mode) on the same inputs: ids equal up to near-ties, scores
    within the kernel tolerance (the two packages sum in other orders)."""
    n, q, k = 2048, 5, 40
    cbuf = ops.candidate_buffer_width(k)
    codes, lut, base = _inputs(kind, n, q, k, seed=4)
    s, i, _ = k2_select(_scores(codes, lut, base), cbuf, 512, "interleaved",
                        seed=5)
    got_s, got_i = ops._normalize(torch.from_numpy(s[:, :k]),
                                  torch.from_numpy(i[:, :k]))
    want_s, want_i = jops.lut16_adc_topk(jnp.asarray(codes), jnp.asarray(lut),
                                         k, bias=jnp.asarray(base),
                                         fused=True)
    assert_topk_match(got_s.numpy(), got_i.numpy(), np.asarray(want_s),
                      np.asarray(want_i))
