"""Checks and per-kernel times of ``launch.dryrun.lower_retrieval``'s
shard, kept out of the launcher: ``inspect_form`` is the ``inspect`` hook
that ``chip_smoke.py``'s ``dryrun`` phase and the CPU tests pass it, so a
user's ``launch.dryrun --retrieval`` pays for neither.

    row = lower_retrieval(multi_pod=False, inspect=inspect_form)

On ``CHECK_QUERIES`` queries, every kernel of the path is held to its
plain version over the whole shard: B4 at the block's query count (at 2^26
rows and Q = 64 each of its CTAs streams the lists) and alone, K1's (Q, N)
scores, and K2's fused top-h and top-c1, the plain versions run a slice of
rows at a time so that their int64 code index stays small.
"""

from __future__ import annotations

import time

import torch

from .dryrun import ALPHA, BETA, H, K_PQ, _timed, shard_calls

__all__ = ["CHECK_QUERIES", "PLAIN_SLICE_ROWS", "b4_plan", "kernel_times",
           "plain_scan", "check_form", "inspect_form"]

CHECK_QUERIES = 4
# rows the plain scan takes at a time: its int64 index of (rows, 100)
# codes is 1.68 GB at 2^21 rows
PLAIN_SLICE_ROWS = 1 << 21


def _once(fn, dev: torch.device):
    """(``fn()``, its ms): CUDA events on the card, the host clock on the
    CPU.  For the plain versions, which take seconds at 2^26 rows."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def plain_scan(codes: torch.Tensor, lut: torch.Tensor, *, packed: bool,
               slice_rows: int = PLAIN_SLICE_ROWS) -> torch.Tensor:
    """K1's plain version (``lut16_adc_plain``: the subspaces added in the
    kernels' order) over all of ``codes``, ``slice_rows`` rows at a time.
    Each row's sum is its own, so the slices give the whole call's bits."""
    from ..kernels.ref import lut16_adc_plain

    n = codes.shape[0]
    out = torch.empty((lut.shape[0], n), dtype=torch.float32,
                      device=codes.device)
    for s in range(0, n, slice_rows):
        out[:, s:s + slice_rows] = lut16_adc_plain(
            codes[s:s + slice_rows], lut, packed=packed)
    return out


def b4_plan(arrs: dict, lo: int, hi: int, n: int, dev: torch.device) -> dict:
    """B4's plan at queries [lo, hi) over ``n`` rows, and how many of the
    queries' live postings fall in each CTA's rows: a CTA keeps up to
    ``cap`` of them resident and streams the lists once a tile past that."""
    from ..kernels.inverted import plan_score_inverted

    plan = plan_score_inverted(
        hi - lo, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    rows = arrs["inv_rows"][arrs["q_dims"][lo:hi].long()].reshape(hi - lo, -1)
    live = rows < n
    cta = torch.where(live, rows // (plan.tiles_per_cta * plan.rows_per_tile),
                      0).long()
    counts = torch.zeros((hi - lo, plan.ctas_per_query), dtype=torch.int32,
                         device=dev).scatter_add_(1, cta, live.int())
    return {"rows_per_tile": plan.rows_per_tile,
            "tiles_per_cta": plan.tiles_per_cta,
            "ctas_per_query": plan.ctas_per_query, "cap": plan.cap,
            "max_postings_a_cta": int(counts.max()),
            "ctas_streaming": int((counts > plan.cap).sum()),
            "ctas": int(counts.numel())}


def kernel_times(arrs: dict, backend, lo: int, hi: int, dev: torch.device,
                 runs: int) -> dict:
    """B4 (the tail bias) and K2 (the fused top-h over it) alone at queries
    [lo, hi), ms by ``dryrun._timed``, with B4's plan on the card
    (``b4_plan``); at ``CHECK_QUERIES`` queries also the plain tail
    (``score_inverted``), K1 alone and the materialised route (K1 + a
    stable top-k).  One bias is alive at a time."""
    from ..core.engine import tail_scores
    from ..core.sparse_index import PaddedInvertedIndex, score_inverted
    from ..kernels import ops

    codes = arrs["codes"]
    inv = PaddedInvertedIndex(rows=arrs["inv_rows"], vals=arrs["inv_vals"],
                              num_points=codes.shape[0])
    qd, qv = arrs["q_dims"][lo:hi], arrs["q_vals"][lo:hi]
    lut = arrs["lut"][lo:hi]
    packed = codes.shape[1] != K_PQ
    out = {"queries": hi - lo,
           "b4_ms": _timed(lambda: tail_scores(inv, qd, qv, backend), dev,
                           runs)[0]}
    if dev.type == "cuda":
        out["b4_plan"] = b4_plan(arrs, lo, hi, codes.shape[0], dev)
    if hi - lo == CHECK_QUERIES:
        out["plain_tail_ms"] = _timed(lambda: score_inverted(inv, qd, qv),
                                      dev, runs)[0]
    bias = tail_scores(inv, qd, qv, backend)
    out["k2_ms"] = _timed(lambda: ops.lut16_adc_topk(
        codes, lut, H, bias=bias, packed=packed), dev, runs)[0]
    if hi - lo == CHECK_QUERIES:
        out["k1_ms"] = _timed(lambda: ops.lut16_adc(codes, lut,
                                                    packed=packed), dev,
                              runs)[0]
        out["k1_sort_ms"] = _timed(lambda: ops.lut16_adc_topk(
            codes, lut, H, bias=bias, packed=packed, fused=False), dev,
            runs)[0]
    return out


def check_form(arrs: dict, backend, row_offset: int, blocks: int,
               results: dict, dev: torch.device) -> dict:
    """On ``CHECK_QUERIES`` queries, the last of the first block (so the
    bias and outputs of the blocked calls sit at the block's largest query
    offsets), every kernel against its plain version, bit for bit:

      * the tail bias (B4 on the card) of the whole first block, the
        block's own query count, at these queries' rows, and of these
        queries alone, against ``score_inverted``;
      * K1's (Q, N) scores against the plain scan (``plain_scan``);
      * K2's fused top-h and top-c1 against a stable top-k of the plain
        scan + the bias (``lut16_adc_topk_plain``'s arithmetic), ids and
        scores;

    and the three-pass result against passes 2-3 run on those plain
    candidates; and the blocked calls' rows for these queries against a
    block of just these queries, each call's bits apart
    (``blocked_rows_equal_alone``), and the three-pass rows' ids and
    scores (rtol 1e-5, atol 1e-4) apart from their bits.  Pass 1 is per
    query in every bit (B4 and K2 give any query block the same bits);
    passes 2-3 take cuBLAS products (``dense_residual_scores``) whose order
    of adds may change with the number of queries on the card, so a
    three-pass score may move by an ulp between block sizes there.  The
    plain scan's and plain top-k's ms (one run each) are in the result."""
    from ..core import residual as res
    from ..core.engine import tail_scores
    from ..core.pq import ScalarQuant
    from ..core.sparse_index import (PaddedInvertedIndex, PaddedSparseRows,
                                     score_inverted)
    from ..kernels import ops
    from ..kernels.ref import stable_topk

    codes = arrs["codes"]
    per = arrs["lut"].shape[0] // blocks
    lo, hi = per - CHECK_QUERIES, per
    n_local = codes.shape[0]
    c1 = min(max(ALPHA * H, H), n_local)
    c2 = min(max(BETA * H, H), c1)
    packed = codes.shape[1] != K_PQ
    lut = arrs["lut"][lo:hi]
    inv = PaddedInvertedIndex(rows=arrs["inv_rows"], vals=arrs["inv_vals"],
                              num_points=n_local)
    # the block's bias first: at 2^26 rows it takes the segment that the
    # calls' block biases left, whole, before anything smaller splits it
    block = tail_scores(inv, arrs["q_dims"][:per], arrs["q_vals"][:per],
                        backend)
    block_rows = block[lo:hi].clone()
    del block
    bias, plain_tail_ms = _once(lambda: score_inverted(
        inv, arrs["q_dims"][lo:hi], arrs["q_vals"][lo:hi]), dev)
    block_tail_equal = torch.equal(block_rows, bias)
    del block_rows
    tail_equal = torch.equal(tail_scores(inv, arrs["q_dims"][lo:hi],
                                         arrs["q_vals"][lo:hi], backend),
                             bias)
    scan, plain_scan_ms = _once(
        lambda: plain_scan(codes, lut, packed=packed), dev)
    k1_equal = torch.equal(ops.lut16_adc(codes, lut, packed=packed), scan)
    (ws, wi), plain_topk_ms = _once(lambda: stable_topk(bias + scan, c1),
                                    dev)
    del scan
    wi = torch.where(torch.isfinite(ws), wi, torch.full_like(wi, -1))
    fused_equal = {}
    for k in (H, c1):
        s, i = ops.lut16_adc_topk(codes, lut, k, bias=bias, packed=packed,
                                  fused=True)
        fused_equal[k] = (torch.equal(s, ws[:, :k])
                          and torch.equal(i, wi[:, :k]))
    del bias
    sq = ScalarQuant(q=arrs["res_q"], scale=arrs["res_scale"],
                     zero=arrs["res_zero"])
    s2, ids2 = res.reorder_pass(
        ws, wi, res.dense_residual_scores(sq, wi, arrs["q_dense"][lo:hi]),
        c2)
    rows = PaddedSparseRows(cols=arrs["sres_cols"], vals=arrs["sres_vals"])
    s3, ids3 = res.reorder_pass(
        s2, ids2, res.sparse_residual_scores(rows, ids2,
                                             arrs["q_cols"][lo:hi]), H)
    pass1, search3 = shard_calls(arrs, backend, row_offset)
    m3 = search3(lo, hi)
    three_equal = (torch.equal(m3[0], s3)
                   and torch.equal(m3[1], ids3 + row_offset))
    alone = {"pass1": pass1(lo, hi), "three_pass": m3}
    blocks_equal = {name: all(torch.equal(results[name][j][lo:hi],
                                          alone[name][j]) for j in (0, 1))
                    for name in alone}
    got_s, got_ids = results["three_pass"][0][lo:hi], results[
        "three_pass"][1][lo:hi]
    results["check_three_pass"] = {"blocked": (got_s, got_ids), "alone": m3}
    return {"queries": [lo, hi],
            "block_tail_equals_plain": block_tail_equal,
            "tail_equals_plain": tail_equal,
            "k1_equals_plain": k1_equal,
            "fused_equals_plain": {str(k): v for k, v in fused_equal.items()},
            "three_pass_equals_plain_route": three_equal,
            "blocked_rows_equal_alone": blocks_equal,
            "blocked_three_pass_ids_equal": torch.equal(got_ids, m3[1]),
            "blocked_three_pass_close": bool(torch.allclose(
                got_s, m3[0], rtol=1e-5, atol=1e-4)),
            "blocked_three_pass_max_abs_diff": float(
                (got_s - m3[0]).abs().max()),
            "plain_tail_ms": plain_tail_ms, "plain_scan_ms": plain_scan_ms,
            "plain_topk_ms": plain_topk_ms,
            "plain_k2_ms": plain_scan_ms + plain_topk_ms}


def inspect_form(arrs: dict, backend, row_offset: int, blocks: int,
                 results: dict, dev: torch.device, runs: int) -> dict:
    """``lower_retrieval``'s ``inspect`` hook: ``check_form``, and B4 and
    K2 alone (``kernel_times``) at one block, half a block and the check's
    queries."""
    per = arrs["lut"].shape[0] // blocks
    return {"check": check_form(arrs, backend, row_offset, blocks, results,
                                dev),
            "kernels": {
                "block": kernel_times(arrs, backend, 0, per, dev, runs),
                "half_block": kernel_times(arrs, backend, 0, per // 2, dev,
                                           runs),
                "check_queries": kernel_times(
                    arrs, backend, per - CHECK_QUERIES, per, dev, runs)}}
