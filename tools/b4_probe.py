#!/usr/bin/env python3
"""Where B4's time goes, on one GPU.

    python3 tools/b4_probe.py

On a synthetic padded inverted index of the querysim-shard's tail shape
(N = 524288 rows, d = 10113 dims, lists of up to L = 192 sorted rows with
lengths uniform in [1, 192], the sentinel N past them) and Q = 128 queries
of 256 slots, 40 of them valid, checks B4 (``ops.score_inverted_vf``)
against ``score_inverted`` bit for bit and once under
``torch.cuda.set_sync_debug_mode("error")``, then times
(``chip_smoke.cuda_ms``):

- B4 at Q = 1, 8 and 128 on its plan: one call, 10 back to back, and its
  device time under ``torch.profiler``, beside the bytes bound;
- ``zero_()`` and ``fill_()`` of the (128, N) output: what a kernel that
  only writes it takes;
- B4 at Q = 128 on other plans (CTAs a query, rows a tile, no resident
  buffer), each on the queries and on all-pad queries (no list work: the
  tiles' zeroing and stores alone).

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("b4_probe: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.sparse_index import (PaddedInvertedIndex,
                                               score_inverted)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import inverted as ik

    print(cs.smi_line(), flush=True)
    _build.build()
    g = torch.Generator(device="cuda").manual_seed(0)
    n, d, l, nq, valid = 524288, 10113, 192, 256, 40
    lens = torch.randint(1, l + 1, (d, 1), device="cuda", generator=g)
    rows = torch.randint(0, n, (d, l), device="cuda", generator=g,
                         dtype=torch.int32).sort(dim=1).values
    rows = torch.where(torch.arange(l, device="cuda")[None] < lens, rows,
                       n).to(torch.int32).contiguous()
    vals = (torch.rand((d, l), device="cuda", generator=g)
            * (rows < n)).contiguous()
    inv = PaddedInvertedIndex(rows=rows, vals=vals, num_points=n)
    qd = torch.full((128, nq), d, dtype=torch.int32, device="cuda")
    qd[:, :valid] = torch.randint(0, d, (128, valid), device="cuda",
                                  generator=g, dtype=torch.int32)
    qv = torch.rand((128, nq), device="cuda", generator=g)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.score_inverted_vf(inv, qd, qv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    by_q = {}
    for qn in (1, 8, 128):
        a, b = qd[:qn], qv[:qn]
        cs.b4_equal(torch, ops, inv, a, b, f"the probe's index, Q = {qn}")
        nbytes, entries = cs.tail_bytes(torch, inv, a)
        plan = ik.plan_score_inverted(qn, n, sms)
        prof = cs.device_profile(
            torch, lambda: ops.score_inverted_vf(inv, a, b), runs=10)
        by_q[str(qn)] = {
            "ms": cs.cuda_ms(lambda: ops.score_inverted_vf(inv, a, b)),
            "ms_batched": cs.cuda_ms(
                lambda: ops.score_inverted_vf(inv, a, b), batch=10),
            "device_ms": prof["device_ms"],
            "plain_ms": cs.cuda_ms(lambda: score_inverted(inv, a, b),
                                   runs=5),
            "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
            "live_entries": entries, "plan": str(plan),
            "ctas_per_sm": ik.ctas_per_sm(plan)}
    out = torch.empty((128, n), device="cuda")
    write_only = {"zero_ms": cs.cuda_ms(lambda: out.zero_(), batch=10),
                  "fill_ms": cs.cuda_ms(lambda: out.fill_(1.0), batch=10)}
    pad = torch.full_like(qd, d)

    def plan_of(rows_per_tile, ctas, cap=ik.CAP):
        tiles = -(-n // rows_per_tile)
        per_cta = -(-tiles // ctas)
        return ik.InvertedPlan(rows_per_tile, tiles, per_cta,
                               -(-tiles // per_cta), cap)

    plans = {}
    for name, plan in (("default", ik.plan_score_inverted(128, n, sms)),
                       ("one_cta_a_query", plan_of(12288, 1)),
                       ("two_ctas_a_query", plan_of(12288, 2)),
                       ("eight_ctas_a_query", plan_of(12288, 8)),
                       ("tiles_of_6144", plan_of(6144, 4)),
                       ("one_tile_a_cta", plan_of(12288, 43)),
                       ("streaming", plan_of(12288, 4, cap=0))):
        cs.b4_equal(torch, ops, inv, qd, qv, name, plan)
        plans[name] = {
            "plan": str(plan), "ctas_per_sm": ik.ctas_per_sm(plan),
            "ms_batched": cs.cuda_ms(lambda: ik.score_inverted_cuda(
                inv.rows, inv.vals, qd, qv, n, plan), batch=10),
            "all_pad_ms_batched": cs.cuda_ms(lambda: ik.score_inverted_cuda(
                inv.rows, inv.vals, pad, qv, n, plan), batch=10)}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "by_q": by_q, "write_only_q128": write_only,
                      "plans_q128": plans}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
