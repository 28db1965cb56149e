#!/usr/bin/env python3
"""Where the LUT16 kernels' time goes, on one GPU.

    python3 tools/lut16_probe.py

On synthetic data at the querysim-shard's pass-1 shapes (N = 524288 codes
of K = 100 subspaces, Q = 128 LUTs, a (Q, N) f32 bias, k = 500), checks
that K1 equals its plain version and K2 equals K1 + stable sort, then times
(``chip_smoke.cuda_ms``: median of 20 CUDA-event readings of one call):

- K1 at 8, 4 and 2 queries per CTA (what a query block's code copy costs);
- K2 on three biases: random, falling with the row id (each range fills
  its buffer in its first chunks and then stages nothing: the scan with
  almost no selection) and rising (every row staged: the most selection);
- the materialised route (K1 + stable sort) beside K2 at Q = 1, 8 and 128,
  and K2 at Q = 1 and 8 with 1024-4096 rows per range.

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
        print("lut16_probe: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import check, cuda_ms, smi_line
    from repro_torch.kernels import lut16, ops, ref

    print(smi_line(), flush=True)
    n, k_sub, nq, k = 524288, 100, 128, 500
    g = torch.Generator(device="cuda").manual_seed(0)
    codes = torch.randint(0, 16, (n, k_sub), dtype=torch.uint8, device="cuda",
                          generator=g)
    lut = torch.randn((nq, k_sub, 16), device="cuda", generator=g)
    bias = torch.randn((nq, n), device="cuda", generator=g)
    rows_f = torch.arange(n, device="cuda", dtype=torch.float32)
    check(torch.equal(ops.lut16_adc(codes, lut),
                      ref.lut16_adc_plain(codes, lut)), "K1 != plain")
    fused = ops.lut16_adc_topk(codes, lut, k, bias=bias)
    mat = ops.lut16_adc_topk(codes, lut, k, bias=bias, fused=False)
    check(all(map(torch.equal, fused, mat)), "K2 != K1 + stable sort")

    out = {"k1_ms_by_bq": {}}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bq in (8, 4, 2):
        rows = -(-n * -(-nq // bq) // (8 * sms))
        rows = -(-rows // lut16.THREADS) * lut16.THREADS
        out["k1_ms_by_bq"][bq] = cuda_ms(lambda: lut16.lut16_adc_cuda(
            codes, lut, packed=False, bq=bq, rows_per_cta=rows))

    cbuf = lut16.candidate_buffer_width(k)
    bq, rows = ops._resolve_topk_blocks(nq, n, k_sub, k_sub, False, cbuf,
                                        codes.device)
    out["k2_blocks"] = {"bq": bq, "rows_per_cta": rows}
    out["k2_ms_by_bias"] = {}
    for name, b in (("random", bias),
                    ("falling", (-64.0 * rows_f).expand(nq, n).contiguous()),
                    ("rising", (64.0 * rows_f).expand(nq, n).contiguous())):
        out["k2_ms_by_bias"][name] = cuda_ms(lambda: lut16.lut16_adc_topk_cuda(
            codes, lut, b, cbuf=cbuf, packed=False, bq=bq, rows_per_cta=rows))

    out["by_q"] = {}
    for qn in (1, 8, nq):
        lq, bq_ = lut[:qn], bias[:qn]
        row = {"ms": cuda_ms(lambda: ops.lut16_adc_topk(codes, lq, k,
                                                        bias=bq_)),
               "materialised_ms": cuda_ms(lambda: ops.lut16_adc_topk(
                   codes, lq, k, bias=bq_, fused=False))}
        if qn < nq:
            b2, _ = ops._resolve_topk_blocks(qn, n, k_sub, k_sub, False, cbuf,
                                             codes.device)
            row["ms_by_rows_per_cta"] = {
                r: cuda_ms(lambda: lut16.lut16_adc_topk_cuda(
                    codes, lq, bq_, cbuf=cbuf, packed=False, bq=b2,
                    rows_per_cta=r)) for r in (1024, 2048, 4096)}
        out["by_q"][qn] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
