#!/usr/bin/env python3
"""Where the LUT16 kernels' time goes, on one GPU.

    python3 tools/lut16_probe.py

On synthetic data at the querysim-shard's pass-1 shapes (N = 524288 codes
of K = 100 subspaces, Q = 128 LUTs, a (Q, N) f32 bias, k = 500), checks
that K1 equals its plain version bit for bit and K2 equals K1 + stable
sort, then times (``chip_smoke.cuda_ms``: median of 20 CUDA-event readings
of one call):

- K1 at Q = 1, 8 and 128 and at the delta engine's N = 8192, Q = 128, and
  on packed codes (kc = 50), each with its launch plan and the CTAs per SM
  the CUDA occupancy calculator gives it;
- K1 at Q = 128 with other chunks (rows a CTA stages at once, a row a
  thread): the resident warps per SM they allow;
- K1's LUT image at 1, 2 and 4 queries per shared load
  (``tools/lut16_layouts.cu``, built here with the kernels' nvcc flags),
  each checked against the plain version;
- K2 on three biases: random, falling with the row id (each range fills
  its buffer in its first chunks and then stages nothing: the scan with
  almost no selection) and rising (every row staged: the most selection);
- the materialised route (K1 + stable sort) beside K2 at Q = 1, 8 and 128,
  and K2 at Q = 1 and 8 with 1024-4096 rows per range.

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]


def layouts_lib():
    """Build tools/lut16_layouts.cu into build/ and load it."""
    from repro_torch.kernels import _build
    out = os.path.join(REPO, "build", "lut16_probe")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "liblut16_layouts.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                    os.path.join(REPO, "tools", "lut16_layouts.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.lut16_adc_layout_launch.argtypes = [p, p, p, ll, i, i, i, i, i, i, i,
                                            p]
    lib.lut16_adc_layout_launch.restype = i
    lib.lut16_topk_layout_launch.argtypes = [p, p, p, ll, p, p, p, p, p, ll,
                                             i, i, i, i, i, i, i, p]
    lib.lut16_topk_layout_launch.restype = i
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lut16_probe: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import check, cuda_ms, ptxas_report, smi_line
    from repro_torch.kernels import _build, lut16, ops, ref

    print(smi_line(), flush=True)
    n, k_sub, nq, k = 524288, 100, 128, 500
    g = torch.Generator(device="cuda").manual_seed(0)
    codes = torch.randint(0, 16, (n, k_sub), dtype=torch.uint8, device="cuda",
                          generator=g)
    lut = torch.randn((nq, k_sub, 16), device="cuda", generator=g)
    bias = torch.randn((nq, n), device="cuda", generator=g)
    rows_f = torch.arange(n, device="cuda", dtype=torch.float32)
    want = ref.lut16_adc_plain(codes, lut)
    check(torch.equal(ops.lut16_adc(codes, lut), want), "K1 != plain")
    fused = ops.lut16_adc_topk(codes, lut, k, bias=bias)
    mat = ops.lut16_adc_topk(codes, lut, k, bias=bias, fused=False)
    check(all(map(torch.equal, fused, mat)), "K2 != K1 + stable sort")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"ptxas": ptxas_report(_build.build()["ptxas"]["lut16"],
                                 ("lut16_adc_kernel",
                                  "lut16_topk_partial_kernel"))}

    packed = torch.from_numpy(ops.pack_codes(codes.cpu().numpy())).cuda()
    out["k1"] = {}
    for name, c, qn, nn in (("q1", codes, 1, n), ("q8", codes, 8, n),
                            ("q128", codes, nq, n),
                            ("q128_n8192", codes[:8192], nq, 8192),
                            ("q128_packed", packed, nq, n)):
        lq = lut[:qn]
        is_packed = c is packed
        check(torch.equal(ops.lut16_adc(c, lq, packed=is_packed),
                          ref.lut16_adc_plain(c, lq, packed=is_packed)),
              f"K1 != plain at {name}")
        plan = lut16.plan_adc(qn, nn, c.shape[1], k_sub, sms, is_packed)
        out["k1"][name] = {
            "ms": cuda_ms(lambda: ops.lut16_adc(c, lq, packed=is_packed)),
            "plan": {"bq": plan.bq, "threads": plan.threads,
                     "rows_per_cta": plan.rows_per_cta,
                     "smem_bytes": plan.smem_bytes,
                     "ctas_per_sm": plan.ctas_per_sm,
                     "grid": plan.grid(qn, nn)},
            "ctas_per_sm_cuda": lut16.adc_ctas_per_sm(
                plan.bq, is_packed, c.shape[1], k_sub, plan.threads)}

    def chunk_plan(bq, threads):
        """K1 at Q = 128 with another chunk, one wave of CTAs; None if its
        shared memory does not fit."""
        smem = lut16.adc_smem_bytes(bq, k_sub, k_sub, threads)
        if smem > lut16.SMEM_PER_CTA:
            return None
        ctas = min(lut16.SMEM_PER_SM // (smem + lut16.SMEM_RESERVED_PER_CTA),
                   lut16.ADC_WARPS_PER_SM * 32 // threads)
        return lut16.AdcPlan(
            bq=bq, threads=threads, smem_bytes=smem, ctas_per_sm=ctas,
            rows_per_cta=lut16.wave_rows(nq, n, bq, threads, ctas, sms))

    # other chunks at Q = 128 and the plan's query block, one wave each
    out["k1_ms_by_threads"] = {}
    bq = lut16.plan_adc(nq, n, k_sub, k_sub, sms).bq
    for threads in (256, 384, 512, 640, 768, 896):
        plan = chunk_plan(bq, threads)
        if plan is None:
            continue
        check(torch.equal(lut16.lut16_adc_cuda(codes, lut, packed=False,
                                               plan=plan), want),
              f"K1 at {threads} threads != plain")
        out["k1_ms_by_threads"][threads] = {
            "ms": cuda_ms(lambda: lut16.lut16_adc_cuda(codes, lut,
                                                       packed=False,
                                                       plan=plan)),
            "ctas_per_sm_cuda": lut16.adc_ctas_per_sm(bq, False, k_sub, k_sub,
                                                      threads),
            "rows_per_cta": plan.rows_per_cta}

    # the LUT image: 1, 2 or 4 queries per shared load, 8 or 16 queries per
    # CTA, a few chunks each
    lib = layouts_lib()
    stream = torch.cuda.current_stream().cuda_stream

    def layout(bq, qv, threads, rows):
        o = torch.empty((nq, n), device="cuda")
        code = lib.lut16_adc_layout_launch(
            codes.data_ptr(), lut.data_ptr(), o.data_ptr(), n, k_sub, nq,
            k_sub, bq, qv, threads, rows, stream)
        check(code == 0, f"layout launch bq={bq} qv={qv}: CUDA error {code}")
        return o

    out["k1_ms_by_layout"] = {}
    for bq, qv, chunks in ((8, 1, (256, 512, 896)), (8, 2, (256, 512, 896)),
                           (8, 4, (256, 896)), (16, 1, (256, 384, 640)),
                           (16, 2, (256, 640))):
        for threads in chunks:
            plan = chunk_plan(bq, threads)
            rows = plan.rows_per_cta
            check(torch.equal(layout(bq, qv, threads, rows), want),
                  f"K1 at bq={bq} qv={qv} threads={threads} != plain")
            out["k1_ms_by_layout"][f"bq{bq}_qv{qv}_t{threads}"] = {
                "ms": cuda_ms(lambda: layout(bq, qv, threads, rows)),
                "ctas_per_sm_planned": plan.ctas_per_sm}

    # K2's scan at 1, 2 or 4 queries per shared load (bq = 4)
    cbuf = lut16.candidate_buffer_width(k)

    def topk_layout(qn, qv):
        b = bias[:qn]
        bq, rows, _ = ops._resolve_topk_blocks(qn, n, k_sub, k_sub, False,
                                               cbuf, codes.device)
        parts = -(-n // rows)
        thr = torch.zeros((qn,), dtype=torch.int32, device="cuda")
        sa = torch.empty((qn, parts, cbuf), dtype=torch.int64, device="cuda")
        sb = torch.empty((qn, -(-parts // 16), cbuf), dtype=torch.int64,
                         device="cuda")
        o_s = torch.empty((qn, cbuf), device="cuda")
        o_i = torch.empty((qn, cbuf), dtype=torch.int32, device="cuda")
        code = lib.lut16_topk_layout_launch(
            codes.data_ptr(), lut.data_ptr(), b.data_ptr(), n,
            thr.data_ptr(), sa.data_ptr(), sb.data_ptr(), o_s.data_ptr(),
            o_i.data_ptr(), n, k_sub, qn, k_sub, bq, qv, rows, cbuf, stream)
        check(code == 0, f"K2 layout launch qv={qv}: CUDA error {code}")
        return o_s, o_i

    out["k2_ms_by_query_vec"] = {}
    for qn in (8, nq):
        ref_s, ref_i = lut16.lut16_adc_topk_cuda(
            codes, lut[:qn], bias[:qn], cbuf=cbuf, packed=False,
            **dict(zip(("bq", "rows_per_cta", "chunk"), ops._resolve_topk_blocks(
                qn, n, k_sub, k_sub, False, cbuf, codes.device))))
        for qv in (1, 2, 4):
            s_, i_ = topk_layout(qn, qv)
            check(torch.equal(s_, ref_s) and torch.equal(i_, ref_i),
                  f"K2 at qv={qv} q={qn} differs")
            out["k2_ms_by_query_vec"][f"q{qn}_qv{qv}"] = cuda_ms(
                lambda: topk_layout(qn, qv))

    bq, rows, _ = ops._resolve_topk_blocks(nq, n, k_sub, k_sub, False, cbuf,
                                           codes.device)
    out["k2_blocks"] = {"bq": bq, "rows_per_cta": rows,
                        "ctas_per_sm_cuda": lut16.topk_ctas_per_sm(
                            bq, False, k_sub, k_sub, cbuf)}
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
            b2, _, _ = ops._resolve_topk_blocks(qn, n, k_sub, k_sub, False,
                                                cbuf, codes.device)
            row["ms_by_rows_per_cta"] = {
                r: cuda_ms(lambda: lut16.lut16_adc_topk_cuda(
                    codes, lq, bq_, cbuf=cbuf, packed=False, bq=b2,
                    rows_per_cta=r)) for r in (1024, 2048, 4096)}
        out["by_q"][qn] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
