#!/usr/bin/env python3
"""R0-R3 (``csrc/residual.cu``, the fixed-order kernels of the ADC LUT,
passes 2-3 and the PQ head's exact columns) on one GPU, without the rest of
``chip_smoke.py``.

    python3 tools/residual_probe.py

Builds the kernels, runs ``chip_smoke.edge_cases_residual`` (each kernel
bit for bit with its plain version, twice equal, and every row alone equal
to its row of the batch and of a zero-padded bucket, at the test widths,
at d = 3584 and 8192 and at the PQ heads' shapes), then times each kernel
on random inputs of the slice's shapes (``chip_smoke.cuda_ms``): R0 at
Q = 128, K = 100, l = 16, p = 2; R1 at Q = 128, C = 500 candidates of
N = 524288 int8 rows of d = 200; R2 at Q = 128, C = 120 of N rows of
R = 64 entries, 65536 + 1 query columns; R3 at qwen2-7b's head (B = 32,
C = 100 of V = 152064 f32 rows of d = 3584), beside its plain version and
the eager route the kernel backends replaced.

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
        print("residual_probe: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.pq import PQCodebooks, ScalarQuant, adc_lut
    from repro_torch.core.residual import dense_residual_scores
    from repro_torch.core.sparse_index import PaddedSparseRows, score_rows
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    info = _build.build()
    out = {"build_s": info["seconds"],
           "ptxas": [ln.strip() for ln in info["ptxas"]["residual"]
                     .splitlines() if "registers" in ln or "spill" in ln]}
    out["edge_cases"] = cs.edge_cases_residual(torch, ops, ref)["cases"]

    g = torch.Generator(device="cuda").manual_seed(0)
    n = 524288
    p = cs.residual_problem(torch, g, q=128, c=500, n=n, d=200, r=64,
                            width=65537)
    centers = torch.randn((100, 16, 2), generator=g, device="cuda")
    v, d = cs.HEAD_SHAPES["qwen2-7b"]
    head = torch.randn((v, d), generator=g, device="cuda")
    h = torch.randn((32, d), generator=g, device="cuda")
    ids = torch.randint(0, v, (32, 100), generator=g, device="cuda",
                        dtype=torch.int32)
    sq = ScalarQuant(q=p["rows8"], scale=p["scale"], zero=p["zero"])
    rows = PaddedSparseRows(cols=p["cols"], vals=p["vals"])
    c2 = p["cand"][:, :120]
    calls = {
        "adc_lut": (lambda: ops.adc_lut(p["q"], centers),
                    lambda: ref.adc_lut_plain(p["q"], centers),
                    lambda: adc_lut(p["q"], PQCodebooks(centers=centers))),
        "dense_residual": (
            lambda: ops.dense_residual(sq.q, sq.scale, sq.zero, p["cand"],
                                       p["q"]),
            lambda: ref.dense_residual_plain(sq.q, sq.scale, sq.zero,
                                             p["cand"], p["q"]),
            lambda: dense_residual_scores(sq, p["cand"], p["q"])),
        "sparse_residual": (
            lambda: ops.sparse_residual(rows.cols, rows.vals, c2,
                                        p["q_cols"]),
            lambda: ref.sparse_residual_plain(rows.cols, rows.vals, c2,
                                              p["q_cols"]),
            lambda: score_rows(rows, c2, p["q_cols"])),
        "gathered_dot": (
            lambda: ops.gathered_dot(head, ids, h),
            lambda: ref.gathered_dot_plain(head, ids, h, False),
            lambda: torch.einsum("bd,bcd->bc", h, head[ids.long()])),
    }
    for name, (kern, plain, eager) in calls.items():
        got = kern()
        cs.check(torch.equal(got, plain()), f"{name} != plain")
        out[name] = {"ms": cs.cuda_ms(kern), "plain_ms": cs.cuda_ms(plain),
                     "eager_ms": cs.cuda_ms(eager),
                     "eager_max_abs_diff": cs.max_abs(eager(), got)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
