#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--rows N]

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, builds a
HybridIndex of the "querysim-shard" configuration on the card and drives
the three-pass search through its entry points, then holds every kernel
against its plain PyTorch version on the card.  Each phase prints one JSON
line; any failed check raises, and the script exits non-zero.  The last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, it fails before printing a
result.  It imports nothing of JAX.

The configuration: ``make_hybrid_dataset(num_points=524288, num_queries=128,
d_sparse=200000, d_dense=200, nnz_per_row=134, alpha=2.0, dense_weight=2.0,
seed=3)`` (QuerySim-shaped; d_dense=200 gives K=100 subspaces of l=16) and
``HybridIndexParams(keep_top=192, head_dims=128, kmeans_iters=12,
nq_max=256)``, searched with h=20, alpha=25, beta=6 (c1=500: the fused
scan-and-select and the block-sparse head kernel).  The 524288 rows are a
cut of one 2^22-row shard of a 2^30-row deployment; ``--rows`` cuts further
for quick runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-4         # the JAX package's kernel-vs-oracle tolerance


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def tensor_bytes(obj) -> int:
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def max_abs(a, b) -> float:
    import torch
    fin = torch.isfinite(b)
    check(bool(torch.equal(torch.isfinite(a), fin)), "non-finite mismatch")
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max())


def assert_close(a, b, what: str) -> float:
    import torch
    err = max_abs(a, b)
    fin = torch.isfinite(b)
    check(bool(torch.all((a[fin] - b[fin]).abs()
                         <= ATOL + RTOL * b[fin].abs())),
          f"{what}: max abs err {err} beyond rtol {RTOL} atol {ATOL}")
    check(bool(torch.equal(a[~fin], b[~fin])), f"{what}: -inf slots differ")
    return err


def profile_search(torch, idx, ds, nq, h, alpha, beta, runs=3):
    """Device time of one ``HybridIndex.search`` of ``nq`` queries by
    kernel (torch.profiler), against the search's wall time under the
    profiler: the busy share is their ratio."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    qs, qd = ds.q_sparse[:nq], ds.q_dense[:nq]
    idx.search(qs, qd, h=h, alpha=alpha, beta=beta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            idx.search(qs, qd, h=h, alpha=alpha, beta=beta)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / runs
    per_kernel = [(e.key, e.self_device_time_total / runs / 1e3, e.count // runs)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in per_kernel)
    if device_ms == 0:
        return {"device_ms": "not measured (profiler saw no device time)"}
    per_kernel.sort(key=lambda r: -r[1])
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "kernel_launches": sum(c for _, _, c in per_kernel),
            "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in per_kernel[:10]]}


# ---------------------------------------------------------------------------
# slice: the querysim-shard configuration through the port's entry points
# ---------------------------------------------------------------------------

def run_slice(args, torch):
    from repro_torch.core.baselines import exact_topk, recall_at_h
    from repro_torch.core.engine import Backend, ScoringEngine
    from repro_torch.core.hybrid import HybridIndex, HybridIndexParams
    from repro_torch.core.sparse_index import sparse_queries_to_padded
    from repro_torch.data import make_hybrid_dataset
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS

    t0 = time.perf_counter()
    ds = make_hybrid_dataset(num_points=args.rows, num_queries=128,
                             d_sparse=200000, d_dense=200, nnz_per_row=134,
                             alpha=2.0, dense_weight=2.0, seed=3)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    params = HybridIndexParams(keep_top=192, head_dims=128, kmeans_iters=12,
                               nq_max=256, backend="cuda")
    t0 = time.perf_counter()
    idx = HybridIndex.build(ds.x_sparse, ds.x_dense, params, device="cuda")
    build_s = time.perf_counter() - t0
    arrays = idx.engine.arrays
    emit("slice_build", rows=args.rows, nnz=int(ds.x_sparse.nnz),
         d_active=arrays.d_active, head_tiles=int(arrays.head_ptr[-1]),
         inv_l_max=int(arrays.inv_index.rows.shape[1]),
         res_r_max=int(arrays.sparse_residual.cols.shape[1]),
         generate_s=gen_s, build_s=build_s,
         build_stage_s=idx.build_seconds,
         index_device_bytes=tensor_bytes(arrays),
         max_memory_allocated=torch.cuda.max_memory_allocated())

    h, alpha, beta = 20, 25, 6
    c1, c2 = idx.engine.candidate_counts(h, alpha, beta)
    # the main path, once, with every count at zero just before it
    ops.reset_counts()
    res = idx.search(ds.q_sparse, ds.q_dense, h=h, alpha=alpha, beta=beta)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    plain = dict(PLAIN_CALLS)
    check(launches["lut16_adc_topk"] >= 1, "main path did not launch K2")
    check(launches["block_sparse_matmul"] >= 1, "main path did not launch K3")
    check(sum(plain.values()) == 0, f"main path ran plain versions: {plain}")
    check(res.ids.shape == (128, h) and bool(np.isfinite(res.scores).all()),
          "main-path result is not finite (128, h)")

    t0 = time.perf_counter()
    true_ids, _ = exact_topk(ds.q_sparse, ds.q_dense, ds.x_sparse,
                             ds.x_dense, h, device="cuda")
    exact_s = time.perf_counter() - t0
    recall = recall_at_h(res.ids, true_ids)
    check(recall >= 0.95, f"recall@{h} {recall} < 0.95")

    q_dims_np, q_vals_np = sparse_queries_to_padded(ds.q_sparse, idx.cols,
                                                    nq_max=params.nq_max)
    q_dims = torch.from_numpy(q_dims_np).cuda()
    q_vals = torch.from_numpy(q_vals_np).cuda()
    q_dense = torch.from_numpy(ds.q_dense).cuda()
    eng = idx.engine
    fused = eng.search(q_dims, q_vals, q_dense, h=h, alpha=alpha, beta=beta)
    again = eng.search(q_dims, q_vals, q_dense, h=h, alpha=alpha, beta=beta)
    same_twice = all(torch.equal(a, b) for a, b in zip(fused, again))
    check(same_twice, "two identical searches differ")
    ops.reset_counts()
    unfused = ScoringEngine(arrays=arrays, backend=Backend.CUDA,
                            fused=False).search(q_dims, q_vals, q_dense, h=h,
                                                alpha=alpha, beta=beta)
    check(ops.LAUNCHES["lut16_adc"] >= 1 and ops.LAUNCHES["lut16_adc_topk"] == 0,
          "fused=False did not route through K1")
    check(all(torch.equal(a, b) for a, b in zip(fused, unfused)),
          "fused and materialised searches differ")
    packed_arrays = dataclasses.replace(
        arrays, codes=torch.from_numpy(
            ops.pack_codes(arrays.codes.cpu().numpy())).cuda(),
        codes_packed=True)
    packed = ScoringEngine(arrays=packed_arrays,
                           backend=Backend.CUDA_PACKED).search(
        q_dims, q_vals, q_dense, h=h, alpha=alpha, beta=beta)
    check(torch.equal(packed[1], fused[1]), "cuda-packed ids differ")
    packed_err = assert_close(packed[0], fused[0], "cuda-packed scores")
    ops.reset_counts()
    wide = eng.search(q_dims, q_vals, q_dense, h=100, alpha=20, beta=beta)
    check(ops.LAUNCHES["lut16_adc"] >= 1 and ops.LAUNCHES["lut16_adc_topk"] == 0,
          "c1=2000 did not route through K1")
    check(wide[2].shape[1] == min(2000, args.rows), "c1=2000 candidates")

    latency = {}
    for nq in (1, 8, 128):
        qs, qd = ds.q_sparse[:nq], ds.q_dense[:nq]
        for _ in range(3):
            idx.search(qs, qd, h=h, alpha=alpha, beta=beta)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            idx.search(qs, qd, h=h, alpha=alpha, beta=beta)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        latency[str(nq)] = {"median_ms": med * 1e3, "min_ms": min(times) * 1e3,
                            "qps": nq / med}
    profiles = {str(nq): profile_search(torch, idx, ds, nq, h, alpha, beta)
                for nq in (1, 128)}
    emit("slice", c1=c1, c2=c2, h=h, recall_at_20=recall,
         exact_topk_s=exact_s, main_path_launches=launches,
         main_path_plain_calls=plain, fused_equals_materialised=True,
         repeat_identical=same_twice, packed_ids_equal=True,
         packed_max_abs_err=packed_err, c1_2000_routes_k1=True,
         search_latency=latency, search_profile=profiles,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return idx, ds, (q_dims, q_vals, q_dense), launches, c1


# ---------------------------------------------------------------------------
# kernels: each against its plain version, at the slice's shapes and at edges
# ---------------------------------------------------------------------------

def edge_cases_lut16(torch, ops, ref):
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = 0
    for n, k_sub, q, packed in ((3001, 100, 5, False), (3001, 99, 13, True),
                                (4096, 100, 8, True), (2500, 7, 1, False),
                                (9000, 32, 33, False), (600, 16, 3, True)):
        codes = torch.randint(0, 16, (n, k_sub), generator=g, device="cuda",
                              dtype=torch.uint8)
        lut = torch.randn((q, k_sub, 16), generator=g, device="cuda")
        stored = (torch.from_numpy(ops.pack_codes(codes.cpu().numpy())).cuda()
                  if packed else codes)
        got = ops.lut16_adc(stored, lut, packed=packed)
        want = ref.lut16_adc_plain(
            stored, ops._validate_packed(stored.shape[1], k_sub, 16, lut,
                                         packed), packed=packed)
        assert_close(got, want, f"K1 at {(n, k_sub, q, packed)}")
        # planted ties across CTA boundaries and inside one chunk
        tie_rows = torch.tensor([3, 5, n // 3, n // 2, n - 1], device="cuda")
        codes[tie_rows] = codes[3].clone()
        stored = (torch.from_numpy(ops.pack_codes(codes.cpu().numpy())).cuda()
                  if packed else codes)
        bias = torch.randn((q, n), generator=g, device="cuda")
        bias[:, tie_rows] = 1000.0
        mask = torch.zeros(n, device="cuda")
        mask[torch.randperm(n, generator=g, device="cuda")[: n // 3]] = -torch.inf
        mask[tie_rows] = 0.0
        for kk in (1, 500, 1024):
            if kk > n:
                continue
            for b, rm in ((bias, None), (None, mask), (bias, mask), (None, None)):
                s, i = ops.lut16_adc_topk(stored, lut, kk, bias=b, row_mask=rm,
                                          packed=packed)
                s2, i2 = ops.lut16_adc_topk(stored, lut, kk, bias=b,
                                            row_mask=rm, packed=packed,
                                            fused=False)
                check(torch.equal(s, s2) and torch.equal(i, i2),
                      f"K2 != K1+sort at {(n, k_sub, q, packed, kk)}")
                base = None if b is None else b
                if rm is not None:
                    base = rm[None] if base is None else base + rm[None]
                lut_p = ops._validate_packed(stored.shape[1], k_sub, 16, lut,
                                             packed)
                ps, pi = ref.lut16_adc_topk_plain(stored, lut_p, base, kk,
                                                  packed=packed)
                ps, pi = ops._normalize(ps, pi)
                check(torch.equal(i, pi), f"K2 ids != plain at "
                      f"{(n, k_sub, q, packed, kk)}")
                assert_close(s, ps, "K2 scores")
                if b is not None and kk >= 5:
                    check(bool((i[:, :5] == tie_rows[None].int()).all()),
                          "planted ties not in lowest-id order")
                cases += 1
    return cases


def edge_cases_block_sparse(torch, ops, ref):
    from repro_torch.kernels.block_sparse import dense_to_bcsr
    g = torch.Generator(device="cuda").manual_seed(12)
    cases = 0
    for nb, db, q in ((7, 1, 5), (5, 2, 37), (3, 3, 64)):
        block = torch.randn((nb * 128, db * 128), generator=g, device="cuda")
        block[128:256] = 0.0                  # a row block with no tiles
        block[:128, :128] = 0.0               # a zero tile
        tiles, ptr, col = (torch.from_numpy(a).cuda() for a in dense_to_bcsr(
            block.cpu().numpy(), 128, 128))
        qh = torch.randn((q, db * 128), generator=g, device="cuda")
        got = ops.block_sparse_matmul_bcsr(qh, tiles, ptr, col)
        want = ref.block_sparse_plain(qh, tiles, ptr, col)
        assert_close(got, want, f"K3 at {(nb, db, q)}")
        check(bool((got[:, 128:256] == 0).all()), "empty row block not zero")
        cases += 1
    return cases


def run_kernels(torch, idx, queries, launches, c1):
    from repro_torch.core.engine import pass1_bias, scatter_head_queries
    from repro_torch.core.pq import adc_lut
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    arrays = idx.engine.arrays
    q_dims, q_vals, q_dense = queries
    codes = arrays.codes
    n, kc = codes.shape
    lut = adc_lut(q_dense, arrays.codebooks)
    nq, k_sub, _ = lut.shape
    bias = pass1_bias(arrays, q_dims, q_vals)
    q_head = scatter_head_queries(q_dims, q_vals, arrays.head_pos,
                                  arrays.head.block.shape[1])
    tiles, ptr, col = arrays.head_tiles, arrays.head_ptr, arrays.head_col
    t_real = int(ptr[-1])
    n_pad = (ptr.shape[0] - 1) * 128
    torch.cuda.synchronize()

    # K1
    got = ops.lut16_adc(codes, lut)
    want = ref.lut16_adc_plain(codes, lut)
    k1_err = assert_close(got, want, "K1 at the slice shapes")
    emb_idx = (codes.long() + 16 * torch.arange(k_sub, device="cuda")).contiguous()
    emb_w = lut.permute(1, 2, 0).reshape(k_sub * 16, nq).contiguous()
    k1_lib = torch.nn.functional.embedding_bag(emb_idx, emb_w, mode="sum").T
    assert_close(k1_lib, want, "embedding_bag yardstick")
    k1 = dict(ms=cuda_ms(lambda: ops.lut16_adc(codes, lut)),
              plain_ms=cuda_ms(lambda: ref.lut16_adc_plain(codes, lut)),
              library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
                  emb_idx, emb_w, mode="sum")),
              max_abs_err=k1_err)
    k1_bytes = n * kc + 4 * nq * n
    k1_ops = nq * n * k_sub

    # K2
    s, i = ops.lut16_adc_topk(codes, lut, c1, bias=bias)
    s2, i2 = ops.lut16_adc_topk(codes, lut, c1, bias=bias, fused=False)
    check(torch.equal(s, s2) and torch.equal(i, i2),
          "K2 != K1 + stable sort at the slice shapes")
    ps, pi = ops._normalize(*ref.lut16_adc_topk_plain(codes, lut, bias, c1))
    check(torch.equal(i, pi), "K2 ids != plain at the slice shapes")
    k2 = dict(ms=cuda_ms(lambda: ops.lut16_adc_topk(codes, lut, c1, bias=bias)),
              plain_ms=cuda_ms(lambda: ref.lut16_adc_topk_plain(codes, lut,
                                                                bias, c1)),
              library_ms=None, max_abs_err=assert_close(s, ps, "K2 scores"))
    k2_bytes = n * kc + 4 * nq * n
    k2_ops = nq * n * (k_sub + 1)

    # K3
    got = ops.block_sparse_matmul_bcsr(q_head, tiles, ptr, col)
    want = ref.block_sparse_plain(q_head, tiles, ptr, col)
    dense_block = arrays.head.block
    k3 = dict(ms=cuda_ms(lambda: ops.block_sparse_matmul_bcsr(q_head, tiles,
                                                              ptr, col)),
              plain_ms=cuda_ms(lambda: ref.block_sparse_plain(q_head, tiles,
                                                              ptr, col)),
              library_ms=cuda_ms(lambda: torch.matmul(q_head, dense_block.T)),
              max_abs_err=assert_close(got, want, "K3 at the slice shapes"))
    k3_bytes = 4 * (t_real * 128 * 128 + nq * n_pad + nq * q_head.shape[1])
    k3_ops = 2 * nq * t_real * 128 * 128

    edge_lut = edge_cases_lut16(torch, ops, ref)
    edge_bs = edge_cases_block_sparse(torch, ops, ref)

    def row(name, source, replaces, key, m, nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": max(tb, to),
                "bound_by": "bytes" if tb >= to else "operations",
                "library_ms": m["library_ms"]}

    rows = [
        row("lut16_adc", "src/repro_torch/csrc/lut16.cu",
            "src/repro/kernels/lut16.py:110", "lut16_adc", k1, k1_bytes,
            k1_ops),
        row("lut16_adc_topk", "src/repro_torch/csrc/lut16.cu",
            "src/repro/kernels/lut16.py:216", "lut16_adc_topk", k2, k2_bytes,
            k2_ops),
        row("block_sparse_matmul", "src/repro_torch/csrc/block_sparse.cu",
            "src/repro/kernels/block_sparse.py:83", "block_sparse_matmul", k3,
            k3_bytes, k3_ops),
    ]
    emit("kernels_checked", slice_shapes={"Q": nq, "N": n, "Kc": kc, "K": k_sub,
                                          "k": c1, "tiles": t_real,
                                          "N_pad": n_pad},
         edge_cases_lut16=edge_lut, edge_cases_block_sparse=edge_bs,
         tolerance={"rtol": RTOL, "atol": ATOL})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=524288,
                    help="rows of the slice (default 524288)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import _build

    # f32 products stay f32: no TF32 anywhere in this run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)

    info = _build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in info["ptxas"].items()}
    emit("build", seconds=info["seconds"], built=info["built"], ptxas=ptxas)

    idx, _, queries, launches, c1 = run_slice(args, torch)
    rows = run_kernels(torch, idx, queries, launches, c1)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
