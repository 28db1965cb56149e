#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--rows N] [--inserts M]

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, builds a
HybridIndex of the "querysim-shard" configuration on the card and drives
its two serving paths through their entry points: the immutable three-pass
search (phase ``slice``) and the mutable index — inserts into the delta
shard, deletes, searches merged across main and delta, merge and retrain
compaction (phase ``mutable``).  It holds every kernel against its plain
PyTorch version on the card (phases ``kernels_checked`` and
``value_forward``, the latter also driving ``score_inverted_vf``).  Each
phase prints one JSON line; any failed check raises, and the script exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the rest of the repository beside it, it fails
before printing a result.  It imports nothing of JAX.

The configuration: ``make_hybrid_dataset(num_points=524288, num_queries=128,
d_sparse=200000, d_dense=200, nnz_per_row=134, alpha=2.0, dense_weight=2.0,
seed=3)`` (QuerySim-shaped; d_dense=200 gives K=100 subspaces of l=16) and
``HybridIndexParams(keep_top=192, head_dims=128, kmeans_iters=12,
nq_max=256)``, searched with h=20, alpha=25, beta=6 (c1=500: the fused
scan-and-select and the block-sparse head kernel).  The 524288 rows are a
cut of one 2^22-row shard of a 2^30-row deployment; ``--rows`` cuts further
for quick runs.  The mutable phase inserts ``--inserts`` (default 8192)
perturbed copies of main rows in batches of 16 into the default
64-slot delta shard.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12         # H100 SXM dense TF32 on the tensor cores
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


def cuda_ms(fn, runs: int = 20, warmup: int = 3, batch: int = 1) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after warm-up.  With
    ``batch`` > 1 each timing spans that many back-to-back calls and is
    divided by it, so the host's launch work hides behind queued device work."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
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
    return idx, ds, (q_dims, q_vals, q_dense), launches, c1, res


# ---------------------------------------------------------------------------
# kernels: each against its plain version, at the slice's shapes and at edges
# ---------------------------------------------------------------------------

def edge_cases_lut16(torch, ops, ref):
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = 0
    for n, k_sub, q, packed in ((3001, 100, 5, False), (3001, 99, 13, True),
                                (4096, 100, 8, True), (2500, 7, 1, False),
                                (9000, 32, 33, False), (600, 16, 3, True),
                                (1024, 100, 8, False), (64, 100, 3, True)):
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
        # k == N (one CTA, every row selected, masked rows -1) wherever
        # it fits the fused buffer, as the delta engine asks for it
        for kk in sorted({1, 500, 1024, n}):
            if kk > min(n, ops.MAX_FUSED_CANDIDATES):
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
    """K3 against its plain version at ragged shapes: Q below one n8 tile,
    exactly one, either side of the small-Q layout's 16, inside one query
    group and past it (130: a second group on blockIdx.y); one to four
    column blocks, the last row block holding all of its tiles; more row
    blocks than SMs, with tiles dropped at random, so that a persistent CTA
    walks several row blocks, keeps its query slice or reloads it; positive
    lognormal values over 1e-3..1e3, like the head's weights, also at
    D_pad = 512, where a sum carried through the tensor cores' truncating
    accumulation would leave rtol.  Each case has an empty row block and a
    zero tile that BCSR drops; each must hold the tolerance, leave the
    empty row block zero, and give the same bits on a second launch."""
    from repro_torch.kernels.block_sparse import dense_to_bcsr
    g = torch.Generator(device="cuda").manual_seed(12)

    def values(shape, positive):
        if not positive:
            return torch.randn(shape, generator=g, device="cuda")
        return torch.exp(2.3 * torch.randn(shape, generator=g, device="cuda")
                         ).clamp(1e-3, 1e3)

    cases = []
    for nb, db, q, positive in ((7, 1, 5, False), (5, 2, 37, False),
                                (3, 3, 64, False), (4, 3, 1, False),
                                (6, 2, 8, False), (5, 2, 16, False),
                                (5, 2, 17, False), (6, 3, 130, False),
                                (300, 2, 37, False), (5, 3, 37, True),
                                (300, 1, 130, True), (64, 4, 128, True)):
        block = values((nb * 128, db * 128), positive)
        if nb > 100:                          # drop a third of the tiles
            drop = torch.rand((nb - 1, db), generator=g, device="cuda") < 0.33
            view = block[:-128].view(nb - 1, 128, db, 128)
            view.mul_(~drop[:, None, :, None])
        block[128:256] = 0.0                  # a row block with no tiles
        block[:128, :128] = 0.0               # a zero tile
        tiles, ptr, col = (torch.from_numpy(a).cuda() for a in dense_to_bcsr(
            block.cpu().numpy(), 128, 128))
        check(int(ptr[-1] - ptr[-2]) == db, "last row block not full")
        qh = values((q, db * 128), positive)
        got = ops.block_sparse_matmul_bcsr(qh, tiles, ptr, col)
        want = ref.block_sparse_plain(qh, tiles, ptr, col)
        shape = (nb, db, q, "lognormal" if positive else "normal")
        err = assert_close(got, want, f"K3 at {shape}")
        check(bool((got[:, 128:256] == 0).all()), "empty row block not zero")
        check(torch.equal(got, ops.block_sparse_matmul_bcsr(qh, tiles, ptr,
                                                            col)),
              f"K3 at {shape}: two launches differ")
        cases.append({"shape": shape, "tiles": int(ptr[-1]),
                      "max_abs_err": err,
                      "max_rel_err": float(((got - want).abs()
                                            / want.abs().clamp_min(1e-30))
                                           .max())})
    return cases


def k3_ptxas(log: str) -> dict:
    """Registers, static shared memory and spills of each K3 instantiation
    (``block_sparse_kernel<WM,NT,STAGES>``) from nvcc's ``-Xptxas -v``
    report of block_sparse.cu."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      ln)
        if m:
            k = re.search(r"block_sparse_kernelI((?:Li\d+E)+)E", m.group(1))
            args = ",".join(re.findall(r"\d+", k.group(1))) if k else ""
            cur = f"block_sparse_kernel<{args}>" if k else None
            continue
        if cur is None:
            continue
        e = out.setdefault(cur, {})
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            e["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            e["static_smem_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            e["spill_stores"], e["spill_loads"] = map(int, m.groups())
    return out


def kernel_row(name, source, replaces, launches, m, nbytes, nops,
               ops_per_s=F32_OPS_PER_S) -> dict:
    """One entry of the ``kernels`` line; the bound is the larger of the
    bytes over the memory rate and the operations over ``ops_per_s`` (the
    f32 rate outside the tensor cores unless the kernel runs elsewhere)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": m["library_ms"]}


def run_kernels(torch, idx, queries, launches, c1):
    from repro_torch.core.engine import pass1_bias, scatter_head_queries
    from repro_torch.core.pq import adc_lut
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_sparse import _smem_bytes

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

    # K3, at the slice's Q = 128 and at the online callers' Q = 1 and 8
    got = ops.block_sparse_matmul_bcsr(q_head, tiles, ptr, col)
    check(torch.equal(got, ops.block_sparse_matmul_bcsr(q_head, tiles, ptr,
                                                        col)),
          "K3: two launches at the slice shapes differ")
    want = ref.block_sparse_plain(q_head, tiles, ptr, col)
    dense_block = arrays.head.block

    def k3_bytes(qn):
        return 4 * (t_real * 128 * 128 + qn * n_pad + qn * q_head.shape[1])

    def k3_ops(qn):
        return 2 * qn * t_real * 128 * 128

    k3_by_q = {}
    for qn in (1, 8, nq):
        qs = q_head[:qn]
        err = assert_close(ops.block_sparse_matmul_bcsr(qs, tiles, ptr, col),
                           want[:qn], f"K3 at Q = {qn}")
        def k3_call():
            return ops.block_sparse_matmul_bcsr(qs, tiles, ptr, col)

        def lib_call():
            return torch.matmul(qs, dense_block.T)

        # ms and library_ms time one call, as every other kernel's; the
        # _batched pair beside them is the mean of 10 back-to-back calls
        k3_by_q[str(qn)] = {
            "ms": cuda_ms(k3_call), "library_ms": cuda_ms(lib_call),
            "ms_batched": cuda_ms(k3_call, batch=10),
            "library_ms_batched": cuda_ms(lib_call, batch=10),
            "bound_ms": max(k3_bytes(qn) / HBM_BYTES_PER_S,
                            3 * k3_ops(qn) / TF32_OPS_PER_S) * 1e3,
            "max_abs_err": err}
    k3 = dict(ms=k3_by_q[str(nq)]["ms"],
              plain_ms=cuda_ms(lambda: ref.block_sparse_plain(q_head, tiles,
                                                              ptr, col)),
              library_ms=k3_by_q[str(nq)]["library_ms"],
              max_abs_err=assert_close(got, want, "K3 at the slice shapes"))

    edge_lut = edge_cases_lut16(torch, ops, ref)
    edge_bs = edge_cases_block_sparse(torch, ops, ref)

    rows = [
        kernel_row("lut16_adc", "src/repro_torch/csrc/lut16.cu",
                   "src/repro/kernels/lut16.py:110", launches["lut16_adc"],
                   k1, k1_bytes, k1_ops),
        kernel_row("lut16_adc_topk", "src/repro_torch/csrc/lut16.cu",
                   "src/repro/kernels/lut16.py:216",
                   launches["lut16_adc_topk"], k2, k2_bytes, k2_ops),
        kernel_row("block_sparse_matmul",
                   "src/repro_torch/csrc/block_sparse.cu",
                   "src/repro/kernels/block_sparse.py:83",
                   launches["block_sparse_matmul"], k3, k3_bytes(nq),
                   3 * k3_ops(nq), TF32_OPS_PER_S),
    ]
    # the bound at the port's tolerance is 3xTF32 on the tensor cores; the
    # f32 CUDA-core bound stays beside it, comparable with earlier runs
    rows[2].update(
        bound_f32_ms=max(k3_bytes(nq) / HBM_BYTES_PER_S,
                         k3_ops(nq) / F32_OPS_PER_S) * 1e3,
        ptxas={"dynamic_smem_bytes": {f"Q={qn}": _smem_bytes(qn)
                                      for qn in (1, nq)},
               **k3_ptxas(_build.build()["ptxas"]["block_sparse"])},
        by_q=k3_by_q)
    emit("kernels_checked", slice_shapes={"Q": nq, "N": n, "Kc": kc, "K": k_sub,
                                          "k": c1, "tiles": t_real,
                                          "N_pad": n_pad},
         edge_cases_lut16=edge_lut, edge_cases_block_sparse=len(edge_bs),
         block_sparse_cases=edge_bs,
         tolerance={"rtol": RTOL, "atol": ATOL})
    return rows


# ---------------------------------------------------------------------------
# value_forward: B4 through score_inverted_vf, against score_inverted
# ---------------------------------------------------------------------------

def edge_cases_value_forward(torch, ops, ref):
    """B4 at small shapes on the card: each must equal the port's
    score_inverted and the plain version bit for bit."""
    import scipy.sparse as sp
    from repro_torch.core.sparse_index import (build_compact_columns,
                                               build_padded_inverted_index,
                                               build_value_forward_stream,
                                               score_inverted,
                                               sparse_queries_to_padded)
    cases, empty_segments = 0, 0
    # (N, d, Q, bn, query density): N not a multiple of bn and Q not of
    # bq; exact multiples; a single row block; small row blocks and short
    # queries, so that many segments are empty
    for n, d, qn, bn, qdens in ((700, 500, 9, 512, 0.02),
                                (512, 200, 8, 512, 0.02),
                                (50, 80, 3, 512, 0.02),
                                (3000, 400, 5, 16, 0.004)):
        x = sp.random(n, d, density=0.01, random_state=n, format="csr",
                      dtype=np.float32)
        cols, xc = build_compact_columns(x)
        inv = build_padded_inverted_index(xc, device="cuda")
        qs = sp.random(qn, d, density=qdens, random_state=n + 1,
                       format="csr", dtype=np.float32)
        qd, qv = sparse_queries_to_padded(qs, cols, nq_max=32)
        if n == 700:
            qd[0, 1], qv[0, 1] = qd[0, 0], 0.5      # a repeated dim
            qd[2, :], qv[2, :] = cols.num_active, 0.0   # an all-pad query
        qd_t, qv_t = torch.from_numpy(qd).cuda(), torch.from_numpy(qv).cuda()
        got = ops.score_inverted_vf(inv, qd_t, qv_t, bn=bn, chunk=16)
        check(torch.equal(got, score_inverted(inv, qd_t, qv_t)),
              f"B4 != score_inverted at {(n, d, qn, bn)}")
        st = build_value_forward_stream(inv, qd_t, qv_t, bn=bn, chunk=16)
        kw = dict(bq=st.bq, bn=st.bn, chunk=st.chunk,
                  num_row_blocks=st.num_row_blocks)
        check(torch.equal(
            ops.inverted_value_forward(st.ptr, st.rows, st.qidx, st.contrib,
                                       **kw),
            ref.inverted_value_forward_plain(st.ptr, st.rows, st.qidx,
                                             st.contrib, **kw)),
            f"B4 != plain at {(n, d, qn, bn)}")
        if n == 700:
            check(bool((got[2] == 0).all()), "all-pad query not zero")
        ptr = st.ptr.cpu().numpy().reshape(-1, st.num_row_blocks + 1)
        empty_segments += int((np.diff(ptr, axis=1) == 0).sum())
        cases += 1
    check(empty_segments > 0, "no edge case had an empty segment")
    return {"cases": cases, "empty_segments": empty_segments}


def run_value_forward(torch, idx, queries):
    from repro_torch.core.engine import scatter_queries_compact
    from repro_torch.core.sparse_index import (build_value_forward_stream,
                                               score_inverted)
    from repro_torch.kernels import ops, ref

    inv = idx.engine.arrays.inv_index
    q_dims, q_vals, _ = queries
    nq, n, d_active = q_dims.shape[0], inv.num_points, inv.rows.shape[0]
    torch.cuda.synchronize()
    # the path, once, with every count at zero just before it
    ops.reset_counts()
    got = ops.score_inverted_vf(inv, q_dims, q_vals)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["inverted_value_forward"]
    check(launches == 1 and sum(ref.PLAIN_CALLS.values()) == 0,
          "score_inverted_vf did not launch B4 once")
    check(tuple(got.shape) == (nq, n), "score_inverted_vf shape")
    check(torch.equal(got, score_inverted(inv, q_dims, q_vals)),
          "B4 != score_inverted at the slice shapes")

    planner = []
    for _ in range(5):
        t0 = time.perf_counter()
        st = build_value_forward_stream(inv, q_dims, q_vals)
        torch.cuda.synchronize()
        planner.append(time.perf_counter() - t0)
    kw = dict(bq=st.bq, bn=st.bn, chunk=st.chunk,
              num_row_blocks=st.num_row_blocks)
    args = (st.ptr, st.rows, st.qidx, st.contrib)
    out = ops.inverted_value_forward(*args, **kw)
    plain = ref.inverted_value_forward_plain(*args, **kw)
    check(torch.equal(out, plain), "B4 != plain at the slice shapes")

    # yardstick: the tail postings as an (N x d_active) CSR times the
    # scattered (d_active x Q) queries, one cuSPARSE product
    live = inv.rows < n
    dims = torch.arange(d_active, device=inv.rows.device)[:, None].expand_as(
        inv.rows)
    coo = torch.sparse_coo_tensor(
        torch.stack([inv.rows[live].long(), dims[live]]), inv.vals[live],
        (n, d_active)).coalesce()
    x_csr = coo.to_sparse_csr()
    q_cols = scatter_queries_compact(q_dims, q_vals, d_active)[:, :d_active]
    q_mat = q_cols.T.contiguous()
    lib = torch.sparse.mm(x_csr, q_mat).T
    assert_close(lib, got, "torch.sparse.mm yardstick")

    m = dict(ms=cuda_ms(lambda: ops.inverted_value_forward(*args, **kw)),
             plain_ms=cuda_ms(lambda: ref.inverted_value_forward_plain(
                 *args, **kw), runs=5, warmup=1),
             library_ms=cuda_ms(lambda: torch.sparse.mm(x_csr, q_mat)),
             max_abs_err=max_abs(out, plain))
    si_ms = cuda_ms(lambda: score_inverted(inv, q_dims, q_vals))
    qb, p_pad = st.rows.shape
    entries = int((st.rows < st.bn).sum())
    padded = int(st.ptr.reshape(qb, -1)[:, -1].sum()) * st.chunk
    # the bound counts the stream entries the function needs (row, query,
    # contribution), not the chunk padding or the tail past each block
    nbytes = 12 * entries + 4 * qb * (st.num_row_blocks + 1) + 4 * nq * n
    edges = edge_cases_value_forward(torch, ops, ref)
    emit("value_forward", launches=launches, equals_score_inverted=True,
         equals_plain=True, kernel_ms=m["ms"],
         planner_ms=statistics.median(planner) * 1e3,
         plain_ms=m["plain_ms"], library_ms=m["library_ms"],
         library="torch.sparse.mm, (N x d_active) CSR x (d_active x Q)",
         score_inverted_ms=si_ms, stream_entries=entries,
         padded_entries=padded, p_pad=p_pad, query_blocks=qb,
         row_blocks=st.num_row_blocks,
         padding_share=1.0 - entries / (qb * p_pad), edge_cases=edges)
    return kernel_row("inverted_value_forward",
                      "src/repro_torch/csrc/block_sparse.cu",
                      "src/repro/kernels/block_sparse.py:172", launches, m,
                      nbytes, entries)


# ---------------------------------------------------------------------------
# mutable: the streaming index through HybridIndex's entry points
# ---------------------------------------------------------------------------

def perturbed_rows(ds, m: int, seed: int, dense_weight: float = 2.0):
    """``m`` insert rows made as make_hybrid_dataset makes its queries:
    copies of random main rows, sparse values x U(0.7, 1.3), dense plus
    N(0, 0.2 * dense_weight / sqrt(d_dense))."""
    rng = np.random.default_rng(seed)
    n, d_dense = ds.x_dense.shape
    src = rng.choice(n, size=m, replace=False)
    xs = ds.x_sparse[src].copy()
    xs.data *= rng.uniform(0.7, 1.3, size=xs.nnz).astype(np.float32)
    xd = (ds.x_dense[src] + 0.2 * dense_weight / np.sqrt(d_dense)
          * rng.normal(size=(m, d_dense))).astype(np.float32)
    return xs, xd


def live_recall(torch, midx, ds, res, h) -> float:
    """recall@h of a mutable search against exact search over the live
    corpus (``MutableState.survivors()``), in external ids."""
    from repro_torch.core.baselines import exact_topk, recall_at_h
    xs, xd, ids = midx.mutable_state.survivors()
    pos, _ = exact_topk(ds.q_sparse, ds.q_dense, xs, xd, h, device="cuda")
    return recall_at_h(res.ids, ids[pos])


def timed_searches(torch, midx, ds, h, alpha, beta) -> dict:
    out = {}
    for nq in (1, 8, 128):
        qs, qd = ds.q_sparse[:nq], ds.q_dense[:nq]
        for _ in range(3):
            midx.search(qs, qd, h=h, alpha=alpha, beta=beta)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            midx.search(qs, qd, h=h, alpha=alpha, beta=beta)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        out[str(nq)] = {"median_ms": med * 1e3, "min_ms": min(times) * 1e3,
                        "qps": nq / med}
    return out


def counted_search(torch, midx, ds, h, alpha, beta):
    """One Q = 128 search with every count at zero just before it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS
    ops.reset_counts()
    res = midx.search(ds.q_sparse, ds.q_dense, h=h, alpha=alpha, beta=beta)
    torch.cuda.synchronize()
    check(sum(PLAIN_CALLS.values()) == 0, "mutable search ran a plain version")
    check(res.ids.shape == (ds.q_dense.shape[0], h)
          and bool(np.isfinite(res.scores).all()),
          "mutable search result is not finite (Q, h)")
    return res, dict(ops.LAUNCHES)


def delta_kernel_check(torch, midx, q) -> dict:
    """The delta engine's pass 1 at the shapes the mutable path gives it:
    the current snapshot's codes, LUT, pass-1 bias and tombstone mask with
    k == N == capacity.  K2 (up to 1024 slots) or K1 + stable sort (above)
    must equal the plain version bit for bit, and every masked slot must
    come back with id -1."""
    from repro_torch.core.engine import pass1_bias
    from repro_torch.core.pq import adc_lut
    from repro_torch.kernels import ops, ref
    snap = midx.mutable_state.delta.snapshot()
    arrays, k = snap.arrays, snap.capacity
    q_dims, q_vals, q_dense = q
    codes, packed, mask = arrays.codes, arrays.codes_packed, arrays.valid_mask
    lut = adc_lut(q_dense, arrays.codebooks)
    bias = pass1_bias(arrays, q_dims, q_vals, midx.engine.backend)
    lut_p = ops._validate_packed(codes.shape[1], lut.shape[1], lut.shape[2],
                                 lut, packed)
    s, i = ops.lut16_adc_topk(codes, lut, k, bias=bias, row_mask=mask,
                              packed=packed)
    ps, pi = ops._normalize(*ref.lut16_adc_topk_plain(
        codes, lut_p, bias + mask[None], k, packed=packed))
    kernel = "K2" if k <= ops.MAX_FUSED_CANDIDATES else "K1 + stable sort"
    check(torch.equal(s, ps) and torch.equal(i, pi),
          f"delta {kernel} != plain at k == N == {k}")
    if k > ops.MAX_FUSED_CANDIDATES:
        check(torch.equal(ops.lut16_adc(codes, lut, packed=packed),
                          ref.lut16_adc_plain(codes, lut_p, packed=packed)),
              f"delta K1 != plain at N == {k}")
    masked = int((i == -1).sum())
    check(masked == q_dims.shape[0] * (k - snap.live),
          f"delta at k == N == {k}: {masked} ids -1, expected "
          f"{q_dims.shape[0]} x {k - snap.live} masked slots")
    return {"kernel": kernel, "k": k, "live": snap.live, "ids_minus_1": masked,
            "equals_plain": True}


def held_snapshot_check(torch, midx, q, insert, alpha, beta) -> dict:
    """Hold the delta's snapshot, insert, and search the held snapshot
    again: the result must not change by a bit."""
    from repro_torch.core.engine import ScoringEngine
    delta = midx.mutable_state.delta
    snap = delta.snapshot()
    eng = ScoringEngine(arrays=snap.arrays, backend=midx.engine.backend)
    before = eng.search(*q, h=snap.capacity, alpha=alpha, beta=beta)
    insert()
    after = eng.search(*q, h=snap.capacity, alpha=alpha, beta=beta)
    check(all(torch.equal(a, b) for a, b in zip(before, after)),
          "a held delta snapshot changed under an insert")
    return {"count": snap.count, "capacity": snap.capacity,
            "capacity_after": delta.capacity,
            "in_place": delta.capacity == snap.capacity}


def run_mutable(args, torch, ds, params, immutable_res):
    from repro_torch.core.distributed import ceil16
    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.core.sparse_index import sparse_queries_to_padded
    from repro_torch.kernels.ops import MAX_FUSED_CANDIDATES

    h, alpha, beta = 20, 25, 6
    n = ds.x_sparse.shape[0]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    midx = HybridIndex.build(ds.x_sparse, ds.x_dense, params, mutable=True,
                             device="cuda")
    build_s = time.perf_counter() - t0
    st = midx.mutable_state
    delta = st.delta
    # 1. before any mutation: the immutable index's search, bit for bit
    res0, launches0 = counted_search(torch, midx, ds, h, alpha, beta)
    check(np.array_equal(res0.ids, immutable_res.ids)
          and np.array_equal(res0.scores, immutable_res.scores),
          "fresh mutable search != the immutable index's search")

    # 2-4. inserts, batch 16, into the default 64-slot delta; the device
    # view is materialised after every batch, as before a serving search
    xs_new, xd_new = perturbed_rows(ds, args.inserts, seed=3)
    q_dims, q_vals = sparse_queries_to_padded(ds.q_sparse, midx.cols,
                                              nq_max=params.nq_max)
    q = (torch.from_numpy(q_dims).cuda(), torch.from_numpy(q_vals).cuda(),
         torch.from_numpy(ds.q_dense).cuda())
    new_ids, insert_s, steps = [], 0.0, {}
    for lo in range(0, args.inserts, 16):
        def insert(lo=lo):
            new_ids.extend(midx.insert(xs_new[lo:lo + 16],
                                       xd_new[lo:lo + 16]).tolist())
            delta.snapshot()
        if delta.count == 1536:
            steps["held_snapshot_in_place"] = held_snapshot_check(
                torch, midx, q, insert, alpha, beta)
        else:
            t0 = time.perf_counter()
            insert()
            torch.cuda.synchronize()
            insert_s += time.perf_counter() - t0
        if delta.count in (48, MAX_FUSED_CANDIDATES - 16):
            # k == N with unfilled slots under the mask: one CTA
            steps[f"delta_kernel_{delta.count}"] = delta_kernel_check(
                torch, midx, q)
        if delta.count == MAX_FUSED_CANDIDATES:
            _, launches = counted_search(torch, midx, ds, h, alpha, beta)
            check(delta.capacity == MAX_FUSED_CANDIDATES
                  and launches["lut16_adc_topk"] == 2
                  and launches["lut16_adc"] == 0,
                  f"delta at k == N == 1024 did not take K2: {launches}")
            steps["delta_1024"] = {"launches": launches,
                                   "capacity": delta.capacity,
                                   "kernel": delta_kernel_check(torch, midx, q)}
    check(args.inserts <= 1536 or "held_snapshot_in_place" in steps,
          "the in-place snapshot check did not run")
    timed_inserts = args.inserts - 16 * ("held_snapshot_in_place" in steps)
    insert_stats = {"rows": args.inserts, "batch": 16, "seconds": insert_s,
              "rows_per_s": timed_inserts / insert_s,
              "upload_bytes": delta.upload_bytes,
              "upload_bytes_per_row": delta.upload_bytes / args.inserts,
              "capacity": delta.capacity, "r_max": delta._rmax,
              "postings_l_max": delta._postings.l_max,
              "dropped_nnz": delta.dropped_nnz}

    # 5. delete 256 delta rows and 16 main rows
    rng = np.random.default_rng(4)
    main_dead = rng.choice(n, size=80, replace=False)
    delta_dead = new_ids[::32][:256]
    check(midx.delete(delta_dead) == len(delta_dead), "delta deletes")
    check(midx.delete(main_dead[:16]) == 16, "main deletes")
    res5, launches5 = counted_search(torch, midx, ds, h, alpha, beta)
    c1_main = alpha * (h + ceil16(16))
    check(launches5["lut16_adc"] == 1 and launches5["lut16_adc_topk"] == 1,
          f"delta K1 + main K2 (c1 {c1_main}) expected: {launches5}")
    recall5 = live_recall(torch, midx, ds, res5, h)
    check(recall5 >= 0.95, f"recall@{h} after the mutations {recall5} < 0.95")
    steps["after_deletes"] = {
        "main_c1": c1_main, "launches": launches5, "recall_at_20": recall5,
        "delta_kernel": delta_kernel_check(torch, midx, q),
        "search_latency": timed_searches(torch, midx, ds, h, alpha, beta)}

    # 6. 64 more main deletes: the main engine's c1 passes 1024 -> K1
    check(midx.delete(main_dead[16:]) == 64, "main deletes")
    res6, launches6 = counted_search(torch, midx, ds, h, alpha, beta)
    c1_main = alpha * (h + ceil16(80))
    check(launches6["lut16_adc"] == 2 and launches6["lut16_adc_topk"] == 0,
          f"delta K1 + main K1 (c1 {c1_main}) expected: {launches6}")
    steps["after_more_deletes"] = {
        "main_c1": c1_main, "launches": launches6,
        "recall_at_20": live_recall(torch, midx, ds, res6, h),
        "search_latency": timed_searches(torch, midx, ds, h, alpha, beta)}

    # 7. snapshot isolation at the end of the inserts (this insert grows)
    xs7, xd7 = perturbed_rows(ds, 16, seed=5)
    steps["held_snapshot_growth"] = held_snapshot_check(
        torch, midx, q, lambda: midx.insert(xs7, xd7), alpha, beta)

    # 8. merge compaction
    t0 = time.perf_counter()
    merged = midx.compact(retrain=False)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    res8, _ = counted_search(torch, merged, ds, h, alpha, beta)
    recall8 = live_recall(torch, merged, ds, res8, h)
    check(recall8 >= 0.95, f"recall@{h} after merge compaction {recall8}")
    steps["merge_compact"] = {
        "seconds": merge_s, "rows": merged.num_points,
        "recall_at_20": recall8,
        "index_device_bytes": tensor_bytes(merged.engine.arrays)}
    del merged

    # 9. retrain compaction == a scratch build on survivors(), bit for bit
    t0 = time.perf_counter()
    retrained = midx.compact(retrain=True)
    retrain_s = time.perf_counter() - t0
    r_a = retrained.search(ds.q_sparse, ds.q_dense, h=h, alpha=alpha,
                           beta=beta)
    del retrained
    xs, xd, ids = st.survivors()
    scratch = HybridIndex.build(xs, xd, params, mutable=True, ext_ids=ids,
                                device="cuda")
    r_b = scratch.search(ds.q_sparse, ds.q_dense, h=h, alpha=alpha,
                         beta=beta)
    del scratch
    check(np.array_equal(r_a.ids, r_b.ids)
          and np.array_equal(r_a.scores, r_b.scores),
          "retrain compaction != scratch build")
    steps["retrain_compact"] = {"seconds": retrain_s,
                                "equals_scratch_build": True}
    del midx
    torch.cuda.empty_cache()
    emit("mutable", build_s=build_s, fresh_equals_immutable=True,
         fresh_launches=launches0, insert=insert_stats, steps=steps,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t_phase)
    return launches6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=524288,
                    help="rows of the slice (default 524288)")
    ap.add_argument("--inserts", type=int, default=8192,
                    help="rows the mutable phase inserts (default 8192)")
    args = ap.parse_args()
    t_start = time.perf_counter()

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

    idx, ds, queries, launches, c1, res = run_slice(args, torch)
    rows = run_kernels(torch, idx, queries, launches, c1)
    rows.append(run_value_forward(torch, idx, queries))
    params = idx.params
    del idx, queries
    torch.cuda.empty_cache()
    # K1 runs on the mutable path: its count comes from that path's run
    rows[0]["launches"] = run_mutable(args, torch, ds, params,
                                      res)["lut16_adc"]
    for r, path in zip(rows, ("mutable", "slice", "slice", "value_forward")):
        r["path"] = path
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
