#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--rows N] [--inserts M]

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, searches
one 2^26-row shard of the paper's 2^30-row index at its full size
(``launch.dryrun.lower_retrieval``, phase ``dryrun``: K2 and B4 at N =
2^26, held to their plain versions over the whole shard), builds a
HybridIndex of the "querysim-shard" configuration on the card and drives
its serving paths through their entry points: the immutable three-pass
search (phase ``slice``), each of its 128 queries alone, in
``QueryService`` buckets of 8 and 32 and in the Q = 128 call, bit for bit,
on ``cuda`` and ``cuda-packed``, fused and materialised (phase
``batch_invariance``), the mutable index — inserts into the delta
shard, deletes, searches merged across main and delta, merge and retrain
compaction (phase ``mutable``) — and the serving tier: ``QueryService``
over the slice's index under a ragged request stream, with the shard
fan-out, a refresh under load and per-pass times (phase ``service``), a
durable service with its snapshot store and WAL, recovered bit for bit
(phase ``durable``), the cluster tier — a ``LocalCluster`` of a primary,
two scorers and a replica, each a process of its own on the card, driven
through ``ClusterRouter`` and held bit for bit to in-process fan-outs
through a ragged stream, mutations, two compactions (a second router
searching from a thread all through each, none refused), healed frame
faults, a scorer kill and a failover, and to exact search by recall (phase
``cluster``) — ``python -m
repro_torch.launch.serve --retrieval`` plain, durable and restored, and
``--role router`` and ``--arch`` (phase ``launch``), the PQ LM head at the
qwen2-7b, qwen2.5-14b and deepseek-67b widths on random weights, K1 at K =
d/2 (phase ``lm_head``), the dense LM's decode loop at qwen2-7b's full
width and depth — ``greedy_generate`` and ``ServeSession`` with the exact
head and with the PQ head, K1 once a step, decode held to forward (phase
``lm_decode``) — the other families of the LM zoo: recurrentgemma-9b at
full width and depth through both heads (K1 at V = 256000, K = 2048 a PQ
step) and qwen2-moe-a2.7b at full width and depth through both heads
(K1 at V = 151936, K = 1024; each session reached by handing the f32 tree
over, ``donate=True``), mamba2-780m at full size through the exact head,
and the six smoke configs of these families (phase ``lm_families``) — and
the store the JAX
package wrote (``tests/data/reference_store``) recovered on the card and
held to the reference's results (phase ``reference_store``).  It holds
every kernel against its plain PyTorch version on the card, at the
slice's shapes, at those the cluster's nodes give it and, for K1 and K2,
at K up to 8192 (phases
``kernels_checked``, ``score_inverted_vf`` — B4, the pass-1 tail bias,
which every search path launches, timed beside the plain route —
``value_forward``, the JAX layout's stream kernel, off every path — and
``residual_checked``: R0-R3, ``csrc/residual.cu``, the fixed-order kernels
of the LUT, passes 2-3 and the PQ head's exact columns, at the test
widths and the heads' d = 3584 and 8192).  Each
phase prints one JSON line; any failed check
raises, and the script exits non-zero.  The last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or without the rest of the
repository beside it, it fails before printing a result.  It imports
nothing of JAX.

The configuration: ``make_hybrid_dataset(num_points=524288, num_queries=128,
d_sparse=200000, d_dense=200, nnz_per_row=134, alpha=2.0, dense_weight=2.0,
seed=3)`` (QuerySim-shaped; d_dense=200 gives K=100 subspaces of l=16) and
``HybridIndexParams(keep_top=192, head_dims=128, kmeans_iters=12,
nq_max=256)``, searched with h=20, alpha=25, beta=6 (c1=500: the fused
scan-and-select and the block-sparse head kernel).  The 524288 rows are a
cut of one 2^26-row shard of a 2^30-row deployment (the ``dryrun`` phase
runs a whole one); ``--rows`` cuts further for quick runs.  The mutable phase inserts ``--inserts`` (default 8192)
perturbed copies of main rows in batches of 16 into the default
64-slot delta shard; the durable phase 2048 + 256 of them, on the same
rows.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
from repro_torch.roofline.analysis import H100  # noqa: E402

HBM_BYTES_PER_S = H100["hbm_bw"]    # H100 SXM HBM3
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# The 67e12 counts an FMA as two operations; an f32 add takes one FMA lane
# a clock, so adds alone run at half of it (132 SMs x 128 lanes x 1.98 GHz).
F32_ADDS_PER_S = F32_OPS_PER_S / 2
TF32_OPS_PER_S = 495e12         # H100 SXM dense TF32 on the tensor cores
RTOL, ATOL = 1e-5, 1e-4         # the JAX package's kernel-vs-oracle tolerance


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_clock_mhz() -> float:
    """The SM clock's maximum as nvidia-smi reports it (MHz)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


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
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def max_abs(a, b) -> float:
    import torch
    fin = torch.isfinite(b)
    check(bool(torch.equal(torch.isfinite(a), fin)), "non-finite mismatch")
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max())


def assert_close(a, b, what: str, rtol: float = RTOL,
                 atol: float = ATOL) -> float:
    import torch
    err = max_abs(a, b)
    fin = torch.isfinite(b)
    check(bool(torch.all((a[fin] - b[fin]).abs()
                         <= atol + rtol * b[fin].abs())),
          f"{what}: max abs err {err} beyond rtol {rtol} atol {atol}")
    check(bool(torch.equal(a[~fin], b[~fin])), f"{what}: -inf slots differ")
    return err


def device_profile(torch, fn, runs=3) -> dict:
    """Device time of ``fn()`` by kernel (torch.profiler), against its wall
    time under the profiler: the busy share is their ratio."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
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

    def share(name):
        rows = [(ms, c) for k, ms, c in per_kernel if name in k]
        return {"ms": sum(ms for ms, _ in rows),
                "calls": sum(c for _, c in rows)}

    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "kernel_launches": sum(c for _, _, c in per_kernel),
            "k2": {"partial": share("lut16_topk_partial_kernel"),
                   "merge": share("topk_merge_kernel")},
            "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in per_kernel[:10]]}


@contextlib.contextmanager
def plain_tail(ops):
    """Within the block the kernel backends take the tail bias from
    ``score_inverted`` (one scatter-add a query slot), not from B4: the
    plain route, timed beside B4's in one run."""
    from repro_torch.core.sparse_index import score_inverted
    b4 = ops.score_inverted_vf
    ops.score_inverted_vf = score_inverted
    try:
        yield
    finally:
        ops.score_inverted_vf = b4


def profile_search(torch, idx, ds, nq, h, alpha, beta, runs=3):
    """``device_profile`` of one ``HybridIndex.search`` of ``nq`` queries."""
    qs, qd = ds.q_sparse[:nq], ds.q_dense[:nq]
    return device_profile(
        torch, lambda: idx.search(qs, qd, h=h, alpha=alpha, beta=beta), runs)


# ---------------------------------------------------------------------------
# slice: the querysim-shard configuration through the port's entry points
# ---------------------------------------------------------------------------

def querysim_shard(rows: int):
    """The configuration's data (``rows`` of it, 128 queries, seed 3) and
    index params, which ``slice``, ``cluster`` and
    ``tools/cluster_probe.py`` share."""
    from repro_torch.core.hybrid import HybridIndexParams
    from repro_torch.data import make_hybrid_dataset
    ds = make_hybrid_dataset(num_points=rows, num_queries=128,
                             d_sparse=200000, d_dense=200, nnz_per_row=134,
                             alpha=2.0, dense_weight=2.0, seed=3)
    return ds, HybridIndexParams(keep_top=192, head_dims=128,
                                 kmeans_iters=12, nq_max=256, backend="cuda")


def run_slice(args, torch):
    from repro_torch.core.baselines import exact_topk, recall_at_h
    from repro_torch.core.engine import Backend, ScoringEngine
    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.core.sparse_index import sparse_queries_to_padded
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS

    t0 = time.perf_counter()
    ds, params = querysim_shard(args.rows)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
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
    check(launches["score_inverted_vf"] == 1, "main path did not launch B4 "
          "once")
    check(launches["inverted_value_forward"] == 0,
          "main path launched the stream B4")
    check(all(launches[k] == 1 for k in ("adc_lut", "dense_residual",
                                         "sparse_residual")),
          f"main path did not launch R0, R1 and R2 once each: {launches}")
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

    with plain_tail(ops):
        plain_route = eng.search(q_dims, q_vals, q_dense, h=h, alpha=alpha,
                                 beta=beta)
    check(all(torch.equal(a, b) for a, b in zip(fused, plain_route)),
          "the search with score_inverted's tail != the search with B4's")

    # both routes of the tail bias in turns (B4, plain, plain, B4), the
    # median of 20 searches each
    def search_ms(nq):
        qs, qd = ds.q_sparse[:nq], ds.q_dense[:nq]
        for _ in range(3):
            idx.search(qs, qd, h=h, alpha=alpha, beta=beta)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            idx.search(qs, qd, h=h, alpha=alpha, beta=beta)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        return {"median_ms": med * 1e3, "min_ms": min(times) * 1e3,
                "qps": nq / med}

    latency, latency_plain = {}, {}
    for nq in (1, 8, 128):
        turns = {"b4": [], "plain": []}
        for route in ("b4", "plain", "plain", "b4"):
            with (plain_tail(ops) if route == "plain"
                  else contextlib.nullcontext()):
                turns[route].append(search_ms(nq))
        for out, route in ((latency, "b4"), (latency_plain, "plain")):
            out[str(nq)] = {**turns[route][0], "turns_ms": [
                t["median_ms"] for t in turns[route]]}
    profiles = {str(nq): profile_search(torch, idx, ds, nq, h, alpha, beta)
                for nq in (1, 8, 128)}
    with plain_tail(ops):
        profiles_plain = {str(nq): profile_search(torch, idx, ds, nq, h,
                                                  alpha, beta)
                          for nq in (1, 8, 128)}
    emit("slice", c1=c1, c2=c2, h=h, recall_at_20=recall,
         exact_topk_s=exact_s, main_path_launches=launches,
         main_path_plain_calls=plain, fused_equals_materialised=True,
         repeat_identical=same_twice, packed_ids_equal=True,
         packed_max_abs_err=packed_err, c1_2000_routes_k1=True,
         plain_tail_equals_b4=True, search_latency=latency,
         search_latency_plain_tail=latency_plain, search_profile=profiles,
         search_profile_plain_tail=profiles_plain,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return (idx, ds, (q_dims, q_vals, q_dense), launches, c1, res, profiles,
            true_ids)


def k2_profile_split(profiles) -> dict:
    """K2's device time per search in the profile, split between its
    partial kernel and its merge rounds."""
    return {nq: {"partial_ms": p["k2"]["partial"]["ms"],
                 "merge_ms": p["k2"]["merge"]["ms"],
                 "merge_launches": p["k2"]["merge"]["calls"]}
            for nq, p in profiles.items() if "k2" in p}


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
        check(torch.equal(got, want), f"K1 != plain at {(n, k_sub, q, packed)}")
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


def edge_cases_k1(torch, ops, ref) -> dict:
    """K1 against its plain version, bit for bit, at what its design
    introduces: Q off the query block and group (1, 3, 5, 9, 17, 20, 33);
    kc % 4 != 0, whose codes are staged back to back and funnel-shifted (K
    = 7 and 50 unpacked, odd packed K = 99 -> kc = 50, packed K = 13 -> kc
    = 7), beside kc % 4 == 0 with an even word count (K = 32); N not a
    multiple of the chunk and N below one chunk; row ranges that end
    mid-chunk, with several chunks a range (explicit plans); the delta
    engine's N = 8192 at Q = 128, packed and not; codes at a 16-byte offset
    into their allocation (a view).  Each launch runs twice and must give
    the same bits; a plan's CTAs per SM must be the occupancy calculator's,
    its shared memory the C side's; codes off 16-byte alignment must be
    refused."""
    from repro_torch.kernels import lut16
    g = torch.Generator(device="cuda").manual_seed(14)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = []
    for n, k_sub, q, packed, explicit in (
            (1000, 100, 1, False, None), (1000, 100, 3, False, None),
            (3001, 100, 5, False, None), (2049, 99, 17, True, None),
            (777, 13, 9, True, None), (500, 7, 33, False, None),
            (300, 32, 3, False, None), (100, 100, 16, False, None),
            (64, 99, 2, True, None), (8192, 100, 128, False, None),
            (8192, 100, 128, True, None), (1000, 100, 20, False, (96, 288)),
            (1000, 50, 20, False, (64, 192)), (999, 7, 3, False, (32, 96)),
            (1000, 16, 8, False, "view")):
        codes = torch.randint(0, 16, (n + 1, k_sub), generator=g,
                              device="cuda", dtype=torch.uint8)
        codes = codes[1:] if explicit == "view" else codes[:n]
        lut = torch.randn((q, k_sub, 16), generator=g, device="cuda")
        stored = (torch.from_numpy(ops.pack_codes(codes.cpu().numpy())).cuda()
                  if packed else codes.contiguous() if explicit != "view"
                  else codes)
        kc = stored.shape[1]
        lut_p = ops._validate_packed(kc, k_sub, 16, lut, packed).contiguous()
        kl = lut_p.shape[1]
        want = ref.lut16_adc_plain(stored, lut_p, packed=packed)
        plan = lut16.plan_adc(q, n, kc, kl, sms, packed)
        if isinstance(explicit, tuple):
            threads, rows = explicit
            plan = lut16.AdcPlan(
                bq=plan.bq, threads=threads, rows_per_cta=rows,
                smem_bytes=lut16.adc_smem_bytes(plan.bq, kc, kl, threads),
                ctas_per_sm=0)

            def run():
                return lut16.lut16_adc_cuda(stored, lut_p, packed=packed,
                                            plan=plan)
        else:
            check(plan.ctas_per_sm == lut16.adc_ctas_per_sm(
                plan.bq, packed, kc, kl, plan.threads, plan.chunk),
                f"K1 plan at {(n, k_sub, q, packed)}: CTAs per SM differ "
                "from the occupancy calculator's")

            def run():
                return ops.lut16_adc(stored, lut, packed=packed)
        check(plan.smem_bytes == lut16.adc_smem_bytes_cuda(
            plan.bq, kc, kl, plan.threads, plan.chunk),
            "K1 shared memory: Python != C")
        got = run()
        shape = (n, k_sub, q, packed, explicit)
        check(torch.equal(got, want), f"K1 != plain at {shape}")
        check(torch.equal(got, run()), f"K1 at {shape}: two launches differ")
        shapes.append({"n": n, "k": k_sub, "q": q, "packed": packed,
                       "kc": kc, "bq": plan.bq, "threads": plan.threads,
                       "rows_per_cta": plan.rows_per_cta,
                       "ranges": plan.grid(q, n)[0]})
    odd = torch.randint(0, 16, (101, 7), generator=g, device="cuda",
                        dtype=torch.uint8)[1:]
    try:
        ops.lut16_adc(odd, torch.randn((2, 7, 16), device="cuda"))
    except ValueError:
        pass
    else:
        raise AssertionError("K1 took codes off 16-byte alignment")
    return {"cases": len(shapes), "shapes": shapes}


def edge_cases_k2_threshold(torch, ops, ref) -> dict:
    """K2 against inputs that attack its shared per-query threshold, at Q =
    1, 8 and 130 (two query blocks of the grid's x past 128), k = 1, 500 and
    1024, over N = 40000 rows (several row ranges at every k):

    - rising: scores rise with the row id, so every row beats every
      threshold (the most staging);
    - all_equal: every row has the same codes and no bias, so all rows tie
      and the lowest ids must win across every range boundary;
    - planted_ties: a zero LUT and integer scores below 0, with 0 in the
      last cbuf rows and in rows spread over all ranges: exact ties at the
      cbuf-th score, which the last range alone can publish;
    - neginf: a -inf mask on all but k - 1 rows;

    and k == N with a mask at each Q.  In each case K2 must equal K1 +
    stable sort bit for bit, its ids the plain version's, and two launches
    must give the same bits."""
    g = torch.Generator(device="cuda").manual_seed(13)
    n = 40000
    counts: dict[str, int] = {}

    def run(kind, stored, lut, k, bias, mask, packed):
        kw = dict(bias=bias, row_mask=mask, packed=packed)
        s, i = ops.lut16_adc_topk(stored, lut, k, **kw)
        s2, i2 = ops.lut16_adc_topk(stored, lut, k, **kw)
        check(torch.equal(s, s2) and torch.equal(i, i2),
              f"K2 {kind} q={lut.shape[0]} k={k}: two launches differ")
        sm, im = ops.lut16_adc_topk(stored, lut, k, fused=False, **kw)
        check(torch.equal(s, sm) and torch.equal(i, im),
              f"K2 {kind} q={lut.shape[0]} k={k} != K1 + stable sort")
        base = bias
        if mask is not None:
            base = mask[None] if base is None else base + mask[None]
        lut_p = ops._validate_packed(stored.shape[1], lut.shape[1], 16, lut,
                                     packed)
        _, pi = ops._normalize(*ref.lut16_adc_topk_plain(stored, lut_p, base,
                                                         k, packed=packed))
        check(torch.equal(i, pi),
              f"K2 {kind} q={lut.shape[0]} k={k}: ids != plain")
        counts[kind] = counts.get(kind, 0) + 1
        return i

    for q, k_sub, packed in ((1, 100, False), (8, 100, False), (130, 99, True)):
        codes = torch.randint(0, 16, (n, k_sub), generator=g, device="cuda",
                              dtype=torch.uint8)

        def store(c, packed=packed):
            return (torch.from_numpy(ops.pack_codes(c.cpu().numpy())).cuda()
                    if packed else c)

        stored = store(codes)
        same = store(codes[:1].expand(n, k_sub).contiguous())
        lut = torch.randn((q, k_sub, 16), generator=g, device="cuda")
        zero = torch.zeros_like(lut)
        rows = torch.arange(n, device="cuda", dtype=torch.float32)
        for k in (1, 500, 1024):
            cbuf = ops.candidate_buffer_width(k)
            run("rising", stored, lut, k, (256.0 * rows).expand(q, n)
                .contiguous(), None, packed)
            i = run("all_equal", same, lut, k, None, None, packed)
            check(bool((i == torch.arange(k, device="cuda",
                                          dtype=torch.int32)).all()),
                  "all_equal: not the lowest ids")
            bias = -1.0 - torch.floor(20 * torch.rand((q, n), generator=g,
                                                      device="cuda"))
            bias[:, n - cbuf:] = 0.0
            bias[:, 37::n // 64] = 0.0
            i = run("planted_ties", stored, zero, k, bias, None, packed)
            tied = torch.nonzero(bias[0] == 0.0)[:k, 0].int()
            check(bool((i == tied[None]).all()),
                  "planted ties: not the lowest ids")
            mask = torch.full((n,), -torch.inf, device="cuda")
            mask[torch.randperm(n, generator=g, device="cuda")[:k - 1]] = 0.0
            i = run("neginf", stored, lut, k, None, mask, packed)
            check(int((i >= 0).sum()) == q * (k - 1), "neginf: live count")
        # k == N under a mask: one range, every row selected, masked ids -1
        small = stored[:1000]
        mask = torch.zeros(1000, device="cuda")
        mask[torch.randperm(1000, generator=g, device="cuda")[:300]] = -torch.inf
        run("k_equals_n", small, lut, 1000, None, mask, packed)
    counts["total"] = sum(counts.values())
    return counts


WIDE_KS = (694, 718, 1152, 1194, 1792, 2046, 2048, 2560, 4095, 4096, 8192)


def edge_cases_wide_k(torch, ops, ref) -> dict:
    """K1 and K2 at K whose whole LUT image leaves them too few warps an
    SM or does not fit (``WIDE_KS``, up to 8192), unpacked and packed (odd
    K packed: its phantom column), Q = 1, 8, 33, N = 3001 and 152064; K2 at
    k = 20, 500, 1024 with a (Q, N) bias and a row mask (a third of the
    rows at -inf).  K1 equals ``lut16_adc_plain`` bit for bit; K2's scores
    and ids equal the plain selection bit for bit (``lut16_adc_topk_plain``
    at N = 3001; at N = 152064 the same stable sort of the bias, the mask
    and K1's plain scores, which are already at hand); every launch equals
    its second.  Each case reports its plans: chunks, bq, threads and
    warps an SM (at least 8).  Both planners' CTAs an SM equal the
    occupancy calculator's, the C side's shared memory equals the
    mirrors', and K2's op launches the plan ``plan_topk`` makes.  At N =
    152064, Q = 33 and K = 1792, 4096, 8192 K1 and K2 (k = 500) are timed
    beside their bounds (``timed``)."""
    from repro_torch.kernels import lut16
    g = torch.Generator(device="cuda").manual_seed(21)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    shapes, timed = [], []
    for k_sub in WIDE_KS:
        for packed in (False, True):
            kc = -(-k_sub // 2) if packed else k_sub
            for n in (3001, 152064):
                stored = torch.randint(0, 256 if packed else 16, (n, kc),
                                       generator=g, device="cuda",
                                       dtype=torch.uint8)
                if packed and k_sub % 2:
                    stored[:, -1] &= 0x0F      # pack_codes' zero pad nibble
                for q in (1, 8, 33):
                    where = f"K = {k_sub}, packed = {packed}, N = {n}, Q = {q}"
                    lut = torch.randn((q, k_sub, 16), generator=g,
                                      device="cuda")
                    lut_p = ops._validate_packed(kc, k_sub, 16, lut,
                                                 packed).contiguous()
                    kl = lut_p.shape[1]
                    plan = lut16.plan_adc(q, n, kc, kl, sms, packed)
                    ctas = lut16.adc_ctas_per_sm(plan.bq, packed, kc, kl,
                                                 plan.threads, plan.chunk)
                    check(ctas == plan.ctas_per_sm,
                          f"K1 plan at {where}: {plan.ctas_per_sm} CTAs an "
                          f"SM, the occupancy calculator {ctas}")
                    check(plan.smem_bytes == lut16.adc_smem_bytes_cuda(
                        plan.bq, kc, kl, plan.threads, plan.chunk),
                        f"K1 shared memory at {where}: Python != C")
                    check(ctas * plan.threads // 32 >= 8,
                          f"K1 plan at {where}: fewer than 8 warps an SM")
                    want = ref.lut16_adc_plain(stored, lut_p, packed=packed)
                    got = ops.lut16_adc(stored, lut, packed=packed)
                    check(torch.equal(got, want), f"K1 != plain at {where}")
                    check(torch.equal(got, ops.lut16_adc(stored, lut,
                                                         packed=packed)),
                          f"K1 at {where}: two launches differ")
                    del got
                    bias = torch.randn((q, n), generator=g, device="cuda")
                    mask = torch.zeros(n, device="cuda")
                    mask[torch.randperm(n, generator=g, device="cuda")
                         [:n // 3]] = -torch.inf
                    base = bias + mask[None]
                    k2 = []
                    for kk in (20, 500, 1024):
                        got = ops.lut16_adc_topk(stored, lut, kk, bias=bias,
                                                 row_mask=mask, packed=packed)
                        if n <= 3001:
                            plain = ref.lut16_adc_topk_plain(
                                stored, lut_p, base, kk, packed=packed)
                        else:
                            plain = ref.stable_topk(base + want, kk)
                        check(all(torch.equal(a, b) for a, b in zip(
                            got, ops._normalize(*plain))),
                            f"K2 != plain at {where}, k = {kk}")
                        check(all(torch.equal(a, b) for a, b in zip(
                            got, ops.lut16_adc_topk(stored, lut, kk,
                                                    bias=bias, row_mask=mask,
                                                    packed=packed))),
                              f"K2 at {where}, k = {kk}: two launches differ")
                        cbuf = ops.candidate_buffer_width(kk)
                        bq, rows, chunk = ops._resolve_topk_blocks(
                            q, n, kc, kl, packed, cbuf, stored.device)
                        tp = lut16.plan_topk(q, kc, kl, cbuf)
                        check(tp.bq == bq and tp.chunk == chunk,
                              f"K2 plan at {where}, k = {kk}: the op "
                              f"launches ({bq}, {chunk}), the planner "
                              f"({tp.bq}, {tp.chunk})")
                        check(tp.smem_bytes == lut16.topk_smem_bytes_cuda(
                            bq, kc, kl, cbuf, chunk),
                            f"K2 shared memory at {where}: Python != C")
                        ctas2 = lut16.topk_ctas_per_sm(bq, packed, kc, kl,
                                                       cbuf, chunk)
                        check(tp.ctas_per_sm == ctas2,
                              f"K2 plan at {where}, k = {kk}: "
                              f"{tp.ctas_per_sm} CTAs an SM, the occupancy "
                              f"calculator {ctas2}")
                        check(ctas2 * lut16.THREADS // 32 >= 8,
                              f"K2 plan at {where}: fewer than 8 warps an SM")
                        if (n, q, kk) == (152064, 33, 500) and k_sub in (
                                1792, 4096, 8192):
                            timed.append({
                                "k": k_sub, "packed": packed, "n": n, "q": q,
                                "k1_ms": cuda_ms(lambda: ops.lut16_adc(
                                    stored, lut, packed=packed), runs=10),
                                "k2_ms": cuda_ms(lambda: ops.lut16_adc_topk(
                                    stored, lut, kk, bias=bias, row_mask=mask,
                                    packed=packed), runs=10),
                                "k1_bound_ms": max(
                                    (n * kc + 4 * q * n) / HBM_BYTES_PER_S,
                                    q * n * k_sub / F32_ADDS_PER_S) * 1e3,
                                "k2_bound_ms": max(
                                    (n * kc + 4 * q * n) / HBM_BYTES_PER_S,
                                    q * n * (k_sub + 1) / F32_ADDS_PER_S)
                                * 1e3})
                        k2.append({"k": kk, "bq": bq, "rows_per_cta": rows,
                                   "chunk": chunk,
                                   "chunks": -(-kc // (chunk or kc)),
                                   "smem_bytes": tp.smem_bytes,
                                   "warps_per_sm": ctas2 * lut16.THREADS
                                   // 32})
                    shapes.append({
                        "k": k_sub, "packed": packed, "n": n, "q": q,
                        "kc": kc, "k1": {
                            "bq": plan.bq, "threads": plan.threads,
                            "chunk": plan.chunk, "chunks": plan.chunks(kc),
                            "rows_per_cta": plan.rows_per_cta,
                            "smem_bytes": plan.smem_bytes,
                            "warps_per_sm": ctas * plan.threads // 32},
                        "k2": k2})
                    del want, bias, mask, base
                del stored
            torch.cuda.empty_cache()
    return {"cases": len(shapes), "k2_cases": 3 * len(shapes),
            "seconds": time.perf_counter() - t0, "timed": timed,
            "shapes": shapes}


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


def ptxas_report(log: str, kernels: tuple[str, ...]) -> dict:
    """Registers, static shared memory and spills of each instantiation of
    the named kernels (``block_sparse_kernel<WM,NT,STAGES>``,
    ``lut16_topk_partial_kernel<BQ,PACKED>``, ...) from nvcc's
    ``-Xptxas -v`` report of one source."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      ln)
        if m:
            cur = None
            for name in kernels:
                k = re.search(rf"\d{name}(?:I((?:L[ib]\d+E)+)E)?", m.group(1))
                if k:
                    args = ",".join(re.findall(r"L[ib](\d+)E", k.group(1) or ""))
                    cur = f"{name}<{args}>" if args else name
                    break
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


def cluster_kernel_shapes(torch, ops, ref, arrays, queries, c1) -> dict:
    """K1, K2, K3 and B4 at the shapes the ``cluster`` phase's nodes give
    them, each against its plain version on the same inputs (B4 bit for
    bit, on each part's localised inverted index):

    * a scorer's ragged row slice (``split_index_arrays(..., 2,
      ragged=True)``) and the full index (the replica's ``full`` part, the
      primary's direct reads) at the router's buckets Q = 1, 8, 32: K1 bit
      for bit; K2 at k = c1 and at the fused route's largest k, scores and
      ids bit for bit and equal across two launches; K3 within rtol / atol
      (3xTF32: not the plain version's bits) and equal across two launches;
    * the primary's delta: k == N == capacity with a row mask, K2 up to
      1024 slots and K1 + stable sort above, bit for bit, and K1 itself."""
    from repro_torch.core.distributed import split_index_arrays
    from repro_torch.core.engine import pass1_bias, scatter_head_queries
    from repro_torch.core.pq import adc_lut
    q_dims, q_vals, q_dense = queries
    parts, _ = split_index_arrays(arrays, 2, ragged=True)
    ks = (c1, ops.MAX_FUSED_CANDIDATES)
    out = {"buckets": [1, 8, 32], "k2_k": list(ks), "parts": {}}
    for name, a in (("scorer-0", parts[0]), ("scorer-1", parts[1]),
                    ("full", arrays)):
        n, errs = a.num_points, {}
        for qn in (1, 8, 32):
            qd, qv = q_dims[:qn], q_vals[:qn]
            lut = adc_lut(q_dense[:qn], a.codebooks)
            bias = pass1_bias(a, qd, qv)
            where = f"{name}, N = {n}, Q = {qn}"
            check(torch.equal(ops.lut16_adc(a.codes, lut),
                              ref.lut16_adc_plain(a.codes, lut)),
                  f"K1 != plain at {where}")
            for k in ks:
                got = ops.lut16_adc_topk(a.codes, lut, k, bias=bias)
                want = ops._normalize(*ref.lut16_adc_topk_plain(
                    a.codes, lut, bias, k))
                check(all(torch.equal(x, y) for x, y in zip(got, want)),
                      f"K2 != plain at {where}, k = {k}")
                check(all(torch.equal(x, y) for x, y in zip(
                    got, ops.lut16_adc_topk(a.codes, lut, k, bias=bias))),
                      f"K2 at {where}, k = {k}: two launches differ")
            b4_equal(torch, ops, a.inv_index, qd, qv, f"B4 at {where}")
            q_head = scatter_head_queries(qd, qv, a.head_pos,
                                          a.head.block.shape[1])
            bcsr = (a.head_tiles, a.head_ptr, a.head_col)
            got = ops.block_sparse_matmul_bcsr(q_head, *bcsr)
            check(torch.equal(got, ops.block_sparse_matmul_bcsr(q_head,
                                                                *bcsr)),
                  f"K3 at {where}: two launches differ")
            errs[str(qn)] = assert_close(
                got, ref.block_sparse_plain(q_head, *bcsr), f"K3 at {where}")
        out["parts"][name] = {"N": n, "k3_max_abs_err": errs}
    # the delta: main rows' codes at its capacities, a quarter of the
    # slots masked (free or tombstoned), k == N as the delta engine asks
    lut32 = adc_lut(q_dense[:32], arrays.codebooks)
    bias32 = pass1_bias(arrays, q_dims[:32], q_vals[:32])
    out["delta_capacities"] = []
    for cap in (1024, 2048, 4096):
        codes = arrays.codes[:cap]
        mask = torch.zeros(cap, device=codes.device)
        mask[torch.arange(cap, device=codes.device) % 4 == 3] = -np.inf
        for qn in (1, 8, 32):
            lut, bias = lut32[:qn], bias32[:qn, :cap].contiguous()
            where = f"the delta, k == N == {cap}, Q = {qn}"
            got = ops.lut16_adc_topk(codes, lut, cap, bias=bias,
                                     row_mask=mask)
            want = ops._normalize(*ref.lut16_adc_topk_plain(
                codes, lut, bias + mask[None], cap))
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"{where}: pass 1 != plain")
            check(torch.equal(ops.lut16_adc(codes, lut),
                              ref.lut16_adc_plain(codes, lut)),
                  f"{where}: K1 != plain")
        out["delta_capacities"].append(cap)
    return out


def run_kernels(torch, idx, queries, launches, c1):
    from repro_torch.core.engine import pass1_bias, scatter_head_queries
    from repro_torch.core.pq import adc_lut
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_sparse import _smem_bytes
    from repro_torch.kernels.lut16 import (adc_ctas_per_sm, plan_adc,
                                           plan_topk, topk_ctas_per_sm,
                                           topk_smem_bytes,
                                           topk_smem_bytes_cuda)

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

    # K1, at the slice's Q = 128 and at Q = 1, 8 and the delta's N = 8192
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = smi_clock_mhz()
    wavefronts_per_ms = sms * clock_mhz * 1e3

    def k1_bound(qn, nn):
        return max((nn * kc + 4 * qn * nn) / HBM_BYTES_PER_S,
                   qn * nn * k_sub / F32_ADDS_PER_S) * 1e3

    def lut_floors(qn, nn, bq):
        """The scan's shared-memory floors at one wavefront per clock per
        SM: ``smem_floor_ms``, 4 B per lookup at 128 B a wavefront (as in
        earlier runs); ``layout_floor_ms``, the kept layout's wavefronts:
        32 lookups each (an LDS.64 for 2 queries takes two, a half-warp
        each), plus each query block's code words, one wavefront per warp
        and word to stage them and one to read them."""
        lookups = qn * nn * k_sub
        words = -(-nn // 32) * -(-kc // 4) * 2 * -(-qn // bq)
        return {"smem_floor_ms": lookups / 32 / wavefronts_per_ms,
                "layout_floor_ms": (lookups / 32 + words) / wavefronts_per_ms}

    def k1_reading(c, lq):
        qn, nn = lq.shape[0], c.shape[0]
        want = ref.lut16_adc_plain(c, lq)
        got = ops.lut16_adc(c, lq)
        check(torch.equal(got, want), f"K1 != plain at Q = {qn}, N = {nn}")
        check(torch.equal(got, ops.lut16_adc(c, lq)),
              f"K1 at Q = {qn}, N = {nn}: two launches differ")
        e_idx = (c.long() + 16 * torch.arange(k_sub, device="cuda"))
        e_w = lq.permute(1, 2, 0).reshape(k_sub * 16, qn).contiguous()
        lib = torch.nn.functional.embedding_bag(e_idx, e_w, mode="sum").T
        assert_close(lib, want, "embedding_bag yardstick")
        plan = plan_adc(qn, nn, kc, k_sub, sms)
        return {"ms": cuda_ms(lambda: ops.lut16_adc(c, lq)),
                "plain_ms": cuda_ms(lambda: ref.lut16_adc_plain(c, lq)),
                "library_ms": cuda_ms(lambda: torch.nn.functional
                                      .embedding_bag(e_idx, e_w, mode="sum")),
                "bound_ms": k1_bound(qn, nn), "max_abs_err": max_abs(got,
                                                                      want),
                "plan": {"bq": plan.bq, "threads": plan.threads,
                         "chunk": plan.chunk,
                         "rows_per_cta": plan.rows_per_cta,
                         "grid": plan.grid(qn, nn),
                         "smem_bytes": plan.smem_bytes,
                         "ctas_per_sm": plan.ctas_per_sm,
                         "ctas_per_sm_cuda": adc_ctas_per_sm(
                             plan.bq, False, kc, k_sub, plan.threads),
                         "warps_per_sm": plan.warps_per_sm},
                **lut_floors(qn, nn, plan.bq)}

    k1_by_q = {str(qn): k1_reading(codes, lut[:qn]) for qn in (1, 8, nq)}
    k1_by_q["128_n8192"] = k1_reading(codes[:8192], lut)
    k1 = {key: k1_by_q[str(nq)][key]
          for key in ("ms", "plain_ms", "library_ms", "max_abs_err")}
    k1_plan = k1_by_q[str(nq)]["plan"]
    check(k1_plan["ctas_per_sm"] == k1_plan["ctas_per_sm_cuda"],
          "K1's plan and the occupancy calculator disagree")
    check(all(r["plan"]["chunk"] is None for r in k1_by_q.values()),
          "K1 at the slice shapes does not plan its whole LUT image")
    k1_bytes = n * kc + 4 * nq * n
    k1_ops = nq * n * k_sub

    # K2
    s, i = ops.lut16_adc_topk(codes, lut, c1, bias=bias)
    s2, i2 = ops.lut16_adc_topk(codes, lut, c1, bias=bias, fused=False)
    check(torch.equal(s, s2) and torch.equal(i, i2),
          "K2 != K1 + stable sort at the slice shapes")
    ps, pi = ops._normalize(*ref.lut16_adc_topk_plain(codes, lut, bias, c1))
    check(torch.equal(i, pi), "K2 ids != plain at the slice shapes")
    check(all(torch.equal(a, b) for a, b in zip(
        (s, i), ops.lut16_adc_topk(codes, lut, c1, bias=bias))),
        "K2: two launches at the slice shapes differ")
    # the fused pass 1 produces no f32 (Q > 1, >= N) tensor; the
    # materialising route does (the reference's structural check)
    fused_writes = ops.dense_scores_materialized(
        lambda c, lq: ops.lut16_adc_topk(c, lq, c1), codes, lut)
    route_writes = ops.dense_scores_materialized(
        lambda c, lq: ops.lut16_adc_topk(c, lq, c1, fused=False), codes, lut)
    check(not fused_writes and route_writes,
          "dense_scores_materialized: fused "
          f"{fused_writes}, materialised {route_writes}")
    k2 = dict(ms=cuda_ms(lambda: ops.lut16_adc_topk(codes, lut, c1, bias=bias)),
              plain_ms=cuda_ms(lambda: ref.lut16_adc_topk_plain(codes, lut,
                                                                bias, c1)),
              library_ms=None, max_abs_err=assert_close(s, ps, "K2 scores"))

    def k2_bytes(qn):
        return n * kc + 4 * qn * n

    def k2_ops(qn):
        return qn * n * (k_sub + 1)

    # K2 against the route fusion has to beat: the port's own materialised
    # pass 1 (K1 + stable sort), one call a reading, at Q = 1, 8 and 128
    k2_by_q = {}
    for qn in (1, 8, nq):
        lq, bq_ = lut[:qn], bias[:qn]
        k2_by_q[str(qn)] = {
            "ms": cuda_ms(lambda: ops.lut16_adc_topk(codes, lq, c1, bias=bq_)),
            "materialised_ms": cuda_ms(lambda: ops.lut16_adc_topk(
                codes, lq, c1, bias=bq_, fused=False)),
            "bound_ms": max(k2_bytes(qn) / HBM_BYTES_PER_S,
                            k2_ops(qn) / F32_ADDS_PER_S) * 1e3}
    cbuf = ops.candidate_buffer_width(c1)
    bq_k2, rows_k2, chunk_k2 = ops._resolve_topk_blocks(
        nq, n, kc, k_sub, False, cbuf, codes.device)
    tp_k2 = plan_topk(nq, kc, k_sub, cbuf)
    check(chunk_k2 is None and tp_k2.chunk is None and tp_k2.bq == bq_k2,
          "K2 at the slice shapes does not plan its whole LUT image")
    check(tp_k2.ctas_per_sm == topk_ctas_per_sm(bq_k2, False, kc, k_sub,
                                                cbuf),
          "K2's plan and the occupancy calculator disagree at the slice "
          "shapes")
    check(topk_smem_bytes(bq_k2, kc, k_sub, cbuf) == topk_smem_bytes_cuda(
        bq_k2, kc, k_sub, cbuf), "K2 shared memory: Python != C")
    k2_extra = {
        "materialised_ms": k2_by_q[str(nq)]["materialised_ms"],
        "by_q": k2_by_q,
        "ptxas": {
            "dynamic_smem_bytes": topk_smem_bytes_cuda(bq_k2, kc, k_sub,
                                                       cbuf),
            "ctas_per_sm": topk_ctas_per_sm(bq_k2, False, kc, k_sub, cbuf),
            "bq": bq_k2, "rows_per_cta": rows_k2,
            "ranges": -(-n // rows_k2),
            **ptxas_report(_build.build()["ptxas"]["lut16"],
                           ("lut16_topk_partial_kernel",
                            "topk_merge_kernel"))},
        **lut_floors(nq, n, bq_k2), "smem_floor_clock_mhz": clock_mhz}
    k1_extra = {
        "by_q": k1_by_q,
        "ptxas": {**k1_plan, **ptxas_report(_build.build()["ptxas"]["lut16"],
                                            ("lut16_adc_kernel",))},
        "smem_floor_ms": k1_by_q[str(nq)]["smem_floor_ms"],
        "layout_floor_ms": k1_by_q[str(nq)]["layout_floor_ms"]}

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
    edge_k1 = edge_cases_k1(torch, ops, ref)
    edge_k2 = edge_cases_k2_threshold(torch, ops, ref)
    edge_wide = edge_cases_wide_k(torch, ops, ref)
    edge_bs = edge_cases_block_sparse(torch, ops, ref)
    cluster_shapes = cluster_kernel_shapes(torch, ops, ref, arrays, queries,
                                           c1)

    rows = [
        kernel_row("lut16_adc", "src/repro_torch/csrc/lut16.cu",
                   "src/repro/kernels/lut16.py:110", launches["lut16_adc"],
                   k1, k1_bytes, k1_ops, F32_ADDS_PER_S),
        kernel_row("lut16_adc_topk", "src/repro_torch/csrc/lut16.cu",
                   "src/repro/kernels/lut16.py:216",
                   launches["lut16_adc_topk"], k2, k2_bytes(nq), k2_ops(nq),
                   F32_ADDS_PER_S),
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
               **ptxas_report(_build.build()["ptxas"]["block_sparse"],
                              ("block_sparse_kernel",))},
        by_q=k3_by_q)
    rows[0].update(k1_extra)
    rows[1].update(k2_extra)
    emit("kernels_checked", slice_shapes={"Q": nq, "N": n, "Kc": kc, "K": k_sub,
                                          "k": c1, "tiles": t_real,
                                          "N_pad": n_pad},
         edge_cases_lut16=edge_lut, edge_cases_k1=edge_k1,
         edge_cases_k2_threshold=edge_k2, edge_cases_wide_k=edge_wide,
         dense_scores_materialized={"fused": fused_writes,
                                    "materialised": route_writes},
         edge_cases_block_sparse=len(edge_bs),
         block_sparse_cases=edge_bs, cluster_shapes=cluster_shapes,
         tolerance={"rtol": RTOL, "atol": ATOL})
    return rows


# ---------------------------------------------------------------------------
# residual: R0-R3 (csrc/residual.cu), the fixed-order kernels of the LUT,
# passes 2-3 and the PQ head's exact columns, bit for bit with their plain
# versions, each query's rows the same alone and in any batch
# ---------------------------------------------------------------------------

RESIDUAL_SOURCE = "src/repro_torch/csrc/residual.cu"
# no Pallas kernel: the JAX package's plain jnp step each takes the place of
RESIDUAL_REPLACES = {
    "adc_lut": "none: plain jnp, src/repro/core/pq.py:132 adc_lut",
    "dense_residual": "none: plain jnp, src/repro/core/residual.py:32 "
                      "dense_residual_scores",
    "sparse_residual": "none: plain jnp, src/repro/core/sparse_index.py:325 "
                       "score_rows",
    "gathered_dot": "none: plain jnp, src/repro/serve/hybrid_head.py:116 "
                    "(the exact columns)",
}
HEAD_SHAPES = {"qwen2-7b": (152064, 3584), "deepseek-67b": (102400, 8192)}


def residual_problem(torch, g, *, q, c, n, d, r=None, width=None):
    """Random inputs of R1-R3 (and R2's when ``r``): int8 and f32 rows
    (N, d), scale, zero, queries (Q, d), candidates (Q, C) with -1 and
    >= N among them (clipped), R2's rows (N, r) with pads and an all-pad
    row and its queries (Q, width)."""
    out = {"rows8": torch.randint(-128, 128, (n, d), generator=g,
                                  device="cuda", dtype=torch.int8),
           "scale": torch.rand(d, generator=g, device="cuda") * 0.02 + 1e-3,
           "zero": torch.randn(d, generator=g, device="cuda"),
           "q": torch.randn((q, d), generator=g, device="cuda"),
           "cand": torch.randint(0, n, (q, c), generator=g, device="cuda",
                                 dtype=torch.int32)}
    out["cand"][0, 0] = -1
    out["cand"][-1, -1] = n + 3
    if d * n <= 1 << 28:
        out["rows32"] = torch.randn((n, d), generator=g, device="cuda")
    if r is not None:
        cols = torch.randint(0, width - 1, (n, r), generator=g,
                             device="cuda", dtype=torch.int32)
        vals = torch.randn((n, r), generator=g, device="cuda")
        pad = torch.rand((n, r), generator=g, device="cuda") < 0.3
        pad[min(1, n - 1)] = True
        out["cols"] = torch.where(pad, width - 1, cols).to(torch.int32)
        out["vals"] = torch.where(pad, 0.0, vals)
        qc = torch.randn((q, width), generator=g, device="cuda")
        qc[:, -1] = 0.0
        out["q_cols"] = qc
    return out


def residual_calls(ops, ref, p: dict) -> dict:
    """name -> (kernel, plain) of the R kernels on ``p``'s arrays, each a
    function of (queries, candidates) rows (R2's queries are its
    ``q_cols``), so a check can call them on a batch, one query of it, or a
    zero-padded bucket."""
    calls = {
        "dense_residual": (
            lambda q, c: ops.dense_residual(p["rows8"], p["scale"],
                                            p["zero"], c, q),
            lambda q, c: ref.dense_residual_plain(p["rows8"], p["scale"],
                                                  p["zero"], c, q))}
    if "rows32" in p:
        for bf16 in (False, True):
            calls["gathered_dot" + ("_bf16" if bf16 else "")] = (
                lambda q, c, b=bf16: ops.gathered_dot(p["rows32"], c, q,
                                                      bf16_rows=b),
                lambda q, c, b=bf16: ref.gathered_dot_plain(p["rows32"], c,
                                                            q, b))
    if "cols" in p:
        calls["sparse_residual"] = (
            lambda q, c: ops.sparse_residual(p["cols"], p["vals"], c, q),
            lambda q, c: ref.sparse_residual_plain(p["cols"], p["vals"], c,
                                                   q))
    return calls


def rows_batch_invariant(torch, fn, q, c, what: str) -> None:
    """Each row of ``fn(q, c)`` equals the same query alone and the first
    row of a bucket of 8 padded with zero queries, bit for bit."""
    whole = fn(q, c)
    for i in range(q.shape[0]):
        check(torch.equal(fn(q[i:i + 1], c[i:i + 1])[0], whole[i]),
              f"{what}: row {i} alone != its row of the batch")
    pad_q = torch.cat([q[:1], torch.zeros((7,) + tuple(q.shape[1:]),
                                          device=q.device)])
    pad_c = torch.cat([c[:1], c[:1].expand(7, -1)])
    check(torch.equal(fn(pad_q, pad_c)[0], whole[0]),
          f"{what}: row 0 in a padded bucket of 8 != its row of the batch")


def edge_cases_residual(torch, ops, ref) -> dict:
    """R0-R3 against their plain versions bit for bit, twice equal, and each
    row equal alone, in a padded bucket and in the batch: the test file's
    widths (d or R of 1, 31, 33, 200), C = 1 and 9, ids of -1 and >= N,
    int64 ids, pads and an all-pad row; R0 at (d, K) of the tests and of
    the PQ heads; R1 and R3 at the heads' d = 3584 and 8192 on their
    vocabularies' rows (C = 400 and 100, B = 32)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for d, k in ((1, 1), (31, 31), (31, 1), (33, 11), (200, 100),
                 (3584, 1792), (8192, 4096)):
        q = torch.randn((5, d), generator=g, device="cuda")
        centers = torch.randn((k, 16, d // k), generator=g, device="cuda")
        what = f"R0 at d = {d}, K = {k}"
        got = ops.adc_lut(q, centers)
        check(torch.equal(got, ref.adc_lut_plain(q, centers))
              and torch.equal(got, ops.adc_lut(q, centers)),
              f"{what}: != plain or two launches differ")
        rows_batch_invariant(torch, lambda a, _: ops.adc_lut(a, centers), q,
                             q, what)
        cases.append(what)
    for width in (1, 31, 33, 200):
        for c in (1, 9):
            p = residual_problem(torch, g, q=5, c=c, n=40, d=width, r=width,
                                 width=301)
            for name, (kern, plain) in residual_calls(ops, ref, p).items():
                what = f"{name} at width {width}, C = {c}"
                q = p["q_cols"] if name == "sparse_residual" else p["q"]
                got = kern(q, p["cand"])
                check(torch.equal(got, plain(q, p["cand"]))
                      and torch.equal(got, kern(q, p["cand"])),
                      f"{what}: != plain or two launches differ")
                check(torch.equal(got, kern(q, p["cand"].long())),
                      f"{what}: int64 ids differ")
                rows_batch_invariant(torch, kern, q, p["cand"], what)
                cases.append(what)
    for head, (v, d) in HEAD_SHAPES.items():
        p = residual_problem(torch, g, q=32, c=400, n=v, d=d)
        p["rows32"] = torch.randn((v, d), generator=g, device="cuda")
        for name, (kern, plain) in residual_calls(ops, ref, p).items():
            c = p["cand"] if name == "dense_residual" else p["cand"][:, :100]
            what = f"{name} at {head}'s head, d = {d}"
            check(torch.equal(kern(p["q"], c), plain(p["q"], c)),
                  f"{what}: != plain")
            rows_batch_invariant(torch, kern, p["q"][:8], c[:8], what)
            cases.append(what)
        del p
    return {"cases": len(cases), "names": cases}


def unique_rows(torch, cand, n: int) -> int:
    return int(torch.unique(cand.long().clamp(0, n - 1)).numel())


def run_residual_kernels(torch, idx, queries, launches, c1, c2) -> list:
    """R0-R2 at the slice's main-path shapes and inputs (the LUT of its 128
    queries; pass 2 on its pass-1 candidates, C = c1; pass 3 on its pass-2
    candidates, C = c2) and R3 at qwen2-7b's head (V = 152064, d = 3584,
    B = 32, C = 100): bit for bit with the plain version, ms beside the
    bound, the plain version and the eager route the kernel backends
    replaced (``library_ms``: the ``ref`` backend's einsum / gather / sum,
    several launches where the JAX package's jnp takes several ops), and
    each query's rows alone against the batch's on the eager route too
    (``eager_rows_moved``: the rows whose bits moved).  Returns the four
    kernel rows, with ``launches`` from the slice's main-path run (R3's is
    set from ``lm_head``'s)."""
    from repro_torch.core import residual as res
    from repro_torch.core.engine import scatter_queries_compact
    from repro_torch.core.pq import adc_lut
    from repro_torch.core.sparse_index import score_rows
    from repro_torch.kernels import _build, ops, ref

    t_phase = time.perf_counter()
    arrays = idx.engine.arrays
    q_dims, q_vals, q_dense = queries
    sq, srows = arrays.dense_residual, arrays.sparse_residual
    n = arrays.num_points
    cb = arrays.codebooks
    lut = adc_lut(q_dense, cb, fixed_order=True)
    s1, ids1 = idx.engine.pass1_topk(q_dims, q_vals, lut, c1)
    extra = ops.dense_residual(sq.q, sq.scale, sq.zero, ids1, q_dense)
    _, ids2 = res.reorder_pass(s1, ids1, extra, c2)
    q_cols = scatter_queries_compact(q_dims, q_vals, arrays.d_active)
    g = torch.Generator(device="cuda").manual_seed(12)
    v, d_head = HEAD_SHAPES["qwen2-7b"]
    head_rows = torch.randn((v, d_head), generator=g, device="cuda")
    head_h = torch.randn((32, d_head), generator=g, device="cuda")
    head_ids = torch.randint(0, v, (32, 100), generator=g, device="cuda",
                             dtype=torch.int32)
    k, l, p = cb.centers.shape
    nq, d = q_dense.shape
    r_max = srows.cols.shape[1]

    specs = {
        "adc_lut": dict(
            kern=lambda qq, _: ops.adc_lut(qq, cb.centers),
            plain=lambda qq, _: ref.adc_lut_plain(qq, cb.centers),
            lib=lambda qq, _: adc_lut(qq, cb),
            q=q_dense, c=q_dense,
            nbytes=4 * (nq * d + k * l * p + nq * k * l),
            nops=2 * nq * k * l * p),
        "dense_residual": dict(
            kern=lambda qq, c: ops.dense_residual(sq.q, sq.scale, sq.zero,
                                                  c, qq),
            plain=lambda qq, c: ref.dense_residual_plain(
                sq.q, sq.scale, sq.zero, c, qq),
            lib=lambda qq, c: res.dense_residual_scores(sq, c, qq),
            q=q_dense, c=ids1,
            nbytes=(unique_rows(torch, ids1, n) * d + 8 * ids1.numel()
                    + 4 * nq * d + 8 * d),
            nops=2 * ids1.numel() * d + 4 * nq * d),
        "sparse_residual": dict(
            kern=lambda qq, c: ops.sparse_residual(srows.cols, srows.vals,
                                                   c, qq),
            plain=lambda qq, c: ref.sparse_residual_plain(
                srows.cols, srows.vals, c, qq),
            lib=lambda qq, c: score_rows(srows, c, qq),
            q=q_cols, c=ids2, nops=2 * ids2.numel() * r_max),
        "gathered_dot": dict(
            kern=lambda qq, c: ops.gathered_dot(head_rows, c, qq),
            plain=lambda qq, c: ref.gathered_dot_plain(head_rows, c, qq,
                                                       False),
            lib=lambda qq, c: torch.einsum("bd,bcd->bc", qq,
                                           head_rows[c.long()]),
            q=head_h, c=head_ids,
            nbytes=(unique_rows(torch, head_ids, v) * d_head * 4
                    + 8 * head_ids.numel() + 4 * 32 * d_head),
            nops=2 * head_ids.numel() * d_head),
    }
    # R2 needs each candidate row's R entries and the query values at its
    # live columns, each distinct (query, column) once
    rows2 = srows.cols[ids2.long().clamp(0, n - 1)].long()        # (Q, C, R)
    live = rows2 < arrays.d_active
    qcol = (torch.arange(nq, device="cuda")[:, None, None]
            * (arrays.d_active + 1) + rows2)[live]
    specs["sparse_residual"]["nbytes"] = (
        unique_rows(torch, ids2, n) * r_max * 8 + 8 * ids2.numel()
        + 4 * int(torch.unique(qcol).numel()))
    rows, readings = [], {}
    for name, s in specs.items():
        qq, c = s["q"], s["c"]
        got = s["kern"](qq, c)
        want = s["plain"](qq, c)
        check(torch.equal(got, want) and torch.equal(got, s["kern"](qq, c)),
              f"{name} at the main path's shapes: != plain or two launches "
              "differ")
        lib = s["lib"](qq, c)
        err = assert_close(lib, got, f"{name}: the eager route")
        rows_batch_invariant(torch, s["kern"], qq, c, f"{name} (main path)")
        moved = sum(not torch.equal(s["lib"](qq[i:i + 1], c[i:i + 1])[0],
                                    lib[i]) for i in range(qq.shape[0]))
        m = {"ms": cuda_ms(lambda: s["kern"](qq, c)),
             "plain_ms": cuda_ms(lambda: s["plain"](qq, c)),
             "library_ms": cuda_ms(lambda: s["lib"](qq, c)),
             "max_abs_err": max_abs(got, want)}
        row = kernel_row(name, RESIDUAL_SOURCE, RESIDUAL_REPLACES[name],
                         launches.get(name, 0), m, s["nbytes"], s["nops"])
        row.update(shape=({"Q": nq, "K": k, "l": l, "p": p}
                          if name == "adc_lut" else
                          {"Q": qq.shape[0], "C": c.shape[1],
                           "width": qq.shape[1]}),
                   library="the eager route of the ref backend",
                   eager_max_abs_diff=err, eager_rows_moved=moved)
        if name != "adc_lut":
            row["by_q"] = {str(b): {"ms": cuda_ms(lambda b=b: s["kern"](
                qq[:b], c[:b])), "library_ms": cuda_ms(lambda b=b: s["lib"](
                    qq[:b], c[:b]))} for b in (1, 8)}
        rows.append(row)
        readings[name] = row
    edges = edge_cases_residual(torch, ops, ref)
    emit("residual_checked", edge_cases=edges["cases"],
         edge_case_names=edges["names"],
         ptxas=ptxas_report(_build.build()["ptxas"]["residual"],
                            ("adc_lut_kernel", "gathered_dot_kernel",
                             "sparse_residual_kernel")),
         seconds=time.perf_counter() - t_phase)
    return rows


def run_batch_invariance(torch, idx, queries) -> dict:
    """Each of the slice's 128 queries gets the same bits whatever shares
    its call: for ``cuda`` and ``cuda-packed``, fused and materialised, the
    three-pass scores, ids and pass-1 candidates of every query alone
    (Q = 1) and inside ``QueryService`` buckets of 8 and 32 (requests of 5
    and 20 rows, no cache) equal its row of the Q = 128 call; and the LUT
    (R0), the pass-2 (R1) and pass-3 (R2) terms of every query alone equal
    its rows of the batch.  The eager route of the ``ref`` backend's
    passes on the same candidates is counted beside it (rows whose bits
    moved), not checked."""
    from repro_torch.core import residual as res
    from repro_torch.core.engine import (Backend, ScoringEngine,
                                         scatter_queries_compact)
    from repro_torch.core.pq import adc_lut
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS
    from repro_torch.serve import QueryService

    t_phase = time.perf_counter()
    kw = dict(h=20, alpha=25, beta=6)
    q_dims, q_vals, q_dense = queries
    nq = q_dims.shape[0]
    host = [t.cpu().numpy() for t in queries]
    arrays = idx.engine.arrays
    packed = dataclasses.replace(arrays, codes=torch.from_numpy(
        ops.pack_codes(arrays.codes.cpu().numpy())).cuda(), codes_packed=True)
    ops.reset_counts()
    forms = {}
    for backend, arrs in (("cuda", arrays), ("cuda-packed", packed)):
        for fused in (True, False):
            where = f"{backend} {'fused' if fused else 'materialised'}"
            eng = ScoringEngine(arrays=arrs,
                                backend=Backend.from_name(backend),
                                fused=fused)
            whole = eng.search(q_dims, q_vals, q_dense, **kw)
            for i in range(nq):
                alone = eng.search(q_dims[i:i + 1], q_vals[i:i + 1],
                                   q_dense[i:i + 1], **kw)
                check(all(torch.equal(a[0], w[i])
                          for a, w in zip(alone, whole)),
                      f"batch_invariance {where}: query {i} alone != its "
                      "row of the Q = 128 call")
            s_np, i_np = whole[0].cpu().numpy(), whole[1].cpu().numpy()
            svc = QueryService(eng, buckets=(1, 8, 32), cache_size=0, **kw)
            try:
                for size in (5, 20):
                    for lo in range(0, nq, size):
                        rows = np.arange(lo, min(lo + size, nq))
                        s, i = svc.search(*(a[rows] for a in host))
                        check(np.array_equal(s, s_np[rows])
                              and np.array_equal(i, i_np[rows]),
                              f"batch_invariance {where}: rows {lo}.. in a "
                              f"bucket != the Q = 128 call")
                shapes = sorted(svc.jit_cache_info().batch_shapes)
            finally:
                svc.close()
            check({8, 32} <= set(shapes),
                  f"batch_invariance {where}: buckets {shapes}")
            forms[where] = {"queries": nq, "alone_equal": True,
                            "buckets": shapes, "bucket_rows_equal": True}
    plain = dict(PLAIN_CALLS)
    check(sum(plain.values()) == 0,
          f"batch_invariance: the kernel backends ran plain versions: "
          f"{plain}")
    # the steps one at a time, on the cuda form's candidates
    c1, c2 = idx.engine.candidate_counts(kw["h"], kw["alpha"], kw["beta"])
    sq, srows = arrays.dense_residual, arrays.sparse_residual
    lut = adc_lut(q_dense, arrays.codebooks, fixed_order=True)
    s1, ids1 = idx.engine.pass1_topk(q_dims, q_vals, lut, c1)
    q_cols = scatter_queries_compact(q_dims, q_vals, arrays.d_active)
    steps = {
        "lut": (lambda lo, hi, f: adc_lut(q_dense[lo:hi], arrays.codebooks,
                                          fixed_order=f)),
        "pass1": (lambda lo, hi, f: idx.engine.pass1_topk(
            q_dims[lo:hi], q_vals[lo:hi], lut[lo:hi], c1)[1]),
        "pass2": (lambda lo, hi, f: res.dense_residual_scores(
            sq, ids1[lo:hi], q_dense[lo:hi], fixed_order=f)),
        "pass3": (lambda lo, hi, f: res.sparse_residual_scores(
            srows, ids1[lo:hi, :c2], q_cols[lo:hi], fixed_order=f)),
    }
    moved = {}
    for name, fn in steps.items():
        for fixed in (True, False):
            whole = fn(0, nq, fixed)
            n_moved = sum(not torch.equal(fn(i, i + 1, fixed)[0], whole[i])
                          for i in range(nq))
            if fixed:
                check(n_moved == 0, f"batch_invariance: {name} of {n_moved} "
                      "queries alone != their rows of the batch")
            elif name in ("lut", "pass2", "pass3"):
                moved[name] = n_moved
    emit("batch_invariance", forms=forms, steps_equal_alone=list(steps),
         eager_rows_moved=moved, launches=dict(ops.LAUNCHES),
         seconds=time.perf_counter() - t_phase)
    return forms


# ---------------------------------------------------------------------------
# score_inverted_vf: B4, the pass-1 tail bias in one launch, against
# score_inverted (its plain version), on the slice, at edges, with no sync
# ---------------------------------------------------------------------------

def tail_bytes(torch, inv, q_dims) -> tuple[int, int]:
    """(bytes, live entries) the tail bias needs: the (Q, N) f32 output
    written once, each live posting (row and value) of each valid slot read
    once, and the queries read once."""
    n, d = inv.num_points, inv.rows.shape[0]
    qd = q_dims.long()
    valid = (qd >= 0) & (qd < d)
    live = (inv.rows[torch.where(valid, qd, 0)] < n) & valid[..., None]
    entries = int(live.sum())
    nbytes = (4 * q_dims.shape[0] * n + 8 * entries
              + q_dims.numel() * (q_dims.element_size() + 4))
    return nbytes, entries


def tail_yardstick(torch, inv, q_dims, q_vals):
    """One cuSPARSE product for the same function: the tail postings as an
    (N x d) CSR times the queries scattered to (d x Q).  Returns a
    callable."""
    from repro_torch.core.engine import scatter_queries_compact
    n, d = inv.num_points, inv.rows.shape[0]
    live = inv.rows < n
    dims = torch.arange(d, device=inv.rows.device)[:, None].expand_as(
        inv.rows)
    x_csr = torch.sparse_coo_tensor(
        torch.stack([inv.rows[live].long(), dims[live]]), inv.vals[live],
        (n, d)).coalesce().to_sparse_csr()
    q_mat = scatter_queries_compact(q_dims, q_vals, d)[:, :d].T.contiguous()
    return lambda: torch.sparse.mm(x_csr, q_mat)


def b4_equal(torch, ops, inv, qd, qv, what: str, plan=None):
    """B4 against score_inverted bit for bit, and against its own second
    launch; returns B4's output.  With ``plan`` the launcher runs at that
    geometry instead of the op's own (the op takes none)."""
    from repro_torch.core.sparse_index import score_inverted
    from repro_torch.kernels.inverted import score_inverted_cuda

    def b4():
        if plan is None:
            return ops.score_inverted_vf(inv, qd, qv)
        return score_inverted_cuda(inv.rows, inv.vals, qd, qv,
                                   inv.num_points, plan)
    got = b4()
    check(got.is_contiguous() and tuple(got.shape) == (qd.shape[0],
                                                        inv.num_points),
          f"B4 output at {what}: {tuple(got.shape)}")
    check(torch.equal(got, score_inverted(inv, qd, qv)),
          f"B4 != score_inverted at {what}")
    check(torch.equal(got, b4()), f"B4 at {what}: two launches differ")
    return got


def edge_cases_b4(torch, ops) -> dict:
    """B4 at small shapes on the card, each equal to score_inverted bit for
    bit (the cases of tests/test_torch_score_inverted_vf.py and a few the
    card alone can show: rows off 16-byte alignment, explicit plans, q_vals
    in f64, strided queries), and the wrapper's refusals."""
    import scipy.sparse as sp
    from repro_torch.core.sparse_index import (DeltaPostings,
                                               PaddedInvertedIndex,
                                               build_compact_columns,
                                               build_padded_inverted_index,
                                               sparse_queries_to_padded)
    from repro_torch.kernels.inverted import InvertedPlan

    def problem(n, d, qn, seed, nq_max=32, qdens=0.05):
        x = sp.random(n, d, density=0.02, random_state=seed, format="csr",
                      dtype=np.float32)
        cols, xc = build_compact_columns(x)
        inv = build_padded_inverted_index(xc, device="cuda")
        qs = sp.random(qn, d, density=qdens, random_state=seed + 1,
                       format="csr", dtype=np.float32)
        qd, qv = sparse_queries_to_padded(qs, cols, nq_max=nq_max)
        return inv, qd, qv, cols.num_active

    def run(name, inv, qd, qv, plan=None):
        qd = qd if torch.is_tensor(qd) else torch.from_numpy(qd).cuda()
        qv = qv if torch.is_tensor(qv) else torch.from_numpy(qv).cuda()
        b4_equal(torch, ops, inv, qd, qv, name, plan)
        done.append(name)

    def index(rows, vals, n):
        return PaddedInvertedIndex(rows=rows.contiguous(),
                                   vals=vals.contiguous(), num_points=n)

    rng = np.random.default_rng(5)
    done: list[str] = []
    inv, qd, qv, d_act = problem(700, 500, 9, 1)
    run("basic", inv, qd, qv)
    run("q1", inv, qd[:1], qv[:1])
    run("int64_dims", inv, qd.astype(np.int64), qv)
    q2, v2 = qd.copy(), qv.copy()
    q2[0, 1], v2[0, 1] = q2[0, 0], 0.5
    q2[2, :], v2[2, :] = d_act, 0.0
    run("repeated_dim_and_all_pad_query", inv, q2, v2)
    check(not bool(ops.score_inverted_vf(inv, torch.from_numpy(q2).cuda(),
                                         torch.from_numpy(v2).cuda())[2]
                   .any()), "an all-pad query does not score zero")
    q3 = qd.copy()
    q3[0, 0], q3[1, 3], q3[4, 1], q3[5, 2] = -1, d_act, d_act + 7, -3
    run("dims_out_of_range", inv, q3, qv)
    drop = torch.from_numpy(rng.random(tuple(inv.rows.shape)) < 0.3).cuda()
    run("sentinel_mid_list", index(torch.where(drop, 700, inv.rows),
                                   torch.where(drop, 0.0, inv.vals), 700),
        qd, qv)
    rows, vals = inv.rows.clone(), inv.vals.clone()
    rows[:, 0], vals[:, 0] = 17, 0.75
    run("one_row_every_slot", index(rows, vals, 700), qd, qv)
    perm = torch.from_numpy(rng.permuted(np.tile(
        np.arange(inv.rows.shape[1]), (inv.rows.shape[0], 1)), axis=1)).cuda()
    run("unsorted_lists", index(inv.rows.gather(1, perm),
                                inv.vals.gather(1, perm), 700), qd, qv)
    run("q_vals_f64", inv, torch.from_numpy(qd).cuda(),
        torch.from_numpy(qv.astype(np.float64) * 1.1).cuda())
    wide = torch.from_numpy(np.concatenate([qd, qd], axis=1)).cuda()
    run("strided_queries", inv, wide[:, ::2], torch.from_numpy(qv).cuda())
    inv1, qd1, qv1, _ = problem(50, 80, 3, 2)
    run("one_tile", inv1, qd1, qv1)
    inv2, qd2, qv2, _ = problem(900, 400, 4, 3, nq_max=300, qdens=0.9)
    run("two_windows_many_pieces", inv2, qd2, qv2)
    run("two_windows_many_pieces_streaming", inv2, qd2, qv2,
        InvertedPlan(256, 4, 3, 2, 0))
    inv3, qd3, qv3, _ = problem(3001, 600, 7, 4)
    run("n_odd", inv3, qd3, qv3)
    for rows, per_cta, cap in ((256, 3, 0), (512, 2, 8192), (3072, 1, 100)):
        tiles = -(-3001 // rows)
        run(f"n_odd_plan_{rows}_{per_cta}_{cap}", inv3, qd3, qv3,
            InvertedPlan(rows, tiles, per_cta, -(-tiles // per_cta), cap))
    post = DeltaPostings(40, l_max=2, l_cap=6)
    for slot in range(30):
        dims = rng.choice(40, 5, replace=False)
        if slot % 7 == 3:                       # a row that repeats a dim
            dims = np.concatenate([dims, dims[:2]])
        post.append(slot, dims, rng.normal(size=len(dims)).astype(np.float32))
    run("delta_repeated_row", post.to_padded(33, device="cuda"),
        np.tile(np.arange(40, dtype=np.int32), (3, 1)),
        rng.normal(size=(3, 40)).astype(np.float32))

    refusals = 0
    qd_t, qv_t = torch.from_numpy(qd).cuda(), torch.from_numpy(qv).cuda()
    for bad, err in (
            (index(inv.rows.long(), inv.vals, 700), TypeError),
            (PaddedInvertedIndex(rows=inv.rows.T.contiguous().T,
                                 vals=inv.vals.T.contiguous().T,
                                 num_points=700), ValueError),
            (index(inv.rows, inv.vals[:, :-1], 700), ValueError)):
        try:
            ops.score_inverted_vf(bad, qd_t, qv_t)
        except err:
            refusals += 1
    try:
        ops.score_inverted_vf(inv, qd_t.cpu(), qv_t)
    except ValueError:
        refusals += 1
    check(refusals == 4, f"B4's wrapper refused {refusals} of 4 bad inputs")
    return {"cases": len(done), "names": done, "refusals": refusals}


def run_score_inverted_vf(torch, idx, queries, launches) -> dict:
    """B4 on the slice's index: equal to score_inverted at Q = 1, 8, 128,
    with no host sync; its plan against the C side and the occupancy
    calculator; ms beside the bound, the plain version and cuSPARSE at each
    Q; a streaming plan, untimed; the edge cases.  Returns its kernel row,
    with ``launches`` from the slice's main-path run."""
    from repro_torch.core.sparse_index import score_inverted
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import inverted as inv_k

    inv = idx.engine.arrays.inv_index
    q_dims, q_vals, _ = queries
    nq, n = q_dims.shape[0], inv.num_points
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.score_inverted_vf(inv, q_dims, q_vals)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    by_q = {}
    for qn in (1, 8, nq):
        qd, qv = q_dims[:qn], q_vals[:qn]
        got = b4_equal(torch, ops, inv, qd, qv, f"the slice, Q = {qn}")
        lib = tail_yardstick(torch, inv, qd, qv)
        assert_close(lib().T, got, f"torch.sparse.mm yardstick at Q = {qn}")
        nbytes, entries = tail_bytes(torch, inv, qd)
        plan = inv_k.plan_score_inverted(qn, n, sms)
        # ms times one call, as every other kernel's, host work included;
        # ms_batched is the mean of 10 back-to-back calls
        by_q[str(qn)] = {
            "ms": cuda_ms(lambda: ops.score_inverted_vf(inv, qd, qv)),
            "ms_batched": cuda_ms(lambda: ops.score_inverted_vf(inv, qd, qv),
                                  batch=10),
            "plain_ms": cuda_ms(lambda: score_inverted(inv, qd, qv)),
            "library_ms": cuda_ms(lib),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "live_entries": entries,
            "max_abs_err": max_abs(got, score_inverted(inv, qd, qv)),
            "plan": {**dataclasses.asdict(plan), "grid": plan.grid(qn),
                     "smem_bytes": plan.smem_bytes,
                     "smem_bytes_c": inv_k.c_smem_bytes(plan),
                     "ctas_per_sm": inv_k.ctas_per_sm(plan)}}
        check(by_q[str(qn)]["plan"]["smem_bytes"]
              == by_q[str(qn)]["plan"]["smem_bytes_c"],
              "B4's plan and the C side disagree on shared memory")
        check(by_q[str(qn)]["plan"]["ctas_per_sm"] >= 1,
              f"B4's plan at Q = {qn} fits no CTA on an SM")
    # every CTA streaming (no resident buffer: the lists read again for
    # each tile), untimed: the same bits at the slice's Q = 128
    tiles = -(-n // inv_k.MAX_ROWS_PER_TILE)
    b4_equal(torch, ops, inv, q_dims, q_vals, "the slice, streaming",
             inv_k.InvertedPlan(inv_k.MAX_ROWS_PER_TILE, tiles,
                                -(-tiles // 4), 4, 0))
    edges = edge_cases_b4(torch, ops)
    m = by_q[str(nq)]
    emit("score_inverted_vf", launches_main_path=launches, by_q=by_q,
         no_host_sync=True,
         equals_score_inverted=True, edge_cases=edges,
         library="torch.sparse.mm, (N x d_active) CSR x (d_active x Q)",
         ptxas=ptxas_report(_build.build()["ptxas"]["score_inverted"],
                            ("score_inverted_kernel",)))
    row = kernel_row("score_inverted_vf",
                     "src/repro_torch/csrc/score_inverted.cu",
                     "src/repro/kernels/block_sparse.py:172", launches, m,
                     m["bytes"], 2 * m["live_entries"])
    row.update(by_q=by_q)
    return row


# ---------------------------------------------------------------------------
# value_forward: the stream B4 (the JAX layout: host planner + stream
# kernel), off every search, against its plain version and score_inverted
# ---------------------------------------------------------------------------

def edge_cases_value_forward(torch, ops, ref):
    """The stream B4 at small shapes on the card: each must equal the
    plain version and score_inverted bit for bit."""
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
        st = build_value_forward_stream(inv, qd_t, qv_t, bn=bn, chunk=16)
        kw = dict(bq=st.bq, bn=st.bn, chunk=st.chunk,
                  num_row_blocks=st.num_row_blocks)
        got = ops.inverted_value_forward(st.ptr, st.rows, st.qidx,
                                         st.contrib, **kw)
        check(torch.equal(got, ref.inverted_value_forward_plain(
            st.ptr, st.rows, st.qidx, st.contrib, **kw)),
            f"the stream B4 != plain at {(n, d, qn, bn)}")
        got = got[:qn, :n]
        check(torch.equal(got, score_inverted(inv, qd_t, qv_t)),
              f"the stream B4 != score_inverted at {(n, d, qn, bn)}")
        if n == 700:
            check(bool((got[2] == 0).all()), "all-pad query not zero")
        ptr = st.ptr.cpu().numpy().reshape(-1, st.num_row_blocks + 1)
        empty_segments += int((np.diff(ptr, axis=1) == 0).sum())
        cases += 1
    check(empty_segments > 0, "no edge case had an empty segment")
    return {"cases": cases, "empty_segments": empty_segments}


def run_value_forward(torch, idx, queries):
    from repro_torch.core.sparse_index import (build_value_forward_stream,
                                               score_inverted)
    from repro_torch.kernels import ops, ref

    inv = idx.engine.arrays.inv_index
    q_dims, q_vals, _ = queries
    nq, n = q_dims.shape[0], inv.num_points
    planner = []
    for _ in range(5):
        t0 = time.perf_counter()
        st = build_value_forward_stream(inv, q_dims, q_vals)
        torch.cuda.synchronize()
        planner.append(time.perf_counter() - t0)
    kw = dict(bq=st.bq, bn=st.bn, chunk=st.chunk,
              num_row_blocks=st.num_row_blocks)
    args = (st.ptr, st.rows, st.qidx, st.contrib)
    torch.cuda.synchronize()
    # the path, once, with every count at zero just before it
    ops.reset_counts()
    out = ops.inverted_value_forward(*args, **kw)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["inverted_value_forward"]
    check(launches == 1 and sum(ref.PLAIN_CALLS.values()) == 0,
          "the stream path did not launch the stream B4 once")
    plain = ref.inverted_value_forward_plain(*args, **kw)
    check(torch.equal(out, plain), "the stream B4 != plain at the slice "
          "shapes")
    check(torch.equal(out[:nq, :n], score_inverted(inv, q_dims, q_vals)),
          "the stream B4 != score_inverted at the slice shapes")
    lib = tail_yardstick(torch, inv, q_dims, q_vals)
    m = dict(ms=cuda_ms(lambda: ops.inverted_value_forward(*args, **kw)),
             plain_ms=cuda_ms(lambda: ref.inverted_value_forward_plain(
                 *args, **kw), runs=5, warmup=1),
             library_ms=cuda_ms(lib), max_abs_err=max_abs(out, plain))
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
         stream_entries=entries, padded_entries=padded, p_pad=p_pad,
         query_blocks=qb, row_blocks=st.num_row_blocks,
         padding_share=1.0 - entries / (qb * p_pad), edge_cases=edges)
    return kernel_row("inverted_value_forward",
                      "src/repro_torch/csrc/block_sparse.cu",
                      "src/repro/kernels/block_sparse.py:172", launches, m,
                      nbytes, entries)


# ---------------------------------------------------------------------------
# sharded: the row-sharded searches of core/distributed.py on the slice
# ---------------------------------------------------------------------------

def topk_ties(got_ids, got_s, want_ids, want_s, what: str,
              rtol: float = RTOL, atol: float = ATOL) -> int:
    """Row-wise top-k agreement: scores position by position within the
    tolerance; ids equal, except where the reference holds a near-tie (the
    id sits elsewhere in its list at a score within the tolerance, or, for
    an id it did not return, its score ties the reference's last).  Returns
    the number of such tie differences; raises on any other."""
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    check(got_s.shape == want_s.shape, f"{what}: shape {got_s.shape} != "
          f"{want_s.shape}")
    check(bool((np.abs(got_s - want_s) <= atol + rtol * np.abs(want_s)).all()),
          f"{what}: scores beyond rtol {rtol} atol {atol}")

    def near(a, b):
        return abs(a - b) <= atol + rtol * abs(b)

    ties = 0
    for r in range(want_ids.shape[0]):
        pos_of = {int(i): p for p, i in enumerate(want_ids[r])}
        for p in np.flatnonzero(got_ids[r] != want_ids[r]):
            gid = int(got_ids[r, p])
            ok = (near(want_s[r, pos_of[gid]], want_s[r, p]) if gid in pos_of
                  else near(got_s[r, p], want_s[r, -1]))
            check(ok, f"{what}: row {r} position {p}: id {gid} where the "
                  f"reference has {int(want_ids[r, p])} without a tie")
            ties += 1
    return ties


def timed_ms(torch, fn, runs: int = 5) -> float:
    """Median host-clock milliseconds of ``fn()``, a synchronize at both
    ends, after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stacked_inverted(torch, dist, arrays, num_shards):
    """Each shard's inverted lists (local row ids) from
    ``split_index_arrays``, stacked per shard: (S * d_active, L).  The head
    block takes no part in the sharded searches, so it is not split."""
    shards, _ = dist.split_index_arrays(
        dataclasses.replace(arrays, head=None), num_shards)
    return (torch.cat([sh.inv_index.rows for sh in shards]),
            torch.cat([sh.inv_index.vals for sh in shards]))


def run_sharded(torch, idx, queries, true_ids):
    from repro_torch.core import distributed as dist
    from repro_torch.core import residual as res
    from repro_torch.core.baselines import recall_at_h
    from repro_torch.core.engine import scatter_queries_compact
    from repro_torch.core.pq import adc_lut, adc_scores_ref
    from repro_torch.core.sparse_index import score_inverted
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS, stable_topk

    t_phase = time.perf_counter()
    arrays = idx.engine.arrays
    q_dims, q_vals, q_dense = queries
    lut = adc_lut(q_dense, arrays.codebooks)
    q_cols = scatter_queries_compact(q_dims, q_vals, arrays.d_active)
    h, alpha, beta = 20, 25, 6
    counts = (1, 2, 4)
    inv = {s: stacked_inverted(torch, dist, arrays, s) for s in counts}

    def devices(s):
        return ["cuda:0"] * s

    def pass1(s, k):
        return dist.sharded_pass1_topk(devices(s), arrays.codes, lut, *inv[s],
                                       q_dims, q_vals, k=k, adc="cuda")

    def search3(s, a, ar=arrays, inv_s=None, nq=None):
        sl = slice(None, nq)
        dres, sres = ar.dense_residual, ar.sparse_residual
        return dist.sharded_three_pass_topk(
            devices(s), ar.codes, lut[sl], *(inv[s] if inv_s is None
                                              else inv_s), dres.q,
            dres.scale, dres.zero, sres.cols, sres.vals, q_dims[sl],
            q_vals[sl], q_dense[sl], q_cols[sl], h=h, alpha=a[0], beta=a[1],
            adc="cuda")

    # the path, with every count at zero just before it
    torch.cuda.synchronize()
    ops.reset_counts()
    k2 = {s: pass1(s, 500) for s in counts}
    k1 = {s: pass1(s, 2048) for s in counts}
    three = {s: search3(s, (alpha, beta)) for s in counts}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(sum(PLAIN_CALLS.values()) == 0, "the sharded path ran plain versions")
    check(launches["lut16_adc_topk"] == 2 * sum(counts)
          and launches["lut16_adc"] == sum(counts)
          and launches["score_inverted_vf"] == 3 * sum(counts),
          f"the sharded path's launches: {launches}")
    for s in counts[1:]:
        check(all(torch.equal(a, b) for a, b in zip(k2[s], k2[1])),
              f"pass 1 at k = 500 (K2): S = {s} != S = 1")
    for s in counts:
        check(torch.equal(k1[s][0][:, :500], k2[1][0])
              and torch.equal(k1[s][1][:, :500], k2[1][1]),
              f"pass 1 at k = 2048 (K1 + sort), S = {s}: its first 500 != "
              "K2's")
    recall = {str(s): recall_at_h(idx.pi[three[s][1].cpu().numpy()],
                                  true_ids) for s in counts}
    ms = {str(s): timed_ms(torch, lambda s=s: search3(s, (alpha, beta)))
          for s in counts}
    ms_pass1 = {str(s): timed_ms(torch, lambda s=s: pass1(s, 500))
                for s in counts}

    # every row refined: on 8 queries over a prefix of the rows, the merged
    # top-h equals the global top-h of the full sum
    n = arrays.num_points
    prefix = dist.split_index_arrays(dataclasses.replace(arrays, head=None),
                                     max(1, n // 16384), ragged=True)[0][0]
    p_rows, nq = prefix.num_points, 8
    all_ids = torch.arange(p_rows, device=lut.device)[None].expand(nq, p_rows)
    total = (adc_scores_ref(prefix.codes, lut[:nq])
             + score_inverted(prefix.inv_index, q_dims[:nq], q_vals[:nq])
             + res.dense_residual_scores(prefix.dense_residual, all_ids,
                                         q_dense[:nq])
             + res.sparse_residual_scores(prefix.sparse_residual, all_ids,
                                          q_cols[:nq]))
    want_s, want_i = stable_topk(total, h)
    full = {}
    for s in counts:
        a = (p_rows // s) // h + 1
        got_s, got_i = search3(s, (a, a), prefix,
                               stacked_inverted(torch, dist, prefix, s), nq)
        err = assert_close(got_s, want_s, f"fully refined three-pass, S = {s}",
                           rtol=1e-4, atol=1e-4)
        full[str(s)] = {"max_abs_err": err,
                        "ids_equal": bool(torch.equal(got_i, want_i))}
    emit("sharded", shards=list(counts), devices="cuda:0 x S",
         launches=launches, pass1_k500_bits_equal=True,
         pass1_k2048_prefix_equal=True, three_pass_recall_at_20=recall,
         three_pass_ms=ms, pass1_k500_ms=ms_pass1,
         full_refinement={"rows": p_rows, "queries": nq, "by_shards": full,
                          "tolerance": {"rtol": 1e-4, "atol": 1e-4}},
         seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# tables: the paper's Tables 2 and 3 on the card, baselines against hybrid
# ---------------------------------------------------------------------------

EXACT_BASELINES = ("dense_brute_force", "sparse_brute_force",
                   "sparse_inverted_index")


def table_rows(torch, ds, specs, hybrid_params, alpha, beta, h=20) -> dict:
    """Each baseline of ``specs`` (name, keyword arguments, queries) and
    the hybrid index on ``ds``: ms per query (the median of 3 timed calls
    after one warm-up), recall@h against ``exact_topk`` and the speedup
    against ``sparse_inverted_index``.  The exact baselines must return
    ``exact_topk``'s ids, tie-aware."""
    from repro_torch.core import baselines as bl
    from repro_torch.core.hybrid import HybridIndex

    qn = ds.q_sparse.shape[0]
    true_ids, true_s = bl.exact_topk(ds.q_sparse, ds.q_dense, ds.x_sparse,
                                     ds.x_dense, h, device="cuda")
    rows = []
    for name, kw, nq in specs:
        args = (ds.q_sparse[:nq], ds.q_dense[:nq], ds.x_sparse, ds.x_dense)
        getattr(bl, name)(*args, h, **kw)                    # warm-up
        runs = [getattr(bl, name)(*args, h, **kw) for _ in range(3)]
        r = runs[-1]
        row = {"name": r.name, "queries": nq,
               "ms_per_query": statistics.median(x.seconds for x in runs)
               / nq * 1e3,
               "recall_at_20": bl.recall_at_h(r.ids, true_ids[:nq]),
               "build_s": statistics.median(x.build_seconds for x in runs)}
        if name in EXACT_BASELINES:
            row["tie_swaps"] = topk_ties(r.ids, r.scores, true_ids[:nq],
                                         true_s[:nq], r.name)
        rows.append(row)
        del runs, r
        gc.collect()
    t0 = time.perf_counter()
    idx = HybridIndex.build(ds.x_sparse, ds.x_dense, hybrid_params,
                            device="cuda")
    build_s = time.perf_counter() - t0
    ms = timed_ms(torch, lambda: idx.search(ds.q_sparse, ds.q_dense, h=h,
                                            alpha=alpha, beta=beta), runs=3)
    r = idx.search(ds.q_sparse, ds.q_dense, h=h, alpha=alpha, beta=beta)
    rows.append({"name": "hybrid_ours", "queries": qn,
                 "ms_per_query": ms / qn,
                 "recall_at_20": bl.recall_at_h(r.ids, true_ids),
                 "build_s": build_s})
    inv_ms = next(x["ms_per_query"] for x in rows
                  if x["name"] == "sparse_inverted_index")
    for x in rows:
        x["speedup_vs_inverted"] = inv_ms / x["ms_per_query"]
    return rows


def table2_datasets(args) -> dict:
    """Table 2's data (benchmarks/table2.py): Netflix- and Movielens-shaped
    at its widths (d_dense 64, where the paper has 300) and its docstring's
    row counts, scaled with --rows.  Host work alone: ``main`` runs it in a
    thread while the cluster phase waits on its nodes.  Returns ``{tag:
    (dataset, (rows, d_sparse, nnz_per_row, seed), seconds to make it)}``."""
    from repro_torch.data import make_hybrid_dataset

    out = {}
    for tag, rows, d_sparse, nnz, seed in (("netflix", 500000, 18000, 48, 0),
                                           ("movielens", 140000, 27000, 32,
                                            1)):
        rows = max(1000, rows * args.rows // 524288)
        t0 = time.perf_counter()
        ds2 = make_hybrid_dataset(num_points=rows, num_queries=16,
                                  d_sparse=d_sparse, d_dense=64,
                                  nnz_per_row=nnz, seed=seed)
        out[tag] = ds2, (rows, d_sparse, nnz, seed), time.perf_counter() - t0
    return out


def run_tables(args, torch, ds, table2):
    """Tables 3 and 2 on the card; ``table2`` is the future of
    ``table2_datasets``."""
    from repro_torch.core.hybrid import HybridIndexParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_counts()
    # Table 3 (benchmarks/table3.py): the slice's QuerySim-shaped data; the
    # exact inverted index on its first 4 queries, dense brute force left
    # out (524288 x 200200 f32 is 420 GB)
    n = ds.x_sparse.shape[0]
    qn = ds.q_sparse.shape[0]
    torch.cuda.reset_peak_memory_stats()
    rows3 = table_rows(torch, ds, (
        ("sparse_brute_force", {}, qn),
        ("sparse_inverted_index", {}, 4),
        ("hamming512", {"overfetch": max(100, n // 1000)}, qn),
        ("dense_pq_reorder", {"overfetch": max(200, n // 500)}, qn),
        ("sparse_only", {}, qn),
        ("sparse_only", {"overfetch": max(400, n // 250)}, qn)),
        HybridIndexParams(keep_top=192, head_dims=128, kmeans_iters=6,
                          backend="cuda"), alpha=25, beta=6)
    emit("table3", rows=n, queries=qn, table=rows3,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         headline="benchmarks/table3.py:4-5: hybrid ~20x faster than the "
         "exact sparse inverted index at 91% recall@20")
    tables = {"table3": rows3}
    gc.collect()
    torch.cuda.empty_cache()

    # Table 2 (benchmarks/table2.py), on the data table2_datasets made
    t0 = time.perf_counter()
    data2 = table2.result()
    data_wait_s = time.perf_counter() - t0
    for tag in list(data2):
        ds2, (rows, d_sparse, nnz, seed), gen_s = data2.pop(tag)
        torch.cuda.reset_peak_memory_stats()
        table = table_rows(torch, ds2, (
            ("dense_brute_force", {}, 16),
            ("sparse_brute_force", {}, 16),
            ("sparse_inverted_index", {}, 16),
            ("hamming512", {"overfetch": max(200, rows // 100)}, 16),
            ("dense_pq_reorder", {"overfetch": max(400, rows // 50)}, 16),
            ("sparse_only", {}, 16),
            ("sparse_only", {"overfetch": max(800, rows // 25)}, 16)),
            HybridIndexParams(keep_top=128, head_dims=64, kmeans_iters=6,
                              backend="cuda"), alpha=20, beta=5)
        emit(f"table2_{tag}", rows=rows, queries=16, d_sparse=d_sparse,
             d_dense=64, nnz_per_row=nnz, seed=seed, generate_s=gen_s,
             table=table,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        tables[f"table2_{tag}"] = table
        del ds2
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(sum(PLAIN_CALLS.values()) == 0, "the tables ran plain versions")
    check(launches["lut16_adc"] >= 1 and launches["lut16_adc_topk"] >= 1
          and launches["block_sparse_matmul"] >= 1
          and launches["score_inverted_vf"] >= 1,
          f"the tables did not launch K1, K2, K3 and B4: {launches}")
    emit("tables", launches=launches, table2_data_wait_s=data_wait_s,
         seconds=time.perf_counter() - t_phase)
    return launches


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


def live_recall(torch, midx, ds, got_ids, h) -> float:
    """recall@h of external ids found for every query of ``ds`` against
    exact search over the live corpus (``MutableState.survivors()``)."""
    from repro_torch.core.baselines import exact_topk, recall_at_h
    xs, xd, ids = midx.mutable_state.survivors()
    pos, _ = exact_topk(ds.q_sparse, ds.q_dense, xs, xd, h, device="cuda")
    return recall_at_h(got_ids, ids[pos])


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
    st = midx.mutable_state
    engines = 1 + int(st is not None and st.delta.live_count > 0)
    check(ops.LAUNCHES["score_inverted_vf"] == engines,
          f"mutable search did not launch B4 once in each of its {engines} "
          f"engines: {ops.LAUNCHES}")
    check(res.ids.shape == (ds.q_dense.shape[0], h)
          and bool(np.isfinite(res.scores).all()),
          "mutable search result is not finite (Q, h)")
    return res, dict(ops.LAUNCHES)


def delta_kernel_check(torch, midx, q, timed: bool = False) -> dict:
    """The delta engine's pass 1 at the shapes the mutable path gives it:
    the current snapshot's codes, LUT, pass-1 bias and tombstone mask with
    k == N == capacity.  K2 (up to 1024 slots) or K1 + stable sort (above)
    must equal the plain version bit for bit, and every masked slot must
    come back with id -1.  B4 on the delta's inverted index must equal
    score_inverted bit for bit at Q = 1, 8, 128; ``timed`` adds its ms
    beside its bound, the plain version's and cuSPARSE's."""
    from repro_torch.core.engine import pass1_bias
    from repro_torch.core.pq import adc_lut
    from repro_torch.core.sparse_index import score_inverted
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
    inv = arrays.inv_index
    b4 = {"L": int(inv.rows.shape[1])}
    for qn in (1, 8, q_dims.shape[0]):
        qd, qv = q_dims[:qn], q_vals[:qn]
        b4_equal(torch, ops, inv, qd, qv, f"the delta, N == {k}, Q = {qn}")
        if timed:
            nbytes, entries = tail_bytes(torch, inv, qd)
            b4[str(qn)] = {
                "ms": cuda_ms(lambda: ops.score_inverted_vf(inv, qd, qv)),
                "plain_ms": cuda_ms(lambda: score_inverted(inv, qd, qv)),
                "library_ms": cuda_ms(tail_yardstick(torch, inv, qd, qv)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "live_entries": entries}
    return {"kernel": kernel, "k": k, "live": snap.live, "ids_minus_1": masked,
            "equals_plain": True, "b4_equals_score_inverted": b4}


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
    recall5 = live_recall(torch, midx, ds, res5.ids, h)
    check(recall5 >= 0.95, f"recall@{h} after the mutations {recall5} < 0.95")
    steps["after_deletes"] = {
        "main_c1": c1_main, "launches": launches5, "recall_at_20": recall5,
        "delta_kernel": delta_kernel_check(torch, midx, q, timed=True),
        "search_latency": timed_searches(torch, midx, ds, h, alpha, beta)}

    # 6. 64 more main deletes: the main engine's c1 passes 1024 -> K1
    check(midx.delete(main_dead[16:]) == 64, "main deletes")
    res6, launches6 = counted_search(torch, midx, ds, h, alpha, beta)
    c1_main = alpha * (h + ceil16(80))
    check(launches6["lut16_adc"] == 2 and launches6["lut16_adc_topk"] == 0,
          f"delta K1 + main K1 (c1 {c1_main}) expected: {launches6}")
    steps["after_more_deletes"] = {
        "main_c1": c1_main, "launches": launches6,
        "recall_at_20": live_recall(torch, midx, ds, res6.ids, h),
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
    recall8 = live_recall(torch, merged, ds, res8.ids, h)
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


# ---------------------------------------------------------------------------
# service: QueryService on the slice's index (micro-batching, the result
# cache, the shard fan-out, refresh under load, per-pass time, spans)
# ---------------------------------------------------------------------------

def storage_bytes(torch, arrays) -> int:
    """Bytes of the distinct device storages behind an ``IndexArrays``."""
    from repro_torch.core.engine import _tensors
    seen = {}
    for t in _tensors(arrays):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def span_sums(traces, keys) -> dict:
    """Sums of the tags ``keys`` over every span of finished traces."""
    out = dict.fromkeys(keys, 0.0)
    todo = list(traces)
    while todo:
        node = todo.pop()
        for k in keys:
            out[k] += node["tags"].get(k, 0.0)
        todo += node["children"]
    return out


def run_service(args, torch, idx, ds, slice_res):
    from repro_torch.core.baselines import exact_topk, recall_at_h
    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.core.sparse_index import sparse_queries_to_padded
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS
    from repro_torch.obs import Observability, pass_breakdown
    from repro_torch.serve import QueryService

    t_phase = time.perf_counter()
    h, alpha, beta = 20, 25, 6
    kw = dict(h=h, alpha=alpha, beta=beta)
    params = idx.params
    q_dims, q_vals = sparse_queries_to_padded(ds.q_sparse, idx.cols,
                                              nq_max=params.nq_max)
    q_dense = np.asarray(ds.q_dense, np.float32)
    nq = q_dense.shape[0]
    rng = np.random.default_rng(7)
    requests = [rng.integers(0, nq, int(q)) for q in rng.integers(1, 33, 64)]
    svc = QueryService(idx.engine, id_map=idx.pi, buckets=(1, 8, 32),
                       cache_size=512, obs=Observability(trace=True), **kw)

    def stream():
        t0 = time.perf_counter()
        out = [svc.search(q_dims[r], q_vals[r], q_dense[r]) for r in requests]
        return out, time.perf_counter() - t0

    # the service path, once, with every count at zero just before it
    torch.cuda.synchronize()
    ops.reset_counts()
    cold, cold_s = stream()
    launches = dict(ops.LAUNCHES)
    plain = dict(PLAIN_CALLS)
    check(launches["lut16_adc_topk"] >= 1 and launches["block_sparse_matmul"]
          >= 1 and launches["score_inverted_vf"] >= 1,
          f"the service path did not launch K2, K3 and B4: {launches}")
    check(sum(plain.values()) == 0, f"the service ran plain versions: {plain}")
    traces = svc.obs.tracer.take()
    spans = span_sums(traces, ("dispatch_s", "merge_s"))
    spans["search_s"] = sum(t["duration_s"] for t in traces)
    warm, warm_s = stream()
    rows = sum(len(r) for r in requests)
    for r, (s, ids), (ws, wi) in zip(requests, cold, warm):
        check(np.array_equal(ids, slice_res.ids[r]),
              "service ids != HybridIndex.search's on the same rows")
        check(np.array_equal(ws, s) and np.array_equal(wi, ids),
              "a warm (cached) result differs from the cold one")
        check(bool(np.isfinite(s).all()), "a served score is not finite")
    score_err = 0.0
    for r, (s, _) in zip(requests, cold):
        want = slice_res.scores[r]
        score_err = max(score_err, float(np.abs(s - want).max()))
        check(np.array_equal(s, want),
              "service scores != HybridIndex.search's on the same rows "
              "(a bucket's query must get its batch row's bits)")
    info, shapes = svc.cache_info(), svc.jit_cache_info()
    check(set(shapes.batch_shapes) <= {1, 8, 32}
          and shapes.entries <= shapes.bound,
          f"shape keys {shapes} beyond the bucketing bound")

    # the shard fan-out.  With every row refined (alpha * h and beta * h
    # >= N, the condition of the JAX package's own test of it) two row
    # shards must give the one engine's ids.  At the service's c1 = 500 the
    # two shards refine 500 candidates each, twice the one engine's, so
    # their ids may differ where the one engine's pass-1 cut drops a
    # neighbour: there the check is recall against exact search.
    full = -(-idx.num_points // h)
    exhaustive = dict(h=h, alpha=full, beta=full, cache_size=0)
    rows8 = np.arange(8)
    batch = (q_dims[rows8], q_vals[rows8], q_dense[rows8])
    one = QueryService(idx.engine, id_map=idx.pi, **exhaustive)
    two = QueryService(idx.engine, id_map=idx.pi, num_shards=2, **exhaustive)
    s1, i1 = one.search(*batch)
    s2, i2 = two.search(*batch)
    shard_swaps = neighbour_swaps(i2, i1, s1)
    shard_err = float(np.abs(s1 - s2).max())
    check(bool((np.abs(s2 - s1) <= ATOL + RTOL * np.abs(s1)).all()),
          "exhaustive 2-shard scores beyond tolerance of 1-shard scores")
    one.close()
    two.close()
    two = QueryService(idx.engine, id_map=idx.pi, num_shards=2,
                       cache_size=0, **kw)
    s2c, i2c = two.search(q_dims, q_vals, q_dense)
    two.close()
    del one, two
    gc.collect()
    torch.cuda.empty_cache()
    true_ids, _ = exact_topk(ds.q_sparse, ds.q_dense, ds.x_sparse,
                             ds.x_dense, h, device="cuda")
    recall_1 = recall_at_h(slice_res.ids, true_ids)
    recall_2 = recall_at_h(i2c, true_ids)
    check(recall_2 >= recall_1, f"2-shard recall@{h} {recall_2} below the "
          f"one engine's {recall_1}")
    sharded = {"exhaustive_rows": 8, "exhaustive_ids_equal":
               bool(np.array_equal(i1, i2)),
               "exhaustive_neighbour_swaps": shard_swaps,
               "exhaustive_max_score_diff": shard_err,
               "c1_500_rows_differing":
                   int((i2c != slice_res.ids).any(axis=1).sum()),
               "c1_500_recall_at_20": {"1_shard": recall_1,
                                       "2_shards": recall_2}}

    # per-pass time at Q = 1, 8, 32 (CUDA events) and the host's share at
    # Q = 1: a one-row request's wall time against its device time
    dev = idx.engine.arrays.codes.device
    qd_t = torch.from_numpy(q_dims).to(dev)
    qv_t = torch.from_numpy(q_vals).to(dev)
    qe_t = torch.from_numpy(q_dense).to(dev)
    breakdown = {}
    for q in (1, 8, 32):
        b = pass_breakdown(idx.engine, qd_t[:q], qv_t[:q], qe_t[:q], iters=10,
                           **kw)
        breakdown[str(q)] = {"pass1_ms": b["pass1_s"] * 1e3,
                             "passes23_ms": b["pass23_s"] * 1e3,
                             "full_ms": b["full_s"] * 1e3,
                             "pass1_fraction": b["pass1_fraction"],
                             "timer": b["timer"]}
    nocache = QueryService(idx.engine, id_map=idx.pi, cache_size=0, **kw)
    q1 = device_profile(torch, lambda: nocache.search(
        q_dims[:1], q_vals[:1], q_dense[:1]), runs=10)
    nocache.close()
    if isinstance(q1.get("device_ms"), float):
        q1["host_share"] = 1.0 - q1["busy_share"]

    stats = svc.stats()
    svc.close()

    # refresh under a submit() stream: a rebuilt generation (another k-means
    # seed) swapped in while searches are in flight, on a service without a
    # result cache, so every result comes from a search of the batch
    t0 = time.perf_counter()
    idx_b = HybridIndex.build(ds.x_sparse, ds.x_dense,
                              dataclasses.replace(params, seed=params.seed + 1),
                              device="cuda")
    rebuild_s = time.perf_counter() - t0
    ref_a = QueryService(idx.engine, id_map=idx.pi, cache_size=0,
                         **kw).search(*batch)
    ref_b = QueryService(idx_b.engine, id_map=idx_b.pi, cache_size=0,
                         **kw).search(*batch)
    check(not np.array_equal(ref_a[0], ref_b[0]),
          "the two generations are indistinguishable")
    gen_a_bytes = storage_bytes(torch, idx.engine.arrays)
    live = QueryService(idx.engine, id_map=idx.pi, cache_size=0, **kw)
    # the pool's threads first: each thread's first matmul allocates its
    # own cuBLAS workspace, which would hide what the refresh frees
    for f in [live.submit(*batch) for _ in range(4)]:
        f.result(timeout=300)
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    futures = [live.submit(*batch) for _ in range(6)]
    # once one has finished, the pool's threads hold generation a in the
    # next ones: the refresh swaps under them and frees a after the last
    futures[0].result(timeout=300)
    t0 = time.perf_counter()
    live.refresh(idx_b.engine, id_map=idx_b.pi)
    swap_s = time.perf_counter() - t0
    futures += [live.submit(*batch) for _ in range(4)]
    results = [f.result(timeout=300) for f in futures]
    gens = []
    for s, ids in results:
        from_a = np.array_equal(s, ref_a[0]) and np.array_equal(ids, ref_a[1])
        from_b = np.array_equal(s, ref_b[0]) and np.array_equal(ids, ref_b[1])
        check(from_a != from_b, "a result mixes the two generations")
        gens.append("a" if from_a else "b")
    check(gens[6:] == ["b"] * 4, "a search after refresh() saw generation a")
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    freed = mem_before - mem_after
    check(freed >= gen_a_bytes,
          f"memory_allocated fell by {freed} B after refresh(), less than "
          f"the retired generation's {gen_a_bytes} B")
    live.close()
    del idx_b, live
    emit("service", requests=len(requests), rows=rows,
         buckets=list(svc.buckets), cold_s=cold_s, warm_s=warm_s,
         cold_qps=rows / cold_s, warm_qps=rows / warm_s,
         hit_rate=info.hit_rate, cache=dataclasses.asdict(info),
         shape_keys=dataclasses.asdict(shapes), launches=launches,
         plain_calls=plain, ids_equal_search=True,
         max_score_diff_vs_search=score_err, sharded=sharded,
         span_totals_s=spans,
         pass_breakdown=breakdown, q1_request=q1,
         refresh={"rebuild_s": rebuild_s, "swap_ms": swap_s * 1e3,
                  "generations_seen": "".join(gens),
                  "memory_allocated_before": mem_before,
                  "memory_allocated_after": mem_after,
                  "bytes_freed": freed, "retired_generation_bytes": gen_a_bytes},
         stats={k: stats[k] for k in ("requests", "batches", "refreshes",
                                      "version")},
         seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# durable: QueryService(persist_dir=...) on the mutable slice, recovery
# ---------------------------------------------------------------------------

def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)


def percentile_ms(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q) * 1e3)


# inserts of the durable phase: past 1024 delta slots, so that the
# recovered delta engine scores through K1 + sort
DURABLE_INSERTS = 2048


def run_durable(torch, ds, params):
    import shutil
    import tempfile

    from repro_torch import persist
    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS
    from repro_torch.serve import QueryService

    t_phase = time.perf_counter()
    kw = dict(h=20, alpha=25, beta=6, cache_size=0, auto_compact=False)
    tmp = tempfile.mkdtemp(prefix="durable-")
    root = os.path.join(tmp, "store")
    disk_free = shutil.disk_usage(tmp).free
    try:
        t0 = time.perf_counter()
        midx = HybridIndex.build(ds.x_sparse, ds.x_dense, params,
                                 mutable=True, device="cuda")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc = QueryService(index=midx, persist_dir=root, **kw)
        bootstrap_s = time.perf_counter() - t0
        bootstrap_bytes = dir_bytes(root)

        # time the WAL's two halves: the append (frame + flush under the
        # mutation lock) and the fsync that acks it (group commit)
        dur = svc._durability
        append_s, fsync_s, ack_s = [], [], []

        def timed(fn, sink):
            def call(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                sink.append(time.perf_counter() - t)
                return out
            return call

        dur.log_insert = timed(dur.log_insert, append_s)
        dur.sync = timed(dur.sync, fsync_s)
        n0 = DURABLE_INSERTS
        xs_new, xd_new = perturbed_rows(ds, n0 + 256, seed=9)
        new_ids = []
        t0 = time.perf_counter()
        for lo in range(0, n0, 16):
            t = time.perf_counter()
            new_ids += svc.insert(xs_new[lo:lo + 16],
                                  xd_new[lo:lo + 16]).tolist()
            ack_s.append(time.perf_counter() - t)
        insert_s = time.perf_counter() - t0
        rng = np.random.default_rng(10)
        main_dead = rng.choice(ds.x_sparse.shape[0], size=16, replace=False)
        check(svc.delete(new_ids[::32]) == len(new_ids[::32]), "deletes")
        check(svc.delete(main_dead) == 16, "main deletes")
        t0 = time.perf_counter()
        svc.checkpoint()
        checkpoint_s = time.perf_counter() - t0
        checkpoint_bytes = dir_bytes(root)
        tail = []
        for lo in range(n0, n0 + 256, 16):
            tail += svc.insert(xs_new[lo:lo + 16],
                               xd_new[lo:lo + 16]).tolist()
        check(svc.delete(tail[:8]) == 8, "tail deletes")
        live = svc.search_sparse(ds.q_sparse, ds.q_dense)
        live_stats = svc.stats()
        svc.close()
        del svc, midx, dur
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        rsvc = QueryService(restore_from=root, **kw)
        recover_s = time.perf_counter() - t0
        # the recovered service's search, counted: main (K2 at c1 = 900,
        # K3) + delta (K1 past 1024 slots)
        torch.cuda.synchronize()
        ops.reset_counts()
        got = rsvc.search_sparse(ds.q_sparse, ds.q_dense)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        check(sum(PLAIN_CALLS.values()) == 0,
              "the recovered service ran a plain version")
        check(launches["lut16_adc"] >= 1 and launches["lut16_adc_topk"] >= 1
              and launches["block_sparse_matmul"] >= 1
              and launches["score_inverted_vf"] >= 2,
              f"the recovered search did not launch K1, K2, K3 and B4 "
              f"(main and delta): {launches}")
        check(np.array_equal(got[1], live[1]) and np.array_equal(got[0],
                                                                 live[0]),
              "recovered ids/scores != the live service's, bit for bit")
        rstats = rsvc.stats()
        check(rstats["recovered_replayed"] == 256 // 16 + 1,
              f"replayed {rstats['recovered_replayed']} WAL records, "
              "expected the 17 after the checkpoint")
        before = persist.read_current(root)["snapshot"]
        t0 = time.perf_counter()
        rsvc.compact()
        compact_s = time.perf_counter() - t0
        after_s, after_i = rsvc.search_sparse(ds.q_sparse, ds.q_dense)
        check(bool(np.isfinite(after_s).all()), "post-compaction scores")
        rsvc.close()
        cur = persist.read_current(root)
        manifest = json.load(open(os.path.join(root, cur["snapshot"],
                                               "manifest.json")))
        wal = persist.MutationWAL(os.path.join(root, "wal"))
        tail_records = len(wal.records(from_seq=manifest["replay_from_seq"]))
        wal_files = sorted(os.listdir(os.path.join(root, "wal")))
        wal.close()
        check(cur["snapshot"] != before and tail_records == 0,
              "compact() did not cut a snapshot and truncate the WAL")
        emit("durable", rows=ds.x_sparse.shape[0], disk_free=disk_free,
             build_s=build_s, bootstrap_s=bootstrap_s,
             bootstrap_store_bytes=bootstrap_bytes,
             inserts={"rows": n0, "batch": 16, "seconds": insert_s,
                      "rows_per_s": n0 / insert_s,
                      "ack_p50_ms": percentile_ms(ack_s, 50),
                      "ack_p99_ms": percentile_ms(ack_s, 99),
                      "wal_append_p50_ms": percentile_ms(append_s, 50),
                      "wal_append_p99_ms": percentile_ms(append_s, 99),
                      "wal_fsync_p50_ms": percentile_ms(fsync_s, 50),
                      "wal_fsync_p99_ms": percentile_ms(fsync_s, 99)},
             checkpoint_s=checkpoint_s, checkpoint_store_bytes=checkpoint_bytes,
             recover_s=recover_s, replayed=rstats["recovered_replayed"],
             delta_rows=live_stats["delta_rows"],
             deleted_pending=live_stats["deleted_pending"],
             recovered_equals_live=True, launches=launches,
             compact_s=compact_s, snapshot_after_compact=cur["snapshot"],
             wal_files_after_compact=wal_files,
             store_bytes_after_compact=dir_bytes(root),
             seconds=time.perf_counter() - t_phase)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# cluster: a LocalCluster on the card (primary, 2 scorers, 1 replica, each a
# process of its own) driven through ClusterRouter, every result held to an
# in-process fan-out of the port bit for bit
# ---------------------------------------------------------------------------

# inserts of the cluster phase: past 1024 delta slots, so that the
# primary's delta engine goes from K2 to K1 + sort
CLUSTER_INSERTS = 2048
CLUSTER_DELETES = 256
CLUSTER_SEARCH_LIMIT_S = 120.0   # a search's limit after the compaction
# the share of the searches during a compaction that may be refused
# StaleGeneration: none.  A chunk pinned at the primary's new generation
# that a scorer does not hold yet is served by the primary's full read
# (ROADMAP C10, closed); before that repair, 14 of 345 were refused
CLUSTER_REFUSED_SHARE = 0.0
# the longest a search during a compaction may take: it waits neither on
# the primary's fold nor on a follower's reload (C10; 0.23-0.24 s on the
# card, 14.6-17.5 s before the repair)
CLUSTER_FLIP_WALL_S = 5.0


class InProcessCluster:
    """The router's two read paths, computed in this process on the same
    state as the cluster (every mutation is applied here too):

    * ``fan`` — the scorer fan-out: the main generation split by
      ``split_index_arrays(..., ragged=True)`` into the scorers' row
      slices, each fetching ``plan_overfetch``'s depth, plus the delta at
      its capacity, merged by ``core.streaming.fanout_search`` (what
      ``QueryService(num_shards=S)`` runs);
    * ``one`` — the one-engine read that the primary's direct path and a
      replica's ``full`` part serve: the main engine at the router's depth
      (h + ceil16 of the main and fully deleted ids) plus the server's
      self-slack (ceil16 of its tombstones), the delta, and the per-part
      drops of ``merge_topk_host``.  At c1 = alpha * depth the depth
      changes the candidates, so it must be the router's, not a
      ``QueryService``'s.

    Queries go unpadded, where the router pads them to its buckets: on the
    kernel backends a query's result does not depend on its batch."""

    def __init__(self, torch, idx, num_scorers, h, alpha, beta):
        self.torch, self.idx, self.s = torch, idx, num_scorers
        self.h, self.alpha, self.beta = h, alpha, beta
        self._split = None

    def _engines(self):
        from repro_torch.core.distributed import split_index_arrays
        from repro_torch.core.engine import ScoringEngine
        arrays = self.idx.engine.arrays
        if self._split is None or self._split[0] is not arrays:
            parts, offsets = split_index_arrays(arrays, self.s, ragged=True)
            self._split = (arrays, [ScoringEngine(
                arrays=a, backend=self.idx.engine.backend) for a in parts],
                offsets)
        return self._split[1], self._split[2]

    def _queries(self, q_sparse, q_dense):
        from repro_torch.core.sparse_index import sparse_queries_to_padded
        qd, qv = sparse_queries_to_padded(q_sparse, self.idx.cols,
                                          nq_max=self.idx.params.nq_max)
        dev = self.idx.device
        return ([self.torch.from_numpy(a).to(dev) for a in (
            qd, qv, np.asarray(q_dense, np.float32))], qd.shape[0])

    def _delta(self):
        from repro_torch.core.engine import ScoringEngine
        st = self.idx.mutable_state
        if not st.delta.live_count:
            return None, None
        snap = st.delta.snapshot()
        return ScoringEngine(arrays=snap.arrays,
                             backend=self.idx.engine.backend), snap

    def fan(self, q_sparse, q_dense):
        from repro_torch.core.streaming import fanout_search, plan_overfetch
        q, qn = self._queries(q_sparse, q_dense)
        engines, offsets = self._engines()
        st = self.idx.mutable_state
        de, snap = self._delta()
        return fanout_search(
            engines, plan_overfetch(engines, self.h, st.main_tombstones),
            offsets, st.id_map, de, None if snap is None else snap.ids,
            st.main_tombstones, *q, h=self.h, alpha=self.alpha,
            beta=self.beta, qn=qn, dedup_upserts=True)

    def one(self, q_sparse, q_dense):
        from repro_torch.core.distributed import ceil16, merge_topk_host
        from repro_torch.device import to_numpy
        q, qn = self._queries(q_sparse, q_dense)
        st = self.idx.mutable_state
        main_dead = set(st.main_tombstones)
        fully = (main_dead | set(st.extra_ids)) - st._loc.keys()
        n = self.idx.engine.arrays.num_points
        dead = main_dead | fully
        h_fetch = min(self.h + (ceil16(len(dead)) if dead else 0), n)
        h_eff = min(h_fetch + (ceil16(len(main_dead)) if main_dead else 0),
                    n)
        kw = dict(alpha=self.alpha, beta=self.beta)
        ms, mi, _ = self.idx.engine.search(*q, h=h_eff, **kw)
        parts = [(to_numpy(ms)[:qn],
                  np.asarray(st.id_map)[to_numpy(mi)][:qn],
                  np.asarray(sorted(dead), np.int64))]
        de, snap = self._delta()
        if de is not None:
            ds_, di, _ = de.search(*q, h=snap.capacity, **kw)
            parts.append((to_numpy(ds_)[:qn], snap.ids[to_numpy(di)][:qn],
                          np.asarray(sorted(fully), np.int64)))
        return merge_topk_host(parts, self.h)

    def path(self, rows: int):
        """The comparator of the path the router takes for ``rows`` rows
        (``direct_q_max`` = 1)."""
        return self.one if rows == 1 else self.fan


def trace_hops(root: dict, names: dict) -> dict:
    """One router search's trace, in short: its path, its annotations and
    each hop's node, part and seconds (wall, and score on the node)."""
    return {"seconds": root["duration_s"], "path": root["tags"].get("path"),
            "annotations": root["annotations"],
            "hops": [{"node": names.get(c["tags"].get("peer"),
                                        c["tags"].get("peer")),
                      "part": c["tags"].get("part"),
                      "wall_s": c["tags"].get("wall_s"),
                      "score_s": c["tags"].get("score_s")}
                     for c in root["children"]]}


def node_stats(cluster) -> dict:
    """The ``stats`` reply of every live node, by node name."""
    from repro_torch.serve.cluster import ShardClient
    out = {}
    for hnd in [cluster.primary, *cluster.scorers, *cluster.replicas]:
        if not hnd.alive():
            continue
        c = ShardClient("127.0.0.1", hnd.port, timeout=120)
        try:
            st, _ = c.call("stats")
        finally:
            c.close()
        st.pop("metrics")
        out[hnd.name] = st
    return out


def wait_replica(cluster, seq: int, timeout: float = 120.0) -> dict:
    from repro_torch.serve.cluster import ShardClient
    c = ShardClient("127.0.0.1", cluster.replicas[0].port, timeout=timeout)
    deadline = time.monotonic() + timeout
    try:
        while True:
            st, _ = c.call("status")
            if st["applied_seq"] >= seq:
                return st
            check(time.monotonic() < deadline,
                  f"replica stuck at applied seq {st['applied_seq']}, "
                  f"want {seq}")
            time.sleep(0.05)
    finally:
        c.close()


def run_cluster(torch, ds, params):
    import shutil
    import tempfile

    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.core.sparse_index import sparse_queries_to_padded
    from repro_torch.serve.cluster import (DegradedResultError, LocalCluster,
                                           ShardClient)

    t_phase = time.perf_counter()
    h, alpha, beta, scorers = 20, 25, 6, 2
    tmp = tempfile.mkdtemp(prefix="cluster-")
    disk_free = shutil.disk_usage(tmp).free
    rng = np.random.default_rng(7)
    nq = ds.q_dense.shape[0]
    requests = [rng.integers(0, nq, int(q)) for q in rng.integers(1, 33, 64)]
    rows32 = np.arange(32)
    parity_checks = {"fan": 0, "one": 0, "flip_direct": 0}
    cluster = None
    routers = []
    try:
        t0 = time.perf_counter()
        idx = HybridIndex.build(ds.x_sparse, ds.x_dense, params,
                                mutable=True, device="cuda")
        build_s = time.perf_counter() - t0
        comp = InProcessCluster(torch, idx, scorers, h, alpha, beta)
        t0 = time.perf_counter()
        cluster = LocalCluster.launch(idx, tmp, num_scorers=scorers,
                                      num_replicas=1, device="cuda:0")
        launch_s = time.perf_counter() - t0
        boot = node_stats(cluster)
        # a scorer's share: the bytes of the slice split_index_arrays
        # gives it (every tensor of it owned), per generation it holds
        slice_bytes = {1: [tensor_bytes(e.arrays)
                           for e in comp._engines()[0]]}
        for name, st in boot.items():
            check(st["kernels_built"] == [],
                  f"node {name} compiled kernels: {st['kernels_built']}")
        router = cluster.router(h=h, alpha=alpha, beta=beta, timeout=600)
        routers.append(router)

        def same(got, want, what):
            check(np.array_equal(got[1], want[1])
                  and np.array_equal(got[0], want[0]),
                  f"{what}: the router's ids/scores != the in-process "
                  "path's, bit for bit")

        def parity(r, what):
            for rows in (rows32, rows32[5:6]):
                got = r.search_sparse(ds.q_sparse[rows], ds.q_dense[rows])
                same(got, comp.path(len(rows))(ds.q_sparse[rows],
                                               ds.q_dense[rows]), what)
                parity_checks["one" if len(rows) == 1 else "fan"] += 1

        def router_recall(what):
            """recall@h of the router's results for every query against
            exact search over the live rows, an answer independent of
            the depths the router and its comparators share."""
            got = np.concatenate([router.search_sparse(
                ds.q_sparse[lo:lo + 32], ds.q_dense[lo:lo + 32])[1]
                for lo in range(0, nq, 32)])
            r = live_recall(torch, comp.idx, ds, got, h)
            check(r >= 0.95, f"router recall@{h} {what} {r} < 0.95")
            return r

        # fan against one on the 128 queries: where 2 x c1 candidates
        # refined by the slices differ from one engine's c1
        fan_one = {"ids_differing": 0, "rows_differing": 0}
        for lo in range(0, nq, 32):
            f = comp.fan(ds.q_sparse[lo:lo + 32], ds.q_dense[lo:lo + 32])
            o = comp.one(ds.q_sparse[lo:lo + 32], ds.q_dense[lo:lo + 32])
            fan_one["ids_differing"] += int((f[1] != o[1]).sum())
            fan_one["rows_differing"] += int((f[1] != o[1]).any(axis=1).sum())

        # the ragged stream, twice (the router has no result cache)
        want = [comp.path(len(r))(ds.q_sparse[r], ds.q_dense[r])
                for r in requests]
        passes = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = [router.search_sparse(ds.q_sparse[r], ds.q_dense[r])
                   for r in requests]
            passes.append(time.perf_counter() - t0)
            for r, g, w in zip(requests, got, want):
                same(g, w, f"ragged stream, a request of {len(r)} rows")
        stream_rows = sum(len(r) for r in requests)
        check(router.stats["direct_reads"] > 0
              and router.stats["primary_reads"] > router.stats[
                  "direct_reads"], "the stream took only one path")

        # four CUDA contexts on one card: one scorer searched alone, then
        # both at once (score_s is each server's own wall time of a search)
        pin = router._pin()
        qd, qv = sparse_queries_to_padded(ds.q_sparse[rows32], pin.cols,
                                          nq_max=router._nq_max)
        req = {"part": "main", "gen": pin.gen, "h": h, "alpha": alpha,
               "beta": beta}
        q_arrays = {"q_dims": qd, "q_vals": qv,       # 32 rows: no padding
                    "q_dense": np.asarray(ds.q_dense[rows32], np.float32)}
        clients = [ShardClient("127.0.0.1", hd.port, timeout=120)
                   for hd in cluster.scorers]
        try:
            alone, both, both_wall = [], [], []
            for _ in range(12):
                m, _ = clients[0].call("search", req, q_arrays)
                alone.append(m["score_s"])
            for _ in range(12):
                t0 = time.perf_counter()
                ps = [c.submit("search", req, q_arrays) for c in clients]
                ms_ = [p.result()[0] for p in ps]
                both_wall.append(time.perf_counter() - t0)
                both += [m["score_s"] for m in ms_]
        finally:
            for c in clients:
                c.close()
        contexts = {"scorer_rows": 32,
                    "scorer_alone_score_ms_p50": percentile_ms(alone, 50),
                    "scorers_together_score_ms_p50": percentile_ms(both, 50),
                    "scorers_together_wall_ms_p50": percentile_ms(both_wall,
                                                                  50)}

        # mutations through the router, mirrored in-process
        xs_new, xd_new = perturbed_rows(ds, CLUSTER_INSERTS, seed=11)
        ack_s, new_ids = [], []
        for lo in range(0, CLUSTER_INSERTS, 16):
            t0 = time.perf_counter()
            got = router.insert(xs_new[lo:lo + 16], xd_new[lo:lo + 16])
            ack_s.append(time.perf_counter() - t0)
            check(np.array_equal(got, idx.insert(xs_new[lo:lo + 16],
                                                 xd_new[lo:lo + 16])),
                  "the router's assigned ids != the in-process index's")
            new_ids += got.tolist()
            if (lo + 16) % 512 == 0:
                parity(router, f"after {lo + 16} inserts")
        drng = np.random.default_rng(12)
        doomed = np.concatenate([
            drng.choice(ds.x_sparse.shape[0], CLUSTER_DELETES // 2,
                        replace=False),
            drng.choice(new_ids, CLUSTER_DELETES // 2, replace=False)])
        for lo in range(0, CLUSTER_DELETES, 16):
            batch = doomed[lo:lo + 16].tolist()
            check(router.delete(batch) == idx.delete(batch) == 16,
                  "a delete batch did not kill 16 rows in both")
        parity(router, "after the deletes")
        recall = {"after_deletes": router_recall("after the deletes")}
        delta_slots = idx.mutable_state.delta.capacity

        def compact(want_gen):
            """Compact in-process, then through the router (until every
            follower serves the new generation, ``held_compaction``),
            while a second router searches from a thread all through it
            (``searches_during``); parity and recall after.  Prints the
            searches, the compaction's steps (the router's
            ``cluster.compact`` trace: the fold, then each reload), each
            node's stages of them and the seconds scorer 0's reload was
            held (within the compaction's seconds)."""
            folded = comp.idx.compact()
            t0 = time.perf_counter()
            gen = searches_during(lambda: held_compaction(folded))
            compact_s.append(time.perf_counter() - t0)
            steps = [trace_hops(r, names) for r in router.obs.tracer.take()
                     if r["name"] == "cluster.compact"][-1]
            emit("cluster_compaction", generation=gen,
                 seconds=compact_s[-1], held_s=held_s[-1],
                 **during_compaction[f"to_generation_{gen}"],
                 steps=steps["hops"],
                 node_stages_s={n: st["stages_s"] for n, st in
                                node_stats(cluster).items()})
            comp.idx = folded
            check(gen == want_gen, f"compaction went to generation {gen}")
            parity(router, f"after compaction to generation {gen}")
            recall[f"after_compaction_{gen}"] = router_recall(
                f"after compaction to generation {gen}")
            slice_bytes[gen] = [tensor_bytes(e.arrays)
                                for e in comp._engines()[0]]

        def held_compaction(folded):
            """``router.compact`` with scorer 0's reload held before its
            swap.  While it is held, the primary serves the new generation
            and scorer 0 holds only the old one: a fresh router's 32-row
            search must be served by the primary's full read
            (``flip_direct``, C10) and equal ``one`` on ``folded`` bit for
            bit.  Then the release; returns the new generation."""
            want = InProcessCluster(torch, folded, scorers, h, alpha,
                                    beta).one(ds.q_sparse[rows32],
                                              ds.q_dense[rows32])
            box = {}

            def run():
                try:
                    box["gen"] = router.compact()
                except BaseException as e:          # raised below
                    box["error"] = e

            sc = ShardClient("127.0.0.1", cluster.scorers[0].port,
                             timeout=120)
            t = threading.Thread(target=run, daemon=True)
            t_held = None
            try:
                sc.call("fault", {"mode": "hold_reload"})
                t.start()
                deadline = time.monotonic() + CLUSTER_SEARCH_LIMIT_S
                while sc.call("stats")[0]["holding"] != ["reload"]:
                    check(t.is_alive() and time.monotonic() < deadline,
                          "scorer 0's reload was never held: "
                          f"{box.get('error')!r}")
                    time.sleep(0.1)
                t_held = time.perf_counter()
                probe = cluster.router(h=h, alpha=alpha, beta=beta,
                                       timeout=120)
                routers.append(probe)
                got = probe.search_sparse(ds.q_sparse[rows32],
                                          ds.q_dense[rows32])
                check(probe.stats["flip_direct"] == 32,
                      "a 32-row search with scorer 0 behind was not served "
                      f"by the primary's full read: {probe.stats}")
                same(got, want, "a flip_direct search during a compaction")
                parity_checks["flip_direct"] += 1
            finally:
                sc.call("fault", {"mode": "release_reload"})
                sc.close()
                held_s.append(None if t_held is None
                              else time.perf_counter() - t_held)
                if t.is_alive():
                    t.join(CLUSTER_SEARCH_LIMIT_S * 4)
            check(not t.is_alive(), "the compaction did not end")
            if "error" in box:
                raise box["error"]
            return box["gen"]

        def mutate(seed):
            """64 inserts and 6 deletes (2 of the new rows, 4 of main)
            through the router and in-process, then parity: a delta and
            tombstones for the reads that follow."""
            xs_more, xd_more = perturbed_rows(ds, 64, seed=seed)
            for lo in range(0, 64, 16):
                got = router.insert(xs_more[lo:lo + 16], xd_more[lo:lo + 16])
                check(np.array_equal(got, comp.idx.insert(
                    xs_more[lo:lo + 16], xd_more[lo:lo + 16])),
                      "the router's assigned ids != the in-process index's")
            live_main = np.setdiff1d(np.arange(ds.x_sparse.shape[0]),
                                     np.fromiter(deleted, np.int64))
            batch = [int(got[0]), int(got[5])] + drng.choice(
                live_main, 4, replace=False).tolist()
            check(router.delete(batch) == comp.idx.delete(batch)
                  == len(batch), "the post-compaction deletes")
            deleted.update(batch)
            parity(router, f"after the mutations of seed {seed}")

        def searches_during(compaction):
            """Run ``compaction`` while a second router searches from a
            thread, 32-row fan-outs and one-row direct reads in turns, 20
            ms apart, and once each after it.  A search pinned before a
            generation flip gets StaleGeneration from a node and retries
            (C8: a fan-out cut by one shard's refusal must settle its
            other entries, or the retry waits on them for good); while the
            scorers reload, a chunk pinned at the new generation is served
            by the primary's full read (``flip_direct``, C10).  A search
            refused StaleGeneration is counted and held to
            ``CLUSTER_REFUSED_SHARE`` (none), and each must take less than
            ``CLUSTER_FLIP_WALL_S``.  Every search must end within
            the thread's time limit, the ones that return without
            duplicate ids in a row and without an id deleted before the
            compaction began, and the two after it must return.  Prints
            the searches by path, their wall times and the slowest one's
            trace (``trace_hops``)."""
            from repro_torch.serve.cluster import RemoteError
            bg = cluster.router(h=h, alpha=alpha, beta=beta, timeout=120)
            routers.append(bg)
            stop, box = threading.Event(), {}
            walls = {"returned": [], "refused": []}
            paths = collections.Counter()
            slowest = {"seconds": -1.0}
            dead = np.fromiter(deleted, np.int64)

            def search(i, refusable):
                rows = rows32 if i % 2 == 0 else rows32[i % 32:i % 32 + 1]
                t0 = time.perf_counter()
                try:
                    _, ids = bg.search_sparse(ds.q_sparse[rows],
                                              ds.q_dense[rows])
                except RemoteError as e:
                    if not refusable or "StaleGeneration" not in str(e):
                        raise
                    walls["refused"].append(time.perf_counter() - t0)
                    return
                finally:
                    for root in bg.obs.tracer.take():
                        paths[root["tags"].get("path")] += 1
                        if root["duration_s"] > slowest["seconds"]:
                            slowest.update(trace_hops(root, names))
                walls["returned"].append(time.perf_counter() - t0)
                for row in ids:
                    live = row[row >= 0]
                    check(len(np.unique(live)) == len(live),
                          f"a search during compaction served "
                          f"duplicate ids: {row}")
                    check(not np.isin(live, dead).any(),
                          "a search during compaction served an id "
                          f"deleted before it began: "
                          f"{live[np.isin(live, dead)]}")

            def search_loop():
                try:
                    i = 0
                    while not stop.is_set():
                        search(i, refusable=True)
                        i += 1
                        time.sleep(0.02)
                    search(0, refusable=False)      # a fan-out after it
                    search(1, refusable=False)      # a direct read after it
                except BaseException as e:          # raised below
                    box["error"] = e

            t = threading.Thread(target=search_loop, daemon=True)
            t.start()
            try:
                gen = compaction()
            finally:
                stop.set()
                t.join(CLUSTER_SEARCH_LIMIT_S)
            check(not t.is_alive(), "a search during compaction did not "
                  f"end within {CLUSTER_SEARCH_LIMIT_S} s of it")
            if "error" in box:
                raise box["error"]
            every = walls["returned"] + walls["refused"]
            refused = len(walls["refused"]) / max(1, len(every) - 2)
            during_compaction[f"to_generation_{gen}"] = dict(
                searches=len(every) - 2, returned=len(walls["returned"]) - 2,
                refused_stale=len(walls["refused"]),
                refused_bound=CLUSTER_REFUSED_SHARE,
                paths=dict(paths), flip_direct_rows=bg.stats["flip_direct"],
                p50_ms=percentile_ms(every, 50),
                p99_ms=percentile_ms(every, 99), max_s=max(every),
                stale_retries=bg.stats["stale_retries"],
                resyncs=bg.stats["resyncs"], slowest=slowest)
            check(refused <= CLUSTER_REFUSED_SHARE,
                  f"{len(walls['refused'])} of {len(every) - 2} searches "
                  "during compaction were refused StaleGeneration, more "
                  f"than {CLUSTER_REFUSED_SHARE:.0%}")
            check(max(every) < CLUSTER_FLIP_WALL_S,
                  f"a search during compaction took {max(every):.2f} s, "
                  f"not under {CLUSTER_FLIP_WALL_S} s: "
                  f"{json.dumps(slowest)}")
            return gen

        # two compactions, mutations before each and after the last: the
        # second one drops generation 1 from every scorer; a second router
        # searches all through each
        names = {hd.addr: hd.name for hd in
                 [cluster.primary, *cluster.scorers, *cluster.replicas]}
        compact_s, held_s = [], []
        during_compaction = {}
        deleted = set(doomed.tolist())
        compact(2)
        mutate(13)
        readings = {"bootstrap": boot, "compacted_once": node_stats(cluster)}
        compact(3)
        mutate(14)
        idx = comp.idx

        # a second router on the same cluster agrees with the first
        r2 = cluster.router(h=h, alpha=alpha, beta=beta, timeout=600)
        routers.append(r2)
        for r in requests[:16]:
            a = router.search_sparse(ds.q_sparse[r], ds.q_dense[r])
            b = r2.search_sparse(ds.q_sparse[r], ds.q_dense[r])
            same(b, a, "two routers")
        parity(r2, "the second router")

        # every node's counts, bytes and timings before the faults
        stats = readings["compacted_twice"] = node_stats(cluster)
        mem = {}
        for name, st in stats.items():
            check(st["kernels_built"] == [],
                  f"node {name} compiled kernels: {st['kernels_built']}")
            check(sum(st["plain_calls"].values()) == 0,
                  f"node {name} ran plain versions: {st['plain_calls']}")
            if name.startswith("scorer"):
                # its bytes above the process's baseline (the cuBLAS
                # workspace of its device thread, taken before any index)
                k = int(name.split("-")[1])
                for when, gens in (("bootstrap", [1]),
                                   ("compacted_once", [1, 2]),
                                   ("compacted_twice", [2, 3])):
                    s_ = readings[when][name]
                    check(s_["generations"] == gens,
                          f"{name} holds generations {s_['generations']} "
                          f"at {when}, not {gens}")
                    held = s_["memory_allocated"] - s_["baseline_allocated"]
                    bound = 1.25 * sum(slice_bytes[g][k] for g in gens)
                    check(held <= bound,
                          f"{name} holds {held} B above its baseline at "
                          f"{when}, beyond 1.25 x its slices of "
                          f"generations {gens} ({bound:.0f})")
            mem[name] = {"baseline": st["baseline_allocated"],
                         **{when: {"now": r_[name]["memory_allocated"],
                                   "max": r_[name]["max_memory_allocated"],
                                   "generations": r_[name]["generations"]}
                            for when, r_ in readings.items()}}
        # what one search adds to a scorer's bytes at its slice's shapes:
        # the same search in this process, at the stream's 32 rows, at
        # depth h (K2), at the depth the 128 main deletes gave the scorers
        # (K1 + sort) and at the depth of all 256 deletes
        q, _ = comp._queries(ds.q_sparse[rows32], ds.q_dense[rows32])
        eng = comp._engines()[0][0]
        transient = {}
        for depth in (h, h + CLUSTER_DELETES // 2, h + CLUSTER_DELETES):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eng.search(*q, h=depth, alpha=alpha, beta=beta)
            torch.cuda.synchronize()
            transient[str(depth)] = torch.cuda.max_memory_allocated() - before
        launches = dict.fromkeys(stats[next(iter(stats))]["kernel_launches"],
                                 0)
        for st in stats.values():
            for k, v in st["kernel_launches"].items():
                launches[k] += v
        check(launches["lut16_adc"] > 0 and launches["lut16_adc_topk"] > 0
              and launches["block_sparse_matmul"] > 0
              and launches["score_inverted_vf"] > 0,
              f"the cluster did not launch K1, K2, K3 and B4: {launches}")
        check(launches["inverted_value_forward"] == 0,
              "the cluster launched the stream B4")

        # faults, last: they tear the topology down
        sc = ShardClient("127.0.0.1", cluster.scorers[0].port, timeout=120)
        try:
            for mode in ("corrupt_next", "close_next"):
                sc.call("fault", {"mode": mode})
                before = sum(c.reconnects for c in router.scorers)
                parity(router, f"after a {mode} fault")
                check(sum(c.reconnects for c in router.scorers)
                      == before + 1, f"{mode} was not healed by a reconnect")
        finally:
            sc.close()
        wait_replica(cluster, router._last_seq)
        cluster.kill_scorer(0)
        reads = router.stats["replica_reads"]
        got = router.search_sparse(ds.q_sparse[rows32], ds.q_dense[rows32])
        same(got, comp.one(ds.q_sparse[rows32], ds.q_dense[rows32]),
             "scorer 0 killed: the replica's full part")
        check(router.stats["replica_reads"] == reads + 32,
              "the replica did not serve the request")
        cluster.kill_primary()
        t0 = time.perf_counter()
        term = router.failover()
        failover_s = time.perf_counter() - t0
        got = router.search_sparse(ds.q_sparse[7:8], ds.q_dense[7:8])
        same(got, comp.one(ds.q_sparse[7:8], ds.q_dense[7:8]),
             "after failover: the new primary's direct path")
        try:
            router.search_sparse(ds.q_sparse[rows32], ds.q_dense[rows32])
            check(False, "a fan-out with scorer 0 dead and no replica "
                         "returned a result")
        except DegradedResultError:
            pass
        status = router.status()
        hops = router.hops()
        score = {name: {"p50_ms": None if st["score_s_p50"] is None
                        else st["score_s_p50"] * 1e3,
                        "p99_ms": None if st["score_s_p99"] is None
                        else st["score_s_p99"] * 1e3}
                 for name, st in stats.items()}
        emit("cluster", rows=ds.x_sparse.shape[0], scorers=scorers,
             replicas=1, disk_free=disk_free, build_s=build_s,
             launch_s=launch_s,
             bootstrap={n: {"seconds": st["bootstrap_s"],
                            "store_bytes_fetched": st["store_bytes_fetched"]}
                        for n, st in boot.items()},
             fan_vs_one_128_queries=fan_one,
             stream={"requests": len(requests), "rows": stream_rows,
                     "first_s": passes[0], "second_s": passes[1],
                     "first_rows_per_s": stream_rows / passes[0],
                     "second_rows_per_s": stream_rows / passes[1]},
             contexts=contexts, hops_s=hops, score_s=score,
             inserts={"rows": CLUSTER_INSERTS, "batch": 16,
                      "ack_p50_ms": percentile_ms(ack_s, 50),
                      "ack_p99_ms": percentile_ms(ack_s, 99)},
             deletes=CLUSTER_DELETES, delta_slots_at_compaction=delta_slots,
             compact_s=compact_s,
             searches_during_compaction=during_compaction,
             failover_s=failover_s, term=term,
             parity_checks=parity_checks, recall_at_20=recall, memory=mem,
             scorer_slice_bytes=slice_bytes,
             scorer_search_transient_bytes=transient,
             index_bytes_over_scorers=storage_bytes(
                 torch, idx.engine.arrays) / scorers,
             node_launches={n: st["kernel_launches"]
                            for n, st in stats.items()},
             launches=launches, router_status=status,
             seconds=time.perf_counter() - t_phase)
        return launches
    except BaseException:
        if cluster is not None:
            for hd in [cluster.primary, *cluster.scorers, *cluster.replicas]:
                with open(hd.log_path, errors="replace") as f:
                    print(f"--- {hd.name} log tail ---\n{f.read()[-3000:]}",
                          file=sys.stderr)
        raise
    finally:
        for r in routers:
            r.close()
        if cluster is not None:
            cluster.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# launch: python -m repro_torch.launch.serve --retrieval, plain / durable /
# restored, --role router and --arch (qwen2-7b-smoke, qwen2-7b and
# qwen2-moe-a2.7b, the PQ head; recurrentgemma-9b-smoke with it,
# mamba2-780m-smoke without), launch.train, launch.dryrun and
# roofline.report, as processes of their own on the card
# ---------------------------------------------------------------------------

LAUNCH_PARALLEL = 5       # the children that share the card at once


def run_launch():
    """The launchers as processes of their own on the card: the retrieval
    modes, the router, the smoke LMs, the training smoke, qwen2-7b at full
    width (a 40 GB peak) and the dry run of stablelm-1.6b (on ``meta``)
    ``LAUNCH_PARALLEL`` at a time, a durable store's restore after its
    bootstrap; then, one at a time with the card to themselves,
    qwen2-moe-a2.7b at full width and depth (its f32 tree handed over to
    the session, a 64 GB peak), the dry run of the 2^26-row shard and the
    roofline report on both dry runs' rows.  Fails unless each exits 0
    and prints what its mode promises; the full-width LMs' peak device
    memory must stay under 70 GB."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="launch-")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = {}
    store = os.path.join(tmp, "store")
    rows, lm_rows = (os.path.join(tmp, f) for f in ("dryrun.jsonl",
                                                     "dryrun_lm.jsonl"))
    serve, train = "repro_torch.launch.serve", "repro_torch.launch.train"
    dryrun = "repro_torch.launch.dryrun"
    report = "repro_torch.roofline.report"

    def child(name, module, extra):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", module, *extra],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=REPO)
        check(r.returncode == 0, f"{module} {name} exited "
              f"{r.returncode}: {r.stderr[-2000:]}")
        lines = [ln for ln in r.stdout.splitlines()
                 if not ln.startswith("stats")]
        res = {"seconds": time.perf_counter() - t0,
               "stdout": [ln[:160] for ln in lines]}
        if name == "router":
            status = [ln for ln in lines
                      if ln.startswith("router status:")]
            check(len(status) == 1 and "'degraded': 0" in status[0],
                  f"launch.serve --role router status: {status}")
            res["status"] = status[0]
        if name.startswith("lm_"):
            gen = [ln for ln in lines if ln.startswith("generated (")]
            head = "pq-hybrid" if "--pq-head" in extra else "exact"
            check(len(gen) == 1 and f"head={head}" in gen[0],
                  f"launch.serve {' '.join(extra)}: {lines}")
            peak = [int(ln.split()[1]) for ln in lines
                    if ln.startswith("max_memory_allocated: ")]
            check(len(peak) == 1 and peak[0] < 70e9,
                  f"launch.serve {' '.join(extra)}: peak {peak}")
            res["max_memory_allocated"] = peak[0]
        if module == train:
            done = [ln for ln in lines if ln.startswith("done: loss ")]
            check(len(done) == 1 and " -> " in done[0],
                  f"launch.train {' '.join(extra)}: {lines}")
        if module == dryrun:
            check(lines[-1].endswith(" ok, 0 skip, 0 fail"),
                  f"launch.dryrun {' '.join(extra)}: {lines[-3:]}")
        if name == "dryrun_retrieval":
            with open(rows) as fh:
                row = json.loads(fh.readline())
            check(row["query_blocks"]["blocks"] == 4,
                  f"launch.dryrun --retrieval: {row['query_blocks']}")
            res["query_blocks"] = row["query_blocks"]
            res["calls"] = {
                form: {call: {k: f[call][k] for k in (
                    "ms", "ms_runs", "rows_per_s", "launches",
                    "max_memory_allocated")}
                    for call in ("pass1", "three_pass")}
                for form, f in row["forms"].items()}
        if module == report:
            table = [ln for ln in lines if ln.startswith("|")]
            check(len(table) == 4
                  and "| hybrid-retrieval-1b | search_q128 |" in table[2]
                  and "| stablelm-1.6b | train_4k |" in table[3],
                  f"roofline.report: {lines}")
            res["table"] = table
        return name, res

    # chains of children: a chain runs in order, chains run at once; the
    # LM dry run (its memory reckoned on meta, the host alone) first, beside
    # the card's children
    small = [
        [("dryrun_stablelm", dryrun, ["--arch", "stablelm-1.6b", "--shape",
                                      "train_4k", "--out", lm_rows])],
        [("plain", serve, ["--retrieval"])],
        [("persist", serve, ["--retrieval", "--persist-dir", store]),
         ("restore", serve, ["--retrieval", "--restore", store])],
        [("router", serve, ["--role", "router"])],
        [("lm_smoke", serve, ["--arch", "qwen2-7b-smoke", "--pq-head"])],
        [("lm_recurrentgemma_smoke", serve,
          ["--arch", "recurrentgemma-9b-smoke", "--pq-head"])],
        [("lm_mamba2_smoke", serve, ["--arch", "mamba2-780m-smoke"])],
        [("train_smoke", train,
          ["--arch", "stablelm-1.6b-smoke", "--steps", "4", "--device",
           "cuda", "--ckpt", os.path.join(tmp, "train")])],
        [("lm_qwen2_7b", serve, ["--arch", "qwen2-7b", "--pq-head",
                                 "--tokens", "8"])]]
    large = [
        ("lm_qwen2_moe", serve, ["--arch", "qwen2-moe-a2.7b", "--pq-head",
                                 "--tokens", "8"]),
        # 4 blocks of 32 queries, beside the dryrun phase's fewest
        ("dryrun_retrieval", dryrun, ["--retrieval", "--query-blocks", "4",
                                      "--out", rows])]
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(LAUNCH_PARALLEL) as pool:
            done = [pool.submit(lambda c: [child(*job) for job in c], chain)
                    for chain in small]
            out.update(res for fut in done for res in fut.result())
        small_s = time.perf_counter() - t0
        out.update(child(*job) for job in large)
        with open(rows, "a") as fh, open(lm_rows) as lm:
            fh.write(lm.read())            # the report: the shard, then lm
        out.update([child("roofline_report", report, [rows])])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("launch", runs=out, parallel=LAUNCH_PARALLEL,
         shared_children_s=small_s, seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# reference_store: the JAX package's committed store, recovered on the card
# ---------------------------------------------------------------------------

def neighbour_swaps(got_ids, want_ids, want_s) -> int:
    """Ids must equal the reference's, except that two neighbours whose
    reference scores differ by less than ATOL may trade places; returns the
    number of such swaps and raises on any other difference."""
    swaps = 0
    for r in range(want_ids.shape[0]):
        p = 0
        while p < want_ids.shape[1]:
            if got_ids[r, p] == want_ids[r, p]:
                p += 1
                continue
            q = p + 1
            check(q < want_ids.shape[1]
                  and got_ids[r, p] == want_ids[r, q]
                  and got_ids[r, q] == want_ids[r, p]
                  and abs(want_s[r, p] - want_s[r, q]) < ATOL,
                  f"row {r} position {p}: id {got_ids[r, p]} where the "
                  f"reference has {want_ids[r, p]}, not a neighbour swap")
            swaps += 1
            p += 2
    return swaps


def run_reference_store(torch):
    import shutil
    import tempfile

    import scipy.sparse as sp

    from repro_torch import persist
    from repro_torch.core.engine import ScoringEngine
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import PLAIN_CALLS

    data = os.path.join(REPO, "tests", "data")
    e = np.load(os.path.join(data, "reference_store_expected.npz"))
    q = sp.csr_matrix((e["q_data"], e["q_indices"], e["q_indptr"]),
                      shape=tuple(e["q_shape"]))
    kw = dict(h=int(e["h"]), alpha=int(e["alpha"]), beta=int(e["beta"]))
    want_ids, want_s = e["ids"], e["scores"]
    tmp = tempfile.mkdtemp(prefix="refstore-")
    try:
        root = os.path.join(tmp, "store")
        shutil.copytree(os.path.join(data, "reference_store"), root)
        rec = persist.recover(root, backend="cuda", device="cuda")
        rec.durability.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(rec.replayed == int(e["replayed"]), "WAL records replayed")
    idx = rec.index
    out = {}
    for name, fused in (("fused", True), ("materialised", False)):
        idx.engine = ScoringEngine(arrays=idx.engine.arrays,
                                   backend=idx.engine.backend, fused=fused)
        torch.cuda.synchronize()
        ops.reset_counts()
        res = idx.search(q, e["q_dense"], **kw)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        check(sum(PLAIN_CALLS.values()) == 0, "a plain version ran")
        check(launches["block_sparse_matmul"] >= 1
              and launches["score_inverted_vf"] >= 1
              and launches["lut16_adc_topk" if fused else "lut16_adc"] >= 1,
              f"{name}: the kernels did not run: {launches}")
        fin = np.isfinite(want_s)
        check(np.array_equal(np.isfinite(res.scores), fin),
              f"{name}: -inf slots differ")
        err = np.abs(res.scores - want_s)[fin]
        check(bool((err <= ATOL + RTOL * np.abs(want_s[fin])).all()),
              f"{name}: scores beyond rtol {RTOL} atol {ATOL}")
        out[name] = {"launches": launches,
                     "neighbour_swaps": neighbour_swaps(res.ids, want_ids,
                                                        want_s),
                     "ids_equal": bool(np.array_equal(res.ids, want_ids)),
                     "max_abs_err": float(err.max(initial=0.0))}
    emit("reference_store", rows=idx.num_points,
         delta_rows=idx.mutable_state.delta.live_count,
         replayed=rec.replayed, queries=int(q.shape[0]), results=out)


# ---------------------------------------------------------------------------
# lm_head: the PQ LM head (serve/hybrid_head.py) at published widths, K1 at
# the head's K through its wide variant
# ---------------------------------------------------------------------------

# three configs of repro_torch.configs at their published widths (d_model,
# vocab_size); K = d / 2 subspaces of l = 16
LM_HEADS = ("qwen2-7b", "qwen2.5-14b", "deepseek-67b")
# what one approx_topk (and one PQ decode step) launches once each: R0, K1,
# R1, R3
PQ_STEP_KERNELS = ("adc_lut", "lut16_adc", "dense_residual", "gathered_dot")
LM_BATCHES = (1, 8, 32)


def head_k1_reading(torch, ops, ref, hp, lut, sms) -> dict:
    """K1 on the head's codes and a batch's LUT, bit for bit with its plain
    version; ms beside its bound, the plain version (one call) and
    ``embedding_bag`` (mode sum over the (subspace, code) rows of the
    (Q, K * 16) LUT); the plan with the occupancy calculator's CTAs."""
    from repro_torch.kernels import lut16
    codes, packed = hp.codes, hp.codes_packed
    qn, k_sub, _ = lut.shape
    nn, kc = codes.shape
    lut_p = ops._validate_packed(kc, k_sub, 16, lut, packed).contiguous()
    got = ops.lut16_adc(codes, lut, packed=packed)
    # the plain version (K launches of gathers) is timed on this one call
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    want = ref.lut16_adc_plain(codes, lut_p, packed=packed)
    t1.record()
    t1.synchronize()
    check(torch.equal(got, want), f"K1 != plain on the head, Q = {qn}")
    unpacked = ops.unpack_codes(codes, k_sub) if packed else codes
    e_idx = unpacked.long() + 16 * torch.arange(k_sub, device="cuda")
    e_w = lut.permute(1, 2, 0).reshape(k_sub * 16, qn).contiguous()

    def bag():
        return torch.nn.functional.embedding_bag(e_idx, e_w, mode="sum")

    assert_close(bag().T, want, "embedding_bag yardstick")
    plan = lut16.plan_adc(qn, nn, kc, lut_p.shape[1], sms, packed)
    ctas = lut16.adc_ctas_per_sm(plan.bq, packed, kc, lut_p.shape[1],
                                 plan.threads, plan.chunk)
    check(ctas == plan.ctas_per_sm, "K1 head plan: CTAs differ from the "
          "occupancy calculator's")
    out = {"ms": cuda_ms(lambda: ops.lut16_adc(codes, lut, packed=packed)),
           "plain_ms": t0.elapsed_time(t1),
           "library_ms": cuda_ms(bag),
           "bound_ms": max((nn * kc + 4 * qn * nn) / HBM_BYTES_PER_S,
                           qn * nn * k_sub / F32_ADDS_PER_S) * 1e3,
           "max_abs_err": max_abs(got, want),
           "plan": {"bq": plan.bq, "threads": plan.threads,
                    "chunk": plan.chunk, "chunks": plan.chunks(kc),
                    "rows_per_cta": plan.rows_per_cta,
                    "smem_bytes": plan.smem_bytes,
                    "warps_per_sm": ctas * plan.threads // 32}}
    out["bound_by"] = ("bytes" if (nn * kc + 4 * qn * nn) / HBM_BYTES_PER_S
                       >= qn * nn * k_sub / F32_ADDS_PER_S else "operations")
    return out


def run_lm_head(torch) -> dict:
    """The PQ LM head at the widths of ``LM_HEADS``' configs (d_model,
    vocab_size), random weights from a seeded
    ``torch.Generator`` on the card, built and served on ``cuda`` and on
    ``cuda-packed``: build seconds by stage; ``approx_topk`` (k = 50,
    alpha = 8) at B = 1, 8, 32, f32 and with the bf16 pass 3, against
    ``exact_topk`` in f32 (medians of CUDA-event readings); K1 at each
    shape (``head_k1_reading``); top-1 agreement and recall@50 against
    ``exact_topk`` at B = 32; ``max_memory_allocated``.  Fails unless each
    ``approx_topk`` launches K1, R0, R1 and R3 exactly once each and
    nothing else, returns the ``ref`` backend's ids on the same params
    (f32, B = 8; scores within rtol / atol), and ``approx_topk_bucketed``
    returns ``approx_topk``'s results on ragged batches bit for bit (the
    LUT and passes 2-3 sum in a fixed order, so padding changes no bit).
    Each head is freed before the next is built.  Returns the launches of
    each of the four kernels."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.pq import adc_lut
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ref import PLAIN_CALLS
    from repro_torch.serve import HybridLMHead
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k, alpha = 50, 8
    heads, launches = {}, dict.fromkeys(PQ_STEP_KERNELS, 0)
    for name in LM_HEADS:
        cfg = get_config(name)
        d, v = cfg.d_model, cfg.vocab_size
        f32 = dataclasses.replace(cfg, dtype="float32")
        bf16 = dataclasses.replace(cfg, dtype="bfloat16")
        g = torch.Generator(device="cuda").manual_seed(d)
        lm_head = torch.randn((d, v), generator=g, device="cuda") / math.sqrt(d)
        hidden = torch.randn((max(LM_BATCHES), d), generator=g,
                             device="cuda")
        ragged = torch.randn((40, d), generator=g, device="cuda")
        row = {"d": d, "V": v, "K": d // 2}
        t_head = time.perf_counter()
        for backend in ("cuda", "cuda-packed"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            head = HybridLMHead(f32, backend=backend)
            t0 = time.perf_counter()
            hp = head.build(lm_head, device="cuda")
            build_s = time.perf_counter() - t0
            where = f"{name} on {backend}"
            # the main path: one approx_topk, every count at zero before it
            ops.reset_counts()
            s, i = head.approx_topk(hp, hidden, None, k, alpha)
            torch.cuda.synchronize()
            got = dict(ops.LAUNCHES)
            check(all(got[n] == 1 for n in PQ_STEP_KERNELS)
                  and sum(got.values()) == len(PQ_STEP_KERNELS)
                  and sum(PLAIN_CALLS.values()) == 0,
                  f"{where}: approx_topk launched {got}, plain "
                  f"{dict(PLAIN_CALLS)}")
            for n in PQ_STEP_KERNELS:
                launches[n] += got[n]
            check(tuple(i.shape) == (max(LM_BATCHES), k)
                  and bool(torch.isfinite(s).all())
                  and bool(((i >= 0) & (i < v)).all()),
                  f"{where}: approx_topk is not finite ({max(LM_BATCHES)}, "
                  f"{k}) ids of the vocabulary")
            # the ref backend on the same params (its scan gathers a
            # (B, V, K) f32 block: B = 8)
            cs, ci = head.approx_topk(hp, hidden[:8], None, k, alpha)
            rs, ri = HybridLMHead(f32, backend="ref").approx_topk(
                hp, hidden[:8], None, k, alpha)
            check(torch.equal(ci, ri), f"{where}: ids != the ref backend's")
            ref_err = assert_close(cs, rs, f"{where}: scores vs ref")
            for b in (3, 20, 40):
                want = head.approx_topk(hp, ragged[:b], None, k, alpha)
                got_b = head.approx_topk_bucketed(hp, ragged[:b], None, k,
                                                  alpha)
                check(torch.equal(got_b[0], want[0])
                      and torch.equal(got_b[1], want[1]),
                      f"{where}: bucketed B = {b} != approx_topk")
            es, ei = head.exact_topk(hp, hidden, None, k)
            ids, eids = i.cpu().numpy(), ei.cpu().numpy()
            quality = {
                "top1_agreement": float((ids[:, 0] == eids[:, 0]).mean()),
                "recall_at_50": float(np.mean([
                    len(set(a.tolist()) & set(e.tolist())) / k
                    for a, e in zip(ids, eids)]))}
            head_bf16 = HybridLMHead(bf16, backend=backend)
            by_b = {}
            for b in LM_BATCHES:
                hb = hidden[:b]
                ops.reset_counts()
                head.approx_topk(hp, hb, None, k, alpha)
                torch.cuda.synchronize()
                check(ops.LAUNCHES["lut16_adc"] == 1,
                      f"{where}: B = {b} launched K1 "
                      f"{ops.LAUNCHES['lut16_adc']} times")
                by_b[str(b)] = {
                    "approx_ms": cuda_ms(lambda: head.approx_topk(
                        hp, hb, None, k, alpha)),
                    "approx_bf16_pass3_ms": cuda_ms(
                        lambda: head_bf16.approx_topk(hp, hb, None, k,
                                                      alpha)),
                    "exact_ms": cuda_ms(lambda: head.exact_topk(
                        hp, hb, None, k)),
                    "k1": head_k1_reading(torch, ops, ref, hp,
                                          adc_lut(hb, hp.codebooks), sms)}
            row[backend] = {
                "k1_launches_per_call": 1,
                "build_s": build_s, "build_stage_s": hp.build_seconds,
                "codes_bytes": tensor_bytes(hp.codes),
                "params_device_bytes": tensor_bytes(hp),
                "ref_max_abs_err": ref_err, "bucketed_equal": True,
                **quality, "by_batch": by_b,
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
            del hp, s, i, cs, ci, rs, ri, es, ei
        heads[name] = row
        emit("lm_head", config=name, seconds=time.perf_counter() - t_head,
             **row)
        del lm_head, hidden, ragged
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


# ---------------------------------------------------------------------------
# lm_decode: the dense LM zoo's decode loop (serve/serving.py) at qwen2-7b's
# full width and depth, through the exact head and the PQ head (K1 a step)
# ---------------------------------------------------------------------------

DENSE_SMOKES = ("qwen2-7b-smoke", "stablelm-1.6b-smoke", "qwen2.5-14b-smoke",
                "deepseek-67b-smoke")
DECODE_ARCH = "qwen2-7b"
DECODE_BATCHES = (1, 32)
DECODE_PROMPT, DECODE_TOKENS, DECODE_MAX_LEN = 16, 32, 128
DECODE_REL = 3e-2       # tests/test_models.py:72-73, decode against forward
DECODE_REL_F32 = 1e-4   # the same check in f32: tests/test_torch_models.py


def model_batch(torch, cfg, g, b, s) -> dict:
    """Seeded inputs of the config's frontend on the card: token ids (B, S)
    or embeddings (B, S, D), and ``cond`` (B, Tc, D) where its layers
    attend over one."""
    if cfg.frontend == "tokens":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=g, device="cuda")}
    else:
        batch = {"embeds": torch.randn((b, s, cfg.d_model), generator=g,
                                       device="cuda")}
    if cfg.num_cond_tokens:
        batch["cond"] = torch.randn((b, cfg.num_cond_tokens, cfg.d_model),
                                    generator=g, device="cuda")
    return batch


@contextlib.contextmanager
def moe_routes():
    """While open, every MoE layer call also routes its input through
    ``moe_route`` and appends (its tokens' top-k expert ids, sorted,
    (B, S, k); whether each assignment is within capacity, (B, S k)) to
    the yielded list."""
    from repro_torch.models import mlp as mlp_mod
    routes, moe = [], mlp_mod.moe

    def recording(x, p, cfg):
        _, _, ids, _, in_cap, _ = mlp_mod.moe_route(x, p, cfg)
        routes.append((ids.reshape(x.shape[0], x.shape[1], -1).sort(-1)
                       .values, in_cap))
        return moe(x, p, cfg)

    mlp_mod.moe = recording
    try:
        yield routes
    finally:
        mlp_mod.moe = moe


def decode_vs_forward(torch, model, params, g, b=2, s=32,
                      flips: list | None = None) -> float:
    """prefill(S - 1) + decode(1) against the teacher-forced forward's last
    position, on random inputs: the max relative error, as the reference's
    test_decode_matches_forward reads it.  ``flips`` (MoE models) receives,
    a MoE layer each, the prompt tokens (of B (S - 1)) whose top-k experts
    differ between the forward and the prefill, and the last tokens (of B)
    whose top-k differ between the forward and the decode step: where the
    two routes part."""
    batch = model_batch(torch, model.cfg, g, b, s)
    with moe_routes() as routes:
        full, _ = model.forward(params, batch)
        want = full[:, -1].float()
        del full
        key = "tokens" if "tokens" in batch else "embeds"
        pre = {**batch, key: batch[key][:, :s - 1]}
        n = len(routes)
        _, state = model.prefill(params, pre, 64)
        last = (batch[key][:, s - 1] if key == "tokens"
                else batch[key][:, s - 1:s])
        got, _ = model.decode_step(params, state, last)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{model.cfg.name}: decode logits {tuple(got.shape)} are not "
          f"finite {tuple(want.shape)}")
    if flips is not None:
        ids = [r[0] for r in routes]
        fwd, prompt, step = ids[:n], ids[n:2 * n], ids[2 * n:]
        flips += [{"prompt": int((f[:, :s - 1] != p).any(-1).sum()),
                   "last": int((f[:, s - 1:] != d).any(-1).sum())}
                  for f, p, d in zip(fwd, prompt, step)]
    return float((got.float() - want).abs().max() / want.abs().max())


def smoke_decode_rels(torch, names) -> dict:
    """decode against forward in f32 on each smoke config (MoE at
    capacity_factor 16, as the reference's test): the rel of each, held
    under ``DECODE_REL_F32``."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    rels = {}
    for name in names:
        cfg = dataclasses.replace(get_config(name), dtype="float32")
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, capacity_factor=16.0)
        model = Model(cfg)
        g = torch.Generator(device="cuda").manual_seed(cfg.d_model)
        rel = decode_vs_forward(torch, model,
                                model.init(g, device="cuda"), g)
        check(rel < DECODE_REL_F32,
              f"{name} (f32): decode vs forward rel {rel}")
        rels[name] = rel
    return rels


def token_spread(tokens) -> dict:
    """How far a route's greedy tokens vary: distinct tokens in each row
    (min / median / max over the batch) and in the whole batch."""
    rows = [len(set(r)) for r in tokens.tolist()]
    return {"per_row_min_median_max": [min(rows), statistics.median(rows),
                                       max(rows)],
            "batch": len(set(tokens.flatten().tolist()))}


def top1_margins(torch, model, params, prompt, tokens) -> dict:
    """The exact head's top-1 margin (top-1 minus top-2 logit, in the
    compute dtype's logits) at each generated position, from one
    teacher-forced forward over the prompt and the exact route's tokens:
    min / median / max, the share of ties, and the logits' std for scale.
    A PQ head can only disagree where this margin is below its error."""
    seq = torch.cat([prompt, tokens[:, :-1].long()], dim=1)
    full, _ = model.forward(params, {"tokens": seq})
    lg = full[:, prompt.shape[1] - 1:].float()
    del full
    top2 = lg.topk(2, dim=-1).values
    m = (top2[..., 0] - top2[..., 1]).flatten()
    return {"min_median_max": [float(m.min()), float(m.median()),
                               float(m.max())],
            "tie_share": float((m == 0).float().mean()),
            "logit_std": float(lg.std())}


def lockstep_decode(torch, ops, routes: dict, prompt) -> dict:
    """``greedy_generate``'s loop, spelled out, on each route of ``routes``
    (name -> (session, use_pq_head)), the routes in lockstep: each step,
    every route takes its step in turn, the order alternating from step to
    step so that the host's drift falls on all of them alike.  A CUDA event
    pair spans each step's ``decode_step`` + ``next_token`` + count bump
    (the host's work included); each step's launch counts are read after
    it.  Returns name -> (tokens, per-step ms, per-step K1 launches, a
    function that runs one more step)."""
    from repro_torch.kernels.ref import PLAIN_CALLS
    from repro_torch.serve.serving import _bump, _last_hidden

    def start(sess, pq):
        model = sess.model
        batch = {"tokens": prompt}
        logits, state = sess.prefill(batch)
        counts = torch.zeros((prompt.shape[0], model.cfg.vocab_size),
                             device="cuda")
        _bump(counts, prompt)
        tok = sess.next_token(_last_hidden(model, sess.params, batch) if pq
                              else logits, counts)
        _bump(counts, tok[:, None])
        loop = {"state": state, "tok": tok, "out": [tok], "ms": [],
                "k1": []}

        def step():
            y, loop["state"] = model.decode_step(sess.params, loop["state"],
                                                 loop["tok"], pq)
            loop["tok"] = sess.next_token(y, counts)
            _bump(counts, loop["tok"][:, None])
            return loop["tok"]

        loop["step"] = step
        return loop

    loops = {name: start(*route) for name, route in routes.items()}
    for i in range(DECODE_TOKENS - 1):
        for name in (list(loops) if i % 2 == 0 else list(loops)[::-1]):
            loop = loops[name]
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ops.reset_counts()
            a.record()
            loop["out"].append(loop["step"]())
            b.record()
            b.synchronize()
            loop["ms"].append(a.elapsed_time(b))
            loop["k1"].append(ops.LAUNCHES["lut16_adc"])
            check(all(ops.LAUNCHES[n] == loop["k1"][-1]
                      for n in PQ_STEP_KERNELS)
                  and sum(ops.LAUNCHES.values())
                  == len(PQ_STEP_KERNELS) * loop["k1"][-1]
                  and sum(PLAIN_CALLS.values()) == 0,
                  f"{name}: a decode step launched {dict(ops.LAUNCHES)}, "
                  f"plain {dict(PLAIN_CALLS)}")
    return {name: (torch.stack(loop["out"], dim=1).to(torch.int32),
                   loop["ms"], loop["k1"], loop["step"])
            for name, loop in loops.items()}


def moe_drop_share(torch, sess) -> dict:
    """The (token, expert) assignments that a prefill of 32 seeded prompts
    of 16 tokens drops at the config's own capacity_factor, over every MoE
    layer (``moe_routes``)."""
    cfg = sess.model.cfg
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size,
                           (max(DECODE_BATCHES), DECODE_PROMPT),
                           generator=g, device="cuda")
    with moe_routes() as routes:
        sess.prefill({"tokens": prompt})
    total = sum(cap.numel() for _, cap in routes)
    dropped = total - sum(int(cap.sum()) for _, cap in routes)
    return {"assignments": total, "dropped": dropped,
            "dropped_share": dropped / total, "moe_layers": len(routes),
            "capacity_factor": sess.model.cfg.capacity_factor}


# ---------------------------------------------------------------------------
# the dry run's memory proof held to the card: a step's reckoned
# temp + output - alias (launch.dryrun.reckon_memory on a one-device mesh)
# against max_memory_allocated() - memory_allocated() around the step
# ---------------------------------------------------------------------------

MEM_BAND = (0.85, 1.15)     # measured / reckoned
def step_peak(torch, fn, *args) -> int:
    """What one call of ``fn(*args)`` adds at its peak to the memory
    allocated before it, its result included."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def memory_reading(mem: dict, measured: int, reckon_s: float,
                   hidden: dict | None = None) -> dict:
    """One step's reckoned ``temp + output - alias`` beside its measured
    peak increase (and, from ``tools/memory_probe.py``, the ops that held
    buffers of their own)."""
    reckoned = mem["mem_temp"] + mem["mem_output"] - mem["mem_alias"]
    out = {"reckoned": reckoned, "measured": measured,
           "ratio": measured / reckoned, **mem, "reckon_seconds": reckon_s}
    if hidden is not None:
        out["hidden_buffers"] = hidden
    return out


def check_memory_band(phase: str, readings: dict) -> None:
    check(all(MEM_BAND[0] <= r["ratio"] <= MEM_BAND[1]
              for r in readings.values()),
          f"{phase}: measured / reckoned peak increase outside {MEM_BAND}: "
          + json.dumps({k: {f: r[f] for f in ("reckoned", "measured",
                                              "ratio", "hidden_buffers")
                            if f in r}
                        for k, r in readings.items()}))


def decode_memory_proof(torch, model, cfg, params, prompts,
                        hidden=None) -> dict:
    """The dry run's decode cell (f32 params, the config's bf16 compute, an
    empty state of ``DECODE_MAX_LEN`` slots) reckoned at B = 1 and 32 on a
    one-device mesh, against one ``decode_step`` on ``params`` (the f32
    tree on the card) from a warmed state; fails outside ``MEM_BAND``.
    ``hidden(torch, fn, *args)``, where given, names the ops of one more
    step that held buffers of their own."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import reckon_memory
    from repro_torch.launch.mesh import make_test_mesh

    readings = {}
    for b in DECODE_BATCHES:
        t0 = time.perf_counter()
        mem = reckon_memory(cfg, ShapeConfig(f"decode_b{b}", DECODE_MAX_LEN,
                                             b, "decode"),
                            make_test_mesh((1, 1)))
        reckon_s = time.perf_counter() - t0
        state = model.init_decode_state(params, b, DECODE_MAX_LEN)
        token = prompts[b][:, 0].to(torch.int32)
        model.decode_step(params, state, token)          # warm
        measured = step_peak(torch, model.decode_step, params, state, token)
        found = (hidden(torch, model.decode_step, params, state, token)
                 if hidden else None)
        del state
        readings[f"B{b}"] = memory_reading(mem, measured, reckon_s, found)
    check_memory_band(f"{cfg.name} decode", readings)
    return {"readings": readings, "band": MEM_BAND,
            "mesh": "1x1", "nvidia_smi": smi_line()}


def decode_cell(torch, cfg, *, pq: bool, check_cfg=None,
                memory_proof: bool = False) -> tuple:
    """One model's decode loop at ``cfg``'s width and depth, random weights
    from ``Model.init`` with a seeded ``torch.Generator`` on the card, in
    the config's bf16 from ``ServeSession.create`` on.  Each session is
    reached without holding two trees: the seeded f32 tree is handed over
    (``donate=True``) and cast in place.  First decode against forward on
    the f32 tree in f32 (on ``check_cfg``'s model when given: MoE at a
    raised capacity_factor), within 1e-4, and with ``memory_proof`` the
    dry run's reckoning held to one step on it (``decode_memory_proof``);
    then the main path, as a user
    calls it: ``greedy_generate(donate=True)`` at B = 1 and 32 with the
    exact head and, with ``pq``, the PQ head (``cuda``: K1 at K = d / 2 a
    step), each on the seeded tree drawn anew; then one session (its PQ
    head built once, as ``greedy_generate`` builds it) from the tree drawn
    once more, and the exact route on its bf16 layers.  Fails unless
    decode equals forward within the reference's rel 3e-2 in bf16 (the
    failure names, for a MoE model, the route flips below), every PQ step launches K1 exactly once and the exact route never, the
    spelled-out timed loop (``lockstep_decode``) gives ``greedy_generate``'s
    tokens, and one step of each route runs under
    ``set_sync_debug_mode("error")``.  Reports, at B = 1 and 32, ms a step
    (median of CUDA-event readings, host work included, the routes in
    lockstep), tokens/s, the head's ms inside a step, launches and device
    time a step (torch.profiler), the distinct tokens of each route, the
    exact head's top-1 margins, PQ-vs-exact agreement, K1 at the head's
    shapes (``head_k1_reading``) and, for a MoE model, the tokens whose
    top-k experts differ between decode and forward, layer by layer, in
    bf16.  Returns (the cell's fields, K1's launches on the main path, the
    session)."""
    from repro_torch.core.pq import adc_lut
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ref import PLAIN_CALLS
    from repro_torch.models import Model
    from repro_torch.models.common import compute_dtype
    from repro_torch.serve import ServeSession, greedy_generate

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    model = Model(cfg)

    def seeded_tree():
        """The f32 tree of seed 0, drawn anew on the card."""
        gc.collect()
        torch.cuda.empty_cache()
        return model.init(torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")

    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_bytes = tensor_bytes(params)
    prompts = {b: torch.randint(0, cfg.vocab_size, (b, DECODE_PROMPT),
                                generator=g, device="cuda")
               for b in DECODE_BATCHES}
    route_list = (("exact", False), ("pq", True)) if pq else (
        ("exact", False),)

    # decode against forward on the f32 tree in f32, before any cast: what
    # the bf16 check below leaves to rounding
    f32_cfg = dataclasses.replace(check_cfg or cfg, dtype="float32")
    rel_f32 = decode_vs_forward(torch, Model(f32_cfg), params, g)
    check(rel_f32 < DECODE_REL_F32,
          f"{cfg.name} (f32): decode vs forward rel {rel_f32}")
    mem_proof = (decode_memory_proof(torch, model, cfg, params, prompts)
                 if memory_proof else None)

    # the main path, as a user calls it: greedy_generate on the f32 tree,
    # handed over, every count at zero just before each call
    launches, tokens = 0, {}
    for b in DECODE_BATCHES:
        for route, use_pq in route_list:
            if params is None:
                params = seeded_tree()
            ops.reset_counts()
            toks = greedy_generate(model, params, prompts[b], DECODE_TOKENS,
                                   DECODE_MAX_LEN, use_pq_head=use_pq,
                                   donate=True)
            torch.cuda.synchronize()
            params = None            # the session's tree: it goes here
            got = dict(ops.LAUNCHES)
            want_k1 = DECODE_TOKENS if use_pq else 0
            check(all(got[n] == want_k1 for n in PQ_STEP_KERNELS)
                  and sum(got.values()) == len(PQ_STEP_KERNELS) * want_k1
                  and sum(PLAIN_CALLS.values()) == 0,
                  f"{cfg.name} {route}, B = {b}: greedy_generate launched "
                  f"{got} (K1 {want_k1} expected), plain "
                  f"{dict(PLAIN_CALLS)}")
            launches += got["lut16_adc"]
            check(tuple(toks.shape) == (b, DECODE_TOKENS)
                  and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                  f"{cfg.name} {route}, B = {b}: tokens "
                  f"{tuple(toks.shape)} outside the vocabulary")
            tokens[b, route] = toks

    # the timed loop's session: one build of the PQ head from the f32
    # lm_head, then the tree cast in place; the exact route on its layers
    params = seeded_tree()
    t0 = time.perf_counter()
    sess = ServeSession.create(model, params, DECODE_MAX_LEN,
                               use_pq_head=pq,
                               head_backend="cuda" if pq else None,
                               donate=True)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    del params
    exact_sess = dataclasses.replace(sess, pq_head=None, pq_params=None)
    flips = [] if cfg.family == "moe" else None
    rel = decode_vs_forward(torch, Model(check_cfg or cfg), sess.params, g,
                            flips=flips)
    check(rel < DECODE_REL, f"{cfg.name}: decode vs forward rel {rel} >= "
          f"{DECODE_REL}" + (f"; route flips by layer {flips}" if flips
                             else ""))

    by_b = {}
    for b in DECODE_BATCHES:
        prompt = prompts[b]
        sessions = {"exact": (exact_sess, False)}
        if pq:
            sessions["pq"] = (sess, True)
        routes, spread = {}, {}
        timed = lockstep_decode(torch, ops, sessions, prompt)
        for route, (r_sess, use_pq) in sessions.items():
            t_toks, ms, k1, step = timed[route]
            check(torch.equal(t_toks, tokens[b, route]),
                  f"{cfg.name} {route}, B = {b}: the timed loop's tokens "
                  f"differ from greedy_generate's")
            check(all(n == (1 if use_pq else 0) for n in k1),
                  f"{cfg.name} {route}, B = {b}: K1 launches a step {k1}")
            if b == DECODE_BATCHES[0]:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            # the head inside a step, on this route's last hidden state
            hidden, _ = model.decode_step(
                r_sess.params, model.init_decode_state(
                    r_sess.params, b, DECODE_MAX_LEN), t_toks[:, -1], True)
            counts = torch.zeros((b, cfg.vocab_size), device="cuda")
            if use_pq:
                head_ms = cuda_ms(lambda: r_sess.next_token(hidden, counts))
                k1_reading = head_k1_reading(
                    torch, ops, ref, r_sess.pq_params,
                    adc_lut(hidden, r_sess.pq_params.codebooks), sms)
            else:
                h16 = hidden.to(compute_dtype(cfg))[:, None]
                head_ms = cuda_ms(lambda: r_sess.next_token(
                    model._head(r_sess.params, h16)[:, 0], counts))
            prof = device_profile(torch, step)
            prof.pop("k2", None)
            step_ms = statistics.median(ms)
            routes[route] = {
                "step_ms": step_ms,
                "step_ms_p10_p90": [float(np.percentile(ms, 10)),
                                    float(np.percentile(ms, 90))],
                "tokens_per_s": b * 1e3 / step_ms,
                "head_ms": head_ms, "head_share": head_ms / step_ms,
                "k1_launches_per_step": k1[0], "profile": prof}
            if use_pq:
                routes[route]["k1"] = k1_reading
            spread[route] = token_spread(tokens[b, route])
        row = {"distinct_tokens": spread,
               "exact_top1_margin": top1_margins(
                   torch, model, exact_sess.params, prompt,
                   tokens[b, "exact"]),
               **routes}
        if pq:
            row["pq_exact_token_agreement"] = float(
                (tokens[b, "exact"] == tokens[b, "pq"]).float().mean())
        by_b[str(b)] = row
    fields = {"config": cfg.name, "family": cfg.family,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "dtype": cfg.dtype,
              "decode_rel": rel, "decode_bound": DECODE_REL,
              "decode_rel_f32": rel_f32,
              "decode_f32_bound": DECODE_REL_F32, "init_s": init_s,
              "params_f32_bytes": params_bytes,
              "session_create_s": create_s,
              "session_device_bytes": tensor_bytes(sess.params)
              + (tensor_bytes(sess.pq_params) if pq else 0),
              "by_batch": by_b}
    if mem_proof is not None:
        fields["memory_proof"] = mem_proof
    if flips is not None:
        fields["route_flips_bf16"] = flips
    if pq:
        fields["head_build_s"] = sum(sess.pq_params.build_seconds.values())
        fields["head_build_stage_s"] = sess.pq_params.build_seconds
    return fields, launches, sess


def run_lm_decode(torch) -> dict:
    """The decode loop at qwen2-7b's full width and depth (28 layers, d 3584,
    GQA 28 / 4, d_ff 18944, V 152064) through ``decode_cell`` with the exact
    and the PQ head, and decode against forward within 1e-4 on the four
    dense smoke configs in f32.  Fails unless ``max_memory_allocated``
    stays under 70 GB.  Returns K1's launches on the main path."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    smokes = smoke_decode_rels(torch, DENSE_SMOKES)
    fields, launches, _ = decode_cell(torch, get_config(DECODE_ARCH),
                                      pq=True, memory_proof=True)
    peak = torch.cuda.max_memory_allocated()
    check(peak < 70e9, f"lm_decode max_memory_allocated {peak} >= 70 GB")
    emit("lm_decode", **fields, prompt=DECODE_PROMPT,
         new_tokens=DECODE_TOKENS, max_len=DECODE_MAX_LEN,
         smoke_f32_decode_rel=smokes,
         smoke_f32_decode_bound=DECODE_REL_F32, max_memory_allocated=peak,
         seconds=time.perf_counter() - t_phase)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# lm_families: the other families of the LM zoo; recurrentgemma-9b and
# qwen2-moe-a2.7b at full width and depth through the exact and the PQ head
# (K1 at V = 256000, K = 2048 and at V = 151936, K = 1024 a step), and
# mamba2-780m at full size through the exact head
# ---------------------------------------------------------------------------

FAMILY_SMOKES = ("qwen2-moe-a2.7b-smoke", "qwen3-moe-235b-a22b-smoke",
                 "mamba2-780m-smoke", "recurrentgemma-9b-smoke",
                 "llama-3.2-vision-90b-smoke", "musicgen-medium-smoke")
FAMILY_ARCH = "recurrentgemma-9b"      # 12 x (rglru, rglru, lattn) + 2
SSM_ARCH = "mamba2-780m"               # 48 ssd layers
MOE_ARCH = "qwen2-moe-a2.7b"           # 24 moe layers, 60 experts top-4
FAMILY_PEAK_BOUND = 70e9


def run_lm_families(torch) -> dict:
    """The other families through ``decode_cell``: recurrentgemma-9b at full
    width and depth (RG-LRU, the local-attention ring at W = max_len 128,
    MQA at head_dim 256, GeGLU; V 256000) and qwen2-moe-a2.7b at full width
    and depth (24 layers of 60 routed experts top-4 and 4 shared; V 151936;
    decode held to forward at capacity_factor 16, with the layers where
    the two routes send a token to other experts; the prompt's prefill
    read for dropped assignments at its own 1.25), each with the exact and
    the PQ head; mamba2-780m at full width and depth with the exact head;
    decode against forward within 1e-4 on the six smoke configs of these
    families in f32 (``cond`` and ``embeds`` seeded where the config takes
    them).  Fails unless each cell's ``max_memory_allocated`` stays under
    70 GB.  Returns K1's launches on the main path."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    smokes = smoke_decode_rels(torch, FAMILY_SMOKES)
    cells = {}
    launches = 0
    for cfg, pq in ((get_config(FAMILY_ARCH), True),
                    (get_config(SSM_ARCH), False),
                    (get_config(MOE_ARCH), True)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        check_cfg = (dataclasses.replace(cfg, capacity_factor=16.0)
                     if cfg.family == "moe" else None)
        fields, k1, sess = decode_cell(torch, cfg, pq=pq,
                                       check_cfg=check_cfg)
        launches += k1
        if cfg.family == "moe":
            fields["prefill_drops"] = moe_drop_share(torch, sess)
            fields["cut"] = None
        peak = torch.cuda.max_memory_allocated()
        check(peak < FAMILY_PEAK_BOUND, f"lm_families {cfg.name} "
              f"max_memory_allocated {peak} >= 70 GB")
        cells[cfg.name] = {**fields, "max_memory_allocated": peak,
                           "seconds": time.perf_counter() - t0}
        del sess
    emit("lm_families", cells=cells, prompt=DECODE_PROMPT,
         new_tokens=DECODE_TOKENS, max_len=DECODE_MAX_LEN,
         smoke_f32_decode_rel=smokes, smoke_f32_decode_bound=DECODE_REL_F32,
         peak_bound=FAMILY_PEAK_BOUND,
         seconds=time.perf_counter() - t_phase)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# train: the training stack (Model.loss, AdamW, Trainer, checkpoints) with
# stablelm-1.6b at full width and depth, a resume on the card, and the six
# family smokes' steps on the card against the CPU
# ---------------------------------------------------------------------------

TRAIN_ARCH = "stablelm-1.6b"           # 24 x (LayerNorm, MHA 32/32, d_ff 5632)
TRAIN_B, TRAIN_S = 8, 512              # 4096 tokens a step, one loss chunk
TRAIN_STEPS = 12                       # step 0 warms up; 1-11 are timed
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2       # cosine to lr_min at TRAIN_STEPS
TRAIN_PEAK_BOUND = 70e9
BF16_PEAK_FLOPS = H100["peak_flops"]   # H100 SXM dense bf16
RESUME_LAYERS, RESUME_AT, RESUME_STEPS = 2, 2, 4
FAMILY_STEP_RTOL = 1e-4


def train_flops(cfg, matmul_params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x the params that enter a matmul
    (all but the embedding table, a gather) x tokens, plus attention's
    QK^T and PV, 4 S d a token a layer forward, x 3 with the backward (the
    full S x S products the masked attention computes).  The remat
    forward is not counted."""
    attn = 12 * cfg.num_layers * cfg.d_model * seq
    return float((6 * matmul_params + attn) * tokens)


def train_accounting(cfg, ocfg, step_s: float) -> dict:
    """The package's accounting of the phase's step (``roofline.analysis``):
    the reference's ``model_flops`` for B = 8, S = 512, and ``cost_of``'s
    flops and bytes of the same step (``launch.dryrun.build_cell``: grads +
    ``adamw_update``) counted on ``meta``; ``eager_traffic_ms``, the larger
    of the counted flops over the bf16 peak and the counted bytes over the
    memory rate, beside the measured ms a step.  It is an estimate of the
    eager program's op-by-op traffic with no cache reuse, not a bound: a
    fused step moves fewer bytes."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.roofline.analysis import cost_of, model_flops

    t0 = time.perf_counter()
    shape = ShapeConfig("train_b8_s512", TRAIN_S, TRAIN_B, "train")
    cell = build_cell(cfg, shape, opt_cfg=ocfg)
    c_flops, c_bytes = cost_of(cell.fn, *cell.args)
    compute_ms = c_flops / H100["peak_flops"] * 1e3
    memory_ms = c_bytes / H100["hbm_bw"] * 1e3
    return {"model_flops": model_flops(cfg, shape),
            "counted_flops": c_flops, "counted_bytes": c_bytes,
            "eager_traffic_ms": max(compute_ms, memory_ms),
            "eager_traffic_by": ("operations" if compute_ms >= memory_ms
                                 else "bytes"),
            "compute_ms": compute_ms, "memory_ms": memory_ms,
            "ms_per_step": step_s * 1e3,
            "count_seconds": time.perf_counter() - t0}


def tree_devices(torch, tree) -> set:
    from repro_torch.models.layout import flatten
    return {t.device.type for t in flatten(tree)
            if isinstance(t, torch.Tensor)}


def trend_ok(losses) -> bool:
    """The reference's trend check (tests/test_train_optim_ckpt.py:147-148):
    the mean of the last 3 losses below the mean of the first 3."""
    return sum(losses[-3:]) / 3 < sum(losses[:3]) / 3


def family_batch(cfg, seed: int, b=2, s=16) -> dict:
    """Seeded inputs of a smoke config's frontend (tokens or embeds,
    ``cond`` where it attends over one) and labels, as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    if cfg.num_cond_tokens:
        out["cond"] = rng.standard_normal(
            (b, cfg.num_cond_tokens, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


def family_steps_vs_cpu(torch) -> dict:
    """Two f32 train steps of each family smoke on the card and on the CPU
    from the same params and batches: each step's nll and grad norm within
    rtol 1e-4, and every grad leaf within rtol 1e-4 plus 1e-4 of the leaf's
    largest |grad| (f32 sums in another order; the grads are what a device
    fault in a backward pass would change).  Params after the two steps are
    held within 5e-3 (test_microbatch_equivalence's bound): AdamW's first
    steps move a param by about lr whatever its grad's size, so a grad at
    the rounding's level moves it by lr on one device and not the other."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.layout import flatten, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    out = {}
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, decay_steps=4)
    for name in FAMILY_SMOKES:
        cfg = dataclasses.replace(get_config(name), dtype="float32")
        step = make_train_step(Model(cfg), ocfg)
        cpu = Model(cfg).init(7, device="cpu")
        gpu = tree_map(lambda t: t.to("cuda"), cpu)
        states = {"cpu": (cpu, adamw_init(cpu, ocfg)),
                  "cuda": (gpu, adamw_init(gpu, ocfg))}
        rows, grad_err = [], 0.0
        for k in range(2):
            batch = family_batch(cfg, seed=k)
            got, grads = {}, {}
            for dev, (p, o) in states.items():
                g, m = step.grads(p, {key: torch.from_numpy(v).to(dev)
                                      for key, v in batch.items()})
                _, _, om = step.update(p, g, o)
                grads[dev] = flatten(g)
                got[dev] = [float(m["nll"]), float(om["grad_norm"])]
            for i, what in enumerate(("nll", "grad_norm")):
                a, w = got["cuda"][i], got["cpu"][i]
                check(math.isfinite(a) and abs(a - w) <= FAMILY_STEP_RTOL
                      * abs(w), f"{name} step {k} {what}: card {a} cpu {w}")
            for a, w in zip(grads["cuda"], grads["cpu"]):
                err = (a.cpu() - w).abs()
                tol = FAMILY_STEP_RTOL * (w.abs() + w.abs().max())
                check(bool(torch.all(err <= tol)),
                      f"{name} step {k}: a grad differs from the CPU's by "
                      f"{float(err.max())} (leaf max {float(w.abs().max())})")
                grad_err = max(grad_err, float((err / (w.abs().max()
                                                       + 1e-30)).max()))
            rows.append(got)
        d = max(float((a.cpu() - w).abs().max()) for a, w in
                zip(flatten(states["cuda"][0]), flatten(states["cpu"][0])))
        check(d < 5e-3, f"{name}: params after 2 steps differ by {d}")
        out[name] = {"nll_grad_norm_by_step": rows,
                     "grad_max_err_over_leaf_max": grad_err,
                     "params_max_abs_diff": d}
    return out


def train_resume_child(root: str) -> int:
    """Run in a process of its own (``--train-resume-child DIR``) with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts and
    deterministic algorithms on: stablelm-1.6b at full width cut to 2
    layers, 4 steps uninterrupted; then 2 steps with a checkpoint at 2, and
    a fresh Trainer that resumes there and runs to 4.  Prints one JSON line:
    both runs' losses at steps 3-4, whether they and the final params and
    moments are equal bit for bit, the checkpoint's bytes and seconds.
    f32 moments unless the disk holds less than twice the npz's bytes,
    then int8 ones."""
    import shutil

    import torch
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import Model
    from repro_torch.models.layout import flatten
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=RESUME_LAYERS)
    n_params = sum(t.numel() for t in flatten(Model(cfg).init(
        0, device="cuda")))
    torch.cuda.empty_cache()
    free = shutil.disk_usage(root).free
    quantize = free < 2 * 3 * 4 * n_params   # f32 params + two f32 moments
    ocfg = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=1,
                       decay_steps=RESUME_STEPS, quantize_moments=quantize)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                      global_batch=TRAIN_B, seed=0)

    def trainer(d, every):
        return Trainer(Model(cfg), ocfg, dcfg,
                       TrainerConfig(num_steps=RESUME_STEPS, ckpt_every=every,
                                     ckpt_dir=os.path.join(root, d),
                                     log_every=10 ** 9))

    p_whole, o_whole, h_whole = trainer("whole", 10 ** 9).run(0)
    t0 = time.perf_counter()
    trainer("cut", RESUME_AT).run(0, RESUME_AT)
    to_ckpt_s = time.perf_counter() - t0
    npz = os.path.join(root, "cut", f"step_{RESUME_AT}", "arrays.npz")
    t0 = time.perf_counter()
    p_res, o_res, h_res = trainer("cut", 10 ** 9).run(0)
    resume_s = time.perf_counter() - t0
    print(json.dumps({
        "layers": RESUME_LAYERS, "params": n_params,
        "quantize_moments": quantize, "disk_free": free,
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "steps_resumed": [h["step"] for h in h_res],
        "loss_whole": [h["loss"] for h in h_whole[RESUME_AT:]],
        "loss_resumed": [h["loss"] for h in h_res],
        "params_equal": all(torch.equal(a, b) for a, b in
                            zip(flatten(p_whole), flatten(p_res))),
        "moments_equal": all(torch.equal(a, b) for a, b in
                             zip(flatten(o_whole), flatten(o_res))),
        "checkpoint_bytes": os.path.getsize(npz),
        "run_to_checkpoint_s": to_ckpt_s,
        "restore_and_run_s": resume_s}), flush=True)
    return 0


def train_resume_check() -> dict:
    """``train_resume_child`` in its own process, in a temp dir deleted
    after: fails unless the resumed steps' losses, params and moments equal
    the uninterrupted run's bit for bit."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="train-resume-")
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--train-resume-child", root],
                           capture_output=True, text=True, timeout=400,
                           env=env, cwd=REPO)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(r.returncode == 0, f"train resume child exited {r.returncode}: "
          f"{r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    check(res["steps_resumed"] == list(range(RESUME_AT, RESUME_STEPS)),
          f"train: the resume started at {res['steps_resumed']}")
    check(res["loss_resumed"] == res["loss_whole"] and res["params_equal"]
          and res["moments_equal"],
          f"train: the resumed run differs from the uninterrupted one: {res}")
    res["seconds"] = time.perf_counter() - t0
    return res


def microbatch_twin(torch, cfg, ocfg, params, batch) -> dict:
    """One ``microbatches=2`` step beside its ``microbatches=1`` twin from
    the same params (restored in between from a host copy) and fresh
    moments, held as test_microbatch_equivalence holds them: params within
    5e-3, nll within 5e-2."""
    from repro_torch.models import Model
    from repro_torch.models.layout import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    torch.cuda.reset_peak_memory_stats()
    start = [t.to("cpu", copy=True) for t in flatten(params)]
    nll, after = {}, None
    for mb in (1, 2):
        for t, s in zip(flatten(params), start):
            t.copy_(s)
        opt = adamw_init(params, ocfg)
        m = make_train_step(Model(cfg), ocfg, mb)(params, opt, batch)[2]
        nll[mb] = float(m["nll"])
        del opt, m
        if mb == 1:
            after = [t.clone() for t in flatten(params)]
    del start
    d = max(float((a - b).abs().max())
            for a, b in zip(after, flatten(params)))
    check(d < 5e-3 and abs(nll[1] - nll[2]) < 5e-2,
          f"train: microbatches 1 vs 2: params {d}, nll {nll}")
    return {"nll": nll, "params_max_abs_diff": d,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def train_memory_proof(torch, cfg, ocfg, params, batch,
                       phase_peak: int | None, hidden=None) -> dict:
    """The dry run's train cell at B = ``TRAIN_B``, S = ``TRAIN_S`` on a
    one-device mesh, reckoned at microbatches 1 and 2 (the twin's), against
    one step of each from a warmed state (fresh moments, one step run
    first); fails outside ``MEM_BAND``.  The reckoned ``bytes_per_device``
    stands beside the phase's own peak (``phase_peak``: the trainer's
    steps).  ``hidden`` as in ``decode_memory_proof``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import reckon_memory
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    shape = ShapeConfig("train_b8_s512", TRAIN_S, TRAIN_B, "train")
    readings = {}
    for mb in (1, 2):
        t0 = time.perf_counter()
        mem = reckon_memory(cfg, shape, make_test_mesh((1, 1)),
                            microbatches=mb, opt_cfg=ocfg)
        reckon_s = time.perf_counter() - t0
        step = make_train_step(Model(cfg), ocfg, mb,
                               cast_params_bf16=cfg.params_bf16_cast)
        opt = adamw_init(params, ocfg)
        step(params, opt, batch)                         # warm
        measured = step_peak(torch, step, params, opt, batch)
        found = hidden(torch, step, params, opt, batch) if hidden else None
        del opt
        gc.collect()
        torch.cuda.empty_cache()
        readings[f"microbatches_{mb}"] = memory_reading(mem, measured,
                                                        reckon_s, found)
    check_memory_band("train", readings)
    return {"readings": readings, "band": MEM_BAND, "mesh": "1x1",
            "reckoned_bytes_per_device":
                readings["microbatches_1"]["bytes_per_device"],
            "phase_max_memory_allocated": phase_peak,
            "nvidia_smi": smi_line()}


def run_train(torch) -> None:
    """The training stack on the card: stablelm-1.6b at full width and depth
    (1.645B params; bf16 compute, f32 master weights and moments, remat as
    its config sets) through ``Trainer`` for ``TRAIN_STEPS`` steps at B = 8,
    S = 512 from a seeded ``Model.init``; one more step under
    torch.profiler (launches and busy share a step) and one under
    ``set_sync_debug_mode("error")``; ``microbatch_twin``; the dry run's
    memory proof held to the card (``train_memory_proof``); the resume check
    in a process of its own (``train_resume_check``); the six family
    smokes' f32 steps on the card against the CPU
    (``family_steps_vs_cpu``).  Fails on a non-finite loss or grad norm, a
    failed trend check, a params / moments / batch / metric tensor off the
    card, peak memory over 70 GB, or a K1-K3 / B4 launch (the training path
    runs none of them).  Reports ms a step, tokens/s and the optimizer's ms
    inside a step (medians of CUDA-event readings over steps 1-11),
    ``max_memory_allocated`` and ``mfu``, the model FLOPs' share of the
    bf16 dense peak."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.models.layout import flatten
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    launches_before = dict(ops.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    ocfg = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       decay_steps=TRAIN_STEPS)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                      global_batch=TRAIN_B, seed=0)
    ckpt = tempfile.mkdtemp(prefix="train-")
    trainer = Trainer(Model(cfg), ocfg, dcfg,
                      TrainerConfig(num_steps=TRAIN_STEPS,
                                    ckpt_every=10 ** 9, ckpt_dir=ckpt,
                                    log_every=10 ** 9))
    t0 = time.perf_counter()
    params, opt, hist = trainer.run(0)
    run_s = time.perf_counter() - t0
    os.rmdir(ckpt)
    losses = [h["loss"] for h in hist]
    norms = trainer.grad_norms
    check(len(losses) == TRAIN_STEPS and not any(h["skipped"] for h in hist)
          and all(math.isfinite(x) for x in losses + norms),
          f"train: non-finite loss or grad norm: {losses} {norms}")
    check(trend_ok(losses), f"train: loss trend not met: {losses}")
    check(tree_devices(torch, params) == tree_devices(torch, opt)
          == {"cuda"}, "train: a params or moments leaf is off the card")
    n_params = sum(t.numel() for t in flatten(params))
    matmul_params = n_params - params["embed"].numel()
    tokens = TRAIN_B * TRAIN_S
    step_s = statistics.median(trainer.step_times[1:])
    opt_s = statistics.median(trainer.opt_times[1:])
    flops = train_flops(cfg, matmul_params, tokens, TRAIN_S)
    accounting = train_accounting(cfg, ocfg, step_s)

    # one more step under the profiler, then one under the sync checker
    batch = synthetic_batch(dcfg, TRAIN_STEPS, "cuda")
    check(tree_devices(torch, batch) == {"cuda"}, "train: batch off the card")
    step = trainer.step_fn
    prof = device_profile(torch, lambda: step(params, opt, batch), runs=1)
    prof.pop("k2", None)
    if isinstance(prof.get("device_ms"), float):
        # the profiler slows the host: its device time against the
        # unprofiled steps' event time reads the busy share without it
        prof["device_ms_over_step_ms"] = prof["device_ms"] / (step_s * 1e3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(params, opt, batch)[2]
        sync_free = True
    except RuntimeError as e:
        metrics, sync_free = None, f"raised: {str(e)[:300]}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if metrics is not None:
        check(tree_devices(torch, metrics) == {"cuda"},
              "train: a step metric is off the card")
    peak = torch.cuda.max_memory_allocated()
    check(peak < TRAIN_PEAK_BOUND,
          f"train: max_memory_allocated {peak} >= 70 GB")
    step_ms = [t * 1e3 for t in trainer.step_times]
    opt_ms = [t * 1e3 for t in trainer.opt_times]
    stragglers = trainer.straggler_steps
    del opt, trainer, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    twin = microbatch_twin(torch, cfg, ocfg, params,
                           synthetic_batch(dcfg, 0, "cuda"))
    check(twin["max_memory_allocated"] < TRAIN_PEAK_BOUND,
          f"train: the microbatch twin's max_memory_allocated "
          f"{twin['max_memory_allocated']} >= 70 GB")
    mem_proof = train_memory_proof(torch, cfg, ocfg, params,
                                   synthetic_batch(dcfg, 0, "cuda"), peak)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    resume = train_resume_check()
    families = family_steps_vs_cpu(torch)
    check(dict(ops.LAUNCHES) == launches_before,
          f"train: a kernel launched on the training path: "
          f"{ops.LAUNCHES} against {launches_before}")
    emit("train", arch=TRAIN_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, params=n_params,
         batch=TRAIN_B, seq=TRAIN_S, tokens_per_step=tokens,
         steps=TRAIN_STEPS, lr_peak=TRAIN_LR, warmup=TRAIN_WARMUP,
         remat=cfg.remat, dtype=cfg.dtype, losses=losses, grad_norms=norms,
         trend_first3_last3=[sum(losses[:3]) / 3, sum(losses[-3:]) / 3],
         ms_per_step=step_s * 1e3, tokens_per_s=tokens / step_s,
         optimizer_ms=opt_s * 1e3, step_ms=step_ms, optimizer_step_ms=opt_ms,
         straggler_steps=stragglers, run_seconds=run_s, profile=prof,
         sync_free_step=sync_free, max_memory_allocated=peak,
         peak_bound=TRAIN_PEAK_BOUND, flops_per_step=flops,
         mfu=flops / step_s / BF16_PEAK_FLOPS, mfu_params=matmul_params,
         accounting=accounting,
         microbatch_twin=twin, memory_proof=mem_proof, resume=resume,
         families_card_vs_cpu=families,
         kernel_launches="none: the K1-K3 and B4 counts are unchanged by "
                         "the phase",
         seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# dryrun: one 2^26-row shard of the paper's 2^30-row index on the card
# ---------------------------------------------------------------------------

DRYRUN_SHARD_BYTES = 54_626_615_296    # codes, inverted index, residuals
ALLOC_ROUNDING = 1 << 20               # the caching allocator's rounding


def dryrun_bounds(n: int, q: int, packed: bool) -> dict:
    """Bounds (ms) of K1, K2 and B4 over the shard at ``q`` queries: K1 the
    larger of N·Kc + 4·Q·N bytes and Q·N·K f32 adds, K2 of the same bytes
    and Q·N·(K + 1) adds; B4 its 4·Q·N bytes out, 8 B a live posting
    (every list full, every query slot a distinct dim) and the queries."""
    from repro_torch.launch import dryrun as dr

    kc = dr.K_PQ // 2 if packed else dr.K_PQ
    k_b = (n * kc + 4 * q * n) / HBM_BYTES_PER_S * 1e3
    k1_o = q * n * dr.K_PQ / F32_ADDS_PER_S * 1e3
    k2_o = q * n * (dr.K_PQ + 1) / F32_ADDS_PER_S * 1e3
    b4_b = (4 * q * n + 8 * q * dr.NQ * dr.L_MAX + 8 * q * dr.NQ) \
        / HBM_BYTES_PER_S * 1e3
    return {"k1_bound_ms": max(k_b, k1_o),
            "k1_bound_by": "bytes" if k_b >= k1_o else "operations",
            "k2_bound_ms": max(k_b, k2_o),
            "k2_bound_by": "bytes" if k_b >= k2_o else "operations",
            "b4_bound_ms": b4_b, "b4_bound_by": "bytes"}


def dryrun_library(torch, arrs: dict, blocks: int) -> dict:
    """The library yardsticks over the whole 2^26-row shard at the check's
    4 queries (the last of the first block): ``torch.sparse.mm`` of the
    tail postings as an (N x d) CSR by the scattered queries, for B4, and
    ``embedding_bag`` (mode sum) over the (subspace, code) rows of the LUT
    in the plain scan's 2^21-row slices, their times summed, for K1; each
    held to the kernel within rtol / atol (they sum in other orders).
    Median of 3 CUDA-event readings after a warm-up."""
    from repro_torch.core.sparse_index import PaddedInvertedIndex
    from repro_torch.kernels import ops
    from repro_torch.launch.retrieval_check import (CHECK_QUERIES,
                                                    PLAIN_SLICE_ROWS)

    codes = arrs["codes"]
    n = codes.shape[0]
    per = arrs["lut"].shape[0] // blocks
    lo, hi = per - CHECK_QUERIES, per
    lut = arrs["lut"][lo:hi]
    qd, qv = arrs["q_dims"][lo:hi], arrs["q_vals"][lo:hi]
    inv = PaddedInvertedIndex(rows=arrs["inv_rows"], vals=arrs["inv_vals"],
                              num_points=n)
    spmm = tail_yardstick(torch, inv, qd, qv)
    b4_err = assert_close(spmm().T, ops.score_inverted_vf(inv, qd, qv),
                          "torch.sparse.mm yardstick at N = 2^26")
    b4_ms = cuda_ms(spmm, runs=3, warmup=1)
    del spmm
    gc.collect()
    torch.cuda.empty_cache()
    qn, k_sub, _ = lut.shape
    e_w = lut.permute(1, 2, 0).reshape(k_sub * 16, qn).contiguous()
    k1_ms, k1_err = 0.0, 0.0
    for s in range(0, n, PLAIN_SLICE_ROWS):
        c = codes[s:s + PLAIN_SLICE_ROWS]
        e_idx = c.long() + 16 * torch.arange(k_sub, device=c.device)

        def bag():
            return torch.nn.functional.embedding_bag(e_idx, e_w, mode="sum")

        k1_err = max(k1_err, assert_close(
            bag().T, ops.lut16_adc(c, lut),
            f"embedding_bag yardstick at rows {s}.. of N = 2^26"))
        k1_ms += cuda_ms(bag, runs=3, warmup=1)
        del e_idx
    return {"queries": [lo, hi],
            "b4_library_ms": b4_ms, "b4_library": "torch.sparse.mm",
            "b4_library_max_abs_diff": b4_err,
            "k1_library_ms": k1_ms,
            "k1_library": f"embedding_bag in {PLAIN_SLICE_ROWS}-row slices, "
                          "summed",
            "k1_library_max_abs_diff": k1_err}


def dryrun_inspect(arrs, backend, row_offset, blocks, results, dev, runs):
    """``inspect_form``, and on the unpacked form the library yardsticks
    (``dryrun_library``)."""
    import torch
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.retrieval_check import inspect_form

    out = inspect_form(arrs, backend, row_offset, blocks, results, dev, runs)
    if arrs["codes"].shape[1] == dr.K_PQ:
        out["library"] = dryrun_library(torch, arrs, blocks)
    return out


def run_dryrun(torch) -> dict:
    """``launch.dryrun.lower_retrieval`` at its production size: shard 15
    of the 16-way ``data`` axis of a 2^30-row index, 2^26 rows (54.63 GB of
    codes, inverted index and residuals) allocated on the card from seed 0
    and searched, pass 1 at k = 100 and the three-pass search at h = 100,
    alpha = 5, beta = 2, on ``cuda`` then ``cuda-packed``, the 128 queries in
    the fewest equal blocks whose bias fits.  Fails unless: the shard's
    reckoned bytes are 54,626,615,296 and ``memory_allocated`` grows by
    the arrays' bytes in the build (within the allocator's rounding); each
    call launches K2 and B4 once a block and K1 never; and, through
    ``launch.retrieval_check.inspect_form``, at 4 queries (the last of the
    first block) in both forms: B4 equals ``score_inverted`` bit for bit at
    those queries' rows of the whole first block's bias (where every CTA
    streams) and alone; K1's (4, 2^26) scores equal the plain scan, run in
    2^21-row slices, bit for bit; K2's fused top-100 and top-500 equal a
    stable top-k of the plain scan + the bias bit for bit, and the
    three-pass result equals passes 2-3 on those candidates; the plain
    versions' ms are kept beside the kernels'; the blocked pass-1 and
    three-pass rows of those queries equal a block of just them bit for bit
    (passes 2-3 sum in a fixed order, R1 and R2); the library yardsticks of
    B4 and K1 at those queries (``dryrun_library``); every id lies in the
    shard's global row range; the peak stays under the card's memory and the peak
    over the arrays under one bias block + the block slack; and the
    package's ``H100["hbm_bytes"]`` is not above the card's total memory.
    The launches of the timed calls are the path's count."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    check(H100["hbm_bytes"] <= total,
          f"dryrun: H100 hbm_bytes {H100['hbm_bytes']} > total {total}")
    ops.reset_counts()
    row = dr.lower_retrieval(multi_pod=False, device="cuda", seed=0,
                             keep_results=True, inspect=dryrun_inspect,
                             verbose=False)
    counted = dict(ops.LAUNCHES)
    n, blocks = row["rows"], row["query_blocks"]["blocks"]
    per = row["query_blocks"]["queries_a_block"]
    rb = row["reckoned_bytes"]
    check(n == 2 ** 26 and row["row_offset"] == 15 * 2 ** 26,
          f"dryrun: {n} rows at offset {row['row_offset']}")
    check(rb["shard"] == DRYRUN_SHARD_BYTES,
          f"dryrun: the shard reckons {rb['shard']} B")
    arrays = sum(v for k, v in rb.items() if k not in ("codes_packed",
                                                        "shard"))
    alloc = row["memory_allocated_by_build"]
    check(arrays <= alloc <= arrays + ALLOC_ROUNDING,
          f"dryrun: memory_allocated {alloc} after a {arrays} B build")
    main_path = dict.fromkeys(ops.LAUNCHES, 0)
    for form, f in row["forms"].items():
        c = f["check"]
        f["kernels"]["check_queries"].update(
            plain_k1_ms=c["plain_scan_ms"], plain_k2_ms=c["plain_k2_ms"])
        check(c["block_tail_equals_plain"] and c["tail_equals_plain"],
              f"dryrun {form}: B4 differs from score_inverted at 4 queries: "
              f"{c}")
        check(c["k1_equals_plain"],
              f"dryrun {form}: K1 differs from the plain scan: {c}")
        check(all(c["fused_equals_plain"].values())
              and c["three_pass_equals_plain_route"],
              f"dryrun {form}: K2 differs from the plain scan + stable "
              f"top-k: {c}")
        check(c["blocked_rows_equal_alone"]["pass1"]
              and c["blocked_rows_equal_alone"]["three_pass"],
              f"dryrun {form}: blocked pass-1 or three-pass rows differ "
              f"from a block of their queries alone: "
              f"{c['blocked_rows_equal_alone']}")
        del f["results"]
        check(f["ids_in_shard"], f"dryrun {form}: ids {f['id_range']} off "
              f"[{row['row_offset']}, {row['row_offset'] + n})")
        for call, extra in (("pass1", ()),
                            ("three_pass", ("dense_residual",
                                            "sparse_residual"))):
            want = dict.fromkeys(("lut16_adc_topk", "score_inverted_vf")
                                 + extra, blocks)
            check(f[call]["launches"] == want,
                  f"dryrun {form} {call}: launches {f[call]['launches']}")
            check(f[call]["max_memory_allocated"] < total,
                  f"dryrun {form} {call}: peak over the card's memory")
            for k, v in f[call]["launches_all_calls"].items():
                main_path[k] += v
        check(f["peak_over_arrays"] <= per * n * 4 + dr.BLOCK_SLACK,
              f"dryrun {form}: {f['peak_over_arrays']} B over the arrays")
        for where, kt in f["kernels"].items():
            kt.update(dryrun_bounds(n, kt["queries"], form != "cuda"))
    check(all(counted[k] >= v for k, v in main_path.items()),
          f"dryrun: counts {counted} below the calls' {main_path}")
    emit("dryrun", **row, counted_launches=counted,
         main_path_launches=main_path,
         seconds=time.perf_counter() - t_phase)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": main_path,
            "kernels": {form: f["kernels"]
                        for form, f in row["forms"].items()},
            "library": row["forms"]["cuda"]["library"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=524288,
                    help="rows of the slice (default 524288)")
    ap.add_argument("--inserts", type=int, default=8192,
                    help="rows the mutable phase inserts (default 8192)")
    ap.add_argument("--train-resume-child", metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if args.train_resume_child:
        return train_resume_child(args.train_resume_child)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
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
    # the production shard first, while the card holds nothing else
    dry = run_dryrun(torch)
    (idx, ds, queries, launches, c1, res, profiles,
     true_ids) = run_slice(args, torch)
    run_batch_invariance(torch, idx, queries)
    rows = run_kernels(torch, idx, queries, launches, c1)
    rows[1]["profile_split"] = k2_profile_split(profiles)
    rows.append(run_score_inverted_vf(torch, idx, queries,
                                      launches["score_inverted_vf"]))
    rows.append(run_value_forward(torch, idx, queries))
    residual_rows = run_residual_kernels(
        torch, idx, queries, launches, c1,
        idx.engine.candidate_counts(20, 25, 6)[1])
    sharded = run_sharded(torch, idx, queries, true_ids)
    params = idx.params
    # the service retires idx's generation at its refresh: idx goes after
    service = run_service(args, torch, idx, ds, res)
    del idx, queries
    gc.collect()
    torch.cuda.empty_cache()
    # K1 runs on the mutable path: its count comes from that path's run
    rows[0]["launches"] = run_mutable(args, torch, ds, params,
                                      res)["lut16_adc"]
    for r, path in zip(rows, ("mutable", "slice", "slice", "slice",
                              "value_forward")):
        r["path"] = path
    for r in residual_rows:
        r["path"] = "lm_head" if r["name"] == "gathered_dot" else "slice"
    rows += residual_rows
    gc.collect()
    torch.cuda.empty_cache()
    durable = run_durable(torch, ds, params)
    gc.collect()
    torch.cuda.empty_cache()
    # the tables' Netflix- and Movielens-shaped data is made on the host
    # while the cluster phase waits on its nodes' store fetches and reloads
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        table2 = pool.submit(table2_datasets, args)
        cluster = run_cluster(torch, ds, params)
        gc.collect()
        torch.cuda.empty_cache()
        tables = run_tables(args, torch, ds, table2)
    del ds
    gc.collect()
    torch.cuda.empty_cache()
    for r in rows:
        r["service_launches"] = {"service": service[r["name"]],
                                 "durable": durable[r["name"]]}
        r["tables_launches"] = tables[r["name"]]
        r["cluster_launches"] = cluster[r["name"]]
        r["sharded_launches"] = sharded[r["name"]]
    # the PQ LM head's main path: K1 at the head's K (its wide variant)
    head_launches = run_lm_head(torch)["launches"]
    rows[0]["lm_head_launches"] = head_launches["lut16_adc"]
    for r in rows:
        if r["name"] == "gathered_dot":
            r["launches"] = head_launches["gathered_dot"]
        elif r["name"] in ("adc_lut", "dense_residual"):
            r["lm_head_launches"] = head_launches[r["name"]]
    # the decode loop's main path: K1 once a PQ step at qwen2-7b
    rows[0]["lm_decode_launches"] = run_lm_decode(torch)["launches"]
    # the decode loops' closures hold the sessions in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    # the other families: K1 once a PQ step at recurrentgemma-9b
    rows[0]["lm_families_launches"] = run_lm_families(torch)["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    # the training stack: no kernel of the four on its path
    run_train(torch)
    # launch's --arch qwen2-7b process needs the sessions' memory
    gc.collect()
    torch.cuda.empty_cache()
    run_launch()
    run_reference_store(torch)
    for r in rows:
        r["dryrun_launches"] = dry["launches"][r["name"]]
        if r["name"] in ("lut16_adc", "lut16_adc_topk", "score_inverted_vf"):
            r["dryrun_kernels"] = dry["kernels"]
        if r["name"] in ("lut16_adc", "score_inverted_vf"):
            r["dryrun_library"] = dry["library"]
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
