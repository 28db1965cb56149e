"""Run one benchmark cell once and print its result as the last line.

    python -m hybench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The run builds
the cell's data on the card from the seed, warms every batch shape its
traffic reaches, sends the traffic for ``--seconds`` (``setup_s`` is
everything before), and then, with the program's state freed, holds a
sample of the window's answers to the plain reference
(``hybench/reference.py``).  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` traces a stretch of the window with
``torch.profiler`` and reports its per-layer metrics.  Without a card, or
with fewer than the cell asks for, it exits 2 and prints no result; if
``jax``, ``jaxlib``, ``flax`` or ``repro`` were loaded, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = frozenset({"jax", "jaxlib", "flax", "repro"})


def blocked_modules(modules=None) -> list[str]:
    """Top-level names among ``modules`` (the loaded ones by default) that
    the benchmark may not load, each compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & BLOCKED)


def prepare_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; the
    program's own kernel build already writes under ``build/``."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def bucket_for(rows: int, buckets: tuple) -> int:
    for b in buckets:
        if rows <= b:
            return b
    return buckets[-1]


def buckets_reached(sizes, buckets: tuple, any_miss_count: bool) -> list:
    """The padded batch sizes a request of each size can reach: a request
    is cut into batches of the largest bucket and a rest; with hits, any
    number of its rows up to its size may miss."""
    out = set()
    for s in set(int(x) for x in sizes):
        for m in (range(1, s + 1) if any_miss_count else (s,)):
            full, rest = divmod(m, buckets[-1])
            if full:
                out.add(buckets[-1])
            if rest:
                out.add(bucket_for(rest, buckets))
    return sorted(out)


def warm_up(built, buckets: list) -> None:
    """Two searches at each bucket on warm-up rows that the traffic never
    sends, so that the second finds every kernel built and planned."""
    at = 0
    for b in buckets:
        for _ in range(2):
            idx = list(range(at, at + b))
            at += b
            if at > len(built.warm):
                raise ValueError(f"warm_rows {len(built.warm)} < {at}")
            built.search(*built.warm.take(idx))


def _median_ms(call, cuda: bool, runs: int = 20) -> float:
    import torch
    call()
    call()
    times = []
    for _ in range(runs):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sample_answers(records, n: int, seed: int):
    """``n`` answered rows, stratified by position within a request: the
    positions 0 .. w - 1 (w the largest request's size) are taken in turn,
    in an order drawn from the seed anew for each round of w, and each
    sampled row comes from a request drawn from the seed that no other
    sampled row comes from (where every request with a row at that
    position is taken, one not sampled there).  With ``n`` a request's
    size, every slot of its batch is compared on every run.  Returns
    (schedule rows, ids (n, h), scores (n, h))."""
    import numpy as np
    rng = np.random.default_rng([int(seed), 0xC0FFEE])
    ok = [records[k] for k in rng.permutation(len(records))
          if records[k].ok]
    width = max((r.size for r in ok), default=0)
    order = np.concatenate([rng.permutation(width)
                            for _ in range(-(-n // width))]) if width else []
    used, taken, picks = set(), set(), []
    for j in order[:n]:
        j = int(j)
        pos = [k for k, r in enumerate(ok) if r.size > j]
        k = next((k for k in pos if k not in used),
                 next((k for k in pos if (k, j) not in taken), None))
        if k is None:
            break
        used.add(k)
        taken.add((k, j))
        picks.append((ok[k], j))
    return (np.asarray([r.rows[j] for r, j in picks], np.int64),
            np.asarray([r.ids[j] for r, j in picks], np.int64),
            np.asarray([r.scores[j] for r, j in picks], np.float32))


def judge_sample(built, cfg: dict, rows, ids, scores, precision="f64"):
    """The reference's numbers for answer rows of schedule ``rows``."""
    import torch
    from hybench import reference
    sc = built.scorer(rows, precision)
    return reference.judge(
        sc, built.ref_ids(ids),
        torch.from_numpy(scores).to(sc.lut.device), h=built.h, c1=built.c1,
        c2=built.c2, block=cfg["reference_block"])


def checks_of(numbers: dict, cfg: dict) -> dict:
    """{name: {"value", "limit"}} for the failed requests (limit 0) and
    each number the configuration's ``limits`` name."""
    limits = {"failed_requests": 0, **cfg["limits"]}
    return {name: {"value": numbers[name], "limit": lim}
            for name, lim in limits.items()}


def _finite(x: float) -> float:
    return x if x == x and abs(x) != float("inf") else 1e30


def run_cell(bench, cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             wrap_search=None) -> dict:
    """One run of ``cell``; returns the result object (without printing).
    ``wrap_search(send, built) -> send`` puts something else in the
    program's place (a control, or a test's broken path)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hybench import load, tracecalc

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    built = bench.maker(cfg["maker"]).build(cfg, mix, seed, dev, trace)
    schedule = load.make_schedule(mix, seed, len(built.fresh))
    warm_up(built, buckets_reached(schedule.sizes(), built.buckets,
                                   float(mix.get("hot_share", 0)) > 0))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(dev)
    info0 = built.cache_info()
    setup_s = time.perf_counter() - t_start

    def send(rows):
        return built.search(*built.rows(rows))

    if wrap_search is not None:
        send = wrap_search(send, built)
    loop = load.ClosedLoop(schedule, send, int(mix["clients"]))
    prof_box: dict = {}

    def during(start, stop):
        """Trace a stretch from ``trace_from`` of the window; a stretch
        whose trace holds no kernel on the card (CUPTI has dropped them
        once in eleven runs) is traced again while the window lasts."""
        length = float(mix["trace_seconds"])
        time.sleep(max(0.0, start + seconds * float(mix["trace_from"])
                       - time.perf_counter()))
        while True:
            with profile(activities=acts) as prof:
                built.obs.tracer.take()       # once the profiler runs:
                t0 = time.perf_counter()      # its first start is slow
                time.sleep(max(0.0, min(stop, t0 + length) - t0))
                t1 = time.perf_counter()
                spans = built.obs.tracer.take()
            tr = tracecalc.capture(prof, tempfile.gettempdir(), t1 - t0)
            prof_box.update(trace=tr, t0=t0, t1=t1, spans=spans)
            if tr.kernels() or not cuda or \
                    time.perf_counter() + length > stop:
                return

    start, stop = loop.run(seconds, during if trace else None)
    records = loop.records
    info1 = built.cache_info()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    window = stop - start
    ok = [r for r in records if r.ok]
    failed = len(records) - len(ok)
    done_rows = sum(r.size for r in ok if r.done <= stop)
    lat = [(r.done - r.sent) * 1e3 if r.ok else float("inf")
           for r in records]
    e2e = {"throughput": done_rows / window,
           "p95_ms": load.percentile(lat, 95) if lat else float("inf"),
           "peak_mem_gb": peak / 1e9, "setup_s": setup_s}

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        tr, t0, t1 = prof_box["trace"], prof_box["t0"], prof_box["t1"]
        in_stretch = [r for r in records if r.ok and t0 <= r.done <= t1]
        pass1_ms = _median_ms(
            built.pass1(built.fresh, np.arange(built.buckets[-1])), cuda)
        ctx = {"trace": tr, "spans": prof_box["spans"],
               "requests": in_stretch, "cache": (info0, info1),
               "pass1_ms": pass1_ms, "pass1_rows": built.buckets[-1],
               "shape": built.shape, "config": cfg, "traffic": mix}
        metrics = {}
        for m in cell.per_layer:
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": _finite(float(e2e[m["name"]])),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    rows, ids, scores = sample_answers(records, int(cfg["sample_rows"]),
                                       seed)
    built.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    for r in [r for r in records if not r.ok][:5]:
        print(f"hybench: request {r.index} of {r.size} rows failed: "
              f"{r.error}", file=sys.stderr)
    numbers = {"failed_requests": failed}
    if len(rows):
        got = judge_sample(built, cfg, rows, ids, scores)
        numbers.update(score_err=got["score_err"], rank_gap=got["rank_gap"])
    else:
        numbers.update(score_err=float("inf"), rank_gap=float("inf"))
    numbers.update(built.checks())
    checks = checks_of(numbers, cfg)
    for c in checks.values():
        c["value"] = _finite(float(c["value"]))
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"hybench: no program under {ROOT / 'src'}", file=sys.stderr)
        return 2
    prepare_environment()
    import torch
    from hybench.spec import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"hybench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda",
                      t_start=T_START)
    found = blocked_modules()
    if found:
        print(f"hybench: modules loaded that the benchmark may not load: "
              f"{found}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
