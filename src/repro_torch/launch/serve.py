"""Serving launcher of the port: the retrieval modes of
``repro.launch.serve``, on the card unless ``--device cpu``.

Retrieval mode (DESIGN.md §5): build a synthetic hybrid index, stand up the
batched QueryService, drive a ragged query stream through it twice (cold +
warm cache) with an index refresh after it, and report QPS + cache +
shape-key stats.

    PYTHONPATH=src python -m repro_torch.launch.serve --retrieval \
        --points 20000 --queries 64 --shards 4

Durable retrieval (DESIGN.md §7): ``--persist-dir DIR`` builds a mutable
index, bootstraps a snapshot store + mutation WAL there, and serves with
every mutation logged; ``--restore DIR`` resumes that store after a
crash/restart (snapshot load + WAL replay) and serves the recovered index.
The store is the JAX package's format, so either package can restore it.

    PYTHONPATH=src python -m repro_torch.launch.serve --retrieval \
        --persist-dir /tmp/hybrid-store          # first run
    PYTHONPATH=src python -m repro_torch.launch.serve --retrieval \
        --restore /tmp/hybrid-store              # after a restart

``--metrics-port`` exposes the service's metrics registry as a text
endpoint.  The LM mode (``--arch``) and the cluster mode (``--role``) are
not ported yet and exit with the ROADMAP item they wait for.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

_WAITS = {"--arch": "ROADMAP queue A items 8-9 (the PQ LM head and the "
                    "LM zoo)",
          "--role": "ROADMAP queue A item 6 (the cluster tier)"}


def _maybe_metrics_server(args, registry):
    """Stand up the ``--metrics-port`` text endpoint (DESIGN.md §9.1) over
    ``registry``; None when the flag wasn't given.  Port 0 binds an
    ephemeral port (printed)."""
    if args.metrics_port is None:
        return None
    from repro_torch.obs import start_metrics_server
    ms = start_metrics_server(registry, args.metrics_port)
    print(f"metrics endpoint: http://127.0.0.1:{ms.port}/metrics")
    return ms


def _dataset(args):
    from repro_torch.data import make_hybrid_dataset
    return make_hybrid_dataset(num_points=args.points,
                               num_queries=args.queries,
                               d_sparse=args.points, d_dense=64,
                               nnz_per_row=48, seed=args.seed)


def _params():
    from repro_torch.core.hybrid import HybridIndexParams
    return HybridIndexParams(keep_top=96, head_dims=64, kmeans_iters=6)


def run_durable_retrieval(args) -> None:
    """Durable serving loop (DESIGN.md §7): bootstrap or restore a snapshot
    store + WAL, mutate under load, and report recovery/persistence stats."""
    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.serve import QueryService

    ds = _dataset(args)
    n0 = args.points - 64
    if args.restore:
        print(f"recovering from {args.restore} on {args.device} ...")
        t0 = time.perf_counter()
        svc = QueryService(restore_from=args.restore, h=args.h,
                           auto_compact=False, device=args.device)
        print(f"recovered in {time.perf_counter() - t0:.2f}s; "
              f"stats: {svc.stats()}")
    else:
        print(f"building durable index: {n0} points on {args.device} -> "
              f"{args.persist_dir}")
        idx = HybridIndex.build(ds.x_sparse[:n0], ds.x_dense[:n0], _params(),
                                mutable=True, device=args.device)
        svc = QueryService(index=idx, h=args.h,
                           persist_dir=args.persist_dir, auto_compact=False,
                           device=args.device)
        new = svc.insert(ds.x_sparse[n0:], ds.x_dense[n0:])
        svc.delete(new[:8])
        print(f"logged {len(new)} inserts + 8 deletes to the WAL; "
              f"stats: {svc.stats()}")
    ms = _maybe_metrics_server(args, svc.obs.metrics)
    try:
        t0 = time.perf_counter()
        s, ids = svc.search_sparse(ds.q_sparse, ds.q_dense)
        dt = time.perf_counter() - t0
        if not (ids.shape == (args.queries, args.h)
                and np.isfinite(s).all()):
            raise RuntimeError(f"served results are not finite "
                               f"({args.queries}, {args.h}): {ids.shape}")
        print(f"served {ids.shape[0]} queries in {dt:.2f}s "
              f"(top ids {ids[0, :5].tolist()})")
    finally:
        if ms is not None:
            ms.close()
        svc.close()


def run_retrieval(args) -> None:
    """QueryService under a ragged query stream: QPS, cache, refresh."""
    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.core.sparse_index import sparse_queries_to_padded
    from repro_torch.serve import QueryService

    if args.restore or args.persist_dir:
        return run_durable_retrieval(args)

    print(f"building index: {args.points} points, {args.shards} shard(s) "
          f"on {args.device}...")
    ds = _dataset(args)
    params = _params()
    idx = HybridIndex.build(ds.x_sparse, ds.x_dense, params,
                            device=args.device)
    q_dims, q_vals = sparse_queries_to_padded(ds.q_sparse, idx.cols,
                                              nq_max=params.nq_max)
    q_dense = np.asarray(ds.q_dense, np.float32)
    svc = QueryService(idx.engine, h=args.h, buckets=(1, 8, 32),
                       cache_size=4 * args.queries, num_shards=args.shards,
                       id_map=idx.pi, device=args.device)
    ms = _maybe_metrics_server(args, svc.obs.metrics)
    try:
        rng = np.random.default_rng(args.seed)
        sizes = rng.integers(1, 33, 64)

        def stream():
            served = 0
            for q in sizes:
                rows = rng.integers(0, args.queries, int(q))
                s, _ = svc.search(q_dims[rows], q_vals[rows], q_dense[rows])
                if not np.isfinite(s).all():
                    raise RuntimeError("a served score is not finite")
                served += int(q)
            return served

        stream()                                # kernel build, cold cache
        t0 = time.perf_counter()
        n = stream()
        dt = time.perf_counter() - t0
        print(f"stream: {n} queries in {dt:.2f}s ({n / dt:.1f} QPS)")

        t0 = time.perf_counter()
        idx2 = HybridIndex.build(
            ds.x_sparse, ds.x_dense,
            dataclasses.replace(params, seed=args.seed + 1),
            device=args.device)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc.refresh(idx2.engine, id_map=idx2.pi)
        swap_s = time.perf_counter() - t0
        print(f"refresh: rebuild {build_s:.2f}s off-path, "
              f"swap {swap_s * 1e3:.2f} ms")

        info, jit = svc.cache_info(), svc.jit_cache_info()
        print(f"cache: {info.hits} hits / {info.misses} misses "
              f"(hit rate {info.hit_rate:.2f}, {info.evictions} evictions)")
        print(f"shape keys: {jit.batch_shapes} (bound {jit.bound})")
        print("stats:", svc.stats())
    finally:
        if ms is not None:
            ms.close()
        svc.close()


def main(argv=None):
    """Parse args and run a retrieval mode; the modes not ported yet exit
    with the ROADMAP item they wait for."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--retrieval", action="store_true",
                    help="serve a hybrid retrieval index (the only mode "
                         "ported so far)")
    ap.add_argument("--arch", help="LM mode: not ported yet")
    ap.add_argument("--role", help="cluster mode: not ported yet")
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--h", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--persist-dir",
                    help="bootstrap a durable snapshot store + WAL here "
                         "and serve with every mutation logged")
    ap.add_argument("--restore",
                    help="recover the index from this store (snapshot + "
                         "WAL replay) and serve it")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose the process's metrics registry as a text "
                         "endpoint on this port (0 = ephemeral; DESIGN.md "
                         "§9.1)")
    args = ap.parse_args(argv)
    for flag, waits in _WAITS.items():
        if getattr(args, flag[2:]) is not None:
            ap.error(f"{flag} is not ported yet: it waits for {waits}")
    if not args.retrieval:
        ap.error("pass --retrieval (the LM mode waits for "
                 f"{_WAITS['--arch']})")
    if args.persist_dir and args.restore:
        ap.error("--persist-dir bootstraps a new store and --restore "
                 "resumes one: pass one of them")
    run_retrieval(args)


if __name__ == "__main__":
    main()
