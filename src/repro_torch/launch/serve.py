"""Serving launcher of the port: the LM, retrieval and cluster modes of
``repro.launch.serve``, on the card unless ``--device cpu``.

LM mode (``--arch``): random weights from ``--seed``, prefill a batch of
prompts, decode ``--tokens`` tokens and report per-step latency, with either
the exact head or the paper's PQ hybrid head (``--pq-head``).  Every family
whose input is token ids alone runs (dense, moe, ssm, hybrid); the vlm and
audio configs stop as the reference's launcher does, with an error that
names the input it does not pass (``cond``; musicgen's ``embeds``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b-smoke \
        --tokens 32 --batch 4 --pq-head

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

Cluster mode (DESIGN.md §8): ``--role router`` spawns a local cluster
(primary + ``--cluster-scorers`` scorers + ``--replicas`` replicas, each a
process of its own on ``--device``), drives inserts, deletes and searches
through a ``ClusterRouter`` and prints its status; ``--role shard
--shard-role {primary,scorer,replica}`` runs one node of a hand-laid-out
deployment (the remaining flags go to the shard server).

    PYTHONPATH=src python -m repro_torch.launch.serve --role router \
        --points 2000 --queries 16 --cluster-scorers 2 --replicas 1

``--metrics-port`` exposes the service's (or router's) metrics registry as
a text endpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def lm_generate(args):
    """The LM mode's greedy tokens: ``--seed``'s f32 tree and prompts drawn
    on ``--device``, the tree handed over to the session, which casts it in
    place (``greedy_generate(donate=True)``), so that a model whose f32 and
    bf16 trees do not fit the card together still serves (qwen2-moe-a2.7b:
    57.3 GB f32, 28.7 GB bf16).  Returns (tokens (B, T) on the CPU, the
    seconds of ``greedy_generate``, the device)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.serve import greedy_generate

    cfg = get_config(args.arch)
    dev = resolve_device(args.device)
    model = Model(cfg)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(g, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=g, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = greedy_generate(model, params, prompt, args.tokens, args.max_len,
                          use_pq_head=args.pq_head, penalty=args.penalty,
                          donate=True).cpu()
    return out, time.perf_counter() - t0, dev


def run_lm(args) -> None:
    """Decode-loop latency probe (exact vs PQ hybrid head) on ``--device``:
    the wall time of ``greedy_generate``, the PQ head's build included, as
    the reference reports it (``lm_generate``); on the card, the run's peak
    device memory too."""
    import torch

    out, dt, dev = lm_generate(args)
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({dt / args.tokens * 1e3:.1f} ms/step, "
          f"head={'pq-hybrid' if args.pq_head else 'exact'})")
    print("sample:", out[0, :16].tolist())
    if dev.type == "cuda":
        print(f"max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated(dev)} B")


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


def run_router(args) -> None:
    """Local cluster demo (DESIGN.md §8): spawn the shard-server topology
    on ``--device``, drive mutations + searches through a
    ``ClusterRouter``, report its status and hop totals."""
    import shutil
    import tempfile

    from repro_torch.core.hybrid import HybridIndex
    from repro_torch.serve.cluster import LocalCluster

    n0 = args.points - 64
    ds = _dataset(args)
    idx = HybridIndex.build(ds.x_sparse[:n0], ds.x_dense[:n0], _params(),
                            mutable=True, device=args.device)
    root = tempfile.mkdtemp(prefix="cluster-demo-")
    print(f"spawning cluster on {args.device}: primary + "
          f"{args.cluster_scorers} scorer(s) + {args.replicas} replica(s) "
          f"under {root}")
    try:
        with LocalCluster.launch(idx, root,
                                 num_scorers=args.cluster_scorers,
                                 num_replicas=args.replicas,
                                 device=args.device) as cluster:
            del idx
            router = cluster.router(h=args.h,
                                    replica_max_lag=args.replica_max_lag)
            ms = _maybe_metrics_server(args, router.obs.metrics)
            try:
                new = router.insert(ds.x_sparse[n0:], ds.x_dense[n0:])
                router.delete(new[:8].tolist())
                t0 = time.perf_counter()
                s, ids = router.search_sparse(ds.q_sparse, ds.q_dense)
                dt = time.perf_counter() - t0
                if not (ids.shape == (args.queries, args.h)
                        and np.isfinite(s).all()):
                    raise RuntimeError(f"served results are not finite "
                                       f"({args.queries}, {args.h}): "
                                       f"{ids.shape}")
                print(f"served {ids.shape[0]} queries in {dt:.2f}s "
                      f"(top ids {ids[0, :5].tolist()})")
                print("router status:", router.status())
                print("hop stage totals (s):", router.hops())
            finally:
                if ms is not None:
                    ms.close()
                router.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    """Parse args and dispatch to the cluster, retrieval or LM launcher, in
    the reference's order.

    ``--role shard`` short-circuits BEFORE the full parser: the remaining
    flags (with ``--shard-role`` mapped to the server's ``--role``) are
    handed verbatim to ``repro_torch.serve.cluster.shard_server.main``, so
    one entry point launches any node of a hand-laid-out deployment."""
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--role" in argv and argv[argv.index("--role") + 1:][:1] == ["shard"]:
        from repro_torch.serve.cluster import shard_server
        i = argv.index("--role")
        rest = argv[:i] + argv[i + 2:]
        rest = ["--role" if a == "--shard-role" else a for a in rest]
        return shard_server.main(rest)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--retrieval", action="store_true",
                    help="serve a hybrid retrieval index")
    # LM mode
    ap.add_argument("--arch", help="LM mode: a config of repro_torch.configs")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--pq-head", action="store_true")
    ap.add_argument("--penalty", type=float, default=0.0)
    # cluster mode (DESIGN.md §8)
    ap.add_argument("--role", choices=["router", "shard"],
                    help="cluster mode: 'shard' runs one shard-server "
                         "process (with --shard-role); 'router' spawns and "
                         "drives a local cluster")
    ap.add_argument("--cluster-scorers", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=0)
    ap.add_argument("--replica-max-lag", type=int, default=0)
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
    if args.role == "router":
        return run_router(args)
    if not args.retrieval:
        if not args.arch:
            ap.error("--arch is required in LM mode")
        return run_lm(args)
    if args.persist_dir and args.restore:
        ap.error("--persist-dir bootstraps a new store and --restore "
                 "resumes one: pass one of them")
    run_retrieval(args)


if __name__ == "__main__":
    main()
