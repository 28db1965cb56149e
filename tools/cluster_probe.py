#!/usr/bin/env python3
"""``chip_smoke.py``'s ``cluster`` phase on one GPU, without the rest of it.

    python3 tools/cluster_probe.py [--tree DIR ...] [--out FILE]

For each tree (the repo this file sits in by default; another checkout of
the repo, such as an unpacked ``git archive`` of a parent commit, by
``--tree``; repeat a tree to alternate two of them), in turn: builds that
tree's kernels, makes the querysim-shard data and params with this repo's
``chip_smoke.querysim_shard`` (524288 rows, from that tree's
``repro_torch``), and runs that tree's ``chip_smoke.run_cluster``.  Each
tree runs in a process of its own, with its own ``repro_torch``.  Beside
the phase, every router search that ends while a
``ClusterRouter.compact`` runs is watched, and the three slowest
searches' traces are printed in short (``chip_smoke.trace_hops``), with
the seconds of every ``compact`` and ``reload`` call the routers made.

Prints the card's name and power limit, then for each tree one JSON
object: its exit code, seconds, the router's rows/s on the phase's
ragged stream (first and second pass), the compactions' seconds and
searches, and the slowest traces.  ``--out`` keeps every line the trees
printed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree: str) -> int:
    """Run ``tree``'s cluster phase in this process (``--child``)."""
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    if not torch.cuda.is_available():
        print("cluster_probe: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.obs import trace
    from repro_torch.serve.cluster import client, router

    slow, compacting, rpcs = [], [], []
    finish, compact = trace.Tracer._finish, router.ClusterRouter.compact

    def watched(self, span):
        finish(self, span)
        if span.name == "cluster.search" and compacting:
            slow.append(span.to_dict())
            slow.sort(key=lambda d: -d["duration_s"])
            del slow[3:]

    def marked(self, *a, **kw):
        compacting.append(1)
        try:
            return compact(self, *a, **kw)
        finally:
            compacting.pop()

    call = client.ShardClient.call

    def timed(self, cmd, *a, **kw):
        t0 = time.perf_counter()
        try:
            return call(self, cmd, *a, **kw)
        finally:
            if cmd in ("compact", "reload"):
                rpcs.append([cmd, self.port, time.perf_counter() - t0])

    trace.Tracer._finish = watched
    router.ClusterRouter.compact = marked
    client.ShardClient.call = timed
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    spec = importlib.util.spec_from_file_location(
        "probe_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mine = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mine)
    cs.run_cluster(torch, *mine.querysim_shard(524288))
    print(json.dumps({"compaction_rpcs": rpcs, "slowest_searches": [
        mine.trace_hops(d, {}) for d in slow]}), flush=True)
    return 0


def summary(lines: list[str]) -> dict:
    """What a tree's run printed, in short: the ``cluster`` line's stream
    rows/s and compactions, and the probe's own line."""
    out = {}
    for line in lines:
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") == "cluster":
            st = d["stream"]
            out["stream_rows_per_s"] = [st["first_rows_per_s"],
                                        st["second_rows_per_s"]]
            out["compact_s"] = d["compact_s"]
            # by generation, or one compaction's (an older tree's line)
            during = d.get("searches_during_compaction", {})
            if not all(isinstance(v, dict) for v in during.values()):
                during = {"to_generation_2": during}
            out["during_compaction"] = {
                g: {k: v.get(k) for k in (
                    "searches", "returned", "refused_stale",
                    "flip_direct_rows", "p50_ms", "max_s")}
                for g, v in during.items()}
        elif "slowest_searches" in d:
            out.update(d)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append",
                    help="a checkout whose cluster phase to run (repeat "
                         "for several, run in the order given; default: "
                         "this repo)")
    ap.add_argument("--out", help="a file for every line the trees print")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch
    if not torch.cuda.is_available():
        print("cluster_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    print(cs.smi_line(), flush=True)
    rc = 0
    for tree in args.tree or [REPO]:
        tree = os.path.abspath(tree)
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", tree], cwd=tree,
                           stdout=subprocess.PIPE, text=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(f"# {tree}\n{p.stdout}")
        print(json.dumps({"tree": tree, "rc": p.returncode,
                          "seconds": time.perf_counter() - t0,
                          **summary(p.stdout.splitlines())}), flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
