#!/usr/bin/env python3
"""Peak device memory of the PQ LM head's k-means, in pieces and whole.

    python3 tools/pq_train_memory.py

At each width of ``chip_smoke.py``'s ``lm_head`` phase (qwen2-7b,
qwen2.5-14b, deepseek-67b: K = d/2 subspaces over at most 65536 sampled
rows of a random (V, d) head) it runs ``core.pq.train_codebooks`` as
``HybridLMHead.build`` does, twice: with ``pq.BLOCK_BYTES`` as committed
(the subspaces walked in pieces of a 1 GiB distance block) and with no
limit (every subspace at once, a (K, N, 16) f32 block).  For each it
reports ``max_memory_allocated`` from a reset taken with the head already
on the card, the seconds, and whether the centers of the two runs are
equal bit for bit.  A run that does not fit reports ``out_of_memory``.

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

WIDTHS = (("qwen2-7b", 3584, 152064), ("qwen2.5-14b", 5120, 152064),
          ("deepseek-67b", 8192, 102400))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pq_train_memory: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import pq

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    committed = pq.BLOCK_BYTES
    out = {}
    for name, d, v in WIDTHS:
        g = torch.Generator(device="cuda").manual_seed(0)
        table = (torch.randn((d, v), generator=g, device="cuda")
                 / math.sqrt(d)).T.contiguous()
        torch.cuda.synchronize()
        row, centers = {"d": d, "v": v, "k": d // 2}, {}
        for label, block in (("pieces", committed), ("whole", 1 << 62)):
            pq.BLOCK_BYTES = block
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t = time.perf_counter()
            try:
                cb = pq.train_codebooks(table, d // 2, 16, iters=8, seed=0)
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                row[label] = {"out_of_memory": True,
                              "max_memory_allocated":
                                  torch.cuda.max_memory_allocated()}
            if "out_of_memory" in row.get(label, {}):
                torch.cuda.empty_cache()
                continue
            row[label] = {"seconds": time.perf_counter() - t,
                          "baseline_bytes": before,
                          "max_memory_allocated":
                              torch.cuda.max_memory_allocated()}
            centers[label] = cb.centers
            del cb
            torch.cuda.empty_cache()
        pq.BLOCK_BYTES = committed
        if len(centers) == 2:
            row["centers_equal"] = torch.equal(centers["pieces"],
                                               centers["whole"])
        out[name] = row
        del table, centers
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
