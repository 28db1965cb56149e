"""Fixtures of the benchmark's CPU tests: the cells at sizes a test run
holds, run through the program's plain (CPU) paths."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

TINY_SHARD = {"num_points": 8192, "row_offset": 3 * 8192,
              "pq_subspaces": 8, "d_dense": 16, "d_active": 512,
              "l_max": 16, "r_max": 8, "nq": 16, "h": 10, "alpha": 5,
              "beta": 2, "fresh_pool": 512, "warm_rows": 96,
              "sample_rows": 16, "reference_block": 2048}
TINY_QUERYSIM = {"num_points": 4096, "d_sparse": 3000, "d_dense": 16,
                 "nnz_per_row": 40, "kmeans_iters": 4, "head_dims": 16,
                 "keep_top": 32, "fresh_pool": 2048, "hot_pool": 64,
                 "warm_rows": 96, "sample_rows": 32,
                 "reference_block": 1024}


@pytest.fixture(scope="session")
def bench():
    from hybench.spec import Bench
    return Bench(ROOT)


def later_root(tmp) -> Path:
    """A checkout at ``tmp`` whose ``BENCHMARK.json`` also holds the
    entries of ``hybench/later/*.json``: the cells ready as files that the
    benchmark does not run yet."""
    import json
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((ROOT / "hybench" / "later").glob("*.json")):
        extra = json.loads(f.read_text())
        for key in ("configs", "workloads", "per_layer"):
            doc[key] += extra.get(key, [])
    tmp = Path(tmp)
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    (tmp / "hybench").symlink_to(ROOT / "hybench")
    return tmp


@pytest.fixture(scope="session")
def later_bench(tmp_path_factory):
    from hybench.spec import Bench
    return Bench(later_root(tmp_path_factory.mktemp("later")))


def tiny(bench, name: str):
    """The cell ``name`` at test size: widths and rows cut, the traffic,
    the limits and everything else as committed."""
    cell = bench.cell(name)
    cfg = {**cell.config, **(TINY_SHARD if cell.config["maker"] == "shard"
                             else TINY_QUERYSIM)}
    mix = dict(cell.traffic)
    if "hot_set" in mix:
        mix["hot_set"] = cfg["hot_pool"]
    mix["requests"] = min(int(mix["requests"]), 512)
    return dataclasses.replace(cell, config=cfg, traffic=mix)
