#!/usr/bin/env python3
"""Write the reference store the port is held against: a durable store
made by the JAX package (``repro``) on the CPU, and the reference's own
results on it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/make_reference_store.py

This is the reference's tool (it imports ``repro``, never the port).  It
builds a small mutable ``HybridIndex`` (1024 rows, a head block, the
``ref`` backend) with the JAX package, serves it through its
``QueryService(persist_dir=…)`` so that 48 inserts and 12 deletes are
WAL-logged behind the initial snapshot, and writes

* ``tests/data/reference_store/``: the store, in the reference's format
  (CURRENT, one snapshot, one WAL segment; under 1 MB);
* ``tests/data/reference_store_expected.npz``: the queries and the
  reference's top-h ids and scores after ``repro.persist.recover`` of that
  store (snapshot load + WAL replay).

``tests/test_torch_persist.py`` recovers the store with both packages on
the CPU and holds each against the ``.npz`` (a stale fixture fails there);
``chip_smoke.py``'s ``reference_store`` phase recovers it with the port on
the card.  Rerun this script only when the store format or the data
changes, and commit both outputs together.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(REPO, "tests", "data", "reference_store")
EXPECTED = os.path.join(REPO, "tests", "data",
                        "reference_store_expected.npz")
N_MAIN, N_INSERT, N_QUERIES = 1024, 48, 16
H, ALPHA, BETA = 10, 20, 5


def main() -> int:
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro.core.hybrid import HybridIndex, HybridIndexParams
    from repro.data import make_hybrid_dataset
    from repro.persist import recover
    from repro.serve import QueryService

    ds = make_hybrid_dataset(num_points=N_MAIN + N_INSERT,
                             num_queries=N_QUERIES, d_sparse=2000,
                             d_dense=16, nnz_per_row=16, seed=5)
    params = HybridIndexParams(keep_top=32, head_dims=24, kmeans_iters=4,
                               backend="ref")
    idx = HybridIndex.build(ds.x_sparse[:N_MAIN], ds.x_dense[:N_MAIN],
                            params, mutable=True)
    if os.path.exists(STORE):
        shutil.rmtree(STORE)
    svc = QueryService(index=idx, persist_dir=STORE, auto_compact=False)
    new = []
    for lo in range(N_MAIN, N_MAIN + N_INSERT, 16):
        new += svc.insert(ds.x_sparse[lo:lo + 16],
                          ds.x_dense[lo:lo + 16]).tolist()
    svc.delete(new[::8])                       # 6 delta rows
    svc.delete([3, 100, 511, 512, 900, 1023])  # 6 main rows
    svc.close()

    rec = recover(STORE)
    rec.durability.close()
    res = rec.index.search(ds.q_sparse, ds.q_dense, h=H, alpha=ALPHA,
                           beta=BETA)
    q = ds.q_sparse.tocsr()
    np.savez(EXPECTED, q_data=q.data, q_indices=q.indices,
             q_indptr=q.indptr, q_shape=np.asarray(q.shape),
             q_dense=np.asarray(ds.q_dense, np.float32),
             ids=np.asarray(res.ids, np.int64),
             scores=np.asarray(res.scores, np.float32),
             h=H, alpha=ALPHA, beta=BETA, replayed=rec.replayed)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(STORE) for f in fs)
    print(f"store {STORE}: {size} bytes, {rec.replayed} WAL records; "
          f"expected results {EXPECTED}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
