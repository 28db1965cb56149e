"""Shared helpers of the port tests (tests/test_torch_*.py): carrying a JAX
index across to the port, the tie-aware comparison of top-k results, and
what the cluster tests share.

XLA and PyTorch sum in different orders, so scores agree only within a
tolerance, and two candidates whose reference scores lie within that
tolerance may swap places.  ``assert_topk_match`` accepts exactly those
swaps and nothing else."""

import numpy as np
import pytest

RTOL, ATOL = 1e-5, 1e-4        # tests/test_kernels.py's kernel tolerance


def jax_index_state(idx):
    """(leaves, scalars) of a live JAX ``HybridIndex`` under the snapshot
    format's names, as numpy — the input of
    ``repro_torch.interchange.hybrid_index_from_numpy``."""
    leaves = {
        "pi": np.asarray(idx.pi),
        "cols_global_ids": np.asarray(idx.cols.global_ids),
        "inv_rows": np.asarray(idx.inv_index.rows),
        "inv_vals": np.asarray(idx.inv_index.vals),
        "res_cols": np.asarray(idx.sparse_residual.cols),
        "res_vals": np.asarray(idx.sparse_residual.vals),
        "centers": np.asarray(idx.codebooks.centers),
        "codes": np.asarray(idx.codes),
        "dres_q": np.asarray(idx.dense_residual.q),
        "dres_scale": np.asarray(idx.dense_residual.scale),
        "dres_zero": np.asarray(idx.dense_residual.zero),
    }
    scalars = {"num_points": int(idx.num_points),
               "inv_num_points": int(idx.inv_index.num_points),
               "codes_packed": bool(idx.engine.arrays.codes_packed),
               "head.block_rows": None, "head.block_cols": None}
    if idx.head is not None:
        leaves["head_block"] = np.asarray(idx.head.block)
        leaves["head_occupancy"] = np.asarray(idx.head.occupancy)
        leaves["head_dims"] = np.asarray(idx.head.head_dims)
        scalars["head.block_rows"] = idx.head.block_rows
        scalars["head.block_cols"] = idx.head.block_cols
    return leaves, scalars


def _near(a, b, rtol, atol):
    return abs(a - b) <= atol + rtol * abs(b)


def assert_topk_match(got_s, got_ids, want_s, want_ids, *, rtol=RTOL,
                      atol=ATOL):
    """Row-wise top-k agreement: scores position by position within the
    tolerance; ids equal, except where the reference holds a near-tie.

    An id that differs at position p is accepted only if the reference has
    the same id at another position whose score is within the tolerance of
    its score at p, or — for an id the reference did not return at all —
    if its score ties the reference's last kept score (a boundary swap)."""
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    assert got_s.shape == want_s.shape and got_ids.shape == want_ids.shape
    np.testing.assert_allclose(got_s, want_s, rtol=rtol, atol=atol)
    for r in range(want_ids.shape[0]):
        pos_of = {int(i): p for p, i in enumerate(want_ids[r])}
        for p in np.flatnonzero(got_ids[r] != want_ids[r]):
            gid = int(got_ids[r, p])
            if gid in pos_of:
                ok = _near(want_s[r, pos_of[gid]], want_s[r, p], rtol, atol)
            else:
                ok = _near(got_s[r, p], want_s[r, -1], rtol, atol)
            assert ok, (f"row {r} position {p}: id {gid} where the "
                        f"reference has {int(want_ids[r, p])} without a tie")


# -- cluster tests (tests/test_torch_cluster*.py) -----------------------------

CLUSTER_TIMEOUT_S = 30.0       # every socket wait of a cluster test


def wait_replica_seq(port: int, seq: int, *, timeout=CLUSTER_TIMEOUT_S):
    """Poll a replica's ``status`` until it has applied ``seq``; returns
    the status meta.  Fails after ``timeout`` seconds."""
    import time

    from repro_torch.serve.cluster import ShardClient, wait_ready
    rc = ShardClient("127.0.0.1", port, timeout=timeout)
    try:
        deadline = time.monotonic() + timeout
        while True:
            st = wait_ready(rc, timeout=timeout)
            if st["applied_seq"] >= seq:
                return st
            if time.monotonic() > deadline:
                raise AssertionError(f"replica stuck at {st}, want {seq}")
            time.sleep(0.05)
    finally:
        rc.close()


@pytest.fixture(scope="module", autouse=True)
def one_thread_nodes():
    """Spawned cluster nodes inherit ``OMP_NUM_THREADS=1``: a test's nodes
    share the machine with the other test workers.  A module that imports
    this fixture gets it for all its tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
