"""Shared helpers of the port tests (tests/test_torch_*.py): carrying a JAX
index across to the port, the tie-aware comparison of top-k results, a
test worker's share of torch's threads and its environment, and what the
cluster tests share (fake nodes on local sockets among it).

XLA and PyTorch sum in different orders, so scores agree only within a
tolerance, and two candidates whose reference scores lie within that
tolerance may swap places.  ``assert_topk_match`` accepts exactly those
swaps and nothing else."""

import contextlib
import os
import socket
import threading
import time

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


def worker_thread_share() -> int:
    """This test worker's share of the cores: all of them in a serial run,
    cores // workers under pytest-xdist (at least one)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(workers, 1))


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` inside the block and restored
    after it.  Each xdist worker starts with one thread a core, so six
    workers on eight cores run 48 OpenMP threads, whose barriers spin for
    threads the other workers hold off the cores: a CPU search of many
    small parallel ops then takes minutes instead of seconds."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def environ_kept():
    """``os.environ`` as it was before the block, after it.  The JAX
    package's ``launch.dryrun`` and ``launch.perf_probe`` set ``XLA_FLAGS``
    to 512 host devices when they are imported; every xdist worker imports
    every test module, so without this each worker's later subprocesses
    (the JAX cluster tests' nodes) started with 512 devices and some 800
    threads each, and a cluster test could hang."""
    before = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(before)


# -- cluster tests (tests/test_torch_cluster*.py) -----------------------------

CLUSTER_TIMEOUT_S = 30.0       # every socket wait of a cluster test


def wait_replica_seq(port: int, seq: int, *, timeout=CLUSTER_TIMEOUT_S):
    """Poll a replica's ``status`` until it has applied ``seq``; returns
    the status meta.  Fails after ``timeout`` seconds."""
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


# -- fake cluster nodes (tests/test_torch_cluster_stale.py, _flip.py) ---------

LIMIT_S = 10.0           # a fake-node case's own time limit


def started(fn):
    """Run ``fn`` in a thread of its own; returns ``(thread, box)`` for
    ``finished``."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:          # noqa: BLE001 - re-raised later
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def finished(t, box, limit=LIMIT_S):
    """Fail unless the thread of ``started`` ends within ``limit`` seconds.
    Returns its result, re-raises its exception."""
    t.join(limit)
    assert not t.is_alive(), f"no answer within {limit} s: a wait hangs"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def bounded(fn, limit=LIMIT_S):
    """Run ``fn`` in a thread; fail unless it returns within ``limit``
    seconds.  Returns its result, re-raises its exception."""
    return finished(*started(fn), limit=limit)


class FakeNode:
    """A shard node on a local socket: ``handle(cmd, meta, arrays)``
    returns ``(op, meta, arrays, delay_s)``, or None for no reply at all.
    Requests on one connection are answered in order, as the real server
    answers them; every request is logged as ``(cmd, meta)``."""

    def __init__(self, handle):
        self.handle = handle
        self.log = []
        self._srv = socket.create_server(("127.0.0.1", 0))
        self._srv.settimeout(0.1)
        self._stop = threading.Event()
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        from repro_torch.serve.cluster.protocol import recv_msg, send_msg
        with conn:
            while not self._stop.is_set():
                try:
                    _, meta, arrays = recv_msg(conn)
                except (ConnectionError, OSError):
                    return
                cmd = meta.pop("cmd")
                self.log.append((cmd, meta))
                reply = self.handle(cmd, meta, arrays)
                if reply is None:
                    continue
                op, rmeta, rarrays, delay = reply
                time.sleep(delay)
                try:
                    send_msg(conn, "reply", rmeta, rarrays, op=op)
                except (ConnectionError, OSError):
                    return

    def close(self):
        self._stop.set()
        self._srv.close()


def stale(role, held, want):
    """The reply a node gives a generation it does not hold."""
    from repro_torch.serve.cluster.protocol import MSG_ERROR
    return (MSG_ERROR, {"error": f"StaleGenerationError: {role} holds "
                                 f"generation {held}, request wants {want}",
                        "kind": "StaleGenerationError"}, {}, 0.0)
