"""The port's cluster router and client never wait without end (C8).

Fake shard nodes on local sockets speak the cluster protocol
(``repro_torch.serve.cluster.protocol``) and answer as the test scripts
them, so each case is deterministic and takes well under a second:

* a fan-out in which one scorer answers ``StaleGeneration`` while the
  other scorer's reply and the primary's delta reply are still in flight:
  the router must settle every coalesced entry it submitted before it
  retries, so that the retry and the next search on every client complete
  (before the repair the uncollected entries kept their clients'
  coalescing slots forever, and the retry waited on them without end);
* a coalesced search queued behind a flush that nobody collects fails with
  ``TimeoutError`` after the client's timeout, and the client ships later
  searches again, each getting its own reply;
* a coalesced search that a flush has taken off the queue, but that the
  flush has not yet sent when the client's timeout runs out, waits for the
  flush and gets its own reply;
* a request in flight when the client is closed fails, and its lost reply
  does not take the next connection's first reply.

Every case runs in a thread joined under its own time limit, so a
regression fails here and does not hang the run."""

import time

import numpy as np
import pytest
from _torch_port_helpers import (LIMIT_S, FakeNode, bounded, finished,
                                 stale, started)

from repro_torch.serve.cluster import ClusterRouter, ShardClient
from repro_torch.serve.cluster.protocol import MSG_RESPONSE

N_ROWS, H, QN = 64, 4, 3


class Cluster:
    """A fake primary and two fake scorers over ``N_ROWS`` rows: scorer k
    holds rows [32 k, 32 k + 32) and scores row i of a query q as
    ``q + i / 1000``.  ``flip()`` is a compaction seen mid-flight: the
    primary is at generation 2, scorer 0 holds only generation 2 and
    refuses 1 at once, scorer 1 holds both and answers 0.2 s late."""

    def __init__(self):
        self.gen = 1
        self.scorer_gens = [{1}, {1}]
        self.primary = FakeNode(self._primary)
        self.scorers = [FakeNode(lambda c, m, a, k=k: self._scorer(k, c, m,
                                                                    a))
                        for k in range(2)]

    def flip(self):
        self.gen = 2
        self.scorer_gens = [{2}, {1, 2}]

    def _primary(self, cmd, meta, arrays):
        if cmd == "info":
            return (MSG_RESPONSE, {
                "gen": self.gen, "alpha": 4, "beta": 2,
                "num_points": N_ROWS, "d_active": 8, "nq_max": 4,
                "term": 1, "epoch": 0, "delta_live": 0, "applied_seq": 0},
                {"cols_global_ids": np.arange(8, dtype=np.int64),
                 "main_tombstones": np.zeros(0, np.int64),
                 "fully_deleted": np.zeros(0, np.int64)}, 0.0)
        if cmd == "search" and meta["part"] == "delta":
            q = arrays["q_dims"].shape[0]
            return (MSG_RESPONSE, {
                "gen": meta["gen"], "epoch": 0, "term": 1,
                "current_gen": self.gen, "applied_seq": 0, "live": 0},
                {"scores": np.zeros((q, 0), np.float32),
                 "ids": np.zeros((q, 0), np.int64)}, 0.05)
        raise AssertionError(f"fake primary got {cmd} {meta}")

    def _scorer(self, k, cmd, meta, arrays):
        assert cmd == "search" and meta["part"] == "main", (cmd, meta)
        held = self.scorer_gens[k]
        if meta["gen"] not in held:
            return stale("scorer", max(held), meta["gen"])
        q, h = arrays["q_dims"].shape[0], int(meta["h"])
        rows = np.arange(32 * k + 31, 32 * k + 31 - h, -1)
        scores = (np.arange(q)[:, None] + rows[None] / 1000.0)
        return (MSG_RESPONSE, {"gen": meta["gen"]},
                {"scores": scores.astype(np.float32),
                 "ids": np.broadcast_to(rows, (q, h)).astype(np.int64)},
                0.2 if k == 1 and len(held) > 1 else 0.0)

    def close(self):
        for n in (self.primary, *self.scorers):
            n.close()


@pytest.fixture
def cluster():
    c = Cluster()
    yield c
    c.close()


def queries(qn=QN):
    return (np.zeros((qn, 4), np.int32), np.zeros((qn, 4), np.float32),
            np.zeros((qn, 4), np.float32))


def want_ids(qn=QN):
    """Every query's top H: scorer 1's highest rows."""
    return np.broadcast_to(np.arange(63, 63 - H, -1), (qn, H))


def test_stale_reply_mid_fanout_settles_every_entry(cluster):
    router = ClusterRouter(cluster.primary.addr,
                           [s.addr for s in cluster.scorers], h=H,
                           direct_q_max=0, timeout=LIMIT_S)
    try:
        s, ids = bounded(lambda: router.search(*queries()))
        np.testing.assert_array_equal(ids, want_ids())
        cluster.flip()
        # pinned at generation 1: scorer 0 refuses at once, scorer 1 and
        # the primary answer later; the retry runs at generation 2
        s, ids = bounded(lambda: router.search(*queries()))
        np.testing.assert_array_equal(ids, want_ids())
        assert router.stats["stale_retries"] == 1
        assert router.gen == 2
        # the next search through every client completes, and so does a
        # coalesced search straight on each client
        s, ids = bounded(lambda: router.search(*queries(1)))
        np.testing.assert_array_equal(ids, want_ids(1))
        for c, part in ((router.scorers[0], "main"),
                        (router.scorers[1], "main"),
                        (router.primary, "delta")):
            meta = {"part": part, "gen": 2, "h": H, "alpha": 4, "beta": 2,
                    "have_epoch": 0, "have_term": 1}
            arrays = dict(zip(("q_dims", "q_vals", "q_dense"), queries(8)))
            rmeta, _ = bounded(lambda c=c, m=meta, a=arrays:
                               c.submit_search(m, a).result())
            assert rmeta["gen"] == 2
            assert not c._co_inflight and not c._co_queue
        assert not router.scorers[1]._pending
    finally:
        router.close()


def echo_node(silent=()):
    """Answers each request with its own ``tag``; no reply to the tags in
    ``silent``."""
    def handle(cmd, meta, arrays):
        if meta.get("tag") in silent:
            return None
        return MSG_RESPONSE, {"tag": meta.get("tag")}, {}, 0.0
    return FakeNode(handle)


def test_coalesced_search_behind_an_uncollected_flush_times_out():
    node = echo_node()
    c = ShardClient("127.0.0.1", node.port, timeout=0.5)
    try:
        first = c.submit_search({"tag": 1}, {})     # ships; never collected
        second = c.submit_search({"tag": 2}, {})    # queued behind it

        def second_result():
            t0 = time.monotonic()
            with pytest.raises(TimeoutError):
                second.result()
            return time.monotonic() - t0

        assert 0.4 < bounded(second_result) < 5.0
        # the queued search never shipped; the first reply is still the
        # first one's, and a later search ships and gets its own
        assert bounded(lambda: first.result())[0]["tag"] == 1
        third = c.submit_search({"tag": 3}, {})
        assert bounded(lambda: third.result())[0]["tag"] == 3
        assert [m["tag"] for _, m in node.log] == [1, 3]
    finally:
        c.close()
        node.close()


def test_coalesced_search_waits_for_a_flush_held_past_the_timeout():
    node = echo_node()
    c = ShardClient("127.0.0.1", node.port, timeout=0.5)
    try:
        first = c.submit_search({"tag": 1}, {})     # ships at once
        second = c.submit_search({"tag": 2}, {})    # queued behind it
        with c._send_lock:
            # collecting the first flushes the second, whose send then
            # waits on the lock held here
            collect = started(first.result)
            deadline = time.monotonic() + LIMIT_S
            while c._co_queue and time.monotonic() < deadline:
                time.sleep(0.005)
            assert not c._co_queue, "the flush never took the second search"

            def second_result():
                t0 = time.monotonic()
                return second.result(), time.monotonic() - t0

            waiter = started(second_result)
            time.sleep(1.5)         # three of the client's timeouts
        assert finished(*collect)[0]["tag"] == 1
        (meta, _), waited = finished(*waiter)
        assert meta["tag"] == 2
        assert waited > 0.5
        assert [m["tag"] for _, m in node.log] == [1, 2]
    finally:
        c.close()
        node.close()


def test_reply_lost_with_a_closed_client_does_not_shift_the_fifo():
    node = echo_node(silent=("lost",))
    c = ShardClient("127.0.0.1", node.port, timeout=LIMIT_S)
    try:
        lost = c.submit("search", {"tag": "lost"})
        c.close()
        with pytest.raises(ConnectionError):
            bounded(lost.wait)
        meta, _ = bounded(lambda: c.call("search", {"tag": "next"}))
        assert meta["tag"] == "next"
    finally:
        c.close()
        node.close()


def test_no_reply_fails_the_connection_within_the_timeout():
    node = echo_node(silent=("silent",))
    c = ShardClient("127.0.0.1", node.port, timeout=0.5)
    try:
        p = c.submit("search", {"tag": "silent"})
        with pytest.raises(OSError):
            bounded(p.wait)
        assert not c._pending
        meta, _ = bounded(lambda: c.call("search", {"tag": "after"}))
        assert meta["tag"] == "after"
    finally:
        c.close()
        node.close()
