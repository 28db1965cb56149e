"""The one traffic generator: a mix file's parameters into a schedule of
requests, and the closed loop that sends them.

A mix (``hybench/traffic/<mix>.json``) gives:

* ``loop``: ``closed`` (each client sends its next request when the last
  one is answered);
* ``clients``: the number of client threads;
* ``sizes``: rows a request as ``[[lo, hi, share], ...]``, the size
  log-uniform within a range;
* ``hot_share``, ``hot_set``, ``zipf_s``: the share of rows drawn from a
  hot set of queries, by rank with P(r) ∝ r^-s; the other rows are fresh;
* ``requests``: the schedule's length;
* ``schedule_seed``: the seed of the sizes and the hot ranks.

Every run draws the same multiset of requests (sizes and hot ranks, from
``schedule_seed``) and sends it in an order drawn from the run's seed, so
two seeds give the same work in another order.  Fresh rows are taken from
the fresh pool in order; past its end the pool starts again (the result
cache, far smaller than the pool, has long evicted them by then).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback

import numpy as np


@dataclasses.dataclass
class Schedule:
    """``rows[i]``: request i's rows as indices into the pools: >= 0 a fresh
    row, < 0 the hot row ``-1 - index``."""
    rows: list

    def __len__(self) -> int:
        return len(self.rows)

    def sizes(self) -> np.ndarray:
        return np.array([len(r) for r in self.rows])


def request_sizes(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    ranges = np.asarray(mix["sizes"], dtype=np.float64)
    share = ranges[:, 2] / ranges[:, 2].sum()
    which = rng.choice(len(ranges), size=n, p=share)
    lo, hi = ranges[which, 0], ranges[which, 1]
    u = rng.random(n)
    sizes = np.floor(np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo))))
    return np.clip(sizes, lo, hi).astype(np.int64)


def zipf_ranks(n: int, hot_set: int, s: float,
               rng: np.random.Generator) -> np.ndarray:
    p = np.arange(1, hot_set + 1, dtype=np.float64) ** -s
    return rng.choice(hot_set, size=n, p=p / p.sum())


def make_schedule(mix: dict, seed: int, fresh_pool: int) -> Schedule:
    fixed = np.random.default_rng(int(mix["schedule_seed"]))
    n = int(mix["requests"])
    sizes = request_sizes(mix, n, fixed)
    total = int(sizes.sum())
    hot = fixed.random(total) < float(mix.get("hot_share", 0.0))
    ranks = np.zeros(total, np.int64)
    if hot.any():
        ranks[hot] = zipf_ranks(int(hot.sum()), int(mix["hot_set"]),
                                float(mix["zipf_s"]), fixed)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    order = np.random.default_rng(int(seed)).permutation(n)
    rows, fresh = [], 0
    for i in order:
        lo, hi = bounds[i], bounds[i + 1]
        r = np.empty(hi - lo, np.int64)
        h = hot[lo:hi]
        r[h] = -1 - ranks[lo:hi][h]
        nf = int((~h).sum())
        r[~h] = (fresh + np.arange(nf)) % fresh_pool
        fresh += nf
        rows.append(r)
    return Schedule(rows=rows)


@dataclasses.dataclass
class Record:
    index: int          # position in the schedule
    rows: np.ndarray    # the schedule's rows
    sent: float         # host clock, seconds
    done: float
    ok: bool
    scores: np.ndarray | None
    ids: np.ndarray | None
    error: str = ""

    @property
    def size(self) -> int:
        return len(self.rows)


class ClosedLoop:
    """``clients`` threads, each sending the schedule's next request to
    ``send(rows)`` (the rows' pool indices) once its last one is answered,
    from ``start`` until the host clock passes ``stop``.  Requests past the
    schedule's end start it again.  A request sent before ``stop`` is
    waited for, however long it takes."""

    def __init__(self, schedule: Schedule, send, clients: int):
        self.schedule, self.send, self.clients = schedule, send, clients
        self._lock = threading.Lock()
        self._next = 0
        self.records: list[Record] = []

    def _take(self) -> int:
        with self._lock:
            i = self._next
            self._next += 1
            return i

    def _client(self, stop: float, out: list) -> None:
        while True:
            i = self._take()
            rows = self.schedule.rows[i % len(self.schedule)]
            t0 = time.perf_counter()
            if t0 >= stop:
                return
            try:
                scores, ids = self.send(rows)
                out.append(Record(i, rows, t0, time.perf_counter(), True,
                                  scores, ids))
            except Exception:             # a failed request is recorded
                out.append(Record(i, rows, t0, time.perf_counter(), False,
                                  None, None, traceback.format_exc()))

    def run(self, seconds: float, during=None) -> tuple[float, float]:
        """Send for ``seconds``; ``during(start, stop)``, if given, runs on
        the calling thread meanwhile.  Returns the window (start, stop)."""
        start = time.perf_counter()
        stop = start + seconds
        outs = [[] for _ in range(self.clients)]
        threads = [threading.Thread(target=self._client, args=(stop, o),
                                    name=f"hybench-client-{c}")
                   for c, o in enumerate(outs)]
        for t in threads:
            t.start()
        try:
            if during is not None:
                during(start, stop)
        finally:
            for t in threads:
                t.join()
        self.records = sorted((r for o in outs for r in o),
                              key=lambda r: r.sent)
        return start, stop


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100), interpolated linearly between the two
    nearest order statistics as numpy's default; a failed request enters
    as +inf, slower than any other."""
    v = np.sort(np.asarray(values, np.float64))
    pos = q / 100.0 * (len(v) - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if lo == hi or not np.isfinite(v[hi]):
        return float(v[hi]) if lo != hi else float(v[lo])
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))
