"""Cluster router of the port (a copy of ``repro.serve.cluster.router``;
host-only numpy, it never touches a device): bucketed fan-out over RPC
shards + host-side merge under SERVER-SIDE authority (DESIGN.md §8.2,
§8.4) — the cross-host form of ``QueryService``'s in-process fan-out,
sharing its actual machinery:
``bucket_for``/``pad_rows`` for micro-batching, the ``plan_overfetch``
budget formula for tombstone slack, ``merge_topk_host`` for the merge.

Topology: N ``scorer`` servers each hold one contiguous row slice of the
ONE build (bit-identity depends on that — frozen artifacts are global,
rows are sliced); the ``primary`` owns mutations and serves the delta
part; ``replica`` followers serve whole-query parts for follower reads
and failover.  The merge order is ``[scorer 0 … scorer S-1, delta]`` —
exactly the in-process ``[main shards…, delta]`` — so stable-sort
tie-breaking, and therefore every bit of every result, matches the
single-process service.

AUTHORITY IS SERVER-SIDE: the primary versions its liveness state
(tombstones, fully-deleted overlay, delta live count) with a
``(term, epoch)`` tag; this router keeps only a CACHE of it.  Every chunk
dispatches the delta request as a validation channel carrying the cached
tag — a mismatched response piggybacks the authoritative sets, and the
merge always uses the authoritative view, re-deepening main fetches when
the cache under-budgeted the overfetch.  That is what makes N routers
over one cluster bit-identical to one router: no router ever merges from
private state another router cannot see (DESIGN.md §8.4).

Failover (DESIGN.md §8.7): ``failover()`` runs a deterministic election
over the replica set (most-applied wins, ties to the lowest index),
promotes the winner via the ``promote`` op — gated server-side on having
applied every sealed seq — and re-points every node at it.  The promoted
term fences the deposed primary: any response carrying a lower term
raises ``StaleTermError`` instead of being folded into state.

Compaction (DESIGN.md §6.3 across processes): the primary flips to
generation g + 1 first, and the scorers load it one after another.  A
chunk pinned at g + 1 that a scorer refuses is served by the primary's
``part="full"`` read (``flip_direct`` in ``stats``); the router then
reads through the primary alone until a ``status`` probe finds every
scorer at g + 1.  No search waits on a reload or is refused for a flip,
as no in-process search is (``QueryService.compact``).  A
``StaleGeneration`` that no path serves is retried, after a resync, up
to the client's ``timeout``.

Read-your-writes: every mutation ack carries its WAL seq; a ``Session``
records the max as its watermark, and follower reads are only served by a
replica whose ``applied_seq`` covers it — otherwise the router falls back
to the primary path.  A replica behind ``last acked seq - replica_max_lag``
is excluded from routing entirely until it catches up.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_futures

import numpy as np

from ...core.distributed import ceil16, merge_topk_host
from ...core.sparse_index import CompactColumns, sparse_queries_to_padded
from ...obs import Observability
from ...obs.trace import NULL_SPAN
from ..query_service import DEFAULT_BUCKETS, bucket_for, pad_rows

from .client import ShardClient, ShardUnavailableError
from .protocol import RemoteError, build_frame

__all__ = ["ClusterRouter", "Session", "DegradedResultError",
           "StaleTermError", "FailoverError"]


class DegradedResultError(RuntimeError):
    """A shard needed for a full-fidelity answer is unreachable and no
    caught-up replica can stand in.  Raised INSTEAD of merging whatever
    parts survived: a silently truncated top-k is a wrong answer that
    looks right, which the fault-injection suite forbids."""


class StaleTermError(RuntimeError):
    """A response carried a fencing term LOWER than one this router has
    already observed: it came from a deposed (zombie) primary.  Its ack is
    refused — the mutation may sit in the zombie's log, but the promoted
    primary's log will never contain it, so folding it into watermarks or
    tombstone state would invent durability (DESIGN.md §8.7)."""


class FailoverError(RuntimeError):
    """No promotion candidate survives the eligibility gate (applied every
    sealed seq, same generation, reachable).  Promoting anything else
    would lose acked mutations, so the election refuses instead."""


@dataclasses.dataclass
class Session:
    """Read-your-writes handle: ``watermark`` is the WAL seq of this
    session's last acked write (-1 = no writes observed yet; real seqs
    start at 1, and seq 0 never occurs); reads made with the session are
    only served by state that has applied at least that seq."""
    watermark: int = -1

    def observe(self, seq: int) -> None:
        """Fold an acked write's seq into the watermark."""
        self.watermark = max(self.watermark, int(seq))


@dataclasses.dataclass(frozen=True)
class _PinnedState:
    """One consistent router-state snapshot for a chunk's lifetime (the
    cross-host analogue of ``QueryService._acquire_view``): generation +
    its corpus geometry, the CACHED liveness sets with their validating
    ``(term, epoch)`` tag, and the last acked seq.  ``epoch == -1`` means
    no cache — the delta response will carry the authoritative sets."""
    gen: int
    num_points: int
    d_active: int
    cols: CompactColumns
    main_dead: frozenset
    fully_deleted: frozenset
    delta_live: int
    last_seq: int
    epoch: int
    term: int


@dataclasses.dataclass
class _Auth:
    """Cached authoritative liveness state for one generation, valid
    exactly at ``(term, epoch)``."""
    epoch: int
    term: int
    main_dead: set
    fully_deleted: set
    delta_live: int


# the least interval between two ``status`` probes of scorers found
# lagging the primary's generation
LAG_PROBE_S = 0.3
# the back-off before a StaleGeneration retry: this times the attempt,
# capped
STALE_BACKOFF_S, STALE_BACKOFF_MAX_S = 0.05, 0.25


class _ScorersBehind(Exception):
    """A scorer refused the chunk's generation, and the primary's delta
    reply shows that generation is the primary's current one: a
    compaction's flip is in progress and the scorers have not loaded it
    yet."""


def _settle(entries) -> None:
    """Collect and drop the replies of coalesced entries whose chunk is
    failing, so each entry's batch completes exactly once and its client's
    coalescer moves on; an entry collected already returns at once, and
    the errors are the chunk's to raise, not these."""
    for en in entries:
        try:
            en.result()
        except Exception:
            pass


def _addr(spec: str) -> tuple[str, int]:
    host, port = spec.rsplit(":", 1)
    return host, int(port)


class ClusterRouter:
    """Client-side coordinator for one shard cluster.

    ``primary``/``scorers``/``replicas`` are ``host:port`` endpoints (see
    ``local.LocalCluster`` for a one-call launcher).  Searches take raw
    scipy sparse queries (``search_sparse``) or pre-padded compact-space
    batches (``search``); mutations go to the primary and their acks feed
    the router's cache + watermark state; ``compact()`` orchestrates the
    cluster-wide generation flip; ``failover()`` promotes a replica when
    the primary dies.  ``lockstep=True`` disables request pipelining,
    coalescing, AND the adaptive fan-out cutoff (one blocking call per
    shard via the thread pool — the pre-batching wire discipline, kept
    for the benchmark's before/after comparison).

    ``direct_q_max`` is the adaptive fan-out cutoff (DESIGN.md §8.8):
    chunks whose padded bucket is at most this many queries skip the
    S-scorer scatter-gather and get served by ONE ``part="full"`` request
    to the primary — the same main+delta read (and the same
    bit-identical merge) a replica serves, against the node that is
    trivially caught-up.  A single query through S scorers pays S+1 RPCs
    of fixed dispatch cost to do one process worth of scoring; the
    scatter-gather only earns its overhead at batch sizes that fill the
    slices.  ``0`` disables the cutoff (every chunk fans out)."""

    def __init__(self, primary: str, scorers: list[str],
                 replicas: list[str] = (), *, h: int = 10,
                 alpha: int | None = None, beta: int | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 prefer_replica: bool = False, replica_max_lag: int = 0,
                 lockstep: bool = False, direct_q_max: int = 1,
                 timeout: float = 60.0, obs: Observability | None = None):
        # tracing defaults ON for the router: per-chunk span trees are
        # the hop breakdown's only source (DESIGN.md §9.2), and their
        # cost is microseconds against millisecond RPCs
        self.obs = obs if obs is not None else Observability(trace=True)
        self.primary = ShardClient(*_addr(primary), timeout=timeout)
        self.scorers = [ShardClient(*_addr(a), timeout=timeout)
                        for a in scorers]
        self.replicas = [ShardClient(*_addr(a), timeout=timeout)
                         for a in replicas]
        self.buckets = buckets
        self.prefer_replica = prefer_replica
        self.replica_max_lag = replica_max_lag
        self.lockstep = lockstep
        self.direct_q_max = int(direct_q_max)
        self.timeout = timeout
        # a generation the scorers were found not to hold yet, and when
        # they may next be probed (``_scorers_lag``)
        self._lag_gen: int | None = None
        self._lag_probe_at = 0.0
        self._lock = threading.RLock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, len(self.scorers) + 1),
            thread_name_prefix="router-fanout")
        info, arrays = self.primary.call("info")
        self.gen = int(info["gen"])
        self.h = h
        self.alpha = int(info["alpha"] if alpha is None else alpha)
        self.beta = int(info["beta"] if beta is None else beta)
        self._num_points = int(info["num_points"])
        self._d_active = int(info["d_active"])
        self._nq_max = int(info["nq_max"])
        self._cols = CompactColumns(global_ids=arrays["cols_global_ids"])
        self.term = int(info.get("term", 0))
        self._auth = {self.gen: _Auth(
            epoch=int(info.get("epoch", 0)), term=self.term,
            main_dead=set(arrays["main_tombstones"].tolist()),
            fully_deleted=set(arrays["fully_deleted"].tolist()),
            delta_live=int(info["delta_live"]))}
        self._last_seq = int(info["applied_seq"])
        self._replica_seq = [(-1) for _ in self.replicas]
        self.stats = {"primary_reads": 0, "replica_reads": 0,
                      "direct_reads": 0, "flip_direct": 0,
                      "failovers": 0, "degraded": 0,
                      "stale_retries": 0, "excluded_stale": 0,
                      "queries": 0, "resyncs": 0, "promotions": 0}
        # cumulative per-stage hop counters, folded from finished chunk
        # spans (``_fold_stages``) — the span-sourced replacement for the
        # old ad-hoc ``hop_s`` field scraping (DESIGN.md §9.2)
        m = self.obs.metrics
        self._hop_c = {k: m.counter(f"cluster.hop.{k}")
                       for k in ("serialize_s", "wire_s", "queue_s",
                                 "score_s", "merge_s")}

    # -- sessions ---------------------------------------------------------

    def session(self) -> Session:
        """A fresh read-your-writes session (watermark -1 = any state)."""
        return Session()

    # -- term fencing + state cache ---------------------------------------

    def _fence_term(self, term: int) -> None:
        """Refuse a deposed primary's response (caller holds ``_lock``):
        terms only grow, so anything below the highest one this router has
        seen is a zombie talking (DESIGN.md §8.7)."""
        if term and term < self.term:
            raise StaleTermError(
                f"response carries term {term} but this router has seen "
                f"term {self.term}: a deposed primary is still answering; "
                "refusing its state")
        if term > self.term:
            self.term = term

    def _adopt_auth(self, gen: int, term: int, epoch: int, main_dead: set,
                    fully_deleted: set, delta_live: int) -> None:
        """Install a synced authoritative view as the cache for ``gen``
        (caller holds ``_lock``); never replaces a newer tag."""
        a = self._auth.get(gen)
        if a is None or (term, epoch) >= (a.term, a.epoch):
            self._auth[gen] = _Auth(epoch=epoch, term=term,
                                    main_dead=main_dead,
                                    fully_deleted=fully_deleted,
                                    delta_live=delta_live)

    def _resync(self) -> None:
        """Re-learn generation, corpus geometry, column space and the
        authoritative liveness state from the primary — another router may
        have compacted, mutated, or failed the cluster over since this
        router last looked."""
        info, arrays = self.primary.call("info")
        with self._lock:
            self._fence_term(int(info.get("term", 0)))
            g = int(info["gen"])
            self.gen = g
            self._num_points = int(info["num_points"])
            self._d_active = int(info["d_active"])
            self._cols = CompactColumns(
                global_ids=arrays["cols_global_ids"])
            self._adopt_auth(g, int(info.get("term", 0)),
                             int(info.get("epoch", 0)),
                             set(arrays["main_tombstones"].tolist()),
                             set(arrays["fully_deleted"].tolist()),
                             int(info["delta_live"]))
            self._auth = {gg: aa for gg, aa in self._auth.items()
                          if gg == g}
            self._last_seq = max(self._last_seq, int(info["applied_seq"]))
            self.stats["resyncs"] += 1

    # -- mutations (primary only) -----------------------------------------

    def _ack(self, meta: dict, *, main_killed, resurrected=(),
             fully_killed=(), session: Session | None,
             span=NULL_SPAN) -> None:
        """Fold one mutation ack into the watermark state and — when the
        ack extends the cache's exact ``(term, epoch)`` tag — the cached
        liveness view.  An ack that does NOT extend the tag (another
        router mutated in between) invalidates the cache instead: the
        next read's delta response re-syncs it from authority.  A stale
        term raises ``StaleTermError`` BEFORE anything is folded — a
        zombie's ack must not move watermarks (and the refusal is
        recorded as a ``term_fenced`` annotation on the mutation's
        span)."""
        seq = meta["seq"]
        term = int(meta.get("term", 0))
        with self._lock:
            try:
                self._fence_term(term)
            except StaleTermError:
                span.annotate(f"term_fenced: ack term {term} < "
                              f"router term {self.term}, refused")
                raise
            g = int(meta["gen"])
            e = int(meta.get("epoch", 0))
            a = self._auth.get(g)
            if a is not None:
                if a.term == term and e in (a.epoch, a.epoch + 1):
                    a.main_dead.update(int(x) for x in main_killed)
                    a.fully_deleted.update(int(x) for x in fully_killed)
                    a.fully_deleted.difference_update(
                        int(x) for x in resurrected)
                    a.delta_live = int(meta["delta_live"])
                    a.epoch = e
                else:
                    del self._auth[g]
            if seq is not None:
                self._last_seq = max(self._last_seq, int(seq))
        # ``is not None``, not truthiness: only a no-op mutation acks with
        # seq None, and a session must observe every REAL seq it was acked
        if session is not None and seq is not None:
            session.observe(seq)

    def insert(self, x_sparse, x_dense, ids=None,
               session: Session | None = None) -> np.ndarray:
        """Insert (or upsert) rows via the primary; returns the assigned
        external ids.  Acked only after the primary's WAL covers the batch
        (its group-commit discipline); the ack's ``main_killed`` ids feed
        the router's cached liveness view and its seq the session
        watermark."""
        import scipy.sparse as sp
        xs = sp.csr_matrix(x_sparse)
        arrays = {"data": xs.data, "indices": xs.indices,
                  "indptr": xs.indptr,
                  "shape": np.asarray(xs.shape, np.int64),
                  "dense": np.atleast_2d(np.asarray(x_dense, np.float32))}
        if ids is not None:
            arrays["ids"] = np.atleast_1d(np.asarray(ids, np.int64))
        with self.obs.tracer.root("cluster.insert") as sp:
            hs = sp.child("rpc", peer=self.primary.addr, part="insert")
            ctx = sp.wire_context()
            meta, arr = self.primary.call(
                "insert", {"trace": ctx} if ctx else None, arrays,
                retry=False, span=hs)
            self._finish_hop(hs, meta)
            assigned = arr["ids"]
            self._ack(meta, main_killed=arr["main_killed"],
                      resurrected=assigned.tolist(), session=session,
                      span=sp)
        return assigned

    def delete(self, ids, session: Session | None = None) -> int:
        """Tombstone rows by external id via the primary; returns #killed.
        The ack's killed ids join BOTH cached sets: ``main_dead`` (drop
        from scorer parts) and ``fully_deleted`` (the overlay that stops a
        lagging replica resurrecting them, DESIGN.md §8.4)."""
        with self.obs.tracer.root("cluster.delete") as sp:
            hs = sp.child("rpc", peer=self.primary.addr, part="delete")
            ctx = sp.wire_context()
            meta, arr = self.primary.call(
                "delete", {"trace": ctx} if ctx else None,
                {"ids": np.atleast_1d(np.asarray(ids, np.int64))},
                retry=False, span=hs)
            self._finish_hop(hs, meta)
            self._ack(meta, main_killed=arr["main_killed"],
                      fully_killed=arr["killed_ids"].tolist(),
                      session=session, span=sp)
        return int(meta["killed"])

    # -- compaction (cluster-wide generation flip) ------------------------

    def compact(self, retrain: bool | None = None) -> int:
        """Orchestrate a cluster compaction: pause replica shipping, fold
        delta + tombstones at the primary (cut as a durable checkpoint),
        have every scorer/replica reload the new store, then
        atomically flip the router's generation + seed the new epoch's
        cache from the compact ack's tag.  Old-generation searches keep
        working mid-flip (servers hold the last two generations), and a
        search pinned at the new one is served by the primary until every
        scorer holds it (module docstring).  A ``cluster.compact`` trace
        times the fold and each reload (one ``rpc`` child each).  Returns
        the new generation number."""
        with self.obs.tracer.root("cluster.compact") as sp:
            for r in self.replicas:
                r.call("fault", {"mode": "pause_shipping"})
            hs = sp.child("rpc", peer=self.primary.addr, part="compact")
            meta, arrays = self.primary.call("compact", {"retrain": retrain},
                                             retry=False, span=hs)
            hs.end()
            gen = int(meta["gen"])
            for c in [*self.scorers, *self.replicas]:
                hs = sp.child("rpc", peer=c.addr, part="reload")
                c.call("reload", {"gen": gen}, span=hs)
                hs.end()
        with self._lock:
            self._fence_term(int(meta.get("term", 0)))
            self.gen = gen
            self._num_points = int(meta["num_points"])
            self._d_active = int(meta["d_active"])
            self._cols = CompactColumns(
                global_ids=arrays["cols_global_ids"])
            # a fresh generation starts with empty liveness sets, valid at
            # the compact ack's tag; a mutation racing the flip bumps the
            # server epoch past it, so the tag validation catches it
            self._auth = {gen: _Auth(epoch=int(meta.get("epoch", 0)),
                                     term=int(meta.get("term", 0)),
                                     main_dead=set(), fully_deleted=set(),
                                     delta_live=0)}
        return gen

    # -- failover (DESIGN.md §8.7) ----------------------------------------

    def failover(self, new_primary: int | None = None) -> int:
        """Promote a replica to primary after the primary died: a
        deterministic election (every router over the same replica set
        picks the same winner: most applied seqs first, ties to the lowest
        index), committed by the ``promote`` op whose server-side gate
        re-checks eligibility under the apply lock.  The new term fences
        the deposed primary everywhere.  Re-points every surviving node's
        upstream, then re-syncs state from the new primary.  Returns the
        new term; raises ``FailoverError`` when no candidate has applied
        every sealed (acked) seq."""
        with self._lock:
            sealed = self._last_seq
            gen = self.gen
            known_term = self.term
        with self.obs.tracer.root("cluster.failover", gen=gen,
                                  sealed_seq=sealed) as sp:
            candidates = []
            for i, rep in enumerate(self.replicas):
                try:
                    st, _ = rep.call("status")
                except (ShardUnavailableError, ConnectionError):
                    sp.annotate(f"candidate {rep.addr} unreachable")
                    continue
                known_term = max(known_term, int(st.get("term", 0)))
                if st.get("role") != "replica" or int(st["gen"]) != gen:
                    continue
                candidates.append((int(st["applied_seq"]), i))
                sp.annotate(f"candidate {rep.addr} "
                            f"applied={int(st['applied_seq'])}")
            eligible = [(a, i) for a, i in candidates if a >= sealed]
            if new_primary is not None:
                eligible = [(a, i) for a, i in eligible
                            if i == new_primary]
            if not eligible:
                sp.annotate("election_failed: no caught-up candidate")
                raise FailoverError(
                    f"no eligible promotion candidate: need applied_seq "
                    f">= sealed seq {sealed} at gen {gen}, saw "
                    f"{sorted(candidates)}; promoting a lagging replica "
                    "would lose acked mutations")
            eligible.sort(key=lambda t: (-t[0], t[1]))
            win = eligible[0][1]
            new_term = known_term + 1
            target = self.replicas[win]
            sp.annotate(f"promote winner={target.addr} "
                        f"new_term={new_term}")
            meta, _ = target.call("promote", {"sealed_seq": sealed,
                                              "new_term": new_term},
                                  retry=False)
            old = self.primary
            with self._lock:
                self.primary = target
                del self.replicas[win]
                del self._replica_seq[win]
                self.term = new_term
                self._last_seq = max(self._last_seq,
                                     int(meta["applied_seq"]))
                # the new primary's state IS the authority now — drop the
                # cache and re-sync below rather than trusting anything
                # folded from the deposed primary's acks
                self._auth.pop(gen, None)
                self.stats["promotions"] += 1
            sp.set("term", new_term)
            new_addr = f"{target.host}:{target.port}"
            for c in [*self.scorers, *self.replicas]:
                try:
                    c.call("set_peer", {"peer": new_addr})
                except (ShardUnavailableError, ConnectionError):
                    pass             # unreachable now; it re-learns on
                                     # restart or the next reload
            old.close()
            self._resync()
        return new_term

    # -- search -----------------------------------------------------------

    def _slice_sizes(self, n: int) -> list[int]:
        """Row counts per scorer under the ragged ceil-split — must mirror
        ``split_index_arrays(..., ragged=True)`` exactly, since the
        overfetch budget computes per-slice fetch depths from them."""
        s = len(self.scorers)
        base, rem = divmod(n, s)
        return [base + 1 if i < rem else base for i in range(s)]

    def _pin(self) -> _PinnedState:
        """Snapshot the router's view for one chunk: generation + corpus
        geometry pinned TOGETHER (a compaction racing the chunk cannot
        re-budget old-generation fetch depths from the new generation's
        row count), plus the cached liveness sets and their validating
        tag."""
        with self._lock:
            g = self.gen
            a = self._auth.get(g)
            return _PinnedState(
                gen=g, num_points=self._num_points,
                d_active=self._d_active, cols=self._cols,
                main_dead=frozenset(a.main_dead) if a else frozenset(),
                fully_deleted=(frozenset(a.fully_deleted) if a
                               else frozenset()),
                delta_live=a.delta_live if a else 0,
                last_seq=self._last_seq,
                epoch=a.epoch if a else -1,
                term=a.term if a else -1)

    def search_sparse(self, q_sparse, q_dense, *, h: int | None = None,
                      alpha: int | None = None, beta: int | None = None,
                      session: Session | None = None):
        """Serve RAW scipy sparse queries: encode against the pinned
        generation's compact column space (generation-bound, like
        ``QueryService.search_sparse``; encoded again whenever a retry
        pins another generation), then fan out.  Returns
        ``(scores (Q, h), ids (Q, h))`` in external ids."""
        q_dense = np.atleast_2d(np.asarray(q_dense, np.float32))

        def encode(pin):
            q_dims, q_vals = sparse_queries_to_padded(q_sparse, pin.cols,
                                                      nq_max=self._nq_max)
            return (np.atleast_2d(np.asarray(q_dims, np.int32)),
                    np.atleast_2d(np.asarray(q_vals, np.float32)), q_dense)
        return self._search_pinned(self._pin(), encode, h, alpha, beta,
                                   session)

    def search(self, q_dims, q_vals, q_dense, *, h: int | None = None,
               alpha: int | None = None, beta: int | None = None,
               session: Session | None = None):
        """Serve pre-padded compact-space query batches (generation-bound
        — streaming clients should prefer ``search_sparse``).  Returns
        ``(scores (Q, h), ids (Q, h))`` numpy arrays, bit-identical to the
        in-process ``QueryService`` fan-out on the same state."""
        q = (np.atleast_2d(np.asarray(q_dims, np.int32)),
             np.atleast_2d(np.asarray(q_vals, np.float32)),
             np.atleast_2d(np.asarray(q_dense, np.float32)))
        return self._search_pinned(self._pin(), lambda pin: q, h, alpha,
                                    beta, session)

    def _search_pinned(self, pin, encode, h, alpha, beta, session):
        """Serve the queries ``encode(pin)`` gives, a chunk of the largest
        bucket at a time; ``encode`` is called again for a new pin."""
        h = self.h if h is None else h
        alpha = self.alpha if alpha is None else alpha
        beta = self.beta if beta is None else beta
        q_dims, q_vals, q_dense = encode(pin)
        qn_total = q_dims.shape[0]
        out_s = np.empty((qn_total, h), np.float32)
        out_i = np.empty((qn_total, h), np.int64)
        max_bucket = self.buckets[-1]
        for lo in range(0, qn_total, max_bucket):
            hi = min(lo + max_bucket, qn_total)
            # one root span per chunk, covering its whole retry loop —
            # the trace tree the hop breakdown is sourced from
            with self.obs.tracer.root("cluster.search",
                                      qn=hi - lo, gen=pin.gen) as span:
                deadline = time.monotonic() + self.timeout
                attempt = 0
                while True:
                    try:
                        s, ids = self._run_chunk(
                            pin, q_dims[lo:hi], q_vals[lo:hi],
                            q_dense[lo:hi], h, alpha, beta, session,
                            span)
                        break
                    except RemoteError as e:
                        left = deadline - time.monotonic()
                        if "StaleGeneration" not in str(e) or left <= 0:
                            raise
                        # a compaction flipped generations mid-flight
                        # (possibly driven by ANOTHER router): re-learn
                        # the cluster state from the primary, re-pin,
                        # retry against the new epoch, until the
                        # client's timeout
                        attempt += 1
                        with self._lock:
                            self.stats["stale_retries"] += 1
                        span.annotate("stale_generation_resync "
                                      f"attempt={attempt}")
                        time.sleep(min(STALE_BACKOFF_S * (attempt - 1),
                                       STALE_BACKOFF_MAX_S, left))
                        try:
                            self._resync()
                        except (ShardUnavailableError, ConnectionError):
                            pass
                        gen = pin.gen
                        pin = self._pin()
                        if pin.gen != gen:
                            q_dims, q_vals, q_dense = encode(pin)
                        span.set("gen", pin.gen)
            out_s[lo:hi], out_i[lo:hi] = s, ids
        with self._lock:
            self.stats["queries"] += qn_total
        return out_s, out_i

    def _run_chunk(self, pin, q_dims, q_vals, q_dense, h, alpha,
                   beta, session, span=NULL_SPAN):
        qn = q_dims.shape[0]
        bucket = bucket_for(qn, self.buckets)
        qd = pad_rows(q_dims, bucket, fill=pin.d_active)
        qv = pad_rows(q_vals, bucket)
        qe = pad_rows(q_dense, bucket)
        required = session.watermark if session is not None else -1
        floor = max(required, pin.last_seq - self.replica_max_lag)

        if self.prefer_replica and self.replicas:
            res = self._try_replicas(pin, qd, qv, qe, qn, h, alpha, beta,
                                     floor, span)
            if res is not None:
                return res
        try:
            if bucket <= self.direct_q_max and not self.lockstep:
                return self._primary_full(pin, qd, qv, qe, qn, h,
                                          alpha, beta, span)
            if not self._scorers_lag(pin.gen):
                try:
                    return self._fanout(pin, qd, qv, qe, qn, h, alpha,
                                        beta, span)
                except _ScorersBehind:
                    with self._lock:
                        self._lag_gen = pin.gen
                        self._lag_probe_at = time.monotonic() + LAG_PROBE_S
            # a flip in progress: the primary holds the pinned generation
            # whole, and its full read is the one a replica would serve
            span.annotate(f"scorers_behind gen={pin.gen}: primary full")
            return self._primary_full(pin, qd, qv, qe, qn, h, alpha, beta,
                                      span, stat="flip_direct")
        except (ShardUnavailableError, ConnectionError):
            with self._lock:
                self.stats["failovers"] += 1
            span.annotate("shard_unreachable: replica failover")
            res = self._try_replicas(pin, qd, qv, qe, qn, h, alpha, beta,
                                     floor, span)
            if res is not None:
                return res
            with self._lock:
                self.stats["degraded"] += 1
            span.annotate("degraded: no caught-up replica")
            raise DegradedResultError(
                "a scoring shard is unreachable and no replica has "
                f"applied seq >= {floor}; refusing to return a silently "
                "truncated top-k") from None

    def _scorers_lag(self, gen: int) -> bool:
        """True while the scorers are known not to hold ``gen`` (a chunk
        then goes to the primary).  At most every ``LAG_PROBE_S`` the
        scorers' ``status`` is read, and once each reports ``gen`` or
        later the router fans out again."""
        with self._lock:
            if self._lag_gen != gen:
                return False
            now = time.monotonic()
            if now < self._lag_probe_at:
                return True
            self._lag_probe_at = now + LAG_PROBE_S
        try:
            held = min((int(c.call("status")[0]["gen"])
                        for c in self.scorers), default=gen)
        except (ShardUnavailableError, ConnectionError, RemoteError):
            return True
        if held < gen:
            return True
        with self._lock:
            if self._lag_gen == gen:
                self._lag_gen = None
        return False

    @staticmethod
    def _behind(pin, e: RemoteError, delta_result) -> bool:
        """Whether a fan-out cut by ``e`` met a flip in progress: a scorer
        refused the pinned generation, and the primary's delta reply
        (``delta_result()``, settled) shows it as the primary's current
        one."""
        if "StaleGeneration" not in str(e):
            return False
        try:
            dmeta, _ = delta_result()
        except Exception:
            return False
        return int(dmeta.get("current_gen", pin.gen)) == pin.gen

    def _collect(self, client, entry, cmd, meta, arrays, span=NULL_SPAN):
        """Collect one pipelined reply, healing a transport failure (torn
        frame, dropped socket) with ONE fresh-connection resend — the same
        discipline and ``reconnects`` accounting as ``ShardClient.call``;
        searches are idempotent, so the resend is safe.  Returns
        ``(rmeta, rarrays)``; the entry's PER-REQUEST timing (wall /
        serialize / coalescer queue — _CoalescedReply fields, never
        shared across requests) is folded into ``span``, and a healed
        resend both re-times through ``call(span=…)`` and annotates the
        span, so the trace survives the reconnect (DESIGN.md §9.2)."""
        try:
            rmeta, rarr = entry.result()
            span.add("serialize_s", entry.send_s)
            span.add("queue_s", entry.queue_s)
            span.set("wall_s", entry.wall_s)
            return rmeta, rarr
        except RemoteError:
            raise
        except ShardUnavailableError:
            raise
        except (ConnectionError, OSError):
            client.reconnects += 1
            span.annotate(f"reconnect_resend cmd={cmd}")
            return client.call(cmd, meta, arrays, retry=False, span=span)

    def _finish_hop(self, hs, rmeta: dict) -> None:
        """Finish one hop span: attach the shard's serialized child span
        (``rmeta["trace"]``, present iff the request carried a trace
        context), fold its server-measured ``queue_s``/``score_s`` into
        the hop's stage tags, and set ``wire_s`` as the residual so the
        stages sum exactly to the hop's measured ``wall_s``
        (serialize + queue + score + wire == wall, DESIGN.md §9.2)."""
        rt = rmeta.get("trace")
        # every hop carries the full stage vocabulary (queue_s is 0.0
        # for replies without a server span, e.g. mutations)
        hs.add("queue_s", float(rt.get("queue_s", 0.0)) if rt else 0.0)
        if rt:
            # score/queue live as hop stage tags; don't duplicate them on
            # the attached child or stage totals would double-count
            hs.attach_remote({k: v for k, v in rt.items()
                              if k not in ("queue_s", "score_s")})
        hs.add("score_s", float(rmeta.get("score_s", 0.0)))
        wall = hs.tags.get("wall_s", 0.0)
        measured = (hs.tags.get("serialize_s", 0.0)
                    + hs.tags.get("queue_s", 0.0)
                    + hs.tags.get("score_s", 0.0))
        hs.set("wire_s", max(0.0, wall - measured))
        hs.end()
        # fold this hop into the cumulative counters exactly once (per
        # hop span, so chunk retries never double-count)
        for k in ("serialize_s", "wire_s", "queue_s", "score_s"):
            v = hs.tags.get(k)
            if v:
                self._hop_c[k].inc(v)

    def _merge_timed(self, span, t_m: float) -> None:
        """Tag the chunk span with the host-merge duration measured from
        ``t_m`` and fold it into the cumulative merge counter."""
        dt = time.perf_counter() - t_m
        span.add("merge_s", dt)
        self._hop_c["merge_s"].inc(dt)

    def _primary_full(self, pin, qd, qv, qe, qn, h, alpha, beta,
                      span=NULL_SPAN, stat: str = "direct_reads"):
        """The adaptive fan-out cutoff: serve one small chunk with ONE
        ``part="full"`` request to the primary (DESIGN.md §8.8).  The
        primary scores its whole main engine plus the live delta — the
        exact read a replica serves, merged with the exact same per-part
        drop construction, against the one node whose applied prefix is
        the cluster's truth (read-your-writes floors hold trivially).
        The response's ``main_tombstones`` are the CURRENT authoritative
        kills and the server self-slacks its fetch depth by them, so a
        stale pinned cache can neither truncate nor resurrect; a frozen
        pinned generation gets the server's StaleGeneration refusal and
        re-pins through ``_search_pinned``'s retry loop.  ``stat`` names
        the counter of such reads: ``direct_reads`` for the cutoff,
        ``flip_direct`` for a chunk the scorers cannot serve yet."""
        t0 = time.perf_counter()
        span.set("path", "direct" if stat == "direct_reads" else stat)
        dead = pin.main_dead | pin.fully_deleted
        h_fetch = min(h + (ceil16(len(dead)) if dead else 0),
                      pin.num_points)
        req = {"part": "full", "gen": pin.gen, "h": int(h_fetch),
               "alpha": int(alpha), "beta": int(beta)}
        ctx = span.wire_context()
        if ctx:
            req["trace"] = ctx
        hs = span.child("rpc", peer=self.primary.addr, part="full")
        meta, arrays = self.primary.call(
            "search", req, {"q_dims": qd, "q_vals": qv, "q_dense": qe},
            span=hs)
        self._finish_hop(hs, meta)
        with self._lock:
            self._fence_term(int(meta.get("term", 0)))
            self._last_seq = max(self._last_seq,
                                 int(meta.get("applied_seq", -1)))
        drop_main = set(arrays["main_tombstones"].tolist())
        drop_main.update(pin.fully_deleted)
        parts = [(arrays["ms"][:qn], arrays["mi"][:qn],
                  np.asarray(sorted(drop_main), np.int64))]
        if "ds" in arrays:
            parts.append((arrays["ds"][:qn], arrays["di"][:qn],
                          np.asarray(sorted(pin.fully_deleted),
                                     np.int64)))
        t_m = time.perf_counter()
        s, ids = merge_topk_host(parts, h)
        self._merge_timed(span, t_m)
        span.set("wall_s", time.perf_counter() - t0)
        with self._lock:
            self.stats["primary_reads"] += qn
            self.stats[stat] += qn
        return s, ids

    def _fanout(self, pin, qd, qv, qe, qn, h, alpha, beta,
                span=NULL_SPAN):
        """The S-scorer + primary-delta path.  The delta request is ALWAYS
        dispatched — it is the chunk's state-validation channel: its
        response either confirms the pinned cache tag or carries the
        authoritative liveness sets, and the merge uses whichever is
        authoritative.  Main fetches are re-deepened (once, only the
        under-budgeted slices) when the authoritative dead set needs more
        overfetch slack than the cache predicted — main parts are pure
        functions of (generation, depth, query), so a re-fetch merges
        exactly as a first fetch would have.

        Per-hop timing is a child span per shard RPC; the SAME chunk
        trace context rides every request meta (one shared value keeps
        the build-once frame sharing intact), and each shard's reply
        carries its server child span back (DESIGN.md §9.2)."""
        t0 = time.perf_counter()
        span.set("path", "fanout")
        sizes = self._slice_sizes(pin.num_points)
        # the plan_overfetch budget formula over pinned slice sizes
        slack = ceil16(len(pin.main_dead)) if pin.main_dead else 0
        h_fetch = [min(h + slack, sz) for sz in sizes]
        q_arrays = {"q_dims": qd, "q_vals": qv, "q_dense": qe}
        ctx = span.wire_context()
        dmeta_req = {"part": "delta", "gen": pin.gen, "h": int(h),
                     "alpha": int(alpha), "beta": int(beta),
                     "have_epoch": pin.epoch, "have_term": pin.term}
        metas = [{"part": "main", "gen": pin.gen, "h": int(hf),
                  "alpha": int(alpha), "beta": int(beta)}
                 for hf in h_fetch]
        if ctx:
            dmeta_req["trace"] = ctx
            for m in metas:
                m["trace"] = ctx
        if self.lockstep:
            hspans = [span.child("rpc", peer=c.addr, part="main")
                      for c in self.scorers]
            dspan = span.child("rpc", peer=self.primary.addr,
                               part="delta")
            futs = [self._pool.submit(c.call, "search", m, q_arrays,
                                      span=hs)
                    for c, m, hs in zip(self.scorers, metas, hspans)]
            dfut = self._pool.submit(self.primary.call, "search",
                                     dmeta_req, q_arrays, span=dspan)
            try:
                mains = [f.result() for f in futs]
                dmeta, darr = dfut.result()
            except RemoteError as e:
                wait_futures([*futs, dfut])    # none outlives the chunk
                if self._behind(pin, e, dfut.result):
                    raise _ScorersBehind() from e
                raise
            except BaseException:
                wait_futures([*futs, dfut])
                raise
            for (rm, _), hs in zip(mains, hspans):
                self._finish_hop(hs, rm)
            self._finish_hop(dspan, dmeta)
        else:
            # pipelined: every request on the wire before any reply is
            # read; one pre-built frame shared by every scorer with the
            # same fetch depth (serialize the query batch ONCE); the
            # per-client coalescer may fold concurrent chunks' requests
            # into msearch frames
            frames: dict[int, bytes] = {}
            entries, hspans = [], []
            for c, m, hf in zip(self.scorers, metas, h_fetch):
                fr = frames.get(hf)
                if fr is None:
                    fr = frames[hf] = build_frame("search", m, q_arrays)
                hspans.append(span.child("rpc", peer=c.addr,
                                         part="main"))
                entries.append(c.submit_search(m, q_arrays, frame=fr))
            dspan = span.child("rpc", peer=self.primary.addr,
                               part="delta")
            dentry = self.primary.submit_search(dmeta_req, q_arrays)
            mains = []
            try:
                for c, m, en, hs in zip(self.scorers, metas, entries,
                                        hspans):
                    rm, ra = self._collect(c, en, "search", m, q_arrays,
                                           span=hs)
                    mains.append((rm, ra))
                    self._finish_hop(hs, rm)
                dmeta, darr = self._collect(self.primary, dentry, "search",
                                            dmeta_req, q_arrays,
                                            span=dspan)
            except BaseException as e:
                # a shard's StaleGeneration (or any failure) cuts the
                # collect loop: settle every entry first, or the clients
                # whose entries went uncollected keep their coalescing
                # slot forever and queue every later search behind it
                _settle([*entries, dentry])
                if isinstance(e, RemoteError) and \
                        self._behind(pin, e, dentry.result):
                    raise _ScorersBehind() from e
                raise
            self._finish_hop(dspan, dmeta)

        # adopt / confirm the authoritative liveness state
        with self._lock:
            self._fence_term(int(dmeta.get("term", 0)))
        # a frozen-generation reply means another router compacted since
        # this chunk pinned: the frozen state misses every post-flip
        # mutation, so re-learn the cluster and retry instead of serving
        # it (the StaleGeneration retry loop in ``_search_pinned``)
        cur_g = int(dmeta.get("current_gen", pin.gen))
        if cur_g != pin.gen:
            raise RemoteError(
                f"StaleGeneration: generation {pin.gen} is frozen — the "
                f"cluster has compacted to generation {cur_g}")
        live = int(dmeta["live"])
        if dmeta.get("sync"):
            auth_md = frozenset(
                int(x) for x in darr["sync_main_dead"].tolist())
            auth_fd = frozenset(
                int(x) for x in darr["sync_fully_deleted"].tolist())
            if int(dmeta.get("epoch", 0)) > 0:    # 0 = frozen prev-gen
                with self._lock:
                    self._adopt_auth(pin.gen, int(dmeta["term"]),
                                     int(dmeta["epoch"]), set(auth_md),
                                     set(auth_fd), live)
        else:
            auth_md, auth_fd = pin.main_dead, pin.fully_deleted

        # re-deepen under-budgeted main fetches against the authoritative
        # dead set
        need = ceil16(len(auth_md)) if auth_md else 0
        if need > slack:
            for k, sz in enumerate(sizes):
                hf2 = min(h + need, sz)
                if hf2 > h_fetch[k]:
                    m2 = dict(metas[k], h=int(hf2))
                    hs2 = span.child("rpc", peer=self.scorers[k].addr,
                                     part="main-redeepen")
                    rm, ra = self.scorers[k].call("search", m2, q_arrays,
                                                  span=hs2)
                    self._finish_hop(hs2, rm)
                    mains[k] = (rm, ra)

        # assemble parts exactly as the in-process fanout_search does:
        # scorer slices in row order (filtered), delta last (unfiltered)
        parts = []
        for rm, ra in mains:
            parts.append((np.asarray(ra["scores"])[:qn],
                          np.asarray(ra["ids"]).astype(np.int64)[:qn],
                          True))
        if live > 0:
            parts.append((np.asarray(darr["scores"])[:qn],
                          np.asarray(darr["ids"]).astype(np.int64)[:qn],
                          False))
        t_m = time.perf_counter()
        s, ids = merge_topk_host(parts, h, drop_ids=auth_md,
                                 dedup_upserts=True)
        self._merge_timed(span, t_m)
        span.set("wall_s", time.perf_counter() - t0)
        with self._lock:
            self.stats["primary_reads"] += qn
        return s, ids

    def _try_replicas(self, pin, qd, qv, qe, qn, h, alpha, beta, floor,
                      span=NULL_SPAN):
        """Serve the chunk from the first eligible replica, or None.
        Eligibility is checked from the cached applied seq (refreshing
        via a status poll when stale) BEFORE the search RPC, and enforced
        again on the response tag — a replica below the floor never
        serves the read (DESIGN.md §8.4).  The overfetch budget covers
        the UNION of both cached dead sets: the merge drops the
        ``fully_deleted`` overlay from the replica's parts too, so
        budgeting from ``main_dead`` alone could truncate the merged
        top-k below h (the replica adds its own self-slack for kills this
        router has not seen)."""
        dead = pin.main_dead | pin.fully_deleted
        h_fetch = min(h + (ceil16(len(dead)) if dead else 0),
                      pin.num_points)
        ctx = span.wire_context()
        for i, rep in enumerate(self.replicas):
            hs = span.child("rpc", peer=rep.addr, part="full",
                            replica=i)
            try:
                if self._replica_seq[i] < floor:
                    st, _ = rep.call("status")
                    with self._lock:
                        self._replica_seq[i] = int(st["applied_seq"])
                    if self._replica_seq[i] < floor or \
                            int(st["gen"]) != pin.gen:
                        with self._lock:
                            self.stats["excluded_stale"] += 1
                        hs.annotate("excluded_stale")
                        hs.end()
                        continue
                req = {"part": "full", "gen": pin.gen,
                       "h": int(h_fetch), "alpha": int(alpha),
                       "beta": int(beta)}
                if ctx:
                    req["trace"] = ctx
                meta, arrays = rep.call(
                    "search", req,
                    {"q_dims": qd, "q_vals": qv, "q_dense": qe},
                    span=hs)
            except (ShardUnavailableError, ConnectionError, RemoteError):
                hs.annotate("replica_unreachable")
                hs.end()
                continue
            with self._lock:
                self._replica_seq[i] = int(meta["applied_seq"])
                # a lagging replica legitimately reports an old term —
                # adopt newer terms, never refuse follower reads over it
                self.term = max(self.term, int(meta.get("term", 0)))
            if int(meta["applied_seq"]) < floor or \
                    int(meta["gen"]) != pin.gen:
                with self._lock:
                    self.stats["excluded_stale"] += 1
                hs.annotate("excluded_stale")
                hs.end()
                continue
            # merge the replica's consistent-prefix parts under the
            # router's view: its own main tombstones (its prefix's
            # upsert/delete kills) plus fully_deleted on BOTH parts — a
            # stale tombstone view can hide nothing and resurrect nothing
            self._finish_hop(hs, meta)
            span.set("path", "replica")
            drop_main = set(arrays["main_tombstones"].tolist())
            drop_main.update(pin.fully_deleted)
            parts = [(arrays["ms"][:qn], arrays["mi"][:qn],
                      np.asarray(sorted(drop_main), np.int64))]
            if "ds" in arrays:
                parts.append((arrays["ds"][:qn], arrays["di"][:qn],
                              np.asarray(sorted(pin.fully_deleted),
                                         np.int64)))
            t_m = time.perf_counter()
            s, ids = merge_topk_host(parts, h)
            self._merge_timed(span, t_m)
            with self._lock:
                self.stats["replica_reads"] += qn
            return s, ids
        return None

    # -- introspection ----------------------------------------------------

    def hops(self) -> dict:
        """Cumulative per-stage hop seconds — ``{"serialize_s",
        "wire_s", "queue_s", "score_s", "merge_s"}`` — folded from every
        finished hop span (searches AND mutations).  Span-sourced: the
        registry counters behind this are only written by
        ``_finish_hop``/``_merge_timed`` (DESIGN.md §9.2)."""
        return {k: c.value for k, c in self._hop_c.items()}

    def metrics(self) -> dict:
        """JSON-ready snapshot of the router's metrics registry."""
        return self.obs.metrics.snapshot()

    def status(self) -> dict:
        """Router-side cluster view: generation, corpus size, cached
        liveness-set sizes + their validating tag, last acked seq,
        per-replica applied seqs, and the read/failover counters."""
        with self._lock:
            g = self.gen
            a = self._auth.get(g)
            return {"gen": g, "num_points": self._num_points,
                    "term": self.term,
                    "epoch": a.epoch if a else -1,
                    "main_dead": len(a.main_dead) if a else 0,
                    "fully_deleted": len(a.fully_deleted) if a else 0,
                    "delta_live": a.delta_live if a else 0,
                    "last_seq": self._last_seq,
                    "replica_seq": list(self._replica_seq),
                    **self.stats}

    def close(self) -> None:
        """Close every client socket and the fan-out pool (idempotent)."""
        self._pool.shutdown(wait=False)
        for c in [self.primary, *self.scorers, *self.replicas]:
            c.close()
