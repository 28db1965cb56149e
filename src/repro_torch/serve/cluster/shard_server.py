"""Cluster shard server of the port: one process, one role, one framed
socket endpoint (DESIGN.md §8.2–§8.3, §8.7); the roles, ops and wire
replies of ``repro.serve.cluster.shard_server``, scoring on a device.

Three roles share the server shell (accept loop, dispatch, fault hooks):

* ``primary`` — owns the ONE mutable ``HybridIndex`` and its persist store
  (``persist.recover``): applies + WAL-logs every mutation, serves the
  DELTA search part, distributes its snapshot store to bootstrapping
  peers, and serves the WAL tail to replicas (``wal_fetch``).  Compaction
  happens here, cut as a durable checkpoint the other roles reload from.
* ``scorer`` — serves the MAIN search part for one row slice: bootstraps
  by copying the primary's store, loads the snapshot, keeps
  ``split_index_arrays(..., ragged=True)[shard]`` plus that slice's
  external ids.  The frozen artifacts (codebooks, column space) are the
  primary's own, which is what makes the RPC fan-out bit-identical to the
  in-process one: there is ONE build, row-sliced — never N builds.
* ``replica`` — a full follower: bootstraps from the store, then ships the
  WAL tail (``MutationWAL.append_frames`` into its OWN local log, then
  ``persist.apply_record`` through the normal mutation path), so a replica
  restarted mid-ingest recovers from its local snapshot + shipped log to
  the exact applied seq.  Serves whole-query (main + delta) parts tagged
  with ``applied_seq`` for the router's watermark rule (DESIGN.md §8.4).
  A caught-up replica can be PROMOTED to primary (``promote`` op), fenced
  by the WAL's monotonic term so the deposed primary's writes are refused
  everywhere (DESIGN.md §8.7).

AUTHORITY lives here, not in any router: the primary's liveness view —
tombstones, fully-deleted ids, delta live count — is versioned by a
``(term, epoch)`` tag that every mutation ack and delta response carries.
Routers keep only a cache keyed by that tag; a delta response whose tag
differs from the request's ``have_epoch``/``have_term`` piggybacks the
full authoritative sets (``state_sync`` serves the same payload on
demand), which is what makes N routers over one cluster bit-identical to
one router (DESIGN.md §8.4).

Every search request carries the router's generation tag; a request
against a generation this process does not hold raises
``StaleGenerationError`` back across the wire — the router re-syncs and
retries rather than merging parts from mixed generations.

A compaction never stalls a read: the primary folds and checkpoints off
the lock that searches, ``info`` and resyncs take (mutations wait on a
lock of their own), and a follower fetches and loads the new store off it
too; each then swaps the new generation in under the lock at once.

The device (``--device``, ``cuda`` unless the caller asks for the CPU):
every engine of the node lives there.  A search request's arrays cross to
it once; results come back to the host with ``device.to_numpy`` and are
mapped to external ids there.  A scorer loads the snapshot on the host,
row-slices it and copies only its slice to the device, so the slice owns
its storage; a generation it drops is freed by storage
(``release_index_arrays``) once no search still reads it.  Searches run
on one device thread per node, not in the connection threads: the card
is one queue anyway, and every host thread that calls cuBLAS keeps a
workspace of its own on the card, so a thread per connection would grow
the node's device memory with its connections.  The ``info``
reply names the backend as the JAX package does (``pallas`` for
``cuda``), and ``stats`` adds this process's kernel launches, the
kernels' build record and, on the card, its allocator's bytes — fields a
reference router ignores.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import shutil
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import persist
from ...core.distributed import ceil16, split_index_arrays
from ...core.engine import ScoringEngine, release_index_arrays
from ...device import resolve_device, to_numpy
from ...kernels import ops
from ...kernels.ref import PLAIN_CALLS
from ...obs import Observability
from ...persist.snapshot import REFERENCE_BACKEND_NAMES

from .client import ShardClient
from .protocol import MSG_ERROR, MSG_RESPONSE, recv_msg, send_msg

__all__ = ["ShardServer", "StaleGenerationError", "NotPrimaryError",
           "PromotionError", "main"]


HOLD_LIMIT_S = 300.0      # the longest a held fold or reload waits


class StaleGenerationError(RuntimeError):
    """The request's generation tag is not one this server holds (a
    compaction moved the cluster on, or the caller is ahead of a server
    that has not reloaded yet).  The router treats it as retriable after a
    state re-sync — never as data."""
    kind = "StaleGeneration"


class NotPrimaryError(RuntimeError):
    """A mutation (or compaction) was sent to a node that is not the
    primary.  Applying it locally would fork the replicated log — the
    exact divergence the single-writer discipline exists to prevent — so
    it is refused outright; the router re-discovers the primary and
    re-drives."""
    kind = "NotPrimary"


class PromotionError(RuntimeError):
    """A ``promote`` request failed its eligibility gate: the target is
    not a replica, has not applied every sealed (acked) seq, or the
    proposed term does not exceed its current one.  Promoting anyway would
    lose acked mutations or un-fence a zombie — the router must pick
    another candidate (DESIGN.md §8.7)."""
    kind = "Promotion"


def _to_device(tree, dev: torch.device):
    """A copy of a (nested) dataclass of tensors with every tensor on
    ``dev``: a row slice copied to the card owns its storage."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_device(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree) if f.init})
    return tree


class _Gen:
    """One generation a scorer serves: the slice engine, its external ids,
    the slice's global row extent, and the searches still reading it (a
    retired generation is freed when the last one ends)."""

    def __init__(self, engine, ext_ids, num_points_total):
        self.engine = engine
        self.ext_ids = ext_ids
        self.num_points_total = num_points_total
        self.users = 0
        self.retired = False

    def release(self) -> None:
        """Free the slice's device storages (caller holds the lock)."""
        release_index_arrays(self.engine.arrays)


class ShardServer:
    """The process behind one cluster endpoint; see the module docstring
    for the role split.  ``start()`` binds (port 0 = ephemeral), spawns the
    accept loop, and returns the bound port; ``__main__`` prints
    ``READY <port>`` on stdout so a launcher can scrape it."""

    def __init__(self, role: str, *, store: str | None = None,
                 peer: str | None = None, shard: int = 0,
                 num_shards: int = 1, workdir: str | None = None,
                 backend: str | None = None, poll_interval: float = 0.02,
                 device="cuda", obs: Observability | None = None):
        if role not in ("primary", "scorer", "replica"):
            raise ValueError(f"unknown role {role!r}")
        self.role = role
        self.device = resolve_device(device)
        # server-side tracing is enabled but PER-REQUEST opt-in: a child
        # span is built only when the request meta carries a trace
        # context, so untraced routers cost this server nothing
        # (DESIGN.md §9.2)
        self.obs = obs if obs is not None else Observability(trace=True)
        self._h_score = self.obs.metrics.histogram("server.score_s")
        # raw score seconds of the latest searches, for stats' p50 / p99
        self._score_s = collections.deque(maxlen=4096)
        self.kernel_build: dict = {}
        self.bootstrap_s = 0.0
        # seconds by stage of the latest fold (primary) or store load
        # (scorer, replica: bootstrap or reload)
        self.stages_s: dict[str, float] = {}
        self.fetched_bytes = 0           # snapshot bytes copied from peers
        # the one thread that runs searches on the device (module docstring)
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{role}-device")
        self.baseline_allocated = 0
        self.store = store
        self.peer = peer
        self.shard = shard
        self.num_shards = num_shards
        self.workdir = workdir
        self.backend = backend
        self.poll_interval = poll_interval
        self.generation = 1
        self._lock = threading.RLock()
        # mutations and the primary's fold: held across a whole fold, so
        # no mutation lands between the fold and the swap (it would be
        # lost); searches, ``info`` and resyncs take only ``_lock``.
        # Order: ``_mut_lock`` before ``_lock``
        self._mut_lock = threading.Lock()
        # a follower's reloads, one at a time (a replica's share one
        # directory); taken before ``_lock``, never with ``_mut_lock``
        self._reload_lock = threading.Lock()
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        self._faults: set[str] = set()
        # armed holds (``hold_fold`` / ``hold_reload``) and the steps
        # waiting on one now (``_hold``)
        self._holds: dict[str, threading.Event] = {}
        self._holding: set[str] = set()
        self._ship_paused = threading.Event()
        self._ship_thread: threading.Thread | None = None
        self.shipped_records = 0
        # primary / replica
        self.index = None
        self.durability = None
        self._applied_seq = 0
        self._prev_index = None          # (gen, index) kept across a flip
        self._prev_auth = None           # frozen (main_dead, fully_deleted)
        self._delta_engine_cache: dict[tuple, ScoringEngine] = {}
        # liveness-state version: bumped under _lock on every op that can
        # change what a merge must drop (mutation, shipped record, flip,
        # promotion).  Paired with the WAL term it orders authoritative
        # state ACROSS primaries: terms only grow, so (term, epoch)
        # compares lexicographically even though a promoted replica's
        # epoch counter is unrelated to the deposed primary's.
        self._state_epoch = 1
        # scorer
        self._gens: dict[int, _Gen] = {}

    # -- bootstrap --------------------------------------------------------

    def _peer_client(self) -> ShardClient:
        host, port = self.peer.rsplit(":", 1)
        return ShardClient(host, int(port))

    def _warm_device(self) -> None:
        """On the device thread, before any index is loaded: one cuBLAS
        product, so its workspace exists, then record the process's device
        bytes — the baseline ``stats`` reports beside
        ``memory_allocated``."""
        a = torch.ones((8, 8), device=self.device)
        (a @ a).sum().item()
        torch.bmm(a[None], a[None]).sum().item()
        self.baseline_allocated = torch.cuda.memory_allocated(self.device)

    def _fetch_store(self, root: str) -> None:
        """Snapshot distribution: copy the peer's committed store into
        ``root``, counting the bytes fetched."""
        client = self._peer_client()
        try:
            files = client.fetch_store(root)
        finally:
            client.close()
        self.fetched_bytes += sum(os.path.getsize(os.path.join(root, rel))
                                  for rel in files)

    def bootstrap(self) -> None:
        """Bring this role to serving state (blocking; run before
        ``start``): primary recovers its store; scorer/replica fetch the
        primary's store first when they have none (snapshot
        distribution).  On the card the kernels are built (or found
        built) first, so no search compiles."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from ...kernels import _build
            self.kernel_build = _build.build()
            self._device_thread.submit(self._warm_device).result()
        if self.role == "primary":
            rec = persist.recover(self.store, backend=self.backend,
                                  metrics=self.obs.metrics,
                                  device=self.device)
            self.index, self.durability = rec.index, rec.durability
            self._applied_seq = self.durability.wal.next_seq - 1
        elif self.role == "scorer":
            self._load_slice(self.generation)
        else:                            # replica
            if persist.read_current(self.store) is None:
                self._fetch_store(self.store)
            rec = persist.recover(self.store, backend=self.backend,
                                  metrics=self.obs.metrics,
                                  device=self.device)
            self.index, self.durability = rec.index, rec.durability
            self._applied_seq = self.durability.wal.next_seq - 1
            peer_status, _ = self._peer_client().call("status")
            self.generation = int(peer_status["gen"])
            self._start_shipping()
        self.bootstrap_s = time.perf_counter() - t0

    def _load_slice(self, gen: int) -> None:
        """Scorer: fetch the primary's current store into a per-generation
        directory, load the snapshot on the host, keep only this shard's
        row slice (plus its external ids), copied to the device, and drop
        the fetched copy — and at most the last two generations, so
        in-flight old-generation requests drain during a flip."""
        root = os.path.join(self.workdir, f"gen-{gen:04d}")
        t0 = time.perf_counter()
        self._fetch_store(root)
        t1 = time.perf_counter()
        index, _ = persist.load_snapshot(root, backend=self.backend,
                                         device="cpu")
        shutil.rmtree(root)              # the slice below is all it keeps
        t2 = time.perf_counter()
        parts, offsets = split_index_arrays(index.engine.arrays,
                                            self.num_shards, ragged=True)
        lo = int(offsets[self.shard])
        hi = lo + parts[self.shard].num_points
        g = _Gen(engine=ScoringEngine(
                     arrays=_to_device(parts[self.shard], self.device),
                     backend=index.engine.backend),
                 ext_ids=np.asarray(index.mutable_state.id_map[lo:hi]),
                 num_points_total=index.engine.arrays.num_points)
        del index, parts
        self.stages_s = {"fetch": t1 - t0, "load": t2 - t1,
                              "slice_to_device": time.perf_counter() - t2}
        self._hold("reload")
        with self._lock:
            if gen in self._gens or gen < self.generation:   # overtaken
                g.release()
                return
            self._gens[gen] = g
            self.generation = gen
            for old in sorted(self._gens)[:-2]:
                dropped = self._gens.pop(old)
                dropped.retired = True
                if dropped.users == 0:
                    dropped.release()

    # -- replication shipping (replica role) ------------------------------

    def _start_shipping(self) -> None:
        self._ship_thread = threading.Thread(target=self._ship_loop,
                                             daemon=True,
                                             name="wal-shipping")
        self._ship_thread.start()

    def applied_seq(self) -> int:
        """Last WAL seq whose effects are VISIBLE in this process's
        serving state.  On the primary that is the log's high-water mark
        (apply-then-log); on a replica it advances only after
        ``apply_record`` returns (log-then-apply) — the distinction the
        watermark rule (DESIGN.md §8.4) depends on: a replica must never
        advertise a seq whose mutation a read could still miss.  Recovery
        re-establishes it exactly (the replica-restart test pins this)."""
        if self.role == "primary":
            return self.durability.wal.next_seq - 1
        return self._applied_seq

    def term(self) -> int:
        """The WAL's fencing term (DESIGN.md §8.7); 0 for scorers, which
        hold no log and take no part in fencing."""
        return self.durability.wal.term if self.durability is not None else 0

    def _ship_loop(self) -> None:
        """Replica tail loop: poll the (current) primary for frames past
        our applied seq, append them BYTE-IDENTICAL to the local log, then
        apply each through the normal mutation path — log-then-apply, so a
        crash between the two replays the record on restart instead of
        losing it.  Follows ``set_peer`` re-pointing (failover moves the
        tail source to the promoted primary) and exits the moment this
        process is itself promoted."""
        peer_addr = self.peer
        peer = self._peer_client()
        while not self._stop.is_set():
            if self.role != "replica":
                peer.close()
                return                   # promoted: this process leads now
            if self.peer != peer_addr:   # re-pointed at a new primary
                peer.close()
                peer_addr = self.peer
                peer = self._peer_client()
            if self._ship_paused.is_set():
                time.sleep(self.poll_interval)
                continue
            try:
                meta, arrays = peer.call(
                    "wal_fetch", {"from_seq": self.applied_seq() + 1})
            except ConnectionError:
                time.sleep(self.poll_interval)
                continue
            frames = arrays["frames"].tobytes()
            if not frames:
                time.sleep(self.poll_interval)
                continue
            try:
                with self._lock:
                    if self.role != "replica":
                        peer.close()
                        return
                    for rec in self.durability.wal.append_frames(frames):
                        persist.apply_record(self.index, rec)
                        self._applied_seq = rec.seq
                        self.shipped_records += 1
                        self._state_epoch += 1
            except ValueError:
                # the term fence refused the frames — a deposed primary is
                # still talking; drop the batch and re-poll (a set_peer /
                # promote is racing this fetch)
                time.sleep(self.poll_interval)

    # -- authoritative liveness state (DESIGN.md §8.4) --------------------

    def _auth_state(self, index) -> tuple[np.ndarray, np.ndarray]:
        """The two dead-id sets every merge must drop, from THIS node's
        applied state (caller holds ``_lock``): ``main_dead`` (tombstoned
        main rows — upserts and deletes both) and ``fully_deleted`` (ids
        with no live copy anywhere — the overlay that stops a lagging
        follower resurrecting them)."""
        st = index.mutable_state
        main_dead = np.asarray(sorted(st.main_tombstones), np.int64)
        fully = (st.main_tombstones | set(st.extra_ids)) - st._loc.keys()
        return main_dead, np.asarray(sorted(fully), np.int64)

    def _ensure_primary(self) -> None:
        if self.role != "primary":
            raise NotPrimaryError(
                f"this node is a {self.role}; mutations go to the primary")

    # -- op handlers ------------------------------------------------------

    def _check_gen(self, meta: dict) -> int:
        gen = int(meta["gen"])
        ok = gen in self._gens if self.role == "scorer" else \
            gen == self.generation or (
                self._prev_index is not None and gen == self._prev_index[0])
        if not ok:
            raise StaleGenerationError(
                f"{self.role} holds generation {self.generation}, "
                f"request wants {gen}")
        return gen

    def _delta_engine(self, index, snap) -> ScoringEngine:
        key = (id(index), snap.version, snap.capacity)
        eng = self._delta_engine_cache.get(key)
        if eng is None:
            self._delta_engine_cache.clear()      # one live snapshot view
            eng = ScoringEngine(arrays=snap.arrays,
                                backend=index.engine.backend)
            self._delta_engine_cache[key] = eng
        return eng

    def _op_search(self, meta, arrays):
        # the request's arrays cross to the device once, shared by every
        # engine this request runs
        qd, qv, qe = (torch.from_numpy(arrays[k]).to(self.device)
                      for k in ("q_dims", "q_vals", "q_dense"))
        h = int(meta["h"])
        alpha, beta = int(meta["alpha"]), int(meta["beta"])
        part = meta["part"]
        # per-request opt-in child span: NULL_SPAN unless the request
        # meta carries the router's trace context (DESIGN.md §9.2)
        sp = self.obs.tracer.from_wire(meta.get("trace"), "shard.search",
                                       role=self.role, part=part)
        t0 = time.perf_counter()
        if part == "main":                       # scorer row slice
            with self._lock:
                gen_no = self._check_gen(meta)
                gen = self._gens[gen_no]
                gen.users += 1
            try:
                s, ids, _ = gen.engine.search(qd, qv, qe, h=h,
                                              alpha=alpha, beta=beta)
                s, ids = to_numpy(s), to_numpy(ids)
            finally:
                with self._lock:
                    gen.users -= 1
                    if gen.retired and gen.users == 0:
                        gen.release()
            # local slice positions -> external ids; -1 sentinels wrap to
            # the slice's last id exactly like the in-process
            # ``id_map[off + ids]`` (their scores are non-finite, so the
            # merge rewrites them to -1 either way)
            out = {"scores": s, "ids": gen.ext_ids[ids]}
            rmeta = {"gen": gen_no}
        elif part == "delta":                    # primary delta shard
            with self._lock:
                gen = self._check_gen(meta)
                current = gen == self.generation
                index = self.index if current else self._prev_index[1]
                st = index.mutable_state
                snap = st.delta.snapshot() if st.delta.live_count else None
                eng = (self._delta_engine(index, snap)
                       if snap is not None else None)
                # the delta response doubles as the router's state
                # validation channel: tag it, and when the caller's cached
                # (term, epoch) is not exactly ours — or it asked about a
                # frozen previous generation (epoch 0 sentinel) — piggyback
                # the full authoritative sets, captured under the SAME lock
                # as the delta snapshot so both describe one state
                epoch = self._state_epoch if current else 0
                term = self.term()
                # ``current_gen`` lets a router that pinned a frozen
                # generation discover the flip from the wire (another
                # router may have compacted) instead of silently serving
                # pre-compaction state that misses newer mutations
                rmeta = {"gen": gen, "epoch": epoch, "term": term,
                         "current_gen": self.generation,
                         "applied_seq": self.applied_seq(),
                         "live": snap.live if snap is not None else 0}
                sync = (not current
                        or int(meta.get("have_epoch", -1)) != epoch
                        or int(meta.get("have_term", -1)) != term)
                if sync:
                    md, fd = self._auth_state(index)
            if snap is None:
                q = int(arrays["q_dims"].shape[0])
                out = {"scores": np.zeros((q, 0), np.float32),
                       "ids": np.zeros((q, 0), np.int64)}
            else:
                s, ids, _ = eng.search(qd, qv, qe, h=snap.capacity,
                                       alpha=alpha, beta=beta)
                out = {"scores": to_numpy(s),
                       "ids": snap.ids[to_numpy(ids)]}
            if sync:
                rmeta["sync"] = True
                out["sync_main_dead"] = md
                out["sync_fully_deleted"] = fd
        elif part == "full":                     # replica OR primary direct
            with self._lock:
                # strictly current-generation: this branch scores
                # ``self.index``, so a frozen prev-gen pin must get the
                # StaleGeneration signal (and re-pin), never current rows
                # budgeted under old-generation geometry
                if int(meta["gen"]) != self.generation:
                    raise StaleGenerationError(
                        f"{self.role} serves part='full' only at its "
                        f"current generation {self.generation}, request "
                        f"wants {meta['gen']}")
                # the index is read under the lock with its delta and
                # tombstones: a fold's swap may replace ``self.index``
                # while this search runs
                index = self.index
                st = index.mutable_state
                snap = st.delta.snapshot() if st.delta.live_count else None
                eng = (self._delta_engine(index, snap)
                       if snap is not None else None)
                tombs = np.asarray(sorted(st.main_tombstones), np.int64)
                applied = self.applied_seq()
                gen, term = self.generation, self.term()
            # self-slack: the caller budgeted overfetch from ITS dead-id
            # view, which cannot know kills this node applied that the
            # caller has not seen acked — deepen the fetch by our own
            # tombstone count so dropping them can never truncate below
            # the requested k (overfetch depth cannot change the merged
            # top-k, only guarantee it)
            n = index.engine.arrays.num_points
            h_eff = min(h + (ceil16(len(tombs)) if len(tombs) else 0), n)
            ms, mi, _ = index.engine.search(qd, qv, qe, h=h_eff,
                                            alpha=alpha, beta=beta)
            out = {"ms": to_numpy(ms),
                   "mi": np.asarray(st.id_map)[to_numpy(mi)],
                   "main_tombstones": tombs}
            if snap is not None:
                ds, di, _ = eng.search(qd, qv, qe, h=snap.capacity,
                                       alpha=alpha, beta=beta)
                out["ds"], out["di"] = to_numpy(ds), snap.ids[to_numpy(di)]
            rmeta = {"gen": gen, "applied_seq": applied, "term": term,
                     "delta_live": snap.live if snap is not None else 0}
        else:
            raise ValueError(f"unknown search part {part!r}")
        score_s = time.perf_counter() - t0
        rmeta["score_s"] = score_s
        self._h_score.observe(score_s)
        self._score_s.append(score_s)
        if sp:
            # the serialized child span the router folds into its hop
            # span; queue_s 0 here — ``msearch`` overwrites it with the
            # sub's measured dispatch wait
            sp.set("score_s", score_s)
            sp.set("queue_s", 0.0)
            rmeta["trace"] = sp.to_wire()
        return rmeta, out

    def _op_msearch(self, meta, arrays):
        """Coalesced searches: ``subs`` is a list of search metas, arrays
        are keyed ``"<i>:<name>"``.  Each sub runs independently; a sub
        that fails reports ``error``/``kind`` in ITS slot of the reply's
        ``subs`` instead of failing the frame — the batch is a transport
        artifact, not a transaction (DESIGN.md §8.8).  Subs run
        sequentially, so sub i waits behind subs 0..i-1; that wait is
        the server-side ``queue_s`` stamped into each traced sub's child
        span — the coalesced-pipelined path's per-request timing that
        previously had no home (DESIGN.md §9.2)."""
        rsubs: list[dict] = []
        out: dict = {}
        t_start = time.perf_counter()
        for i, sub in enumerate(meta["subs"]):
            prefix = f"{i}:"
            sub_arrays = {k[len(prefix):]: v for k, v in arrays.items()
                          if k.startswith(prefix)}
            waited = time.perf_counter() - t_start
            try:
                rm, ra = self._op_search(dict(sub), sub_arrays)
            except Exception as e:
                rm, ra = {"error": f"{type(e).__name__}: {e}",
                          "kind": getattr(e, "kind", type(e).__name__)}, {}
            tr = rm.get("trace")
            if tr is not None:
                tr["queue_s"] = waited
            rsubs.append(rm)
            for k, v in ra.items():
                out[f"{i}:{k}"] = v
        return {"subs": rsubs}, out

    def _op_state_sync(self, meta, arrays):
        """The authoritative liveness snapshot on demand (routers call it
        at attach, after failover, and whenever their cache tag went
        stale): the full dead-id sets plus the (term, epoch) tag and seq /
        corpus scalars, all captured under one lock."""
        if self.index is None:
            raise ValueError("scorers hold no authoritative state; "
                             "state_sync is a primary/replica op")
        with self._lock:
            st = self.index.mutable_state
            md, fd = self._auth_state(self.index)
            return ({"gen": self.generation, "epoch": self._state_epoch,
                     "term": self.term(), "role": self.role,
                     "applied_seq": self.applied_seq(),
                     "delta_live": st.delta.live_count,
                     "num_points": self.index.engine.arrays.num_points,
                     "d_active": self.index.engine.arrays.d_active},
                    {"main_dead": md, "fully_deleted": fd})

    def _op_insert(self, meta, arrays):
        import scipy.sparse as sp
        self._ensure_primary()
        xs = sp.csr_matrix((arrays["data"], arrays["indices"],
                            arrays["indptr"]),
                           shape=tuple(np.asarray(arrays["shape"])))
        ids = arrays["ids"] if "ids" in arrays else None
        with self._mut_lock, self._lock:
            self.durability.ensure_ok()
            st = self.index.mutable_state
            before = set(st.main_tombstones)
            assigned = self.index.insert(xs, arrays["dense"], ids=ids)
            seq = self.durability.log_insert(xs, arrays["dense"], assigned,
                                             sync=False)
            main_killed = sorted(st.main_tombstones - before)
            delta_live = st.delta.live_count
            self._state_epoch += 1
            gen, epoch, term = self.generation, self._state_epoch, self.term()
        self.durability.sync(seq)                # group-commit ack
        return ({"seq": seq, "gen": gen, "epoch": epoch,
                 "term": term, "delta_live": delta_live},
                {"ids": np.asarray(assigned, np.int64),
                 "main_killed": np.asarray(main_killed, np.int64)})

    def _op_delete(self, meta, arrays):
        self._ensure_primary()
        req = np.atleast_1d(np.asarray(arrays["ids"], np.int64))
        with self._mut_lock, self._lock:
            self.durability.ensure_ok()
            st = self.index.mutable_state
            before = set(st.main_tombstones)
            was_live = [int(e) for e in req if int(e) in st._loc]
            killed = self.index.delete(req)
            # seq is None — not 0 — when nothing was logged: 0 is never a
            # real WAL seq, but callers folding watermarks must be able to
            # test "was anything acked" without a falsy-zero trap
            seq = (self.durability.log_delete(req, sync=False)
                   if killed else None)
            main_killed = sorted(st.main_tombstones - before)
            delta_live = st.delta.live_count
            if killed:
                self._state_epoch += 1
            gen, epoch, term = self.generation, self._state_epoch, self.term()
        if seq is not None:
            self.durability.sync(seq)
        return ({"seq": seq, "gen": gen, "killed": killed,
                 "epoch": epoch, "term": term, "delta_live": delta_live},
                {"killed_ids": np.asarray(sorted(was_live), np.int64),
                 "main_killed": np.asarray(main_killed, np.int64)})

    def _op_compact(self, meta, arrays):
        """Fold the delta and tombstones into generation g + 1, cut it as a
        durable checkpoint, then swap it in.  The fold and the checkpoint
        run off ``_lock`` (as ``QueryService.compact`` runs off its serving
        lock): searches, ``info`` and resyncs go on reading generation g
        and its delta meanwhile, and flip at the swap, one critical
        section.  Mutations wait on ``_mut_lock`` for the whole fold, so
        none lands between the fold and the swap and none is lost."""
        retrain = meta.get("retrain")
        self._ensure_primary()
        with self._mut_lock:
            self.durability.ensure_ok()
            t0 = time.perf_counter()
            new_index = self.index.compact(retrain=retrain)
            t1 = time.perf_counter()
            self.durability.checkpoint(new_index)
            self.stages_s = {"fold": t1 - t0,
                             "checkpoint": time.perf_counter() - t1}
            self._hold("fold")
            with self._lock:
                self._prev_index = (self.generation, self.index)
                self.index = new_index
                self.generation += 1
                self._delta_engine_cache.clear()
                self._state_epoch += 1
                gen, epoch = self.generation, self._state_epoch
            return ({"gen": gen, "epoch": epoch, "term": self.term(),
                     "num_points": new_index.engine.arrays.num_points,
                     "d_active": new_index.engine.arrays.d_active,
                     "next_seq": self.durability.wal.next_seq},
                    {"cols_global_ids":
                     np.asarray(new_index.cols.global_ids)})

    # -- failover (DESIGN.md §8.7) ----------------------------------------

    def _op_promote(self, meta, arrays):
        """Promote this replica to primary — the router-driven election's
        commit point.  Gated under the SAME lock that serializes shipped-
        record application, so the eligibility check is exact: a replica
        that passes ``applied_seq >= sealed_seq`` here has applied every
        mutation any router ever acked.  The new term is persisted BEFORE
        the role flips, and a no-op term barrier is logged immediately:
        the first record the new primary ships proves the new term to
        every follower, closing the window where a zombie's same-seq frame
        could still look current."""
        sealed = int(meta["sealed_seq"])
        new_term = int(meta["new_term"])
        with self._lock:
            if self.role != "replica":
                raise PromotionError(
                    f"cannot promote a {self.role}; promotion targets a "
                    "replica")
            if self._applied_seq < sealed:
                raise PromotionError(
                    f"replica applied seq {self._applied_seq} < sealed "
                    f"seq {sealed}: promoting it would lose acked "
                    "mutations")
            if new_term <= self.durability.wal.term:
                raise PromotionError(
                    f"proposed term {new_term} does not exceed current "
                    f"term {self.durability.wal.term}")
            self.durability.wal.set_term(new_term)
            self.role = "primary"        # the ship loop sees this and exits
            barrier = self.durability.log_noop()
            self._state_epoch += 1
            return ({"term": new_term, "seq": barrier,
                     "gen": self.generation, "epoch": self._state_epoch,
                     "applied_seq": self.applied_seq()}, {})

    def _op_set_peer(self, meta, arrays):
        """Re-point this node's upstream (failover moved the primary): a
        replica's ship loop re-targets its WAL tail fetches, a scorer's
        next reload fetches the store from the new address."""
        self.peer = str(meta["peer"])
        return {"peer": self.peer}, {}

    def _op_wal_fetch(self, meta, arrays):
        buf, seqs = self.durability.wal.read_frames(
            int(meta["from_seq"]), limit=int(meta.get("limit", 256)))
        return ({"seqs": seqs, "next_seq": self.durability.wal.next_seq},
                {"frames": np.frombuffer(buf, np.uint8)})

    def _op_store_manifest(self, meta, arrays):
        return {"files": persist.store_files(self.store),
                "gen": self.generation}, {}

    def _op_store_file(self, meta, arrays):
        with open(os.path.join(self.store, meta["path"]), "rb") as f:
            data = f.read()
        return {}, {"data": np.frombuffer(data, np.uint8)}

    def _op_reload(self, meta, arrays):
        """Load the primary's post-compaction store.  The fetch and the
        load run off ``_lock``, into a slice of a new generation (scorer)
        or a store directory of its own (replica); searches, ``status``
        and ``info`` go on reading the old generation meanwhile, and the
        swap is one critical section.  A replica promoted while it loaded
        keeps its store, log and term: the swap checks the role again
        under the lock and refuses (``_op_promote`` takes only ``_lock``),
        and a load that a later one has overtaken is dropped."""
        gen = int(meta["gen"])
        if self.role == "primary":
            raise ValueError("primary does not reload; it compacts")
        with self._reload_lock:
            if self.role == "scorer":
                self._load_slice(gen)
                return {"gen": self.generation}, {}
            return self._reload_replica(gen)

    def _reload_replica(self, gen: int):
        # re-bootstrap onto the primary's post-compaction store: the old
        # local store describes a generation that no longer takes writes,
        # so it is replaced by a fresh fetch, and shipping resumes from
        # the new snapshot's replay horizon
        self._ship_paused.set()          # quiesce the tail loop first
        fresh, old = f"{self.store}.next", f"{self.store}.old"
        for litter in (fresh, old):      # of a reload cut short
            shutil.rmtree(litter, ignore_errors=True)
        t0 = time.perf_counter()
        self._fetch_store(fresh)
        t1 = time.perf_counter()
        rec = persist.recover(fresh, backend=self.backend,
                              metrics=self.obs.metrics, device=self.device)
        rec.durability.close()
        self.stages_s = {"fetch": t1 - t0,
                         "recover": time.perf_counter() - t1}
        self._hold("reload")
        with self._lock:
            keep = self.role == "replica" and self.generation < gen
            if keep:
                self.durability.close()
                os.rename(self.store, old)
                os.rename(fresh, self.store)
                self.durability = persist.reopen(self.store,
                                                 metrics=self.obs.metrics)
                self.index = rec.index
                self._applied_seq = self.durability.wal.next_seq - 1
                self.generation = gen
                self._delta_engine_cache.clear()
                self._state_epoch += 1
            role, have = self.role, self.generation
        if not keep:
            release_index_arrays(rec.index.engine.arrays)
        shutil.rmtree(old if keep else fresh)
        if role != "replica":
            raise ValueError(f"promoted to {role} during its reload to "
                             f"generation {gen}; it keeps its own store")
        self._ship_paused.clear()
        return {"gen": have}, {}

    def _op_status(self, meta, arrays):
        out = {"role": self.role, "gen": self.generation,
               "term": self.term()}
        if self.role in ("primary", "replica"):
            st = self.index.mutable_state
            out.update(applied_seq=self.applied_seq(),
                       delta_live=st.delta.live_count,
                       num_points=self.index.engine.arrays.num_points,
                       epoch=self._state_epoch,
                       shipping_paused=self._ship_paused.is_set())
        else:
            g = self._gens[self.generation]
            out.update(num_points_local=g.engine.num_points,
                       num_points=g.num_points_total, shard=self.shard)
        return out, {}

    def _op_info(self, meta, arrays):
        with self._lock:
            idx = self.index
            st = idx.mutable_state
            md, fd = self._auth_state(idx)
            return ({"gen": self.generation,
                     "num_points": idx.engine.arrays.num_points,
                     "d_active": idx.engine.arrays.d_active,
                     "nq_max": idx.params.nq_max,
                     # the JAX package's name, which its routers read
                     "backend": REFERENCE_BACKEND_NAMES[idx.engine.backend],
                     "h": 10, "alpha": idx.params.alpha,
                     "beta": idx.params.beta,
                     "delta_live": st.delta.live_count,
                     "applied_seq": self.applied_seq(),
                     "epoch": self._state_epoch, "term": self.term(),
                     "role": self.role},
                    {"cols_global_ids": np.asarray(idx.cols.global_ids),
                     "main_tombstones": md, "fully_deleted": fd})

    def _hold(self, step: str) -> None:
        """Wait here while ``hold_<step>`` is armed, until
        ``release_<step>`` (at most ``HOLD_LIMIT_S``): a fold or a reload
        made as long as a test needs."""
        held = self._holds.get(step)
        if held is None:
            return
        self._holding.add(step)
        try:
            held.wait(HOLD_LIMIT_S)
        finally:
            self._holding.discard(step)

    def _op_fault(self, meta, arrays):
        """Fault injection: ``pause_shipping`` / ``resume_shipping``
        (replica), ``corrupt_next`` / ``close_next`` (the next reply),
        and, in the port's nodes only, ``hold_fold`` / ``hold_reload``:
        the primary's next fold and a follower's next reload wait before
        their swap, until ``release_fold`` / ``release_reload``."""
        mode = meta["mode"]
        if mode == "pause_shipping":
            self._ship_paused.set()
        elif mode == "resume_shipping":
            self._ship_paused.clear()
        elif mode in ("corrupt_next", "close_next"):
            self._faults.add(mode)
        elif mode in ("hold_fold", "hold_reload"):
            self._holds[mode.partition("_")[2]] = threading.Event()
        elif mode in ("release_fold", "release_reload"):
            held = self._holds.pop(mode.partition("_")[2], None)
            if held is not None:
                held.set()
        else:
            raise ValueError(f"unknown fault mode {mode!r}")
        return {"mode": mode}, {}

    def _op_ping(self, meta, arrays):
        return {"pong": True}, {}

    def _op_stats(self, meta, arrays):
        """Observability RPC: this node's full metrics registry snapshot
        (per-op counters, score-time histogram, WAL durability gauges on
        primary/replica) plus role/generation — how routers and the
        benches read server-side numbers (DESIGN.md §9.1).  The port adds
        this process's kernel launches and plain-version calls by kernel,
        the p50 / p99 of its latest score seconds, the kernels it compiled
        at bootstrap (none when it found them built), its bootstrap
        seconds, the seconds by stage of its latest fold or store load, the
        snapshot bytes it fetched, the generations a scorer holds, the held
        steps waiting now (``holding``) and, on the card,
        ``torch.cuda.memory_allocated`` /
        ``max_memory_allocated`` beside the baseline the process held
        before it loaded any index (``_warm_device``)."""
        with self._lock:
            gens = sorted(self._gens)
            samples = np.asarray(self._score_s, np.float64)
        out = {"role": self.role, "gen": self.generation,
               "applied_seq": self.applied_seq(),
               "metrics": self.obs.metrics.snapshot(),
               "device": str(self.device),
               "kernel_launches": dict(ops.LAUNCHES),
               "plain_calls": dict(PLAIN_CALLS),
               "kernels_built": list(self.kernel_build.get("built", [])),
               "bootstrap_s": self.bootstrap_s,
               "stages_s": self.stages_s,
               "store_bytes_fetched": self.fetched_bytes,
               "score_s_p50": (float(np.percentile(samples, 50))
                               if samples.size else None),
               "score_s_p99": (float(np.percentile(samples, 99))
                               if samples.size else None),
               "generations": gens,
               "holding": sorted(self._holding)}
        if self.device.type == "cuda":
            out["baseline_allocated"] = self.baseline_allocated
            out["memory_allocated"] = torch.cuda.memory_allocated(
                self.device)
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                self.device)
        return out, {}

    _OPS = {"search": _op_search, "msearch": _op_msearch,
            "insert": _op_insert, "delete": _op_delete,
            "compact": _op_compact, "state_sync": _op_state_sync,
            "promote": _op_promote, "set_peer": _op_set_peer,
            "wal_fetch": _op_wal_fetch, "store_manifest": _op_store_manifest,
            "store_file": _op_store_file, "reload": _op_reload,
            "status": _op_status, "info": _op_info, "fault": _op_fault,
            "ping": _op_ping, "stats": _op_stats}

    # -- server shell -----------------------------------------------------

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    _, meta, arrays = recv_msg(conn)
                except (ConnectionError, OSError):
                    return
                cmd = meta.pop("cmd", None)
                handler = self._OPS.get(cmd)
                try:
                    if handler is None:
                        raise ValueError(f"unknown command {cmd!r}")
                    if cmd in ("search", "msearch"):
                        rmeta, rarr = self._device_thread.submit(
                            handler, self, meta, arrays).result()
                    else:
                        rmeta, rarr = handler(self, meta, arrays)
                    op = MSG_RESPONSE
                    self.obs.metrics.counter(f"server.op.{cmd}").inc()
                except Exception as e:           # ships as MSG_ERROR
                    rmeta = {"error": f"{type(e).__name__}: {e}",
                             "kind": getattr(e, "kind", type(e).__name__)}
                    rarr, op = {}, MSG_ERROR
                    self.obs.metrics.counter("server.op.errors").inc()
                # fault injection never eats its OWN arming ack — the
                # armed fault fires on the NEXT (non-fault) exchange
                if cmd != "fault" and "close_next" in self._faults:
                    self._faults.discard("close_next")
                    return                       # drop mid-exchange
                corrupt = cmd != "fault" and "corrupt_next" in self._faults
                if corrupt:
                    self._faults.discard("corrupt_next")
                try:
                    send_msg(conn, "reply", rmeta, rarr, op=op,
                             corrupt=corrupt)
                except (ConnectionError, OSError):
                    return
        finally:
            conn.close()

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Bind + listen + spawn the accept loop (daemon thread); returns
        the bound port (``port=0`` picks an ephemeral one)."""
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.2)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"{self.role}-accept").start()
        return self._listener.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def stop(self) -> None:
        """Stop accepting, close the listener, close the store handle."""
        self._stop.set()
        self._device_thread.shutdown(wait=False)
        if self._listener is not None:
            self._listener.close()
        if self.durability is not None:
            self.durability.close()


def main(argv=None) -> int:
    """CLI entry (``python -m repro_torch.serve.cluster.shard_server`` or
    ``repro_torch.launch.serve --role shard``): bootstrap the role on
    ``--device``, bind, print ``READY <port>``, serve until killed."""
    ap = argparse.ArgumentParser(description="hybrid cluster shard server")
    ap.add_argument("--role", required=True,
                    choices=["primary", "scorer", "replica"])
    ap.add_argument("--store", help="persist store root (primary/replica)")
    ap.add_argument("--peer", help="primary host:port (scorer/replica)")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--workdir", help="scratch dir (scorer store fetches)")
    ap.add_argument("--backend", default=None,
                    help="engine backend: the port's names (cuda, "
                         "cuda-packed, onehot, ref) or the JAX package's "
                         "(pallas, pallas-packed, onehot-mxu, ...)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions); no card with cuda is an error")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve this node's metrics registry as a text "
                         "endpoint on the given port (0 = ephemeral)")
    args = ap.parse_args(argv)
    server = ShardServer(args.role, store=args.store, peer=args.peer,
                         shard=args.shard, num_shards=args.num_shards,
                         workdir=args.workdir, backend=args.backend,
                         device=args.device)
    server.bootstrap()
    port = server.start(args.port)
    if args.metrics_port is not None:
        from ...obs import start_metrics_server
        ms = start_metrics_server(server.obs.metrics, args.metrics_port)
        print(f"METRICS {ms.port}", flush=True)
    print(f"READY {port}", flush=True)
    try:
        while not server._stop.is_set():
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
