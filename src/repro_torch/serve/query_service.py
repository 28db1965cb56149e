"""Batched query service — the serving request path over the ScoringEngine
(DESIGN.md §5; the layer that turns the paper's per-server scorer into the
§7.2 online system under production query load); counterpart of
``repro.serve.query_service``, serving on the card through K2, K3 and K1.

``QueryService`` owns everything between "a client hands us hybrid queries"
and "refined top-h ids come back":

* **micro-batching into bucketed static shapes** — incoming
  ``(q_dims, q_vals, q_dense)`` batches are padded up to a small fixed set
  of batch-size buckets (default 1/8/32), so the shapes that reach the
  engine (the keys of the K1/K2 launch-plan caches, ``kernels/lut16.py``
  ``plan_adc`` and the kernels' grids; the jit cache in the JAX package)
  stay bounded by ``len(buckets)`` per parameter combination no matter how
  ragged the request stream is (``jit_cache_info()`` exposes the observed
  keys and the declared bound);

* **an LRU result cache** — results are cached per *query row* under a
  content fingerprint (``core.engine.query_fingerprint`` over the padded
  sparse query, the dense query, the search params, and the index
  generation), with exact hit/miss/eviction counters (``cache_info()``).
  Repeats in a warm stream never touch the device;

* **async shard fan-out** — with ``num_shards > 1`` the index is row-sliced
  once (``core.distributed.split_index_arrays``) into per-shard engines;
  a request dispatches the FULL three-pass search on every shard
  back-to-back (CUDA launches are asynchronous, so the shards' device work
  queues back to back — the in-process analogue of the paper's RPC
  fan-out) and the per-shard top-h sets are merged on the host;

* **double-buffered index refresh** — ``refresh(new_arrays)`` installs a
  rebuilt index without blocking in-flight searches: generations are
  refcounted, a search runs to completion against the generation it
  acquired, and the retired copy's device storages are freed to the
  caching allocator (``core.engine.release_index_arrays``, by storage, so
  a shard's view never frees its parent's) once its last in-flight search
  drops the reference.  Every device call of the service runs on the
  current (default) stream, from the caller's thread, the ``submit`` pool
  or the compaction thread alike, so a freed block is handed out again
  only to work queued after everything that read it;

* **streaming mutation** (DESIGN.md §6) — constructed with a *mutable*
  ``HybridIndex`` (``index=``), the service gains ``insert()``/``delete()``:
  inserts land in the index's device-resident delta shard
  (``core.streaming.DeltaShard``) which is served as ONE MORE engine in the
  fan-out above; deletes tombstone either a delta slot (device-side -inf
  mask) or a main-generation row (dropped at the host merge, with the main
  engines overfetching by the tombstone count so results never come up
  short).  Every mutation bumps a version that the result-cache fingerprint
  incorporates, so a cached hit can never return pre-mutation results.
  Once the delta outgrows ``compact_min_rows`` / ``compact_ratio``, a
  background compaction rebuilds the main index from the surviving rows and
  swaps it through the same refcounted ``refresh()`` double-buffer;

* **durability** (DESIGN.md §7) — ``persist_dir=`` attaches a snapshot
  store + mutation WAL (``repro_torch/persist``): every acked mutation is
  WAL-logged before the call returns, each compaction cuts a snapshot and
  truncates the log, and ``QueryService(restore_from=…)`` resumes after a
  crash bit-identical to the state at the last durably-acked mutation.

Results are positions in cache-sorted row order, exactly like
``ScoringEngine.search`` (pass ``id_map=HybridIndex.pi`` to get original
ids); a mutable service maps to external ids automatically.
``chip_smoke.py``'s ``service`` and ``durable`` phases drive it on the
card.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ..core.distributed import split_index_arrays
from ..core.engine import (Backend, IndexArrays, ScoringEngine,
                           query_fingerprint, release_index_arrays)
from ..core.sparse_index import sparse_queries_to_padded
from ..core.streaming import fanout_search, plan_overfetch
from ..device import resolve_device
from ..obs import NULL_SPAN, Observability

__all__ = ["QueryService", "CacheInfo", "JitCacheInfo", "bucket_for",
           "pad_rows"]

DEFAULT_BUCKETS = (1, 8, 32)


def bucket_for(q: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= q; q above the largest bucket gets the largest
    bucket (the caller chunks oversized batches)."""
    for b in buckets:
        if q <= b:
            return b
    return buckets[-1]


def pad_rows(x: np.ndarray, rows: int, fill=0) -> np.ndarray:
    """Pad axis 0 of host array ``x`` up to ``rows`` with ``fill`` — the
    static-shape bucketing primitive."""
    if x.shape[0] >= rows:
        return x
    widths = [(0, rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, widths, constant_values=fill)


@dataclasses.dataclass(frozen=True)
class CacheInfo:
    """Exact LRU result-cache counters (``QueryService.cache_info()``)."""
    hits: int
    misses: int
    evictions: int
    size: int
    capacity: int

    @property
    def hit_rate(self) -> float:
        """Hits over total lookups (0.0 on an untouched cache)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclasses.dataclass(frozen=True)
class JitCacheInfo:
    """Observed shape-key pressure (``QueryService.jit_cache_info()``; the
    name is the JAX package's, where the keys are jit compilations).

    ``batch_shapes`` is every padded batch size that reached the engine —
    bucketing guarantees ``len(batch_shapes) <= len(buckets)``.  ``entries``
    counts distinct (bucket, params) shape keys, each one K1/K2 launch plan
    (``kernels/lut16.py`` ``plan_adc``, an LRU of 256) and one set of
    kernel grids; ``bound`` is the declared ceiling
    ``len(buckets) * <distinct param combos seen>``."""
    batch_shapes: tuple[int, ...]
    entries: int
    bound: int


@dataclasses.dataclass(eq=False)
class _Generation:
    """One installed index copy: the single-device engine, optional per-shard
    engines, and the refcount that gates donation of retired storages.
    eq=False: identity semantics for the service's generation registry."""
    engine: ScoringEngine
    shards: list[ScoringEngine] | None
    offsets: np.ndarray | None
    id_map: np.ndarray | None
    version: int
    refs: int = 0
    retired: bool = False
    donate: bool = True


@dataclasses.dataclass(frozen=True)
class _DeltaView:
    """Immutable snapshot of the mutable side-state a search pairs with the
    generation it acquired (DESIGN.md §6): the delta-shard engine (None when
    the delta is empty), the slot -> external-id map, and the main-row
    tombstones dropped at the host merge.  Swapped atomically under the
    serving lock; in-flight searches keep the view they started with (the
    delta arrays stay alive through the Python reference)."""
    engine: ScoringEngine | None
    ids: np.ndarray | None            # (capacity,) int64 slot -> external id
    live: int
    capacity: int
    deleted: frozenset                # main-generation tombstoned ids


class QueryService:
    """The request path end to end: bucketed micro-batching, LRU result
    caching, (optionally sharded) three-pass search, double-buffered index
    swaps.  Thread-safe; ``submit`` gives the async client API.

    Parameters
    ----------
    engine:
        The ``ScoringEngine`` to serve (e.g. ``HybridIndex.build(...).engine``).
        Alternatively pass ``arrays`` (+ ``backend``) and the service builds
        the engine itself.
    h, alpha, beta:
        Default search parameters; per-call overrides are allowed but each
        distinct combination adds its own shape keys.
    buckets:
        Allowed padded batch sizes, ascending.  Bigger request batches are
        chunked to the largest bucket.
    cache_size:
        LRU result-cache capacity in query rows (0 disables caching).
    num_shards:
        Row-shard the index into this many per-shard engines and fan out
        (requires ``num_points % num_shards == 0``).
    id_map:
        Optional position -> external id mapping (``HybridIndex.pi``)
        applied to returned ids.
    index:
        A MUTABLE ``HybridIndex`` (built with ``mutable=True``) enabling
        ``insert()``/``delete()``/``compact()``.  Supplies the engine and
        the external-id map when those aren't passed explicitly.
    auto_compact, compact_min_rows, compact_ratio:
        Compaction policy (DESIGN.md §6.3): when the pending mutation count
        (delta live rows + main tombstones) reaches
        ``max(compact_min_rows, compact_ratio * main_rows)``, a background
        thread rebuilds the index from the surviving rows and swaps it via
        ``refresh()``.  ``auto_compact=False`` leaves compaction to explicit
        ``compact()`` calls.
    persist_dir:
        Make a mutable service DURABLE (DESIGN.md §7): bootstrap a snapshot
        store + mutation WAL at this path for the freshly built ``index=``.
        Every acked ``insert``/``delete`` is WAL-logged before the call
        returns; each ``compact()`` cuts a new snapshot and truncates the
        log.  Refuses a path that already holds a store (use
        ``restore_from``).
    restore_from:
        Resume a durable service after a crash/restart: recover the index
        from this store (snapshot load + WAL-tail replay, bit-identical to
        the state at the last durably-acked mutation) and keep persisting
        into it.  Mutually exclusive with ``index=``/``persist_dir``.
    persist_sync:
        fsync each WAL append before acking (the default).  ``False`` trades
        the power-loss guarantee for append latency (process-crash safety
        is retained — the bytes are flushed to the OS).  Acks use GROUP
        COMMIT (DESIGN.md §7.6): records are framed + flushed under the
        mutation lock, but the fsync happens outside it and is shared —
        a mutation returns as soon as SOME fsync covers its sequence
        number, so concurrent writers amortize one disk sync.
    compact_retrain:
        Compaction policy for this service's ``compact()`` calls (explicit
        and background): ``False`` forces merge-compaction into the frozen
        build artifacts, ``True`` forces the full batch rebuild, ``None``
        (default) auto-routes per ``MutableState.compact`` (merge unless
        out-of-column-space entries require a retrain).  A per-call
        ``compact(retrain=…)`` overrides it.
    delta_snapshot_records:
        Cut a DELTA-STATE snapshot (DESIGN.md §7.6) + truncate the WAL
        after every this-many logged mutations, bounding replay length
        under sustained ingest without waiting for a compaction.  ``None``
        (default) disables automatic checkpoints; ``checkpoint()`` is the
        explicit form.
    device:
        Where the service serves: ``cuda`` (the default) or ``cpu`` (the
        plain versions of the kernels).  ``restore_from=`` recovers onto
        it; an engine, arrays or index given on another device is refused
        (nothing moves between devices quietly).
    obs:
        The :class:`repro_torch.obs.Observability` bundle (DESIGN.md §9): its
        registry backs ``cache_info()``/``stats()``/``metrics()`` and the
        WAL durability instruments; its tracer (off by default) emits one
        ``serve.search`` root span per request: ``serve.lookup``, a
        ``serve.batch`` per miss batch (``serve.h2d``, ``serve.dispatch``
        with each engine's ``engine.pass1``-``engine.pass3``,
        ``serve.wait``, ``serve.merge``) and ``serve.fill``; each is a
        ``torch.profiler`` range (``obs.trace``).
        ``Observability.off()`` nulls everything — the no-obs baseline for
        overhead measurement (§9.4).
    """

    def __init__(self, engine: ScoringEngine | None = None, *,
                 arrays: IndexArrays | None = None,
                 backend: Backend | str | None = None,
                 index=None,
                 h: int = 10, alpha: int = 20, beta: int = 5,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 cache_size: int = 1024, num_shards: int = 1,
                 id_map: np.ndarray | None = None, max_workers: int = 2,
                 auto_compact: bool = True, compact_min_rows: int = 256,
                 compact_ratio: float = 0.25,
                 persist_dir: str | None = None,
                 restore_from: str | None = None,
                 persist_sync: bool = True,
                 compact_retrain: bool | None = None,
                 delta_snapshot_records: int | None = None,
                 device="cuda", obs: Observability | None = None):
        # one observability bundle for the whole service (DESIGN.md §9):
        # default keeps the metrics registry ON (cache_info()/stats() read
        # its counters) with tracing OFF; Observability.off() nulls both.
        self.obs = obs if obs is not None else Observability()
        m = self.obs.metrics
        self._c_hits = m.counter("serve.cache.hits")
        self._c_misses = m.counter("serve.cache.misses")
        self._c_evictions = m.counter("serve.cache.evictions")
        self._c_requests = m.counter("serve.requests")
        self._c_batches = m.counter("serve.batches")
        self._c_refreshes = m.counter("serve.refreshes")
        self._h_compact = m.histogram("serve.compact_s")
        self._g_delta = m.gauge("serve.delta_rows")
        self.device = resolve_device(device)
        self._durability = None
        self._recovery = None
        if restore_from is not None:
            if index is not None or persist_dir is not None:
                raise ValueError("restore_from= recovers the index from the "
                                 "store; don't also pass index=/persist_dir=")
            from .. import persist
            rec = persist.recover(restore_from, sync=persist_sync,
                                  metrics=m, device=self.device)
            index, self._durability, self._recovery = \
                rec.index, rec.durability, rec
        elif persist_dir is not None:
            if index is None:
                raise ValueError("persist_dir= bootstraps a NEW store for a "
                                 "mutable index=; pass restore_from= to "
                                 "resume an existing one")
            from .. import persist
            self._durability = persist.bootstrap(persist_dir, index,
                                                 sync=persist_sync,
                                                 metrics=m)
        if index is not None:
            if index.mutable_state is None:
                raise ValueError("index= needs HybridIndex.build(..., "
                                 "mutable=True)")
            if engine is None:
                engine = index.engine
            if id_map is None:
                id_map = index.mutable_state.id_map
        if engine is None:
            if arrays is None:
                raise ValueError("pass an engine, arrays, or a mutable index")
            engine = ScoringEngine(arrays=arrays,
                                   backend=Backend.from_name(backend))
        if not buckets:
            raise ValueError("buckets must be non-empty")
        self.h, self.alpha, self.beta = h, alpha, beta
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.num_shards = num_shards
        self._lock = threading.Lock()
        self._version = 0
        self._next_version = 0      # monotonic; unique even across races
        self._gens: set[_Generation] = set()   # every not-yet-donated copy
        self._gen = self._make_generation(engine, id_map, self._version)
        self._cache: OrderedDict[str, tuple[np.ndarray, np.ndarray]] = \
            OrderedDict()
        self._cache_cap = cache_size
        self._jit_keys: set[tuple] = set()
        self._executor: ThreadPoolExecutor | None = None
        self._max_workers = max_workers
        # streaming mutation state (all guarded by _mut_lock except the
        # view/version, which searches read under _lock)
        self._index = index
        self._mut_lock = threading.RLock()
        self._delta_view: _DeltaView | None = None
        self._mutation_version = 0
        self._auto_compact = auto_compact
        self._compact_min_rows = compact_min_rows
        self._compact_ratio = compact_ratio
        self._compact_retrain = compact_retrain
        self._delta_snapshot_records = delta_snapshot_records
        self._records_since_checkpoint = 0
        self._compactions = 0
        self._last_compaction_s: float | None = None
        self._compact_thread: threading.Thread | None = None
        self._closed = False
        if index is not None:
            with self._mut_lock:
                self._install_view()

    # -- generations ------------------------------------------------------

    def _make_generation(self, engine: ScoringEngine,
                         id_map: np.ndarray | None,
                         version: int) -> _Generation:
        dev = engine.arrays.codes.device
        if dev.type != self.device.type:
            raise ValueError(f"the engine's arrays are on {dev}, the service "
                             f"serves on {self.device}; pass device=")
        shards = offsets = None
        if self.num_shards > 1:
            parts, offsets = split_index_arrays(engine.arrays,
                                                self.num_shards)
            shards = [ScoringEngine(arrays=a, backend=engine.backend)
                      for a in parts]
        gen = _Generation(engine=engine, shards=shards, offsets=offsets,
                          id_map=id_map, version=version)
        with self._lock:
            self._gens.add(gen)
        return gen

    def _acquire(self) -> _Generation:
        with self._lock:
            gen = self._gen
            gen.refs += 1
            return gen

    def _acquire_view(self):
        """Atomically pin (generation, delta view, mutation version, index):
        a search must never pair a new main with an old delta or vice versa
        — the stress test's no-mixed-generation invariant.  The index handle
        rides along because compaction swaps it in the same critical section
        as the generation pointer: query encoding against ``index.cols``
        (search_sparse) is only valid for THIS generation."""
        with self._lock:
            gen = self._gen
            gen.refs += 1
            return gen, self._delta_view, self._mutation_version, self._index

    def _release(self, gen: _Generation) -> None:
        with self._lock:
            gen.refs -= 1
            dead = gen.retired and gen.refs == 0
        if dead:
            self._donate(gen)

    def _donate(self, gen: _Generation) -> None:
        """Free the retired generation's device storages (DESIGN.md §5
        double-buffering: the swap itself never blocks; memory of the old
        copy goes back to the allocator the moment its last in-flight search
        finishes).

        The keep set spans EVERY generation still registered — the live one
        AND any other retired copy that hasn't been donated yet (it may
        still have in-flight readers, or be externally owned via
        ``donate=False``) — so storages shared across generations
        (codebooks, ``head_pos``, a shard's view of its parent) survive until
        their last owner goes."""
        with self._lock:
            keep = []
            for g in self._gens:
                if g is gen:
                    continue
                keep.append(g.engine.arrays)
                if g.shards is not None:
                    keep += [s.arrays for s in g.shards]
            if gen.donate:
                self._gens.discard(gen)
        if not gen.donate:
            return
        release_index_arrays(gen.engine.arrays, keep=keep)
        if gen.shards is not None:
            for s in gen.shards:
                release_index_arrays(s.arrays, keep=keep)

    def refresh(self, arrays: IndexArrays | ScoringEngine, *,
                id_map: np.ndarray | None = None,
                donate: bool = True) -> int:
        """Install a rebuilt index without blocking in-flight searches.

        Builds the new generation (including shard slices) OFF the serving
        lock, then swaps the pointer; searches already running keep the old
        generation alive via refcount and complete against it, so every
        result is consistent with exactly one index version.  Version
        numbers come from a monotonic counter read under the lock, so
        concurrent refreshes never mint duplicate cache-key generations.
        With ``donate=True`` (the default) the service owns the retired
        copy's storages and frees them once the last in-flight reference
        drops — callers must not reuse the old ``IndexArrays`` afterwards.
        Returns the new generation's version number.

        Not available on a mutable service: an external swap would leave the
        delta shard encoded against (and sharing device buffers with) the
        retired generation — ``compact()`` is the mutable path's refresh."""
        if self._index is not None:
            raise ValueError(
                "refresh() would desync the delta shard and compact column "
                "space of a mutable service; use insert()/delete()/compact()")
        with self._lock:
            backend = self._gen.engine.backend
            self._next_version += 1
            version = self._next_version
        if isinstance(arrays, ScoringEngine):
            engine = arrays
        else:
            engine = ScoringEngine(arrays=arrays, backend=backend)
        new = self._make_generation(engine, id_map, version)
        return self._swap(new, donate)

    def _swap(self, new: _Generation, donate: bool, on_swap=None) -> int:
        """Install a built generation; ``on_swap`` runs under the serving
        lock in the same critical section as the pointer swap (compaction
        uses it to retire the delta view atomically with the new main)."""
        with self._lock:
            old = self._gen
            self._gen = new
            self._version = new.version
            self._c_refreshes.inc()
            old.retired = True
            old.donate = donate and \
                old.engine.arrays is not new.engine.arrays
            if on_swap is not None:
                on_swap()
            dead = old.refs == 0
        if dead:
            self._donate(old)
        return new.version

    # -- streaming mutation (DESIGN.md §6) --------------------------------

    def _require_index(self):
        if self._index is None:
            raise ValueError("service has no mutable index; construct with "
                             "QueryService(index=HybridIndex.build(..., "
                             "mutable=True))")

    def _install_view(self) -> None:
        """Snapshot the index's delta + tombstones into an immutable view and
        swap it in under the serving lock (callers hold _mut_lock).  The
        mutation version bump is what invalidates result-cache entries."""
        st = self._index.mutable_state
        snap = st.delta.snapshot()
        engine = None
        if snap.live:
            engine = ScoringEngine(arrays=snap.arrays,
                                   backend=self._index.engine.backend)
        view = _DeltaView(engine=engine, ids=snap.ids, live=snap.live,
                          capacity=snap.capacity,
                          deleted=frozenset(st.main_tombstones))
        with self._lock:
            self._delta_view = view
            self._mutation_version += 1
        self._g_delta.set(view.live)

    def insert(self, x_sparse, x_dense, ids=None) -> np.ndarray:
        """Insert (or upsert) rows into the delta shard; they are searchable
        as soon as this returns (encoded against the frozen main-index
        artifacts — see core/streaming.py).  Returns the external ids.
        On a durable service the batch is WAL-logged and fsync-covered
        before this returns — apply-then-log, so a crash mid-call loses at
        most this not-yet-acked batch (DESIGN.md §7.4).  The fsync itself
        is a GROUP COMMIT (§7.6): the record is framed + flushed under the
        mutation lock, the sync happens outside it, and one disk sync acks
        every record it covers — concurrent mutators share fsyncs instead
        of queueing one each.  If the append itself FAILS (disk full), the
        exception propagates (the batch was never acked, though it may
        stay visible until restart) and the durability handle is poisoned:
        further mutations are refused so recoverable and served state
        cannot silently diverge.
        May trigger background compaction per the service's policy."""
        self._require_index()
        seq = None
        with self._mut_lock:
            if self._durability is not None:
                self._durability.ensure_ok()
            assigned = self._index.insert(x_sparse, x_dense, ids=ids)
            if self._durability is not None and len(assigned):
                seq = self._durability.log_insert(x_sparse, x_dense,
                                                  assigned, sync=False)
                self._auto_checkpoint()
            self._install_view()
            due = self._auto_compact and self._compact_due()
        if seq is not None:
            self._durability.sync(seq)       # ack after the (shared) fsync
        if due:
            self._spawn_compaction()
        return assigned

    def delete(self, ids) -> int:
        """Tombstone rows by external id: delta slots die on device (-inf
        mask), main-generation rows at the host merge.  Searches dispatched
        after this returns never report the ids.  On a durable service the
        delete is WAL-logged and fsync-covered (group commit, §7.6) before
        this returns (no-op deletes are not logged — nothing changed); a
        failed append poisons the durability handle exactly like
        ``insert``.  Returns #rows killed."""
        self._require_index()
        seq = None
        with self._mut_lock:
            if self._durability is not None:
                self._durability.ensure_ok()
            killed = self._index.delete(ids)
            if killed:
                if self._durability is not None:
                    seq = self._durability.log_delete(ids, sync=False)
                    self._auto_checkpoint()
                self._install_view()
                due = self._auto_compact and self._compact_due()
            else:
                due = False
        if seq is not None:
            self._durability.sync(seq)       # ack after the (shared) fsync
        if due:
            self._spawn_compaction()
        return killed

    def _auto_checkpoint(self) -> None:
        """Count one logged mutation toward ``delta_snapshot_records`` and
        cut a delta-state checkpoint when the threshold is hit (caller
        holds ``_mut_lock``; the just-logged record is flushed, and the
        checkpoint's rotation fsyncs it before sealing the segment)."""
        self._records_since_checkpoint += 1
        if (self._delta_snapshot_records is not None
                and self._records_since_checkpoint
                >= self._delta_snapshot_records):
            self._durability.delta_checkpoint(self._index)
            self._records_since_checkpoint = 0

    def checkpoint(self) -> None:
        """Cut a DELTA-STATE snapshot of the live mutable index (delta rows
        and tombstones included, no compaction) and truncate the WAL behind
        it (DESIGN.md §7.6): recovery becomes snapshot-load + small tail
        replay even under sustained ingest.  ``delta_snapshot_records``
        does this automatically every N mutations."""
        self._require_index()
        with self._mut_lock:
            if self._durability is None:
                raise ValueError("checkpoint() needs a durable service "
                                 "(persist_dir= or restore_from=)")
            self._durability.ensure_ok()
            self._durability.delta_checkpoint(self._index)
            self._records_since_checkpoint = 0

    def _compact_due(self) -> bool:
        st = self._index.mutable_state
        if st.live_rows == 0:
            return False        # batch build needs >= 1 surviving row
        pending = st.delta.live_count + len(st.main_tombstones)
        floor = max(self._compact_min_rows,
                    int(self._compact_ratio * self._gen.engine.num_points))
        return pending >= floor

    def _spawn_compaction(self) -> None:
        with self._lock:
            if self._closed or (self._compact_thread is not None
                                and self._compact_thread.is_alive()):
                return
            t = threading.Thread(target=self._compact_bg,
                                 name="query-service-compact", daemon=True)
            self._compact_thread = t
            # start INSIDE the lock: an unstarted thread reads as not-alive,
            # so starting outside would let a second spawner overwrite the
            # slot and leave a rebuild running that close() never joins
            t.start()

    def _compact_bg(self) -> None:
        with self._lock:
            # closes the spawn/close race: a thread created before close()
            # but started after it must not begin a rebuild
            if self._closed:
                return
        try:
            self.compact()
        except Exception:                     # pragma: no cover - diagnostic
            import traceback
            traceback.print_exc()

    def compact(self, retrain: bool | None = None) -> int:
        """Fold the delta + tombstones into a compacted index and swap it
        through the double-buffered refresh (DESIGN.md §6.3).  The fold is
        either a merge into the frozen build artifacts or a full batch
        rebuild — ``retrain`` overrides the service's ``compact_retrain``
        policy for this call (see ``MutableState.compact``).  Mutations are
        serialized with the fold (they'd be lost otherwise); searches keep
        serving the old generation + delta throughout and flip atomically
        at the swap, so no result ever mixes the old delta with the new
        main.  On a durable service the compacted generation is snapshotted
        and the WAL truncated right after the swap (DESIGN.md §7.4 covers
        the crash window between the two).  Returns the installed
        generation's version."""
        self._require_index()
        t0 = time.perf_counter()
        if retrain is None:
            retrain = self._compact_retrain
        with self._mut_lock:
            st = self._index.mutable_state
            if st.delta.count == 0 and not st.main_tombstones:
                return self.version              # nothing to fold
            # heavy; off serving lock
            new_idx = self._index.compact(retrain=retrain)
            new_state = new_idx.mutable_state
            engine = new_idx.engine
            with self._lock:
                self._next_version += 1
                version = self._next_version
            new_gen = self._make_generation(engine, new_state.id_map,
                                            version)

            def on_swap():
                self._index = new_idx
                self._delta_view = _DeltaView(
                    engine=None, ids=None, live=0, capacity=0,
                    deleted=frozenset())
                self._mutation_version += 1
                self._compactions += 1
                self._last_compaction_s = time.perf_counter() - t0
                self._h_compact.observe(self._last_compaction_s)
                self._g_delta.set(0)

            out = self._swap(new_gen, donate=True, on_swap=on_swap)
            if self._durability is not None:
                # snapshot = compaction output: cut it while still holding
                # the mutation lock so no WAL record lands between the swap
                # and the log rotation it anchors
                self._durability.checkpoint(new_idx)
                self._records_since_checkpoint = 0
            return out

    def search_sparse(self, q_sparse, q_dense, *, h: int | None = None,
                      alpha: int | None = None, beta: int | None = None):
        """Entry point for RAW scipy sparse queries: encode against the
        pinned generation's compact column space, then serve.  Mutable
        services need this across compactions — the compact space changes
        with each rebuild, so pre-padded ``q_dims`` are generation-bound;
        the generation is held for the WHOLE encode+search so a concurrent
        compaction can never score old-space dim ids against a new index."""
        self._require_index()
        gen, view, mut_version, idx = self._acquire_view()
        try:
            q_dims, q_vals = sparse_queries_to_padded(q_sparse, idx.cols,
                                                      nq_max=idx.params.nq_max)
            return self._serve(gen, view, mut_version,
                               np.atleast_2d(np.asarray(q_dims, np.int32)),
                               np.atleast_2d(np.asarray(q_vals, np.float32)),
                               np.atleast_2d(np.asarray(q_dense, np.float32)),
                               h, alpha, beta)
        finally:
            self._release(gen)

    # -- request path -----------------------------------------------------

    def search(self, q_dims, q_vals, q_dense, *, h: int | None = None,
               alpha: int | None = None, beta: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Serve a batch of hybrid queries through cache + bucketed engine.

        q_dims/q_vals: (Q, nq) padded sparse queries (compact dim ids /
        values, 1-D accepted for a single query); q_dense: (Q, d_dense).
        Returns ``(scores (Q, h), ids (Q, h))`` numpy arrays; ids are
        cache-sorted positions, or external ids when the service was built
        with an ``id_map``.  Duplicate rows within one call are each counted
        as their own cache lookup.

        NOTE (mutable services): pre-padded ``q_dims`` are bound to the
        compact column space of the generation they were encoded against,
        which changes at every compaction — streaming clients should call
        ``search_sparse`` (raw queries, per-generation encoding) instead of
        caching padded queries across mutations."""
        q_dims = np.atleast_2d(np.asarray(q_dims, np.int32))
        q_vals = np.atleast_2d(np.asarray(q_vals, np.float32))
        q_dense = np.atleast_2d(np.asarray(q_dense, np.float32))
        gen, view, mut_version, _ = self._acquire_view()
        try:
            return self._serve(gen, view, mut_version, q_dims, q_vals,
                               q_dense, h, alpha, beta)
        finally:
            self._release(gen)

    def _serve(self, gen: _Generation, view: "_DeltaView | None",
               mut_version: int, q_dims: np.ndarray, q_vals: np.ndarray,
               q_dense: np.ndarray, h: int | None, alpha: int | None,
               beta: int | None) -> tuple[np.ndarray, np.ndarray]:
        """Cache + batch + fan-out against an already-pinned generation
        (the caller holds the refcount)."""
        h = self.h if h is None else h
        alpha = self.alpha if alpha is None else alpha
        beta = self.beta if beta is None else beta
        qn = q_dims.shape[0]
        # fingerprints only exist to key the cache: with caching off the
        # hot path skips the per-row hashing entirely.  The key covers
        # BOTH the generation and the delta-shard mutation version —
        # a cached hit can never serve pre-insert/pre-delete results.
        use_cache = self._cache_cap > 0
        out_s = np.empty((qn, h), np.float32)
        out_i = np.empty((qn, h), np.int64)
        sp = self.obs.tracer.root("serve.search", qn=qn, h=h,
                                  gen=gen.version)
        hits = evictions = 0
        with sp:
            with sp.child("serve.lookup"):
                keys = [query_fingerprint(q_dims[i], q_vals[i], q_dense[i],
                                          h, alpha, beta, gen.version,
                                          mut_version)
                        for i in range(qn)] if use_cache else None
                with self._lock:
                    if not use_cache:
                        miss = list(range(qn))
                    else:
                        miss = []
                        for i, key in enumerate(keys):
                            hit = self._cache.get(key)
                            if hit is not None:
                                self._cache.move_to_end(key)
                                hits += 1
                                out_s[i], out_i[i] = hit
                            else:
                                miss.append(i)
            max_bucket = self.buckets[-1]
            for lo in range(0, len(miss), max_bucket):
                rows = miss[lo:lo + max_bucket]
                with sp.child("serve.batch", rows=len(rows),
                              bucket=bucket_for(len(rows),
                                                self.buckets)) as bs:
                    out_s[rows], out_i[rows] = self._run_batch(
                        gen, view, q_dims[rows], q_vals[rows],
                        q_dense[rows], h, alpha, beta, span=bs)
            with sp.child("serve.fill"):
                if use_cache and miss:
                    with self._lock:
                        for i in miss:
                            self._cache[keys[i]] = (out_s[i].copy(),
                                                    out_i[i].copy())
                            self._cache.move_to_end(keys[i])
                            while len(self._cache) > self._cache_cap:
                                self._cache.popitem(last=False)
                                evictions += 1
            sp.set("cache_hits", hits)
            sp.set("cache_misses", len(miss))
        # counters fold ONCE per request, not per row — exact totals with
        # a bounded number of instrument-lock round-trips (DESIGN.md §9.4)
        self._c_requests.inc(qn)
        if hits:
            self._c_hits.inc(hits)
        if miss:
            self._c_misses.inc(len(miss))
        if evictions:
            self._c_evictions.inc(evictions)
        return out_s, out_i

    def submit(self, q_dims, q_vals, q_dense, **kw) -> Future:
        """Async client API: enqueue a search, get a Future of (scores, ids).

        Dispatch order is submission order on a small worker pool; the shard
        fan-out inside each search already queues every shard's device work
        before it waits for any."""
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="query-service")
            ex = self._executor
        return ex.submit(self.search, q_dims, q_vals, q_dense, **kw)

    def _run_batch(self, gen: _Generation, view: _DeltaView | None,
                   q_dims: np.ndarray, q_vals: np.ndarray,
                   q_dense: np.ndarray, h: int, alpha: int, beta: int,
                   span=NULL_SPAN) -> tuple[np.ndarray, np.ndarray]:
        """Pad one miss-batch to its bucket, fan out over the main engine(s)
        plus the delta shard, merge on host.  ``span`` gets a
        ``serve.h2d`` child for the padding and the copies to the device,
        and ``fanout_search``'s.

        The delta is literally one more engine in the fan-out (DESIGN.md
        §6.2); its tombstoned slots score -inf on device, main-generation
        tombstones are dropped by the host merge.  With tombstones pending,
        every main engine overfetches by the (16-bucketed, so the shape keys
        stay bounded) tombstone count — overfetch-then-truncate of a
        deterministic top-k is exact, so the mutation-free path returns the
        very same bits as before."""
        qn = q_dims.shape[0]
        bucket = bucket_for(qn, self.buckets)
        # padded rows carry the pad dim d_active: no score, no write
        d_active = gen.engine.arrays.d_active
        dev = gen.engine.arrays.codes.device
        with span.child("serve.h2d"):
            qd = torch.from_numpy(pad_rows(q_dims, bucket,
                                           fill=d_active)).to(dev)
            qv = torch.from_numpy(pad_rows(q_vals, bucket)).to(dev)
            qe = torch.from_numpy(pad_rows(q_dense, bucket)).to(dev)

        deleted = view.deleted if view is not None else frozenset()
        engines = gen.shards if gen.shards is not None else [gen.engine]
        offsets = (gen.offsets if gen.shards is not None
                   else np.zeros(1, np.int64))
        h_fetch = plan_overfetch(engines, h, deleted)
        delta_engine = view.engine if view is not None else None

        self._c_batches.inc()
        with self._lock:
            c1, c2 = engines[0].candidate_counts(h_fetch[0], alpha, beta)
            self._jit_keys.add((bucket, q_dims.shape[1], q_dense.shape[1],
                                engines[0].num_points, h_fetch[0], c1, c2,
                                gen.shards is not None))
            if delta_engine is not None:
                hd = delta_engine.num_points        # fetch every delta slot
                cd1, cd2 = delta_engine.candidate_counts(hd, alpha, beta)
                self._jit_keys.add((bucket, q_dims.shape[1],
                                    q_dense.shape[1], hd, hd, cd1, cd2,
                                    "delta"))

        # the shared fan-out merge (core/streaming.py::fanout_search — the
        # same helper search_mutable uses): dispatch every engine before
        # syncing any, assemble in the common id space, merge on host.
        return fanout_search(engines, h_fetch, offsets, gen.id_map,
                             delta_engine,
                             view.ids if view is not None else None,
                             deleted, qd, qv, qe, h=h, alpha=alpha,
                             beta=beta, qn=qn, span=span)

    # -- introspection ----------------------------------------------------

    def cache_info(self) -> CacheInfo:
        """Exact LRU counters: hits, misses, evictions, size, capacity.
        (Registry-backed — reads 0 under ``Observability.off()``.)"""
        with self._lock:
            return CacheInfo(hits=self._c_hits.value,
                             misses=self._c_misses.value,
                             evictions=self._c_evictions.value,
                             size=len(self._cache),
                             capacity=self._cache_cap)

    def jit_cache_info(self) -> JitCacheInfo:
        """Observed engine shape keys vs the declared bucketing bound."""
        with self._lock:
            shapes = tuple(sorted({k[0] for k in self._jit_keys}))
            combos = {k[1:] for k in self._jit_keys}
            return JitCacheInfo(batch_shapes=shapes,
                                entries=len(self._jit_keys),
                                bound=len(self.buckets) * max(1, len(combos)))

    def stats(self) -> dict:
        """Service counters for dashboards/benchmarks (plain dict).  On a
        durable service this includes the WAL durability gauges (DESIGN.md
        §9.1): the most recent fsync latency, the number of records that
        fsync covered (group-commit batch size), and the current
        flushed-but-unsynced backlog."""
        wal = self._durability.wal if self._durability is not None else None
        with self._lock:
            view = self._delta_view
            return {"requests": self._c_requests.value,
                    "batches": self._c_batches.value,
                    "refreshes": self._c_refreshes.value,
                    "version": self._version,
                    "cache_hits": self._c_hits.value,
                    "cache_misses": self._c_misses.value,
                    "cache_evictions": self._c_evictions.value,
                    "num_shards": self.num_shards, "buckets": self.buckets,
                    "mutation_version": self._mutation_version,
                    "delta_rows": view.live if view is not None else 0,
                    "delta_capacity":
                        view.capacity if view is not None else 0,
                    "deleted_pending":
                        len(view.deleted) if view is not None else 0,
                    "compactions": self._compactions,
                    "last_compaction_s": self._last_compaction_s,
                    "durable": wal is not None,
                    "wal_next_seq": wal.next_seq if wal is not None else 0,
                    "wal_last_fsync_s":
                        wal.last_fsync_s if wal is not None else None,
                    "wal_group_commit_batch":
                        wal.last_group_batch if wal is not None else 0,
                    "wal_unsynced_backlog":
                        wal.unsynced_backlog if wal is not None else 0,
                    "recovered_replayed":
                        (self._recovery.replayed
                         if self._recovery is not None else 0)}

    def metrics(self) -> dict:
        """JSON-ready snapshot of every registry instrument this service
        (and its WAL, when durable) feeds — the in-process analogue of the
        ``--metrics-port`` endpoint (DESIGN.md §9.1)."""
        return self.obs.metrics.snapshot()

    @property
    def version(self) -> int:
        """Version number of the currently installed index generation."""
        with self._lock:
            return self._version

    def close(self) -> None:
        """Shut down the async submit pool and wait out any in-flight
        background compaction (idempotent).  The closed flag is set in the
        same critical section that reads the compaction thread, and
        _spawn_compaction refuses once it's set — so no compaction can
        start after close() returns."""
        with self._lock:
            ex, self._executor = self._executor, None
            self._closed = True
            ct = self._compact_thread
        if ex is not None:
            ex.shutdown(wait=True)
        if ct is not None and ct.is_alive():
            ct.join()
        with self._mut_lock:
            if self._durability is not None:
                self._durability.close()
