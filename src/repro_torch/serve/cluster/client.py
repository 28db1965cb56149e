"""Cluster client of the port (a copy of ``repro.serve.cluster.client``):
one socket per shard server, transparent reconnect,
request PIPELINING, and same-shard request COALESCING (DESIGN.md §8.2,
§8.8).

``ShardClient`` is the transport half.  Two request modes share one
socket:

* ``call`` — blocking request/response, with torn frames and dropped
  connections healed by ONE reconnect-and-retry (the retried read is
  idempotent; mutations pass ``retry=False`` and are re-driven by the
  caller, which knows their semantics);
* ``submit`` — PIPELINED: the frame goes out immediately and a
  ``PendingReply`` comes back; replies are matched to requests in FIFO
  order (the server answers one connection strictly in order).  The
  router's fan-out submits to every shard back-to-back and only then
  collects, so S shards cost one round trip, not S — and a frame built
  once (``protocol.build_frame``) is reused byte-identical across shards.

``submit_search`` adds COALESCING on top: while one frame is in flight,
searches from other router threads queue up and the next flush ships them
as ONE ``msearch`` frame (amortizing per-request framing + syscalls —
DESIGN.md §8.8).  With no concurrency it degenerates to exactly one
``search`` frame per request, adding zero latency.

``RemoteMainEngine`` / ``RemoteDeltaEngine`` are the duck-typed
``ShardSearcher`` handles: they expose exactly the
``.search(...)/.num_points`` surface an in-process ``ScoringEngine`` does,
which keeps the transport swappable where the merge contract is not.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import socket
import threading
import time

import numpy as np

from ...checkpoint.leaves import fsync_dir
from ...obs.trace import NULL_SPAN
from .protocol import MSG_ERROR, RemoteError, build_frame, recv_msg

__all__ = ["ShardClient", "PendingReply", "RemoteMainEngine",
           "RemoteDeltaEngine", "ShardUnavailableError", "wait_ready"]


class ShardUnavailableError(ConnectionError):
    """The shard could not be reached even after a reconnect attempt — the
    router's signal to fail over to a replica or raise an explicit
    degraded-result error (never to merge a silently truncated top-k)."""


class PendingReply:
    """One in-flight pipelined request (``ShardClient.submit``).

    ``wait()`` blocks until THIS request's reply arrives, reading replies
    off the shared socket as needed — whichever waiter holds the receive
    lock completes earlier pendings in FIFO order on the way to its own.
    A transport failure fails every in-flight pending on the connection
    (framing is lost for all of them); the raised error is the original
    ``ConnectionError``/``TornFrameError`` so callers keep their existing
    retry semantics.  ``send_s``/``wall_s`` carry PER-REQUEST timing (one
    ``PendingReply`` per submit — never shared across requests, so
    concurrent fan-outs can't overwrite each other's numbers; the router
    folds them into hop spans, DESIGN.md §9.2)."""

    def __init__(self, client: "ShardClient", cmd: str):
        self.client = client
        self.cmd = cmd
        self.send_s = 0.0
        self.wall_s = 0.0
        self._t0 = 0.0
        self._event = threading.Event()
        self._value: tuple | None = None
        self._exc: BaseException | None = None

    def _complete(self, op: int, meta: dict, arrays: dict) -> None:
        self.wall_s = time.perf_counter() - self._t0
        self._value = (op, meta, arrays)
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def wait(self) -> tuple[int, dict, dict]:
        """Block until the reply is in; returns raw ``(op, meta, arrays)``
        (``MSG_ERROR`` frames are returned, not raised — ``result`` is the
        raising form).  Raises the transport error that killed the
        connection if one did.  The wait is bounded by the socket's own
        timeout (the client's ``timeout``): a read that gets no bytes for
        that long fails every request in flight on the connection."""
        while not self._event.is_set():
            # whoever gets the receive lock drains replies FIFO until its
            # own arrives; everyone else wakes on their event
            if self.client._recv_lock.acquire(timeout=0.0005):
                try:
                    if not self._event.is_set():
                        self.client._drain_one()
                finally:
                    self.client._recv_lock.release()
        if self._exc is not None:
            raise self._exc
        return self._value

    def result(self) -> tuple[dict, dict]:
        """``wait()`` + unwrap: pops the protocol's ``cmd`` echo and raises
        ``RemoteError`` for ``MSG_ERROR`` replies; returns
        ``(meta, arrays)``."""
        op, meta, arrays = self.wait()
        meta.pop("cmd", None)
        if op == MSG_ERROR:
            raise RemoteError(f"shard {self.client.addr} failed "
                              f"{self.cmd!r}: {meta.get('error')}")
        return meta, arrays


class _CoalescedReply:
    """One search enrolled in a coalescing batch (``submit_search``): holds
    its slot in the (eventual) ``msearch`` frame and demuxes its own
    sub-result out of the shared reply.

    Timing lives ON THE ENTRY, not on the client or the shared pending:
    ``queue_s`` (enqueue → flush, the client-side coalescer wait),
    ``wall_s`` (enqueue → this entry's reply collected) and ``send_s``
    (the shared frame's send duration) are written once per entry, so
    overlapping coalesced requests keep independent numbers — the race
    the old shared ``last_*`` fields had (DESIGN.md §9.2)."""

    def __init__(self, client: "ShardClient", meta: dict, arrays: dict,
                 frame: bytes | None = None):
        self.client = client
        self.meta = meta
        self.arrays = arrays
        self.frame = frame
        self.slot = 0
        self.width = 1
        self.t_enq = time.perf_counter()
        self.queue_s = 0.0
        self.send_s = 0.0
        self.wall_s = 0.0
        self._ready = threading.Event()
        self._pending: PendingReply | None = None
        self._exc: BaseException | None = None
        self._batch: "_CoalescedBatch | None" = None

    def result(self) -> tuple[dict, dict]:
        """Block for this search's own ``(meta, arrays)``; per-sub remote
        failures raise ``RemoteError``, transport failures raise what the
        connection raised, and an entry still queued after the client's
        ``timeout`` raises ``TimeoutError`` (it is taken off the queue, so
        it never ships).  An entry a flush has taken off the queue waits
        on: the flush ships it within ``submit``'s own timeout."""
        while not self._ready.wait(self.client.timeout):
            self.client._unqueue(self)
        if self._exc is not None:
            raise self._exc
        try:
            op, meta, arrays = self._pending.wait()
            self.wall_s = time.perf_counter() - self.t_enq
            self.send_s = self._pending.send_s
        finally:
            self._batch.on_complete()      # kick the next queued flush
        meta.pop("cmd", None)
        if op == MSG_ERROR:
            raise RemoteError(f"shard {self.client.addr} failed "
                              f"'search': {meta.get('error')}")
        if self.width == 1:
            return meta, arrays
        sub = meta["subs"][self.slot]
        if "error" in sub:
            raise RemoteError(f"shard {self.client.addr} failed "
                              f"'search': {sub['error']}")
        prefix = f"{self.slot}:"
        return sub, {k[len(prefix):]: v for k, v in arrays.items()
                     if k.startswith(prefix)}


class _CoalescedBatch:
    """One flushed group of coalesced searches sharing a single pipelined
    frame; completing it (once) releases the client's in-flight slot and
    flushes whatever queued up behind it."""

    def __init__(self, client: "ShardClient", entries: list[_CoalescedReply]):
        self.client = client
        self.entries = entries
        self._done = False
        self._lock = threading.Lock()

    def on_complete(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
        self.client._coalesce_next()


class ShardClient:
    """Pipelining request client for one shard server (module docstring
    for the call/submit/submit_search split).  Thread-safe: a send lock
    orders frames onto the wire (and pendings into the FIFO), a receive
    lock orders replies off it.  ``reconnects`` counts healed transport
    failures (the torn-frame tests pin it)."""

    def __init__(self, host: str, port: int, *, timeout: float = 30.0):
        self.host, self.port = host, port
        self.timeout = timeout
        self.reconnects = 0
        self.bytes_sent = 0
        self.bytes_recv = 0
        self._sock: socket.socket | None = None
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._pending: collections.deque[PendingReply] = collections.deque()
        # coalescer state: queued searches + whether a frame is in flight
        self._co_lock = threading.Lock()
        self._co_queue: list[_CoalescedReply] = []
        self._co_inflight = False
        self._co_batch: _CoalescedBatch | None = None

    @property
    def addr(self) -> str:
        """``host:port`` of the peer (log/error labels)."""
        return f"{self.host}:{self.port}"

    def _connect(self) -> socket.socket:
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    # -- pipelined transport ----------------------------------------------

    def submit(self, cmd: str, meta: dict | None = None,
               arrays: dict | None = None, *,
               frame: bytes | None = None) -> PendingReply:
        """Send one request WITHOUT waiting for its reply; returns the
        ``PendingReply`` to collect it from.  ``frame`` short-circuits
        serialization with a pre-built ``protocol.build_frame`` result (the
        fan-out's build-once-send-everywhere path).  Raises the transport
        error on send failure — nothing is retried here."""
        if frame is None:
            frame = build_frame(cmd, meta, arrays)
        p = PendingReply(self, cmd)
        with self._send_lock:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                p._t0 = time.perf_counter()
                self._pending.append(p)
                self._sock.sendall(frame)
                p.send_s = time.perf_counter() - p._t0
                self.bytes_sent += len(frame)
            except (OSError, ConnectionError) as e:
                self._fail_all(e)
                raise
        return p

    def _drain_one(self) -> None:
        """Read ONE reply off the socket and complete the oldest pending
        (caller holds ``_recv_lock``).  The protocol is strictly FIFO per
        connection, so reply N belongs to request N; any transport anomaly
        loses framing for every in-flight request, so all of them fail."""
        sock = self._sock
        if sock is None or not self._pending:
            return
        try:
            op, meta, arrays = recv_msg(sock)
        except (OSError, ConnectionError) as e:
            with self._send_lock:
                if self._sock is sock:     # not a socket already dropped
                    self._fail_all(e)
            return
        p = self._pending.popleft()
        p._complete(op, meta, arrays)

    def _fail_all(self, exc: BaseException) -> None:
        """Fail every in-flight pending and drop the socket (caller holds
        ``_send_lock``)."""
        while self._pending:
            self._pending.popleft()._fail(exc)
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    # -- blocking call (with the one-reconnect heal) ----------------------

    def call(self, cmd: str, meta: dict | None = None,
             arrays: dict | None = None, *, retry: bool = True,
             span=NULL_SPAN) -> tuple[dict, dict]:
        """Send one request, read its reply; returns ``(meta, arrays)``.
        Transport failures (torn frame, dead socket) are healed by one
        reconnect + resend when ``retry`` (callers disable it for
        non-idempotent mutations and re-drive at their own layer);
        ``MSG_ERROR`` replies raise ``RemoteError``.  ``span`` receives
        this call's timing tags (``serialize_s`` accumulated across the
        heal, ``wall_s`` of the attempt that answered) plus a
        ``reconnect_resend`` annotation when the heal fired — per-request
        hop accounting with no shared client fields (DESIGN.md §9.2)."""
        frame = build_frame(cmd, meta, arrays)
        attempts = 2 if retry else 1
        for attempt in range(attempts):
            try:
                p = self.submit(cmd, frame=frame)
                op, rmeta, rarrays = p.wait()
                break
            except (OSError, ConnectionError) as e:
                # TornFrameError is a ConnectionError: framing is lost
                # either way, so the socket was dropped — (maybe) retry
                if attempt + 1 >= attempts:
                    raise ShardUnavailableError(
                        f"shard {self.addr} unreachable for "
                        f"{cmd!r}: {e}") from e
                self.reconnects += 1
                span.annotate(f"reconnect_resend cmd={cmd}")
        span.add("serialize_s", p.send_s)
        span.set("wall_s", p.wall_s)
        rmeta.pop("cmd", None)
        if op == MSG_ERROR:
            raise RemoteError(
                f"shard {self.addr} failed {cmd!r}: {rmeta.get('error')}")
        return rmeta, rarrays

    # -- search coalescing (DESIGN.md §8.8) -------------------------------

    def submit_search(self, meta: dict, arrays: dict, *,
                      frame: bytes | None = None) -> _CoalescedReply:
        """Enqueue one search for COALESCED dispatch: if no frame is in
        flight it goes out immediately (alone — zero added latency); while
        one IS in flight, searches pile up and the next flush ships the
        whole pile as one ``msearch`` frame.  ``frame`` is an optional
        pre-built ``build_frame`` result used for the ships-alone case
        (the fan-out's serialize-once path); a coalesced flush rebuilds
        from meta/arrays.  Returns a handle whose ``result()`` yields
        this search's own ``(meta, arrays)``."""
        e = _CoalescedReply(self, meta, arrays, frame)
        with self._co_lock:
            self._co_queue.append(e)
            if self._co_inflight:
                return e
            self._co_inflight = True
            batch = self._co_queue
            self._co_queue = []
        self._flush(batch)
        return e

    def _unqueue(self, e: _CoalescedReply) -> None:
        """``e`` waited the client's ``timeout`` behind a flush that never
        completed: take it off the queue (so it never ships with no one to
        collect it), fail it with ``TimeoutError``, and release the stuck
        batch's slot so that later searches ship (its reply, when it comes,
        still completes that batch's pending in FIFO order).  An entry no
        longer queued is left as it is: a flush has taken it and is
        shipping it."""
        with self._co_lock:
            if e not in self._co_queue:        # flushed, or being flushed
                return
            self._co_queue.remove(e)
            e._exc = TimeoutError(f"shard {self.addr}: a coalesced search "
                                  f"waited {self.timeout:g} s to ship")
            e._ready.set()
            stuck = self._co_batch
        if stuck is not None:
            stuck.on_complete()

    def _coalesce_next(self) -> None:
        """Release the in-flight slot and flush whatever coalesced behind
        the batch that just completed."""
        with self._co_lock:
            if not self._co_queue:
                self._co_inflight = False
                return
            batch = self._co_queue
            self._co_queue = []
        self._flush(batch)

    def _flush(self, batch: list[_CoalescedReply]) -> None:
        """Ship one batch as a single pipelined frame: a plain ``search``
        for a batch of one, an ``msearch`` (sub-metas under ``subs``,
        arrays keyed ``"<i>:<name>"``) otherwise."""
        now = time.perf_counter()
        for e in batch:
            e.queue_s = now - e.t_enq      # client-side coalescer wait
        try:
            if len(batch) == 1:
                p = self.submit("search", batch[0].meta, batch[0].arrays,
                                frame=batch[0].frame)
            else:
                subs = [e.meta for e in batch]
                arrays = {f"{i}:{k}": v
                          for i, e in enumerate(batch)
                          for k, v in e.arrays.items()}
                p = self.submit("msearch", {"subs": subs}, arrays)
        except BaseException as exc:
            shared = _CoalescedBatch(self, batch)
            shared._done = True           # nothing in flight to complete
            for e in batch:
                e._batch = shared
                e._exc = exc
                e._ready.set()
            self._coalesce_next()
            return
        shared = self._co_batch = _CoalescedBatch(self, batch)
        for i, e in enumerate(batch):
            e.slot, e.width = i, len(batch)
            e._pending = p
            e._batch = shared
            e._ready.set()

    # -- snapshot distribution (DESIGN.md §8.3) ---------------------------

    def fetch_store(self, dst_root: str) -> list[str]:
        """Copy the peer's committed snapshot store into ``dst_root`` —
        snapshot distribution (DESIGN.md §8.3).  The CURRENT pointer is
        written LAST, and only after every data file is verified against
        the manifest's recorded sha256 and fsync'd (file + containing
        dir): an interrupted or bit-flipped fetch can never leave a
        committed-looking but torn local store — the exact guarantee the
        CURRENT-last ordering claims.  Returns the copied relative
        paths."""
        meta, _ = self.call("store_manifest")
        digests: dict[str, str] = {}
        dirs: set[str] = set()
        deferred: list[str] = []
        for rel in meta["files"]:
            if os.path.basename(rel) == "CURRENT":
                deferred.append(rel)       # commit pointers strictly last
                continue
            fmeta, farr = self.call("store_file", {"path": rel})
            data = farr["data"]            # a view of the reply's bytes
            digests[rel] = hashlib.sha256(data).hexdigest()
            path = os.path.join(dst_root, rel)
            os.makedirs(os.path.dirname(path) or dst_root, exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            dirs.add(os.path.dirname(path) or dst_root)
        self._verify_manifests(dst_root, digests)
        for d in sorted(dirs):
            fsync_dir(d)
        for rel in deferred:
            fmeta, farr = self.call("store_file", {"path": rel})
            path = os.path.join(dst_root, rel)
            with open(path, "wb") as f:
                f.write(farr["data"])
                f.flush()
                os.fsync(f.fileno())
            fsync_dir(os.path.dirname(path) or dst_root)
        return list(meta["files"])

    @staticmethod
    def _verify_manifests(dst_root: str, digests: dict[str, str]) -> None:
        """Check every fetched blob against the sha256 its snapshot
        manifest recorded at write time — a bitrotted source file (or a
        wire layer that lied) fails the fetch instead of becoming a
        committed follower store."""
        for rel, digest in digests.items():
            if os.path.basename(rel) != "manifest.json":
                continue
            with open(os.path.join(dst_root, rel)) as f:
                manifest = json.load(f)
            snap_dir = os.path.dirname(rel)
            for leaf in manifest.get("leaves", {}).values():
                blob_rel = f"{snap_dir}/{leaf['file']}" if snap_dir \
                    else leaf["file"]
                got = digests.get(blob_rel)
                if got is not None and got != leaf["sha256"]:
                    raise ValueError(
                        f"fetched blob {blob_rel!r} sha256 {got[:12]}… "
                        f"does not match the manifest's recorded "
                        f"{leaf['sha256'][:12]}… — refusing to commit a "
                        "corrupt follower store")

    def close(self) -> None:
        """Close the socket (idempotent); the next call reconnects.  Every
        request still in flight fails with ``ConnectionError``: its reply
        is gone with the socket, and left queued it would take the next
        connection's first reply."""
        with self._send_lock:
            self._fail_all(ConnectionError(f"shard {self.addr}: client "
                                           "closed"))


class _RemoteEngineBase:
    """Shared half of the remote ``ShardSearcher`` duck-type: ships the
    padded query batch, returns ``(scores, ids)`` with ids ALREADY in the
    external id space (the server maps through its row slice / delta
    slots), and surfaces the response's replication tags to the router."""

    def __init__(self, client: ShardClient, *, generation: int,
                 num_points: int, part: str):
        self.client = client
        self.generation = generation
        self.num_points = num_points
        self.part = part
        self.last_meta: dict = {}

    def search(self, qd, qv, qe, *, h: int, alpha: int, beta: int):
        meta, arrays = self.client.call(
            "search", {"part": self.part, "gen": self.generation,
                       "h": int(h), "alpha": int(alpha), "beta": int(beta)},
            {"q_dims": np.asarray(qd, np.int32),
             "q_vals": np.asarray(qv, np.float32),
             "q_dense": np.asarray(qe, np.float32)})
        self.last_meta = meta
        return arrays["scores"], arrays["ids"]


class RemoteMainEngine(_RemoteEngineBase):
    """RPC handle for one scoring shard's main row slice: ``num_points``
    is the slice size (so ``plan_overfetch`` budgets exactly like the
    in-process shard engine) and ``search`` returns the slice's top-k in
    external ids."""

    def __init__(self, client: ShardClient, *, generation: int,
                 num_points: int):
        super().__init__(client, generation=generation,
                         num_points=num_points, part="main")


class RemoteDeltaEngine(_RemoteEngineBase):
    """RPC handle for the primary's delta shard: like the in-process delta
    engine it fetches its WHOLE capacity (the server pins a snapshot and
    uses its capacity; ``num_points`` here is advisory), and tombstoned
    slots come back -inf so the merge semantics match bit for bit."""

    def __init__(self, client: ShardClient, *, generation: int,
                 num_points: int):
        super().__init__(client, generation=generation,
                         num_points=num_points, part="delta")


def wait_ready(client: ShardClient, *, timeout: float = 30.0,
               poll: float = 0.05) -> dict:
    """Poll ``status`` until the server answers (subprocess startup races);
    returns the first status meta.  Raises ``ShardUnavailableError`` after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            meta, _ = client.call("status")
            return meta
        except (ShardUnavailableError, ConnectionError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(poll)
