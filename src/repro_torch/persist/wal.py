"""Mutation write-ahead log (DESIGN.md §7.2).

Every acked ``insert``/``delete`` appends ONE framed record before the call
returns, so a process crash loses at most the mutation that was still being
written — and that one was never acked to the client.  Records are the
normalized mutation inputs (CSR parts + dense rows + external ids), NOT
encoded index state: replay re-runs the exact ``core/streaming.py``
encode-on-insert machinery, which is what makes a recovered index
bit-identical to the never-crashed one (tests/test_persist.py).

Frame format (little-endian, 27-byte header)::

    magic   2s   b"WR"
    kind    u8   1 = insert, 2 = delete
    seq     u64  global monotone mutation sequence number
    term    u64  monotone primary term (DESIGN.md §8.7): every record is
                 stamped with the term of the primary that wrote it, and a
                 log refuses shipped frames from a LOWER term than its own
                 — the fence that stops a zombie ex-primary's post-
                 promotion writes from entering a follower's log
    length  u32  payload byte count
    crc32   u32  zlib.crc32 of magic+kind+seq+term+length THEN the payload
                 — the header fields are covered too, so a flipped bit in
                 ``seq``, ``term`` or ``kind`` is a detected error, not a
                 silently skipped or reordered mutation
    payload      checkpoint.leaves.pack_arrays of the record's arrays

The current term persists in a ``TERM`` file beside the segments (written
atomically + fsync'd by ``set_term``) and is additionally recovered from
the scanned active segment's records, so a restarted node can never
come back believing an OLDER term than anything it durably wrote.

Truncation policy: a reader stops at the FIRST anomaly — short header,
wrong magic, short payload, or crc mismatch — and everything before it is
the recovered state ("recover to the last complete record").  A torn tail
is expected after a crash, so reopening the log for append truncates the
garbage and resumes; corruption earlier in the stream also stops the scan
there (later records' preconditions may be gone), which recovery reports
through its replayed-count/last-seq result rather than by resurrecting
records past the damage.

Segmentation: each file ``wal-<first_seq>.log`` covers records
``[first_seq, next segment's first_seq)``.  ``rotate()`` starts a fresh
segment at a snapshot/compaction point; ``truncate_before(seq)`` deletes
whole segments strictly below the snapshot's replay horizon.  Replay after
recovery therefore touches exactly the tail the latest snapshot doesn't
already contain.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib

import numpy as np

from ..checkpoint.leaves import fsync_dir, pack_arrays, unpack_arrays

__all__ = ["MutationWAL", "WalRecord", "RECORD_INSERT", "RECORD_DELETE",
           "RECORD_NOOP"]

RECORD_INSERT = 1
RECORD_DELETE = 2
RECORD_NOOP = 3       # term barrier: no state change, just a durable term

_MAGIC = b"WR"
_HEADER = struct.Struct("<2sBQQII")     # magic, kind, seq, term, len, crc32
_PREFIX = struct.Struct("<2sBQQI")      # the crc-covered header fields
_SEG_PREFIX, _SEG_SUFFIX = "wal-", ".log"
_TERM_FILE = "TERM"


def _frame_crc(kind: int, seq: int, term: int, payload: bytes) -> int:
    """crc32 over the header prefix (magic, kind, seq, term, length) AND
    the payload, so header corruption is detected, not silently replayed."""
    return zlib.crc32(payload,
                      zlib.crc32(_PREFIX.pack(_MAGIC, kind, seq, term,
                                              len(payload))))


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded WAL record: the mutation kind, its global sequence
    number, the primary term that wrote it, and the payload arrays
    (``pack_arrays`` names)."""
    seq: int
    kind: int
    arrays: dict
    term: int = 1


def _segment_path(wal_dir: str, first_seq: int) -> str:
    return os.path.join(wal_dir, f"{_SEG_PREFIX}{first_seq:020d}{_SEG_SUFFIX}")


def _segment_first_seq(name: str) -> int | None:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def _scan_segment(path: str):
    """Decode one segment file.  Returns ``(records, valid_bytes, clean)``:
    every complete record in order, the byte offset of the first anomaly
    (== file size when clean), and whether the file ended exactly on a
    record boundary."""
    with open(path, "rb") as f:
        buf = f.read()
    records, off = [], 0
    while True:
        header = buf[off:off + _HEADER.size]
        if len(header) < _HEADER.size:
            return records, off, len(header) == 0
        magic, kind, seq, term, length, crc = _HEADER.unpack(header)
        if magic != _MAGIC:
            return records, off, False
        payload = buf[off + _HEADER.size:off + _HEADER.size + length]
        if len(payload) < length or \
                _frame_crc(kind, seq, term, payload) != crc:
            return records, off, False
        records.append(WalRecord(seq=seq, kind=kind, term=term,
                                 arrays=unpack_arrays(payload)))
        off += _HEADER.size + length


def _has_valid_frame_after(buf: bytes, start: int) -> bool:
    """True if a crc-valid frame decodes anywhere past ``start`` — the
    torn-tail / bitrot discriminator: a crash leaves garbage with nothing
    decodable after it, mid-log corruption leaves acked records stranded
    past the damage (and truncating those would silently lose them)."""
    i = buf.find(_MAGIC, start)
    while i != -1:
        header = buf[i:i + _HEADER.size]
        if len(header) == _HEADER.size:
            magic, kind, seq, term, length, crc = _HEADER.unpack(header)
            payload = buf[i + _HEADER.size:i + _HEADER.size + length]
            if len(payload) == length and _frame_crc(kind, seq, term,
                                                     payload) == crc:
                return True
        i = buf.find(_MAGIC, i + 1)
    return False


class MutationWAL:
    """Append-only, segmented, checksummed mutation log.

    Opening an existing directory scans the ACTIVE (last) segment — the
    only one a crash can tear — truncates any torn tail, and resumes the
    sequence counter after its last complete record, so
    append-after-recovery continues the same log.

    Durability is GROUP COMMIT (DESIGN.md §7.6): ``append`` frames and
    flushes the record under the internal append lock and returns its
    sequence number; the ack is ``sync_to(seq)``, which fsyncs AT MOST
    once for every batch of writes that raced in before it — one disk
    sync covers (and acks) all of them.  ``append(..., sync=True)`` /
    the default ``sync=None`` with ``self.sync`` keep the old
    one-call-one-ack behavior on top of the shared machinery, and
    ``append_many`` amortizes framing + flush + fsync over a whole batch
    explicitly."""

    def __init__(self, wal_dir: str, *, sync: bool = True,
                 start_seq: int = 1, metrics=None):
        self.wal_dir = wal_dir
        self.sync = sync
        # durability instruments (DESIGN.md §9.1): optional registry-backed
        # histograms/gauge, plus always-on plain attributes so
        # ``QueryService.stats()`` can report fsync health even when no
        # registry was threaded through.
        from ..obs.metrics import NULL_REGISTRY
        reg = NULL_REGISTRY if metrics is None else metrics
        self._h_fsync = reg.histogram("wal.fsync_s")
        self._h_batch = reg.histogram(
            "wal.group_commit_batch",
            bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._g_backlog = reg.gauge("wal.unsynced_backlog")
        self.last_fsync_s = 0.0      # duration of the most recent fsync
        self.last_group_batch = 0    # records that fsync covered (acked)
        # _append_lock orders frame bytes + next_seq; _sync_lock serializes
        # fsyncs and guards _synced_seq.  Lock order: _sync_lock BEFORE
        # _append_lock (sync_to, rotate); append takes only _append_lock.
        self._append_lock = threading.Lock()
        self._sync_lock = threading.Lock()
        os.makedirs(wal_dir, exist_ok=True)
        self.term = self._read_term_file()
        self._segments = sorted(
            s for s in (_segment_first_seq(n) for n in os.listdir(wal_dir))
            if s is not None)
        # ``start_seq``: first sequence number of a BRAND-NEW log (ignored
        # when segments already exist).  A follower bootstrapping from a
        # fetched snapshot has no WAL files, but the snapshot's replay
        # horizon is ``replay_from_seq`` — its log must continue THERE, or
        # the first shipped frame after a compaction would look like a gap.
        self.next_seq = start_seq
        if not self._segments:
            self._segments = [start_seq]
            self._file = open(_segment_path(wal_dir, start_seq), "ab")
        else:
            active = _segment_path(wal_dir, self._segments[-1])
            records, valid, clean = _scan_segment(active)
            if not clean:
                with open(active, "rb") as f:
                    buf = f.read()
                if _has_valid_frame_after(buf, valid + 1):
                    raise ValueError(
                        f"{active}: corruption at byte {valid} with intact "
                        "records after it — this is bitrot, not a torn "
                        "tail; refusing to truncate acked mutations "
                        "(restore the file or cut a fresh snapshot)")
                with open(active, "r+b") as f:     # drop the torn tail
                    f.truncate(valid)
            self.next_seq = (records[-1].seq + 1 if records
                             else self._segments[-1])
            # a durably written record proves its term was adopted, even
            # if the crash beat the TERM-file write
            if records:
                self.term = max(self.term,
                                max(r.term for r in records))
            self._file = open(active, "ab")
        # nothing is pending at open: everything on disk counts as synced
        self._synced_seq = self.next_seq - 1

    # -- term fencing (DESIGN.md §8.7) -------------------------------------

    def _read_term_file(self) -> int:
        path = os.path.join(self.wal_dir, _TERM_FILE)
        if not os.path.exists(path):
            return 1
        with open(path) as f:
            return int(f.read().strip())

    def set_term(self, term: int) -> None:
        """Adopt a HIGHER primary term (promotion, or learning of one from
        shipped frames) and persist it durably before any record can be
        stamped with it.  A term can never go backwards: lowering it would
        re-admit a fenced-off zombie primary's writes."""
        with self._append_lock:
            self._adopt_term(int(term))

    def _adopt_term(self, term: int) -> None:
        """Persist + adopt a term (caller holds ``_append_lock``)."""
        if term < self.term:
            raise ValueError(
                f"term {term} < current term {self.term} — terms are "
                "monotone; a lowered term would unfence a zombie primary")
        if term == self.term:
            return
        path = os.path.join(self.wal_dir, _TERM_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(term))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(self.wal_dir)
        self.term = term

    # -- append -----------------------------------------------------------

    def _write_frame(self, kind: int, arrays: dict) -> int:
        """Frame + buffer one record (caller holds ``_append_lock``);
        returns its sequence number.  No flush — the caller batches.
        Records are stamped with the log's current term."""
        seq = self.next_seq
        payload = pack_arrays(arrays)
        frame = _HEADER.pack(_MAGIC, kind, seq, self.term, len(payload),
                             _frame_crc(kind, seq, self.term,
                                        payload)) + payload
        self._file.write(frame)
        self.next_seq = seq + 1
        return seq

    def append(self, kind: int, arrays: dict, *, sync: bool | None = None) -> int:
        """Frame + append one record (flushed to the OS before returning)
        and return its sequence number.  ``sync=None`` (default) fsyncs per
        ``self.sync`` — the one-call-one-ack form; ``sync=False`` defers
        the disk sync to a later ``sync_to`` (group commit: the caller
        acks only after some fsync covers this sequence number)."""
        with self._append_lock:
            seq = self._write_frame(kind, arrays)
            self._file.flush()
        if self.sync if sync is None else sync:
            self.sync_to(seq)
        return seq

    def append_many(self, entries: list[tuple[int, dict]]) -> list[int]:
        """Append a batch of ``(kind, arrays)`` records under ONE lock hold,
        one flush, and (when ``self.sync``) one shared fsync — the explicit
        group-commit form benchmarks use to measure the amortization.
        Returns the assigned sequence numbers."""
        if not entries:
            return []
        with self._append_lock:
            seqs = [self._write_frame(kind, arrays)
                    for kind, arrays in entries]
            self._file.flush()
        self.sync_to(seqs[-1])
        return seqs

    def sync_to(self, seq: int) -> None:
        """Make every record up to (at least) ``seq`` durable: no-op if a
        previous group fsync already covered it, otherwise ONE fsync that
        covers every record flushed so far — concurrent callers piggyback
        on it instead of queueing their own (DESIGN.md §7.6).  No-op when
        the log was opened with ``sync=False``."""
        if not self.sync:
            return
        with self._sync_lock:
            if self._synced_seq >= seq:
                return                   # a shared fsync already covered it
            with self._append_lock:
                # everything flushed so far lands in this fsync; holding
                # _sync_lock keeps rotate() from closing the handle under us
                target = self.next_seq - 1
                fileno = self._file.fileno()
            synced_before = self._synced_seq
            t0 = time.perf_counter()
            os.fsync(fileno)
            dt = time.perf_counter() - t0
            self._synced_seq = max(self._synced_seq, target)
            batch = max(0, target - synced_before)
            self.last_fsync_s = dt
            self.last_group_batch = batch
            self._h_fsync.observe(dt)
            if batch:
                self._h_batch.observe(batch)
            self._g_backlog.set(self.unsynced_backlog)

    def append_insert(self, x_sparse, x_dense, ids, *,
                      sync: bool | None = None) -> int:
        """Log one normalized insert batch (CSR parts + dense + ids)."""
        xs = x_sparse.tocsr()
        return self.append(RECORD_INSERT, {
            "data": xs.data, "indices": xs.indices, "indptr": xs.indptr,
            "shape": np.asarray(xs.shape, np.int64),
            "dense": np.asarray(x_dense, np.float32),
            "ids": np.asarray(ids, np.int64)}, sync=sync)

    def append_delete(self, ids, *, sync: bool | None = None) -> int:
        """Log one delete (the requested external ids, live or not —
        replaying a no-op delete is itself a no-op)."""
        return self.append(RECORD_DELETE,
                           {"ids": np.atleast_1d(np.asarray(ids, np.int64))},
                           sync=sync)

    def append_noop(self, *, sync: bool | None = None) -> int:
        """Log a TERM BARRIER: a record with no state effect whose only job
        is to carry the log's current term (DESIGN.md §8.7).  A freshly
        promoted primary appends one immediately, so the first frame it
        ships proves the new term to every follower — after a follower
        applies it, a deposed primary's same-seq frames are refused by the
        term fence instead of racing the real ones."""
        return self.append(RECORD_NOOP, {}, sync=sync)

    # -- segmentation -----------------------------------------------------

    def rotate(self) -> int:
        """Close the active segment and start a new one at ``next_seq`` —
        the snapshot/compaction cut point.  Returns the new segment's first
        sequence number (the snapshot's ``replay_from_seq``).

        Takes BOTH locks (sync before append, the global order): the old
        segment is fsync'd before it is sealed — a flushed-but-unsynced
        group-commit record must not end up in a closed file no
        ``sync_to`` can reach — and an in-flight ``sync_to`` can never see
        the handle close under its fsync."""
        with self._sync_lock:
            with self._append_lock:
                self._file.flush()
                if self.sync:
                    os.fsync(self._file.fileno())
                self._file.close()
                first = self.next_seq
                self._segments.append(first)
                self._file = open(_segment_path(self.wal_dir, first), "ab")
                self._synced_seq = first - 1
            fsync_dir(self.wal_dir)
        return first

    def truncate_before(self, seq: int) -> int:
        """Delete whole segments every record of which is ``< seq`` (i.e.
        fully covered by a committed snapshot).  The active segment is never
        deleted.  Returns how many segments were removed."""
        removed = 0
        while len(self._segments) > 1 and self._segments[1] <= seq:
            os.remove(_segment_path(self.wal_dir, self._segments.pop(0)))
            removed += 1
        if removed:
            fsync_dir(self.wal_dir)
        return removed

    # -- replication shipping (DESIGN.md §8.3) ----------------------------

    def read_frames(self, from_seq: int, *, limit: int = 256,
                    max_bytes: int = 1 << 24) -> tuple[bytes, list[int]]:
        """Raw framed records with ``seq >= from_seq``, oldest first, capped
        at ``limit`` records / ``max_bytes`` payload — the WAL-shipping read
        a primary serves to its replicas.  Whole segments strictly below
        ``from_seq`` are skipped without being read (the segment-streaming
        point of the ``wal-<first_seq>`` naming), so a caught-up replica's
        poll costs one scan of the active tail, not the full log.

        Ships the frames BYTE-IDENTICAL (header + crc + payload): the
        replica re-validates each crc and appends the same bytes to its own
        log (``append_frames``), so primary and replica logs are the same
        file content record-for-record.  Returns ``(buf, seqs)``.
        """
        out, seqs = [], []
        with self._append_lock:
            self._file.flush()       # ship through the OS-visible tail
            segments = list(self._segments)
        for i, first in enumerate(segments):
            nxt = segments[i + 1] if i + 1 < len(segments) else None
            if nxt is not None and nxt <= from_seq:
                continue             # fully below the ship horizon: skip
            with open(_segment_path(self.wal_dir, first), "rb") as f:
                buf = f.read()
            off = 0
            while len(seqs) < limit and sum(map(len, out)) < max_bytes:
                header = buf[off:off + _HEADER.size]
                if len(header) < _HEADER.size:
                    break
                magic, kind, seq, term, length, crc = _HEADER.unpack(header)
                payload = buf[off + _HEADER.size:off + _HEADER.size + length]
                if (magic != _MAGIC or len(payload) < length
                        or _frame_crc(kind, seq, term, payload) != crc):
                    break            # torn/unflushed tail: stop shipping
                if seq >= from_seq:
                    out.append(buf[off:off + _HEADER.size + length])
                    seqs.append(seq)
                off += _HEADER.size + length
            if len(seqs) >= limit or sum(map(len, out)) >= max_bytes:
                break
        return b"".join(out), seqs

    def append_frames(self, buf: bytes) -> list[WalRecord]:
        """Validate and append SHIPPED frames, preserving their sequence
        numbers — the replica-side half of WAL shipping.  Each frame's crc
        is re-checked and its seq must continue this log exactly at
        ``next_seq`` (shipping is resumable but never leaves a gap: a
        restarted replica recovers to its exact applied seq and re-requests
        from there).  Frames the log already holds (seq < next_seq) are
        skipped, so an overlapping re-ship is idempotent.  A frame stamped
        with a term LOWER than this log's current term is REFUSED — the
        zombie fence (DESIGN.md §8.7): once a follower has learned of term
        T (promotion, or a shipped term-T record), nothing the deposed
        term-(T-1) primary keeps writing can enter its log.  A higher term
        is adopted (and persisted) before the frame lands.  Durability
        follows the log's sync policy.  Returns the decoded records that
        were appended, in order, for the caller to apply."""
        appended: list[WalRecord] = []
        with self._append_lock:
            off = 0
            while off < len(buf):
                header = buf[off:off + _HEADER.size]
                if len(header) < _HEADER.size:
                    raise ValueError("shipped WAL buffer ends mid-header")
                magic, kind, seq, term, length, crc = _HEADER.unpack(header)
                payload = buf[off + _HEADER.size:off + _HEADER.size + length]
                if (magic != _MAGIC or len(payload) < length
                        or _frame_crc(kind, seq, term, payload) != crc):
                    raise ValueError(
                        f"shipped WAL frame at offset {off} failed its "
                        "checksum — refusing to persist garbage")
                frame_end = off + _HEADER.size + length
                if seq < self.next_seq:
                    off = frame_end          # already have it: idempotent
                    continue
                if term < self.term:
                    raise ValueError(
                        f"shipped WAL frame seq {seq} carries term {term} "
                        f"< this log's term {self.term} — refusing a "
                        "deposed (zombie) primary's write")
                if seq != self.next_seq:
                    raise ValueError(
                        f"shipped WAL frame seq {seq} does not continue "
                        f"this log (expected {self.next_seq}) — a gap "
                        "would silently lose mutations")
                if term > self.term:
                    self._adopt_term(term)
                self._file.write(buf[off:frame_end])
                appended.append(WalRecord(seq=seq, kind=kind, term=term,
                                          arrays=unpack_arrays(payload)))
                self.next_seq = seq + 1
                off = frame_end
            self._file.flush()
        if appended:
            self.sync_to(appended[-1].seq)
        return appended

    # -- replay -----------------------------------------------------------

    def records(self, from_seq: int = 0) -> list[WalRecord]:
        """Every complete record with ``seq >= from_seq``, in order, across
        all segments — stopping at the torn tail of the ACTIVE segment.
        An unclean NON-active segment is never a crash artifact (only the
        last segment was being appended to), so it raises instead of
        silently recovering a partial prefix of acked mutations."""
        out = []
        for i, first in enumerate(self._segments):
            path = _segment_path(self.wal_dir, first)
            records, valid, clean = _scan_segment(path)
            if not clean and i + 1 < len(self._segments):
                raise ValueError(
                    f"{path}: corruption at byte {valid} in a sealed "
                    "(non-active) WAL segment — acked mutations would be "
                    "lost; refusing to recover past it")
            out.extend(r for r in records if r.seq >= from_seq)
        return out

    @property
    def unsynced_backlog(self) -> int:
        """Records appended (and OS-flushed) but not yet covered by a
        disk sync — the group-commit exposure window.  Always 0 right
        after a covering ``sync_to`` returns."""
        return max(0, self.next_seq - 1 - self._synced_seq)

    @property
    def segment_paths(self) -> list[str]:
        """Current segment files, oldest first (the active one is last)."""
        return [_segment_path(self.wal_dir, s) for s in self._segments]

    def close(self) -> None:
        """Flush (and, in sync mode, fsync — deferred group-commit records
        must not die with the handle) then close the append handle
        (idempotent)."""
        with self._sync_lock, self._append_lock:
            if not self._file.closed:
                self._file.flush()
                if self.sync:
                    os.fsync(self._file.fileno())
                self._file.close()
