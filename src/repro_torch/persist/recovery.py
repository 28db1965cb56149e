"""Crash recovery: snapshot load + WAL replay (DESIGN.md §7.3);
counterpart of ``repro.persist.recovery``.

``recover(root)`` rebuilds the exact serving state a crashed process had at
its last durably-acked mutation:

1. load the committed snapshot (``persist/snapshot.py``; every leaf
   checksum-verified) into a mutable ``HybridIndex`` on the requested
   device (``cuda`` unless the caller asks for the CPU) — bit-identical
   device arrays, empty delta;
2. replay the WAL tail (records with ``seq >= replay_from_seq``, stopping
   at the first torn/corrupt record) through the NORMAL streaming mutation
   path — ``MutableState.insert``/``delete`` re-run encode-on-insert against
   the loaded frozen artifacts, so the rebuilt delta shard, tombstone set
   and posting lists are bit-identical to the ones the crashed process
   served (tests/test_torch_persist.py on the CPU, ``chip_smoke.py``'s
   ``durable`` phase on the card).

``Durability`` is the attach point the serving layer drives: it owns the
WAL handle, logs every acked mutation, and cuts a new snapshot + rotates +
truncates the log at each compaction (``checkpoint()``).  The crash matrix
— which failure window loses what — is DESIGN.md §7.4.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import scipy.sparse as sp

from .snapshot import load_snapshot, read_current, write_snapshot
from .wal import RECORD_DELETE, RECORD_INSERT, RECORD_NOOP, MutationWAL

__all__ = ["Durability", "RecoveryResult", "recover", "bootstrap",
           "apply_record", "reopen"]

_WAL_SUBDIR = "wal"


@dataclasses.dataclass
class RecoveryResult:
    """What ``recover`` found: the rebuilt index, the re-attached
    ``Durability`` (appends continue the same WAL), the snapshot it loaded,
    how many tail records were replayed, and the last applied sequence
    number (0 when the WAL tail was empty)."""
    index: object
    durability: "Durability"
    snapshot: str
    replayed: int
    last_seq: int


def apply_record(index, record) -> None:
    """Apply one WAL record through the normal mutation path — replay and
    live serving share every line of encode/tombstone machinery."""
    if record.kind == RECORD_INSERT:
        a = record.arrays
        xs = sp.csr_matrix((a["data"], a["indices"], a["indptr"]),
                           shape=tuple(np.asarray(a["shape"])))
        index.mutable_state.insert(xs, a["dense"], ids=a["ids"])
    elif record.kind == RECORD_DELETE:
        index.mutable_state.delete(record.arrays["ids"])
    elif record.kind == RECORD_NOOP:
        pass          # term barrier: advances the applied seq, nothing else
    else:
        raise ValueError(f"unknown WAL record kind {record.kind!r} "
                         f"at seq {record.seq}")


class Durability:
    """The WAL + snapshot-store handle a durable index serves through.

    Lifecycle: ``bootstrap(root, index)`` for a fresh store (initial
    snapshot of the just-built generation + empty WAL), ``recover(root)``
    after a restart.  The owner (``QueryService`` or a direct caller)
    serializes calls — mutations are logged under the same lock that
    applies them."""

    def __init__(self, root: str, wal: MutationWAL):
        self.root = root
        self.wal = wal
        # a failed append POISONS the handle: the in-memory index has a
        # mutation the log doesn't, so acking anything further would let
        # recoverable and served state diverge silently.  The owner checks
        # ensure_ok() before accepting new mutations; serving reads on.
        self.failed = False

    def ensure_ok(self) -> None:
        """Refuse new mutations after an append failure — restart from the
        store to get back to a recoverable state."""
        if self.failed:
            raise RuntimeError(
                "durability is poisoned: a WAL append failed, so the "
                "in-memory index holds an unlogged mutation; restart from "
                f"the store at {self.root!r} to resume durable serving")

    # -- mutation logging -------------------------------------------------

    def log_insert(self, x_sparse, x_dense, ids, *,
                   sync: bool | None = None) -> int:
        """Log one applied insert batch; returns its WAL seq.  With the
        default ``sync=None`` the record is fsync'd per the WAL's policy
        before returning; ``sync=False`` defers the disk sync to a later
        ``sync(seq)`` — the group-commit ack path (DESIGN.md §7.6).
        An append failure poisons the handle (``ensure_ok``)."""
        try:
            return self.wal.append_insert(sp.csr_matrix(x_sparse),
                                          np.atleast_2d(
                                              np.asarray(x_dense,
                                                         np.float32)),
                                          ids, sync=sync)
        except BaseException:
            self.failed = True
            raise

    def log_delete(self, ids, *, sync: bool | None = None) -> int:
        """Log one applied delete; returns its WAL seq (``sync`` as in
        ``log_insert``).  An append failure poisons the handle
        (``ensure_ok``)."""
        try:
            return self.wal.append_delete(ids, sync=sync)
        except BaseException:
            self.failed = True
            raise

    def log_noop(self, *, sync: bool | None = None) -> int:
        """Log a term-barrier no-op (``MutationWAL.append_noop``) — the
        first record a freshly promoted primary writes; returns its WAL
        seq.  An append failure poisons the handle (``ensure_ok``)."""
        try:
            return self.wal.append_noop(sync=sync)
        except BaseException:
            self.failed = True
            raise

    def sync(self, seq: int) -> None:
        """Make the record at ``seq`` durable (group commit: a no-op when a
        shared fsync already covered it — see ``MutationWAL.sync_to``).
        The mutation is acked only after this returns; a failed fsync
        poisons the handle like a failed append."""
        try:
            self.wal.sync_to(seq)
        except BaseException:
            self.failed = True
            raise

    # -- snapshot cut points ----------------------------------------------

    def checkpoint(self, index, *, keep_last: int = 2) -> str:
        """Cut a durable snapshot of a pristine (just-compacted/built)
        generation: rotate the WAL so the snapshot's replay horizon starts
        a fresh segment, commit the snapshot, then truncate the segments it
        supersedes.  Crash-safe at every step — until the CURRENT pointer
        swaps, the previous snapshot + the uncut log still recover the same
        logical corpus (DESIGN.md §7.4).  Returns the snapshot directory."""
        replay_from = self.wal.rotate()
        path = write_snapshot(self.root, index,
                              replay_from_seq=replay_from,
                              keep_last=keep_last)
        self.wal.truncate_before(replay_from)
        return path

    def delta_checkpoint(self, index, *, keep_last: int = 2) -> str:
        """Cut a DELTA-STATE snapshot of a LIVE mutable index — delta rows,
        alive flags and tombstones included (DESIGN.md §7.6) — so recovery
        under sustained ingest is snapshot-load + a short WAL tail instead
        of replaying every mutation since the last compaction.  Same
        rotate/commit/truncate protocol as ``checkpoint`` (and the same
        §7.4 crash windows); the rotation fsyncs the sealed segment, so
        every record the snapshot folds in is already durable.  Returns
        the snapshot directory."""
        replay_from = self.wal.rotate()
        path = write_snapshot(self.root, index,
                              replay_from_seq=replay_from,
                              keep_last=keep_last, delta_state=True)
        self.wal.truncate_before(replay_from)
        return path

    def close(self) -> None:
        """Close the WAL append handle (idempotent)."""
        self.wal.close()


def bootstrap(root: str, index, *, sync: bool = True,
              keep_last: int = 2, metrics=None) -> Durability:
    """Initialize an EMPTY store root with the initial snapshot of a
    freshly built mutable index and an empty WAL; returns the attached
    ``Durability``.  Refuses a root that already holds a committed store
    (use ``recover`` to resume it — silently re-initializing would orphan
    its WAL tail)."""
    if read_current(root) is not None:
        raise ValueError(f"{root!r} already holds a committed snapshot "
                         "store; use persist.recover() to resume it")
    os.makedirs(root, exist_ok=True)
    # no committed store => anything under wal/ is litter from a failed
    # bootstrap; sweep it so the fresh log really starts at seq 1
    wal_dir = os.path.join(root, _WAL_SUBDIR)
    if os.path.isdir(wal_dir):
        shutil.rmtree(wal_dir)
    # snapshot FIRST (it also validates the index is pristine): a rejected
    # index must not leave an open WAL handle or a stray wal/ directory
    write_snapshot(root, index, replay_from_seq=1, keep_last=keep_last)
    return Durability(root, MutationWAL(wal_dir, sync=sync,
                                        metrics=metrics))


def recover(root: str, *, backend=None, sync: bool = True,
            verify: bool = True, metrics=None,
            device="cuda") -> RecoveryResult:
    """Snapshot-load + WAL-replay on ``device``; returns the rebuilt mutable
    index and a re-attached ``Durability`` whose appends continue the
    recovered log (the torn tail, if any, was truncated when the WAL
    reopened).  ``backend`` overrides the recorded engine backend."""
    cur = read_current(root)
    if cur is None:
        raise FileNotFoundError(
            f"{root!r} has no committed snapshot store (CURRENT missing); "
            "bootstrap one with persist.bootstrap(root, index)")
    index, manifest = load_snapshot(root, backend=backend, verify=verify,
                                    device=device)
    # a store with no WAL files yet (a follower's freshly fetched snapshot
    # — WAL segments are never part of snapshot distribution) starts its
    # log AT the snapshot's replay horizon, so shipped frames continue it
    # without a fake gap
    wal = MutationWAL(os.path.join(root, _WAL_SUBDIR), sync=sync,
                      start_seq=int(manifest["replay_from_seq"]),
                      metrics=metrics)
    replayed, last_seq = 0, 0
    for record in wal.records(from_seq=manifest["replay_from_seq"]):
        apply_record(index, record)
        replayed += 1
        last_seq = record.seq
    # opportunistic hygiene: segments a committed snapshot already covers
    wal.truncate_before(manifest["replay_from_seq"])
    return RecoveryResult(index=index, durability=Durability(root, wal),
                          snapshot=cur["snapshot"], replayed=replayed,
                          last_seq=last_seq)


def reopen(root: str, *, sync: bool = True, metrics=None) -> Durability:
    """Re-attach the log of a store whose index the caller already holds
    (``recover``'s, after the store was moved to ``root``): appends go on
    where the log ended; nothing is loaded or replayed."""
    return Durability(root, MutationWAL(os.path.join(root, _WAL_SUBDIR),
                                        sync=sync, metrics=metrics))
