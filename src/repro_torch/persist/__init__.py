"""Durable index persistence (DESIGN.md §7) of the port: snapshot store +
mutation WAL + crash recovery for the streaming mutable index, in the JAX
package's on-disk format (either package recovers the other's stores).

* ``snapshot`` — versioned on-disk copies of a pristine generation
  (manifest + checksummed per-leaf blobs, atomic rename-on-commit);
* ``wal`` — framed, checksummed, segmented log of every acked mutation,
  truncated at each compaction snapshot (a copy of the reference's: the
  frames are byte-identical);
* ``recovery`` — ``recover()`` = snapshot-load + WAL-tail replay through
  the normal streaming machinery, bit-identical to the never-crashed index;
  ``Durability``/``bootstrap()`` are the serving layer's attach points
  (``QueryService(persist_dir=…)`` / ``QueryService(restore_from=…)``,
  ``HybridIndex.load``).
"""

from .snapshot import (FORMAT_VERSION, list_snapshots,  # noqa: F401
                       load_snapshot, read_current, store_files,
                       write_snapshot)
from .wal import (RECORD_DELETE, RECORD_INSERT, RECORD_NOOP,  # noqa: F401
                  MutationWAL, WalRecord)
from .recovery import (Durability, RecoveryResult, apply_record,  # noqa: F401
                       bootstrap, recover, reopen)
