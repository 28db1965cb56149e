"""Training checkpoints in the reference's npz + manifest layout
(``checkpoint.py``, a counterpart of ``repro.checkpoint.checkpoint``) and
the leaf serialization of durable on-disk artifacts (``leaves.py``, a copy
of ``repro.checkpoint.leaves``)."""

from .checkpoint import (save_checkpoint, restore_checkpoint,  # noqa: F401
                         latest_step, CheckpointManager)
from .leaves import (write_array_blob, read_array_blob,  # noqa: F401
                     pack_arrays, unpack_arrays, array_sha256, fsync_dir)
