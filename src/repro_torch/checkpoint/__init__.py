"""Leaf serialization for durable on-disk artifacts (a copy of
``repro.checkpoint.leaves``; the training checkpoints wait for the LM
zoo)."""

from .leaves import (write_array_blob, read_array_blob,  # noqa: F401
                     pack_arrays, unpack_arrays, array_sha256, fsync_dir)
