"""Shared leaf-serialization helpers for durable on-disk artifacts.

Two consumers, one format discipline:

* ``repro/persist`` (index snapshots + mutation WAL) stores every array leaf
  as raw C-contiguous bytes with the dtype/shape/checksum carried OUT OF BAND
  (a JSON manifest for snapshot blobs, a framed header for WAL payloads) —
  no pickling, so a snapshot written by one process version loads in another,
  and a flipped bit is a detected error instead of a silently wrong score;
* ``repro/checkpoint`` (training state) keeps its npz container but shares
  the checksum/atomic-commit conventions.

Contracts:

* round trips are BIT-EXACT: ``read_array_blob(write_array_blob(x)) == x``
  including dtype — persistence bit-identity (tests/test_persist.py) rests
  on this layer;
* blob files carry no header; the manifest entry from ``write_array_blob``
  is the only way to decode one, and ``read_array_blob`` verifies the
  recorded sha256 before returning (opt-out for benchmarks);
* ``pack_arrays``/``unpack_arrays`` give the same exactness for an in-memory
  dict of named arrays (the WAL payload unit): a JSON header line + the
  concatenated raw bytes, deterministic for identical inputs.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

__all__ = ["write_array_blob", "read_array_blob", "pack_arrays",
           "unpack_arrays", "array_sha256", "fsync_dir"]


def _contiguous(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr))


def _raw(a: np.ndarray) -> memoryview:
    """The raw C-order bytes of a contiguous array, viewed, not copied."""
    return memoryview(a.reshape(-1).view(np.uint8))


def array_sha256(arr: np.ndarray) -> str:
    """Hex sha256 of an array's raw C-order bytes (dtype/shape not mixed in —
    the manifest records those separately, so the hash pins content only)."""
    return hashlib.sha256(_raw(_contiguous(arr))).hexdigest()


def write_array_blob(path: str, arr: np.ndarray) -> dict:
    """Write one array as raw bytes; return its manifest entry
    ``{file, dtype, shape, nbytes, sha256}`` (file = basename of ``path``).

    The write goes through a same-directory temp file + atomic rename so a
    crash mid-write never leaves a half-length blob under the final name."""
    a = _contiguous(arr)
    buf = _raw(a)              # the array's own bytes: written and hashed
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return {"file": os.path.basename(path), "dtype": a.dtype.str,
            "shape": list(a.shape), "nbytes": int(a.nbytes),
            "sha256": hashlib.sha256(buf).hexdigest()}


def read_array_blob(path: str, meta: dict, *, verify: bool = True) -> np.ndarray:
    """Read a blob written by ``write_array_blob`` back into an array.

    ``meta`` is the manifest entry; with ``verify`` (the default) the
    recorded sha256 is recomputed and a mismatch raises ``ValueError`` —
    a corrupt snapshot must fail recovery loudly, never score queries."""
    # read into a buffer the array then owns: no copy of the blob's bytes
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        got_n = f.readinto(buf)
    if got_n != int(meta["nbytes"]):
        raise ValueError(f"{path}: expected {meta['nbytes']} bytes, "
                         f"found {got_n}")
    arr = np.frombuffer(buf, dtype=np.dtype(meta["dtype"]))
    arr = arr.reshape(tuple(meta["shape"]))
    if verify:
        got = hashlib.sha256(buf).hexdigest()
        if got != meta["sha256"]:
            raise ValueError(f"{path}: checksum mismatch "
                             f"(manifest {meta['sha256'][:12]}…, "
                             f"file {got[:12]}…)")
    return arr


def pack_array_parts(arrays: dict[str, np.ndarray]) -> list:
    """``pack_arrays``' bytes as a list of buffers in order: the header
    line, then each array's own contiguous bytes, viewed, not copied (a
    large frame is sent or hashed without a copy of its tensors)."""
    metas, blobs = [], []
    off = 0
    for name, arr in arrays.items():
        a = _contiguous(arr)
        metas.append({"name": name, "dtype": a.dtype.str,
                      "shape": list(a.shape), "offset": off,
                      "nbytes": int(a.nbytes)})
        blobs.append(_raw(a))
        off += a.nbytes
    header = json.dumps({"v": 1, "arrays": metas},
                        separators=(",", ":")).encode()
    return [header + b"\n", *blobs]


def pack_arrays(arrays: dict[str, np.ndarray]) -> bytes:
    """Serialize named arrays to one deterministic byte string (the WAL
    payload unit): a JSON header line describing every array's dtype, shape
    and byte extent, then the concatenated raw C-order bytes."""
    return b"".join(pack_array_parts(arrays))


def unpack_arrays(buf, start: int = 0) -> dict[str, np.ndarray]:
    """Inverse of ``pack_arrays`` on ``buf[start:]``; bit-exact including
    dtypes.  An array whose bytes in a writable ``buf`` (a ``bytearray``
    received for them) are aligned for its dtype is a view of it; any other
    is a copy, so every array returned is writable and aligned."""
    nl = buf.index(b"\n", start)
    header = json.loads(bytes(buf[start:nl]).decode())
    body = nl + 1
    out = {}
    for m in header["arrays"]:
        lo, n = body + int(m["offset"]), int(m["nbytes"])
        if lo + n > len(buf):
            raise ValueError(f"payload truncated inside array {m['name']!r}")
        dt = np.dtype(m["dtype"])
        arr = np.frombuffer(buf, dtype=dt, count=n // dt.itemsize, offset=lo)
        if not (arr.flags.writeable and arr.flags.aligned):
            arr = arr.copy()
        out[m["name"]] = arr.reshape(tuple(m["shape"]))
    return out


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a DIRECTORY so a just-committed rename survives
    power loss (no-op on platforms that refuse O_RDONLY dir fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:          # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:          # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)
