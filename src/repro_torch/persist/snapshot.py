"""Snapshot store: one durable, versioned copy of a pristine index
generation (DESIGN.md §7.1); counterpart of ``repro.persist.snapshot``,
whose on-disk format it writes and reads byte for byte.

A snapshot is what the batch build (or a compaction) produces: every
``IndexArrays`` leaf (PQ codes in the packing the engine serves), the
codebooks, the frozen residual grid, padded posting lists, the tile head,
plus the host-side artifacts search needs (``pi``, the compact column
space) and the retained corpus that makes the generation MUTABLE again
after a restart.  A DELTA-STATE snapshot (``delta_state=True``; DESIGN.md
§7.6) also serializes the appended rows in insertion order plus the alive
flags, and load replays them through the normal insert/delete machinery.

On-disk layout (all under one store root)::

    root/
      CURRENT                 {"format": 1, "snapshot": "snap-000002"}
      snap-000002/
        manifest.json         format version, params, scalars,
                              replay_from_seq, per-leaf table w/ sha256
        <leaf>.bin            raw C-order bytes per array leaf
      wal/wal-*.log           mutation segments (persist/wal.py)

Commit protocol (the reference's): leaves + manifest are written into
``.tmp-snap-…``, each blob fsync'd, one atomic rename publishes the
directory and CURRENT is rewritten (tmp + rename) to point at it.

**Crossing between the packages.**  Leaves leave the device through
``device.to_numpy`` with the reference's dtypes (``LEAF_DTYPES``: bool
``head_occupancy``, uint8 codes packed or not, int64 ``pi`` and
``ids_built``, ...); a leaf of another dtype is refused on write and on
load.  Backend names are written as the reference reads them
(``cuda`` → ``pallas``, ``cuda-packed`` → ``pallas-packed``, ``onehot`` →
``onehot-mxu``, ``ref`` → ``ref``) in both ``scalars.backend`` and
``params.backend``; the port reads either set of names.  A store whose
``params.backend`` is None serves on ``cuda`` here, where the reference
serves it on ``ref`` (unless ``use_lut16_kernel``): the port's
``HybridIndexParams`` resolves None to its kernels
(``core/hybrid.py``).  Load assembles the device arrays through the same
``IndexArrays.build`` as the batch build, on the requested device
(``interchange.hybrid_index_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import scipy.sparse as sp

from ..checkpoint.leaves import fsync_dir, read_array_blob, write_array_blob
from ..core.engine import Backend
from ..device import to_numpy

__all__ = ["FORMAT_VERSION", "LEAF_DTYPES", "REFERENCE_BACKEND_NAMES",
           "write_snapshot", "load_snapshot", "read_current",
           "list_snapshots", "store_files"]

FORMAT_VERSION = 1
_CURRENT = "CURRENT"
_MANIFEST = "manifest.json"
_SNAP_PREFIX, _TMP_PREFIX = "snap-", ".tmp-snap-"

# The dtype of every leaf the index (not the caller's corpus) determines,
# as the reference writes it; the corpus leaves keep the caller's scipy
# dtypes, as in the reference.
LEAF_DTYPES = {
    "pi": "<i8", "cols_global_ids": "<i8", "inv_rows": "<i4",
    "inv_vals": "<f4", "res_cols": "<i4", "res_vals": "<f4",
    "centers": "<f4", "codes": "|u1", "dres_q": "|i1", "dres_scale": "<f4",
    "dres_zero": "<f4", "corpus_dense": "<f4", "ids_built": "<i8",
    "head_block": "<f4", "head_occupancy": "|b1", "head_dims": "<i4",
    "extra_dense": "<f4", "extra_ids": "<i8", "extra_alive": "|u1",
    "alive0": "|u1",
}

# the name the reference's Backend.from_name reads for each port backend
REFERENCE_BACKEND_NAMES = {
    Backend.REF: "ref", Backend.ONEHOT: "onehot-mxu",
    Backend.CUDA: "pallas", Backend.CUDA_PACKED: "pallas-packed",
}


def read_current(root: str) -> dict | None:
    """The committed CURRENT pointer, or None when the store is empty."""
    path = os.path.join(root, _CURRENT)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def list_snapshots(root: str) -> list[str]:
    """Committed snapshot directory names, oldest first."""
    if not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root) if d.startswith(_SNAP_PREFIX))


def store_files(root: str) -> list[str]:
    """Root-relative paths of the files a fresh follower copies to
    bootstrap from this store: every file of the snapshot CURRENT names,
    then CURRENT itself (last, so a reader copying in order never commits
    a pointer before its target exists).  WAL segments are excluded."""
    cur = read_current(root)
    if cur is None:
        raise FileNotFoundError(
            f"{root!r} has no committed snapshot store (CURRENT missing)")
    snap = cur["snapshot"]
    names = sorted(os.listdir(os.path.join(root, snap)))
    return [f"{snap}/{n}" for n in names] + [_CURRENT]


def _sweep_tmp(root: str) -> None:
    """Remove half-written ``.tmp-snap-…`` directories (crash litter)."""
    for d in os.listdir(root):
        if d.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def _check_dtype(name: str, dtype_str: str, where: str) -> None:
    want = LEAF_DTYPES.get(name)
    if want is not None and dtype_str != want:
        raise ValueError(f"{where}: leaf {name!r} has dtype {dtype_str}, "
                         f"the snapshot format stores {want}")


def _reference_name(backend) -> str | None:
    """A backend name as the reference reads it (None stays None)."""
    if backend is None:
        return None
    return REFERENCE_BACKEND_NAMES[Backend.from_name(backend)]


def _index_leaves(index) -> dict[str, np.ndarray]:
    """Flatten everything a generation needs into named host arrays."""
    st = index.mutable_state
    xs0 = st.x_sparse0
    leaves = {
        "pi": index.pi,
        "cols_global_ids": np.asarray(index.cols.global_ids),
        "inv_rows": to_numpy(index.inv_index.rows),
        "inv_vals": to_numpy(index.inv_index.vals),
        "res_cols": to_numpy(index.sparse_residual.cols),
        "res_vals": to_numpy(index.sparse_residual.vals),
        "centers": to_numpy(index.codebooks.centers),
        "codes": to_numpy(index.codes),
        "dres_q": to_numpy(index.dense_residual.q),
        "dres_scale": to_numpy(index.dense_residual.scale),
        "dres_zero": to_numpy(index.dense_residual.zero),
        "corpus_data": xs0.data,
        "corpus_indices": xs0.indices,
        "corpus_indptr": xs0.indptr,
        "corpus_dense": st.x_dense0,
        "ids_built": st.ids_built,
    }
    if index.head is not None:
        leaves["head_block"] = to_numpy(index.head.block)
        leaves["head_occupancy"] = to_numpy(index.head.occupancy)
        leaves["head_dims"] = to_numpy(index.head.head_dims)
    return leaves


def _delta_leaves(st) -> dict[str, np.ndarray]:
    """Extra leaves of a DELTA-STATE snapshot (DESIGN.md §7.6): every
    appended row in INSERTION order (CSR parts + dense + external ids) plus
    the alive flags of both tiers."""
    if st.extra_sparse:
        xse = sp.vstack(st.extra_sparse, format="csr")
        xde = np.stack(st.extra_dense).astype(np.float32)
    else:
        xse = sp.csr_matrix((0, st.x_sparse0.shape[1]), dtype=np.float32)
        xde = np.zeros((0, st.x_dense0.shape[1]), np.float32)
    return {
        "extra_data": xse.data,
        "extra_indices": xse.indices,
        "extra_indptr": xse.indptr,
        "extra_dense": xde,
        "extra_ids": np.asarray(st.extra_ids, np.int64),
        "extra_alive": np.asarray(st.extra_alive, np.uint8),
        "alive0": st.alive0.astype(np.uint8),
    }


def write_snapshot(root: str, index, *, replay_from_seq: int,
                   keep_last: int = 2, delta_state: bool = False) -> str:
    """Serialize a mutable generation; atomic commit; returns the committed
    snapshot directory.

    ``replay_from_seq`` is the WAL sequence number recovery resumes from.
    ``keep_last`` older snapshots are garbage-collected after the commit.
    By default raises ``ValueError`` on a non-pristine index (pending delta
    rows or tombstones — compact first); ``delta_state=True`` serializes
    the pending delta rows and alive flags too (DESIGN.md §7.6)."""
    st = index.mutable_state
    if st is None:
        raise ValueError("snapshots need a mutable index "
                         "(HybridIndex.build(..., mutable=True))")
    if not delta_state and (st.version != 0 or st.delta.count
                            or st.main_tombstones):
        raise ValueError(
            "snapshot requires a pristine generation (no pending delta rows "
            "or tombstones): compact() first — a snapshot is by definition "
            "a build/compaction output, mutations belong to the WAL "
            "(or pass delta_state=True to checkpoint the live state)")
    leaves = _index_leaves(index)
    if delta_state:
        leaves.update(_delta_leaves(st))
    for k, v in leaves.items():
        _check_dtype(k, np.asarray(v).dtype.str, "write_snapshot")
    params = dataclasses.asdict(index.params)
    params["backend"] = _reference_name(params["backend"])
    os.makedirs(root, exist_ok=True)
    _sweep_tmp(root)
    # max+1, not count+1: GC shrinks the list, and a recycled name would
    # collide with a still-existing directory at the commit rename
    existing = [int(s[len(_SNAP_PREFIX):]) for s in list_snapshots(root)]
    seqno = max(existing, default=0) + 1
    name = f"{_SNAP_PREFIX}{seqno:06d}"
    tmp = os.path.join(root, f"{_TMP_PREFIX}{seqno:06d}")
    final = os.path.join(root, name)
    os.makedirs(tmp)
    try:
        table = {k: write_array_blob(os.path.join(tmp, f"{k}.bin"), v)
                 for k, v in leaves.items()}
        manifest = {
            "format": FORMAT_VERSION,
            "replay_from_seq": int(replay_from_seq),
            "params": params,
            "scalars": {
                "num_points": int(index.num_points),
                "d_dense": int(index.d_dense),
                "inv_num_points": int(index.inv_index.num_points),
                "codes_packed": bool(index.engine.arrays.codes_packed),
                "backend": _reference_name(index.engine.backend),
                "next_id": int(st.next_id),
                "delta_capacity": int(st.delta.capacity),
                "delta_state": bool(delta_state),
                "corpus_shape": list(st.x_sparse0.shape),
                "head": (None if index.head is None else
                         {"block_rows": index.head.block_rows,
                          "block_cols": index.head.block_cols}),
            },
            "leaves": table,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        # the blobs are fsync'd, but their directory ENTRIES live in tmp's
        # dirent table: flush those before the publish rename
        fsync_dir(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    os.rename(tmp, final)                      # publish the directory
    fsync_dir(root)
    cur_tmp = os.path.join(root, _CURRENT + ".tmp")
    with open(cur_tmp, "w") as f:
        json.dump({"format": FORMAT_VERSION, "snapshot": name}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(cur_tmp, os.path.join(root, _CURRENT))   # commit
    fsync_dir(root)
    for old in list_snapshots(root)[:-max(keep_last, 1)]:
        shutil.rmtree(os.path.join(root, old), ignore_errors=True)
    return final


def load_snapshot(root: str, *, snapshot: str | None = None,
                  backend=None, verify: bool = True, device="cuda"):
    """Load the committed (or a named) snapshot back into a mutable
    ``HybridIndex`` on ``device``; returns ``(index, manifest)``.

    Every leaf's recorded dtype is checked against ``LEAF_DTYPES`` and its
    sha256 against the bytes (``verify=False`` skips the hash, for
    benchmarks only).  ``backend`` overrides the recorded engine backend
    (either package's names); the stored codes stay in their recorded
    packing, so any backend serves any snapshot."""
    from ..core.hybrid import HybridIndexParams
    from ..core.streaming import MutableState
    from ..interchange import hybrid_index_from_numpy

    if snapshot is None:
        cur = read_current(root)
        if cur is None:
            raise FileNotFoundError(f"no committed snapshot under {root!r}")
        if cur.get("format") != FORMAT_VERSION:
            raise ValueError(f"unsupported snapshot store format "
                             f"{cur.get('format')!r} (have {FORMAT_VERSION})")
        snapshot = cur["snapshot"]
    snap_dir = os.path.join(root, snapshot)
    with open(os.path.join(snap_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(f"unsupported snapshot format "
                         f"{manifest.get('format')!r}")
    table = manifest["leaves"]
    for name, meta in table.items():
        _check_dtype(name, meta["dtype"], snap_dir)

    def leaf(name):
        return read_array_blob(os.path.join(snap_dir, table[name]["file"]),
                               table[name], verify=verify)

    sc = manifest["scalars"]
    params = HybridIndexParams(**manifest["params"])
    if backend is not None:
        # the codes stay in their recorded packing whatever the backend
        params = dataclasses.replace(
            params, backend=Backend.from_name(backend).value,
            pack_codes=bool(sc["codes_packed"]))
    head = sc["head"]
    names = [n for n in ("pi", "cols_global_ids", "inv_rows", "inv_vals",
                         "res_cols", "res_vals", "centers", "codes",
                         "dres_q", "dres_scale", "dres_zero", "head_block",
                         "head_occupancy", "head_dims") if n in table]
    idx = hybrid_index_from_numpy(
        {n: leaf(n) for n in names},
        {"num_points": sc["num_points"],
         "inv_num_points": sc["inv_num_points"],
         "codes_packed": sc["codes_packed"],
         "head.block_rows": None if head is None else head["block_rows"],
         "head.block_cols": None if head is None else head["block_cols"]},
        params=params, device=device)
    xs0 = sp.csr_matrix(
        (leaf("corpus_data"), leaf("corpus_indices"), leaf("corpus_indptr")),
        shape=tuple(sc["corpus_shape"]))
    ms = MutableState(
        idx, xs0, leaf("corpus_dense"), ext_ids=leaf("ids_built"),
        # restore the pre-sized delta capacity: replaying a long WAL tail
        # into the default would re-pay every growth re-materialization
        delta_capacity=int(sc.get("delta_capacity", 64)))
    idx.mutable_state = ms
    if sc.get("delta_state"):
        # DELTA-STATE snapshot (DESIGN.md §7.6): replay the serialized rows
        # one by one through the NORMAL insert path (same order, same ids,
        # so every upsert kill chain and capacity doubling happens as it did
        # live), then apply the stored alive flags as deletes.
        eids = leaf("extra_ids")
        ealive = leaf("extra_alive").astype(bool)
        alive0 = leaf("alive0").astype(bool)
        xse = sp.csr_matrix(
            (leaf("extra_data"), leaf("extra_indices"),
             leaf("extra_indptr")),
            shape=(len(eids), int(sc["corpus_shape"][1])))
        xde = leaf("extra_dense")
        for j in range(len(eids)):
            ms.insert(xse[j], xde[j:j + 1], ids=eids[j:j + 1])
        dead = [e for e, (kind, i) in ms._loc.items()
                if not (alive0[i] if kind == "init" else ealive[i])]
        if dead:
            ms.delete(sorted(dead))
    ms.next_id = max(ms.next_id, int(sc["next_id"]))
    return idx, manifest
