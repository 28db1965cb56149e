"""Training checkpoints (counterpart of ``repro.checkpoint.checkpoint``):
npz save / restore with async writes, a manifest for atomicity and
``keep_last`` garbage collection, in the reference's on-disk layout, so
that each package restores the other's checkpoints:

  ckpt_dir/
    manifest.json          {"latest_step": n}, written last
    step_<n>/arrays.npz    one array a leaf, under the reference's names
    step_<n>/treedef.txt   the tree's structure (written, never read)

A leaf's name is its path in the reference's tree, dict keys sorted and
``/``-joined (``params/blocks/0/attn/wq``, ``opt/step``,
``opt/m/blocks/0/attn/wq/q``).  The port's per-layer params are stacked
over the repeats axis on save and unstacked on restore
(``models.layout``); the optimizer's moments already follow the reference's
layout.  A step is written to a temp dir and renamed into place, then the
manifest is written, so a failure mid-write never corrupts the latest
checkpoint.  bf16 leaves are stored as the reference's ``np.savez`` stores
them, raw 2-byte ``|V2`` records, and read back as bf16 where the like-tree
holds bf16.  The reference's ``mesh=`` / ``pspec_tree=`` placement becomes
``device=``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..models.layout import from_reference, leaf_name, named_leaves, \
    to_reference

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

_MANIFEST = "manifest.json"


def _host(x, copy: bool = False) -> np.ndarray:
    """A leaf as the numpy array the reference writes (bf16 as ``|V2``): a
    tensor is copied to host memory; a numpy array is copied when
    ``copy``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.array(x) if copy else np.asarray(x)


def host_tree(tree):
    """``tree`` in the reference's layout as a host copy with numpy leaves
    (per-layer blocks stacked, bf16 as ``|V2``): the snapshot
    ``CheckpointManager`` takes before its writer thread starts."""
    return to_reference(tree, leaf=lambda x: _host(x, copy=True),
                        stack=lambda ts: np.stack([_host(t) for t in ts]))


def _flatten_with_names(tree) -> dict:
    """{name: numpy array} for each reference leaf, in the reference's
    flatten order."""
    out = {}
    for path, leaves, stacked in named_leaves(tree):
        out[leaf_name(path)] = (np.stack([_host(t) for t in leaves])
                                if stacked else _host(leaves[0]))
    return out


def _treedef(tree) -> str:
    """The reference's ``str(jax.tree_util.tree_structure(tree))`` of the
    tree in its layout."""
    def walk(x):
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, (list, tuple)):
            return "[" + ", ".join(walk(v) for v in x) + "]"
        return "*"
    return f"PyTreeDef({walk(to_reference(tree, lambda t: t, lambda ts: 0))})"


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep_last: int = 3):
    """Atomic checkpoint of ``tree`` (dicts and lists of tensors or numpy
    arrays, in the port's or the reference's layout) at ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **_flatten_with_names(tree))
    with open(os.path.join(tmp, "treedef.txt"), "w") as f:
        f.write(_treedef(tree))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, _MANIFEST), "w") as f:
        json.dump({"latest_step": step}, f)
    _gc(ckpt_dir, keep_last)


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    man = os.path.join(ckpt_dir, _MANIFEST)
    if not os.path.exists(man):
        return None
    with open(man) as f:
        return json.load(f)["latest_step"]


def _tensor(arr: np.ndarray, like, device) -> torch.Tensor:
    if arr.dtype.kind == "V":             # the reference's raw bf16
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    dtype = like.dtype if isinstance(like, torch.Tensor) else t.dtype
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device=device, dtype=dtype)


def restore_checkpoint(ckpt_dir: str, step: int, like_tree, *, device=None):
    """Restore into the structure of ``like_tree`` (the port's layout: a
    per-layer blocks position gets its layers back from the stacked leaf).
    Each leaf takes the like-leaf's dtype and lands on ``device``, or on
    the like-leaf's device when ``device`` is None."""
    path = os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")
    with np.load(path) as data:
        names = set(data.files)
        want = {leaf_name(p) for p, _, _ in named_leaves(like_tree)}
        if want != names:
            raise KeyError(f"{path}: leaves {sorted(names ^ want)} are in "
                           f"only one of the checkpoint and the like-tree")
        arrays = {name: data[name] for name in want}

    def get(p, like, repeat):
        arr = arrays[leaf_name(p)]
        return _tensor(np.array(arr if repeat is None else arr[repeat],
                                order="C"), like, device)
    return from_reference(like_tree, get)


class CheckpointManager:
    """Async checkpointing: snapshot to host, write in a background
    thread."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree):
        self.wait()
        host = host_tree(tree)           # snapshot before the thread starts
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host), daemon=True)
        self._thread.start()

    def _write(self, step: int, host):
        try:
            save_checkpoint(self.ckpt_dir, step, host,
                            keep_last=self.keep_last)
        except BaseException as e:       # re-raised by wait()
            self._error = e

    def wait(self):
        """Join the writer; a failed write raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
