"""Parameter / optimizer / decode-state / batch specs (counterpart of
``repro.models.shardings``), and each device's bytes under them.

Specs are derived from leaf *path names* (the param tree is the schema)
through the logical-rule table of ``models.common``, as the reference's
are: the non-tensor-parallel dim of every matrix shards over 'data' (+
'pod'), moments inherit their parameter's spec, scalars and int8 moment
blocks replicate.  A spec is a plain tuple, one entry a dim (None, an axis
name or a tuple of names): ``tuple(PartitionSpec)`` of the reference's.

The trees are the port's: under ``blocks`` a position is a list of
per-layer dicts (``models.layout``), and a per-layer tensor gets the
reference's spec of the stacked leaf with its leading repeats entry (always
None) dropped; a tree in the reference's stacked layout (the optimizer's
moments) keeps it.  A spec tree has its tree's layout, with lists for
containers and a tuple where the tree has a tensor (or, for an int8 moment
block, a dict of tensors that all take that spec).

``shard_shape`` and ``bytes_per_device`` reckon one device's share on a
``launch.mesh.LogicalMesh``; they are exact, because ``resolve_spec`` keeps
an axis only where it divides the dim.
"""

from __future__ import annotations

import math

import torch

from .common import DEFAULT_RULES, resolve_spec
from .layout import from_reference, named_leaves, tree_map

__all__ = ["param_pspecs", "state_pspecs", "state_out_pspecs",
           "logits_pspec", "batch_pspecs", "tree_pspecs", "shard_shape",
           "same_layout", "bytes_per_device"]

# leaf-name -> logical axes per rank (the stacked `blocks` axis is prepended
# automatically when the path passes through "blocks")
_PARAM_AXES = {
    "embed":    ("vocab", "fsdp"),
    "lm_head":  ("fsdp", "vocab"),
    "wq":       ("fsdp", "kv_heads", "heads", None),
    "wk":       ("fsdp", "kv_heads", None),
    "wv":       ("fsdp", "kv_heads", None),
    "wo":       ("kv_heads", "heads", None, "fsdp"),
    "bq":       ("kv_heads", "heads", None),
    "bk":       ("kv_heads", None),
    "bv":       ("kv_heads", None),
    "router":   ("fsdp", "expert"),
    "in_proj":  ("fsdp", "mlp"),
    "out_proj": ("mlp", "fsdp"),
    "conv_w":   (None, "mlp"),
    "conv_b":   ("mlp",),
    "a_log":    ("heads",),
    "dt_bias":  ("heads",),
    "d_skip":   ("heads",),
    "wa":       ("fsdp", "state"),
    "wx":       ("fsdp", "state"),
    "ba":       ("state",),
    "bx":       ("state",),
    "lam":      ("state",),
    "w_rec":    ("fsdp", "state"),
    "out":      ("state", "fsdp"),
    "norm":     ("mlp",),
    "scale":    (None,),
    "bias":     (None,),
}

_STATE_AXES = {
    "k":    ("batch", "kv_seq", "kv_heads", None),
    "v":    ("batch", "kv_seq", "kv_heads", None),
    "ck":   ("batch", None, "kv_heads", None),
    "cv":   ("batch", None, "kv_heads", None),
    "pos":  (None,),
    "conv": ("batch", None, "mlp"),
    "ssm":  ("batch", "heads", None, None),
    "h":    ("batch", "state"),
    "index": (),
}


def _mlp_axes(name: str, rank: int):
    # dense MLP w_gate/w_up (D,F) / w_down (F,D); MoE (E,D,F) / (E,F,D);
    # rglru w_gate (D,W)
    if name in ("w_gate", "w_up"):
        return ("expert", "fsdp", "mlp") if rank == 3 else ("fsdp", "mlp")
    if name == "w_down":
        return ("expert", "mlp", "fsdp") if rank == 3 else ("mlp", "fsdp")
    return None


def _shape(leaf) -> tuple:
    """A tensor's shape; () for a host scalar (a decode state's index)."""
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def _param_axes(name: str, rank: int) -> tuple:
    axes = _mlp_axes(name, rank)
    if axes is None:
        axes = _PARAM_AXES.get(name)
    if axes is None:
        axes = (None,) * rank
    return tuple(axes)


def _state_axes(name: str, rank: int) -> tuple:
    return tuple(_STATE_AXES.get(name, (None,) * rank))


def _leaf_spec(axes_for, mesh, rules, path, leaf, repeat):
    """The reference's spec of the leaf at ``path``: ``leaf`` is one
    layer's tensor when ``repeat`` is not None (the spec then drops the
    stacked axis's None), else the whole leaf (stacked when under
    ``blocks``)."""
    shape = _shape(leaf)
    name = str(path[-1])
    if "blocks" not in path:
        return resolve_spec(mesh, rules, axes_for(name, len(shape))[
            :len(shape)], shape)
    per_layer = shape if repeat is not None else shape[1:]
    spec = resolve_spec(mesh, rules, axes_for(name, len(per_layer))[
        :len(per_layer)], per_layer)
    return spec if repeat is not None else (None,) + spec


def _rules(rules):
    return dict(DEFAULT_RULES, **(rules or {}))


def param_pspecs(params, mesh, rules: dict | None = None):
    """Spec tree matching ``params`` (works on ``meta`` tensors)."""
    rules = _rules(rules)
    return from_reference(params, lambda path, leaf, repeat: _leaf_spec(
        _param_axes, mesh, rules, path, leaf, repeat))


def state_pspecs(state, mesh, rules: dict | None = None):
    """Decode-state spec tree (KV caches / recurrent states; the host-int
    ``index`` takes (), the reference's spec of its int32 scalar)."""
    rules = _rules(rules)
    return from_reference(state, lambda path, leaf, repeat: _leaf_spec(
        _state_axes, mesh, rules, path, leaf, repeat))


# a decode state leaf whose output spec differs from its input spec: XLA's
# propagation gives the local-attention ring's slot positions (W,) the
# sharding of the cache slots they index (kv_seq), where the reference's
# state spec replicates them on the way in
_STATE_OUT_AXES = {"pos": ("kv_seq",)}


def state_out_pspecs(state, mesh, rules: dict | None = None):
    """The specs of the new decode state that the reference's compiled
    prefill and decode steps return: ``state_pspecs``'s, but for the
    leaves of ``_STATE_OUT_AXES``."""
    rules = _rules(rules)
    return from_reference(state, lambda path, leaf, repeat: _leaf_spec(
        lambda name, rank: tuple(_STATE_OUT_AXES.get(name)
                                 or _state_axes(name, rank)),
        mesh, rules, path, leaf, repeat))


def logits_pspec(shape, mesh, rules: dict | None = None) -> tuple:
    """The (B, V) logits' spec: batch and vocab."""
    return resolve_spec(mesh, _rules(rules), ("batch", "vocab"),
                        tuple(shape))


def batch_pspecs(batch, mesh, rules: dict | None = None):
    """Input batch specs: leading dim is always the global batch."""
    rules = _rules(rules)

    def spec(leaf):
        rank = len(_shape(leaf))
        return resolve_spec(mesh, rules, ("batch",) + (None,) * (rank - 1),
                            _shape(leaf))
    return tree_map(spec, batch)


def tree_pspecs(tree, mesh, params_like, rules: dict | None = None):
    """Optimizer-state specs: moments inherit parameter specs (the
    moments keep the reference's stacked layout, so their specs keep the
    leading None); scalars and int8-quantized moment blocks (a dict of
    ``q`` and ``scale`` where the parameter's moment would be) replicate."""
    rules = _rules(rules)
    ref_shapes = {path: ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
                  for path, ts, stacked in named_leaves(params_like)}

    def moments(x, path):
        if path in ref_shapes:
            if isinstance(x, dict) or not _shape(x):
                return ()
            return _leaf_spec(_param_axes, mesh, rules, path,
                              torch.empty(ref_shapes[path], device="meta"),
                              None)
        if isinstance(x, dict):
            return {k: moments(v, path + (k,)) for k, v in x.items()}
        return [moments(v, path + (i,)) for i, v in enumerate(x)]

    out = {}
    for key, sub in tree.items():
        if key in ("m", "v"):
            out[key] = moments(sub, ())
        else:
            out[key] = tree_map(lambda _: (), sub)
    return out


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's block of an array of ``shape`` under ``spec``."""
    out = list(shape)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        n = math.prod(mesh.shape[a] for a in
                      (ax if isinstance(ax, tuple) else (ax,)))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        out[i] //= n
    return tuple(out)


def same_layout(a, b, mesh) -> bool:
    """Two specs lay an array out alike on ``mesh``: equal once the axes of
    size 1 are dropped (a donated buffer is reused only for an output of
    its own layout)."""
    def axes(spec):
        out = []
        for ax in spec:
            names = ax if isinstance(ax, tuple) else (ax,)
            out.append(tuple(n for n in names
                             if n is not None and mesh.shape[n] > 1))
        return out
    return axes(a) == axes(b)


def _leaf_bytes(leaf, spec, mesh) -> int:
    if isinstance(leaf, torch.Tensor):
        return (math.prod(shard_shape(leaf.shape, spec, mesh))
                * leaf.element_size())
    if isinstance(leaf, dict):
        return sum(_leaf_bytes(v, spec, mesh) for v in leaf.values())
    if isinstance(leaf, int):
        return 4          # a host int stands for the reference's int32 ()
    raise TypeError(f"no bytes for a {type(leaf).__name__} leaf")


def bytes_per_device(tree, specs, mesh) -> int:
    """Bytes of ``tree``'s arrays on each device of ``mesh`` under
    ``specs`` (a spec tree of ``tree``'s layout)."""
    if isinstance(specs, tuple):
        return _leaf_bytes(tree, specs, mesh)
    if isinstance(specs, dict):
        return sum(bytes_per_device(tree[k], specs[k], mesh) for k in specs)
    return sum(bytes_per_device(t, s, mesh) for t, s in zip(tree, specs))
