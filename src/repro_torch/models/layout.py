"""The port's per-layer layout of a model tree against the reference's
stacked one.

In the reference every leaf under ``params["blocks"][pos]`` carries a
leading repeats axis (``Model.init`` vmaps the layer init); here
``params["blocks"][pos]`` is a list of per-layer dicts, one a repeat.  A
tree that follows the reference's layout (the optimizer's moments, a host
snapshot) keeps a dict at that place instead.  The rule below reads both:
under the key ``blocks``, a position that is a list holds one dict a
repeat, and its leaves stack, in repeat order, into the reference's leaf.

``named_leaves`` walks a tree in the reference's flatten order (dict keys
sorted, lists by index) and names each leaf as its checkpoint does
(``params/blocks/0/attn/wq``).  Optimizer and checkpoint both go by it: a
reference leaf is the unit of weight decay, int8 moment blocks and the
checkpoint's arrays.
"""

from __future__ import annotations

from typing import Callable, Iterator

__all__ = ["named_leaves", "leaf_name", "to_reference", "from_reference",
           "flatten", "unflatten", "tree_map"]


def _is_layer_list(path: tuple, x) -> bool:
    return bool(path) and path[-1] == "blocks" and isinstance(x, list)


def named_leaves(tree, prefix: tuple = ()) -> Iterator[tuple]:
    """(path, tensors, stacked) for each reference leaf of ``tree``:
    ``tensors`` is the list of per-layer tensors, in repeat order, of a
    leaf under a per-layer blocks position (``stacked`` True), else the one
    leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            if _is_layer_list(prefix, x):
                per_layer = [list(named_leaves(layer)) for layer in x]
                for j, (path, _, _) in enumerate(per_layer[0] if x else []):
                    yield (prefix + (i,) + path,
                           [leaves[j][1][0] for leaves in per_layer], True)
            else:
                yield from named_leaves(x, prefix + (i,))
    else:
        yield prefix, [tree], False


def leaf_name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def to_reference(tree, leaf: Callable, stack: Callable):
    """``tree`` in the reference's layout: a per-layer blocks position
    becomes one dict whose leaves are ``stack(per-layer leaves)``; every
    other leaf becomes ``leaf(x)``."""
    def walk(x, path):
        if isinstance(x, dict):
            return {k: walk(v, path + (k,)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            out = []
            for i, v in enumerate(x):
                if _is_layer_list(path, v):
                    out.append(_stack_layers(v, stack))
                else:
                    out.append(walk(v, path + (i,)))
            return out
        return leaf(x)
    return walk(tree, ())


def _stack_layers(layers: list, stack: Callable):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([layer[k] for layer in layers], stack)
                for k in first}
    return stack(layers)


def from_reference(like, get: Callable):
    """A tree shaped as ``like`` (the port's layout) whose leaves are
    ``get(path, like_leaf, repeat)``: ``path`` the reference leaf's path,
    ``repeat`` the layer's index into its stacked leaf (None off a per-layer
    blocks position)."""
    def walk(x, path, repeat):
        if isinstance(x, dict):
            return {k: walk(v, path + (k,), repeat) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            out = []
            for i, v in enumerate(x):
                if _is_layer_list(path, v):
                    out.append([walk(layer, path + (i,), r)
                                for r, layer in enumerate(v)])
                else:
                    out.append(walk(v, path + (i,), repeat))
            return out
        return get(path, x, repeat)
    return walk(like, (), None)


def flatten(tree) -> list:
    """The tensors of a (nested dict / list) tree, depth first in the
    tree's own order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flatten(v)]
    return [tree]


def unflatten(like, flat):
    """The inverse of ``flatten``: ``like``'s structure over ``flat``."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
