"""Parameter trees: nested dicts and lists with tensors at the leaves.

The port keeps parameters, gradients and optimizer state as plain trees (the
JAX package's pytrees).  These two helpers walk them in one fixed order —
dict insertion order, then list order — so trees built from one another
line up leaf for leaf.
"""

from __future__ import annotations


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in order; ``is_leaf(node)`` stops the descent."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v, is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the matching leaves of one or more trees of one
    structure, in a tree of that structure: dicts, lists, tuples and named
    tuples (an Aaren ``ScanState``) keep their type."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        if isinstance(first, list):
            return out
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return fn(*trees)
