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


def tree_map(fn, tree):
    """``fn`` over the leaves of ``tree``, in a tree of the same structure;
    tuples come back as lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
