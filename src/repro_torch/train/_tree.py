"""Nested-dict parameter trees in JAX's flatten order: dict keys sorted,
tuples (``AdamWState``) in field order, ``None`` an empty subtree. The
optimizer sums and the checkpoint's leaf files follow this order, so a
checkpoint either package writes restores in the other."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def leaves_like(like, tree) -> List[Any]:
    """The leaves of ``tree`` at the places of ``like``'s leaves (nested
    dicts), ``None`` where ``tree`` holds ``None``: a gradient tree whose
    missing gradients are leaves, not empty subtrees."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in leaves_like(like[k], None if tree is None else tree.get(k))]
    return [tree]


def leaves_with_specs(tree, specs) -> List[Tuple[Any, Any]]:
    """``(leaf, spec)`` of every leaf of ``tree`` in flatten order, ``specs``
    a tree of its structure with a partition spec (a tuple) at each leaf
    (``partition.TreeShardings.specs``); a ``None`` leaf (a missing
    gradient) comes with its spec."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in leaves_with_specs(tree[k], specs[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for sub, sp in zip(tree, specs) for pair in leaves_with_specs(sub, sp)]
    return [(tree, specs)]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}  # keep the tree's own key order
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(sub) for sub in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in the tree's shape."""
    leaves = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
