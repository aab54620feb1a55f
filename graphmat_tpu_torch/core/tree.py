"""Nested containers of tensors: the port's stand-in for JAX pytrees.

Vertex properties, messages and program state are tensors or dicts,
lists and tuples of them.
"""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in a fixed order (dict keys sorted, as JAX orders them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]
