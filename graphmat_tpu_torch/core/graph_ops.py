"""Whole-graph vertex and edge operations.

Counterpart of ``graphmat_tpu/core/graph_ops.py``:

* ``apply_to_all_vertices`` (``Graph.h:353-374``): elementwise vp
  transform over valid vertices;
* ``apply_reduce_all_vertices`` (``Graph.h:377-381``): map over vertices,
  then one global reduce;
* ``apply_to_all_edges`` (``Graph.h:390-402``): rewrite every edge value
  as a function of both endpoints' properties.  Every CSR the graph holds
  is updated (each receiver direction and any sender-major index the push
  kernel built), and each one's cached float32 values are dropped, so the
  kernels read the new values.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .graph import Graph
from .tree import tree_map
from .types import Monoid

__all__ = ["apply_to_all_vertices", "apply_reduce_all_vertices",
           "apply_to_all_edges", "reduce_tree"]

_REDUCE = {"sum": lambda a: a.sum(0), "min": lambda a: a.amin(0),
           "any": lambda a: a.amin(0), "max": lambda a: a.amax(0),
           "or": lambda a: a.any(0)}


def apply_to_all_vertices(graph: Graph, fn: Callable) -> None:
    """vp <- fn(vp) over valid vertices (tree -> tree)."""
    new_vp = fn(graph.vp)
    mask = graph.valid_vertex

    def keep(new, old):
        m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)
    graph.vp = tree_map(keep, new_vp, graph.vp)


def _fold_valid(a, combine, cat):
    """Pairwise log-depth fold of the rows of ``a`` with ``combine``: the
    first half's rows with the second's, an odd last row carried on by
    ``cat``."""
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        folded = combine(a[:half], a[half: 2 * half])
        a = cat(folded, a[2 * half:]) if a.shape[0] & 1 else folded
    return a[0]


def _reduce_leaf(leaf, mask, red):
    """Reduce one ``[n_pad, ...]`` leaf over valid vertices with ``red``
    (``graphmat_tpu/core/graph_ops.py:44-74``): a kind string, a
    :class:`Monoid`, or an associative ``combine(a, b)``.  A generic
    Monoid folds pairwise, log-depth, over exactly the valid entries, on
    tensors on the leaf's device (``combine_fn`` gets tensors, as in the
    Engine); an empty reduce gives its identity.  A bare callable folds
    the same way over numpy arrays on the host (the reference folds on
    rank 0, ``multinode/reduce.h:39-74``)."""
    if isinstance(red, str):
        red = Monoid(red)
    if isinstance(red, Monoid) and red.kind != "generic":
        m = mask.reshape(mask.shape + (1,) * (leaf.dim() - 1))
        filled = torch.where(m, leaf, torch.as_tensor(
            red.identity(leaf.dtype), dtype=leaf.dtype, device=leaf.device))
        return _REDUCE[red.kind](filled).cpu().numpy()
    if isinstance(red, Monoid):
        a = leaf[mask]
        if a.shape[0] == 0:
            return torch.full(tuple(leaf.shape[1:]),
                              red.identity(leaf.dtype),
                              dtype=leaf.dtype).numpy()
        return _fold_valid(a, red.combine, lambda x, y: torch.cat(
            (x, y))).cpu().numpy()
    a = leaf[mask].cpu().numpy()
    if a.shape[0] == 0:
        raise ValueError("empty reduce with no identity: pass a Monoid")
    return _fold_valid(a, lambda x, y: np.asarray(red(x, y)),
                       lambda x, y: np.concatenate([x, y]))


def _is_spec(x) -> bool:
    return isinstance(x, (str, Monoid)) or callable(x)


def reduce_tree(mapped, mask, reduce):
    """:func:`_reduce_leaf` across a mapped tree
    (``graphmat_tpu/core/graph_ops.py:77-88``): ``reduce`` is one spec
    for every leaf, or a dict (list, tuple) of specs shaped like
    ``mapped``."""
    if _is_spec(reduce):
        return tree_map(lambda leaf: _reduce_leaf(leaf, mask, reduce),
                        mapped)
    if isinstance(reduce, dict):
        return {k: reduce_tree(mapped[k], mask, r)
                for k, r in reduce.items()}
    return type(reduce)(reduce_tree(m, mask, r)
                        for m, r in zip(mapped, reduce))


def apply_reduce_all_vertices(graph: Graph, map_fn: Callable,
                              reduce="sum"):
    """The reduce of ``map_fn(vp)`` (a tree of ``[n_pad, ...]`` tensors)
    over valid vertices, as host values.  ``reduce`` is a kind string, a
    :class:`Monoid` (generic included), an associative ``combine(a, b)``,
    or a dict of those shaped like the mapped tree."""
    return reduce_tree(map_fn(graph.vp), graph.valid_vertex, reduce)


def apply_to_all_edges(graph: Graph, fn: Callable) -> None:
    """Rewrite edge values: ``val <- fn(vp_src, vp_dst, val)`` for every
    edge of every CSR the graph holds.  ``fn`` gets the gathered source
    and destination properties (``[nnz]`` leading dim) and the current
    values, and returns the new ones (cast to the values' dtype)."""
    vp = graph.vp
    for role, c in graph._all_csrs():
        col, row = c.col.long(), c.row.long()
        # receiver role 'dst': col = src, row = dst; role 'src': swapped
        s_idx, d_idx = (col, row) if role == "dst" else (row, col)
        vp_s = tree_map(lambda a: a[s_idx], vp)
        vp_d = tree_map(lambda a: a[d_idx], vp)
        c.val = torch.as_tensor(fn(vp_s, vp_d, c.val)).to(c.val.dtype)
        c._val_f32 = None
