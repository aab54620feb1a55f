"""Whole-graph operations on a :class:`DistGraph`.

Counterpart of ``graphmat_tpu/parallel/dist_graph_ops.py``, the mesh forms
of the reference's multinode primitives outside the iteration loop:

* ``apply_to_all_vertices``     — ``Apply`` (multinode/apply.h:39-49)
* ``apply_reduce_all_vertices`` — ``MapReduce`` (multinode/reduce.h:39-74)
* ``apply_to_all_edges``        — ``ApplyEdges``
  (multinode/applyedges.h:45-161): a tile's senders read the column
  block's properties (all-gathered along 'r'), its receivers the row
  block's (along 'c').

Semantics are :mod:`graphmat_tpu_torch.core.graph_ops`'s exactly.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.graph_ops import reduce_tree
from ..core.tree import tree_map
from .dist_graph import DistGraph
from .dist_runtime import fold_tiles, map_tiles
from .mesh import COL_AXIS, ROW_AXIS

__all__ = ["apply_to_all_vertices", "apply_reduce_all_vertices",
           "apply_to_all_edges"]


def apply_to_all_vertices(graph: DistGraph, fn: Callable) -> None:
    """vp <- fn(vp) over valid vertices (tree -> tree), per segment."""
    out = []
    for vp, mask in zip(graph.vp, graph.valid_vertex):
        def keep(new, old, mask=mask):
            m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
            return torch.where(m, new, old)
        out.append(tree_map(keep, fn(vp), vp))
    graph.vp = out


def apply_reduce_all_vertices(graph: DistGraph, map_fn: Callable,
                              reduce="sum"):
    """The reduce of ``map_fn(vp)`` over valid vertices, as host values on
    every process; ``reduce`` as in
    :func:`graphmat_tpu_torch.core.graph_ops.apply_reduce_all_vertices`
    (a generic Monoid included).  The mapped segments are gathered, then
    reduced as on one device."""
    mapped = [map_fn(vp) for vp in graph.vp]
    full = fold_tiles(graph._full, mapped)
    return reduce_tree(full, graph._full(graph.valid_vertex), reduce)


def apply_to_all_edges(graph: DistGraph, fn: Callable) -> None:
    """Rewrite edge values: ``val <- fn(vp_src, vp_dst, val)`` for every
    edge of every tile CSR held here (both directions and any
    sender-major index), whose cached float32 values are dropped."""
    cols = map_tiles(lambda ts: graph.mesh.all_gather(ts, ROW_AXIS),
                     graph.vp)
    rows = map_tiles(lambda ts: graph.mesh.all_gather(ts, COL_AXIS),
                     graph.vp)
    # a tile's CSR holds col = its sender (column-local) and row = its
    # receiver (row-local); its sender-major index the other way round;
    # the sender is the source in the receiver=dst direction
    held = [(recv, c.col, c.row, c) for recv, cs in graph._tiles.items()
            for c in cs]
    held += [(recv, c.row, c.col, c) for recv, cs in graph._sender.items()
             for c in cs]
    n_local = len(graph.local)
    for k, (recv, s_loc, r_loc, c) in enumerate(held):
        p = k % n_local
        vs = tree_map(lambda a: a[s_loc.long()], cols[p])
        vr = tree_map(lambda a: a[r_loc.long()], rows[p])
        new = fn(vs, vr, c.val) if recv == "dst" else fn(vr, vs, c.val)
        c.val = torch.as_tensor(new).to(c.val.dtype)
        c._val_f32 = None
