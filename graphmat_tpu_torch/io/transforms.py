"""Edge-list transformations (dataset preparation).

Counterpart of ``graphmat_tpu/io/transforms.py:32-118``
(``edgelist_transformation.h:37-443`` of the reference); the random
relabelling (``randomize_edge_direction``, ``randomize_vertex_ids``) is
not ported yet.  Each takes an :class:`EdgeList` of numpy arrays or of
torch tensors and returns a new one of the same kind, on the same device.
Edge values travel with their edge.  Random weights are drawn with numpy
from the seed, as the JAX package draws them, and moved to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .edgelist import EdgeList

__all__ = ["remove_selfedges", "remove_duplicate_edges",
           "create_bidirectional_edges", "convert_to_dag",
           "convert_to_upper_triangular", "random_edge_weights",
           "unit_edge_weights", "filter_edges"]


def _is_torch(e: EdgeList) -> bool:
    return isinstance(e.src, torch.Tensor)


def _where(e: EdgeList, cond, a, b):
    return torch.where(cond, a, b) if _is_torch(e) else np.where(cond, a, b)


def remove_selfedges(e: EdgeList) -> EdgeList:
    """Drop edges with src == dst (``edgelist_transformation.h:38-53``)."""
    keep = e.src != e.dst
    return EdgeList(e.m, e.n, e.src[keep], e.dst[keep], e.val[keep])


def remove_duplicate_edges(e: EdgeList) -> EdgeList:
    """Sort by (src, dst) and keep the first of each duplicate pair
    (``edgelist_transformation.h:69-95``: stable sort, first occurrence
    wins)."""
    if e.nnz == 0:
        return e.copy()
    if isinstance(e.src, torch.Tensor):
        # one int64 key (ids < 2^31, so src * 2^31 + dst cannot overflow)
        key = (e.src.long() << 31) | e.dst.long()
        key, order = torch.sort(key, stable=True)
        keep = torch.ones_like(key, dtype=torch.bool)
        keep[1:] = key[1:] != key[:-1]
        order = order[keep]
        return EdgeList(e.m, e.n, e.src[order], e.dst[order], e.val[order])
    order = np.lexsort((e.dst, e.src))
    src, dst, val = e.src[order], e.dst[order], e.val[order]
    keep = np.ones(src.shape[0], bool)
    keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    return EdgeList(e.m, e.n, src[keep], dst[keep], val[keep])


def create_bidirectional_edges(e: EdgeList) -> EdgeList:
    """Add the reverse of every edge with the same value, interleaved
    (forward, reverse) as the reference does
    (``edgelist_transformation.h:397-411``)."""
    if _is_torch(e):
        src = torch.stack([e.src, e.dst], 1).reshape(-1)
        dst = torch.stack([e.dst, e.src], 1).reshape(-1)
        val = torch.stack([e.val, e.val], 1).reshape(-1)
        return EdgeList(e.m, e.n, src, dst, val)
    src = np.empty(2 * e.nnz, np.int32)
    dst = np.empty(2 * e.nnz, np.int32)
    val = np.empty(2 * e.nnz, e.val.dtype)
    src[0::2], dst[0::2], val[0::2] = e.src, e.dst, e.val
    src[1::2], dst[1::2], val[1::2] = e.dst, e.src, e.val
    return EdgeList(e.m, e.n, src, dst, val)


def convert_to_dag(e: EdgeList) -> EdgeList:
    """Orient every edge low id -> high id
    (``edgelist_transformation.h:413-420``)."""
    swap = e.src > e.dst
    src = _where(e, swap, e.dst, e.src)
    dst = _where(e, swap, e.src, e.dst)
    if _is_torch(e):
        return EdgeList(e.m, e.n, src, dst, e.val.clone())
    return EdgeList(e.m, e.n, src.astype(np.int32), dst.astype(np.int32),
                    e.val.copy())


def convert_to_upper_triangular(e: EdgeList) -> EdgeList:
    """DAG-orient, then drop self loops and duplicates (the reference's
    TriangleCounting preprocessing)."""
    return remove_duplicate_edges(remove_selfedges(convert_to_dag(e)))


def random_edge_weights(e: EdgeList, random_range: int, seed: int = 0,
                        wdtype=None) -> EdgeList:
    """Uniform random weights in [1, random_range]
    (``edgelist_transformation.h:422-430``), the JAX package's draws."""
    rng = np.random.default_rng(seed)
    t = np.clip(rng.random(e.nnz) * random_range, 1.0, random_range)
    if _is_torch(e):
        dtype = wdtype if wdtype is not None else e.val.dtype
        val = torch.as_tensor(t, device=e.val.device).to(dtype)
        return EdgeList(e.m, e.n, e.src.clone(), e.dst.clone(), val)
    wdtype = np.dtype(wdtype) if wdtype is not None else e.val.dtype
    return EdgeList(e.m, e.n, e.src.copy(), e.dst.copy(), t.astype(wdtype))


def unit_edge_weights(e: EdgeList, wdtype=None) -> EdgeList:
    """Every weight 1."""
    if _is_torch(e):
        dtype = wdtype if wdtype is not None else e.val.dtype
        return EdgeList(e.m, e.n, e.src.clone(), e.dst.clone(),
                        torch.ones(e.nnz, dtype=dtype, device=e.val.device))
    wdtype = np.dtype(wdtype) if wdtype is not None else e.val.dtype
    return EdgeList(e.m, e.n, e.src.copy(), e.dst.copy(),
                    np.ones(e.nnz, wdtype))


def filter_edges(e: EdgeList, predicate) -> EdgeList:
    """Keep the edges where ``predicate(src, dst, val)`` (a bool mask over
    the whole arrays) holds (``edgelist_transformation.h:432-443``), e.g.
    ``lambda s, d, v: v <= delta`` for DeltaStepping's light edges."""
    keep = predicate(e.src, e.dst, e.val)
    if _is_torch(e):
        keep = torch.as_tensor(keep, device=e.src.device).bool()
    else:
        keep = np.asarray(keep, bool)
    return EdgeList(e.m, e.n, e.src[keep], e.dst[keep], e.val[keep])
