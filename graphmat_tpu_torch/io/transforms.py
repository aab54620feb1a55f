"""Edge-list transformations (dataset preparation).

Counterpart of the first two transforms of ``graphmat_tpu/io/transforms.py``
(``edgelist_transformation.h:37-95`` of the reference).  Each takes an
:class:`EdgeList` of numpy arrays or of torch tensors and returns a new one
of the same kind, on the same device.  Edge values travel with their edge.
"""

from __future__ import annotations

import numpy as np
import torch

from .edgelist import EdgeList

__all__ = ["remove_selfedges", "remove_duplicate_edges"]


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
