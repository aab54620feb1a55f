"""Padded neighbour lists and sorted-set intersection.

Counterpart of ``graphmat_tpu/ops/neighbors.py``.  The reference's
TriangleCounting sends variable-length neighbour vectors as messages
(``src/TriangleCounting.cpp:82-111``); here each vertex's neighbour ids
are collected into a ``[n_pad, max_degree]`` matrix padded with
:data:`PAD_ID`, rows ascending, and the reference's sorted-vector
intersection (``:127-144``) becomes a batched ``torch.searchsorted``.
The lists are read from the graph's CSR (``Graph.csr(receiver)``), whose
edges are sorted by (receiver, sender), so each row comes out sorted.
"""

from __future__ import annotations

import torch

__all__ = ["max_degree", "collect_neighbors", "intersect_sorted_counts",
           "PAD_ID"]

PAD_ID = 2 ** 31 - 1   # int32's largest value: a pad sorts after every id


def max_degree(graph, receiver: str = "src") -> int:
    """The largest receiver degree of the direction (1 for a graph
    without edges): a shape, so it is read to the host."""
    csr = graph.csr(receiver)
    if csr.nnz == 0:
        return 1
    return int(csr.rowptr.diff().max())


def collect_neighbors(graph, receiver: str = "src",
                      pad_to: int | None = None, neighbor_ids=None):
    """The padded, row-sorted neighbour matrix, int32 ``[n_pad, D]``.

    ``receiver='src'`` collects each vertex's out-neighbours (the
    reference's GetNeighbors runs IN_EDGES, so the receiver is the source
    and the value recorded is the destination's id).  ``neighbor_ids``
    gives the value recorded for each edge of the CSR, in its order
    (default: the sender's 1-based internal id).  ``D`` is ``pad_to`` or
    the direction's :func:`max_degree`; a row's edges past ``D`` drop.
    """
    csr = graph.csr(receiver)
    D = pad_to if pad_to is not None else max_degree(graph, receiver)
    row = csr.row.long()
    rank = torch.arange(csr.nnz, device=row.device) - csr.rowptr.long()[row]
    vals = (csr.col + 1 if neighbor_ids is None
            else torch.as_tensor(neighbor_ids, device=row.device))
    keep = rank < D
    out = torch.full((graph.n_pad, D + 1), PAD_ID, dtype=torch.int32,
                     device=row.device)
    # an edge past D lands in the extra column, which is cut
    out[row, torch.where(keep, rank, D)] = vals.to(torch.int32)
    return out[:, :D]


def intersect_sorted_counts(a, b):
    """``|a ∩ b|`` per row, for ``[e, D]`` rows ascending and padded with
    :data:`PAD_ID`: each element of ``a`` is looked up in its row of
    ``b`` by binary search (the reference's two-pointer merge,
    ``src/TriangleCounting.cpp:127-144``).  Rows are assumed free of
    duplicates (simple graphs).  Returns int32 ``[e]``."""
    d = b.shape[1]
    idx = torch.searchsorted(b.contiguous(), a.contiguous())
    idx = idx.clamp_(max=d - 1)
    found = torch.gather(b, 1, idx) == a
    return (found & (a != PAD_ID)).sum(1, dtype=torch.int32)
