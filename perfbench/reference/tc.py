"""Triangle counts attributed as the port's bucketed route documents
them: each undirected edge points from the endpoint of smaller (degree,
id) to the other, and a triangle counts at its vertex of smallest
(degree, id), the one from which both other vertices are out-neighbours.
So a vertex's count is the number of edges among its out-neighbours.
"""

from __future__ import annotations

import torch

CANDIDATES = 1 << 24   # pairs looked up at once


def orient(a, b, n: int) -> dict:
    """0-based pairs of any orientation (self loops and duplicates are
    dropped) to the oriented graph: ``rowptr`` over senders, ``nbr`` the
    out-neighbours by sender, ``keys`` every oriented edge ``s * n + r``,
    sorted."""
    a, b = a.long(), b.long()
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    ok = lo != hi
    key = torch.unique(lo[ok] * n + hi[ok])
    lo, hi = key // n, key % n
    deg = torch.bincount(lo, minlength=n) + torch.bincount(hi, minlength=n)
    rank = torch.empty(n, dtype=torch.int64, device=a.device)
    rank[torch.argsort(deg * n + torch.arange(n, device=a.device))] = \
        torch.arange(n, device=a.device)
    fwd = rank[lo] < rank[hi]
    s = torch.where(fwd, lo, hi)
    r = torch.where(fwd, hi, lo)
    keys = torch.sort(s * n + r).values
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=a.device)
    rowptr[1:] = torch.cumsum(torch.bincount(s, minlength=n), 0)
    return {"n": n, "rowptr": rowptr, "nbr": keys % n, "keys": keys}


def out_degree(o: dict):
    return o["rowptr"].diff()


def count_at(o: dict, v: int, acc_dtype=torch.int64) -> int:
    """Edges among ``v``'s out-neighbours: every ordered pair (x, y) of
    them looked up among the oriented edges (one orientation exists per
    edge), the hits summed in ``acc_dtype``."""
    n, keys = o["n"], o["keys"]
    nb = o["nbr"][o["rowptr"][v]:o["rowptr"][v + 1]]
    d = nb.numel()
    total = torch.zeros((), dtype=acc_dtype, device=nb.device)
    if d < 2:
        return 0
    rows = max(1, CANDIDATES // d)
    for b in range(0, d, rows):
        cand = (nb[b:b + rows, None] * n + nb[None, :]).flatten()
        pos = torch.searchsorted(keys, cand).clamp_(max=keys.numel() - 1)
        total = total + (keys[pos] == cand).to(acc_dtype).sum(
            dtype=acc_dtype)
    return int(total.item())


def total(o: dict) -> int:
    """Every vertex's count, summed (exact; for small graphs)."""
    return sum(count_at(o, v) for v in range(o["n"]))
