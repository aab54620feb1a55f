"""Breadth-first search as GraphMat's BFS, with the port's documented
parent rule: level by level from the source, a vertex first reached at
level ``d`` takes depth ``d`` and, as its parent, the smallest 1-based id
among its in-neighbours at depth ``d - 1``.  The source has depth 0 and
parent -1; an unreached vertex has depth ``INF`` and parent -1.
"""

from __future__ import annotations

import torch

INF = 2 ** 31 - 1


def bfs(src, dst, n: int, source0: int, id_dtype=torch.float64):
    """``src``, ``dst``: 0-based edges (int64 tensors).  Ids travel as
    ``id_dtype`` to the min.  Returns int64 ``(depth, parent)``."""
    dev = src.device
    depth = torch.full((n,), INF, dtype=torch.int64, device=dev)
    parent = torch.full((n,), -1, dtype=torch.int64, device=dev)
    depth[source0] = 0
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    front[source0] = True
    level = 0
    while True:
        e = front[src]
        s, d = src[e], dst[e]
        fresh = depth[d] == INF
        s, d = s[fresh], d[fresh]
        if d.numel() == 0:
            return depth, parent
        ids = (s + 1).to(id_dtype).to(torch.float64)
        best = torch.full((n,), float("inf"), dtype=torch.float64,
                          device=dev).scatter_reduce_(0, d, ids, "amin")
        reached = torch.isfinite(best)
        level += 1
        depth[reached] = level
        parent[reached] = best[reached].to(torch.int64)
        front = reached
