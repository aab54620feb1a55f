"""PageRank as GraphMat runs it (``src/PageRank.cpp``).

Out-degree by a count of each sender's edges; every vertex starts at
0.3; a step sends ``pr / degree`` (0 from a vertex of out-degree 0) along
each edge, and a vertex with at least one in-edge takes
``alpha + (1 - alpha) * sum``; one without keeps its value.  The run
stops after the first step in which no vertex changed by more than
``tol``, and that step counts.
"""

from __future__ import annotations

import torch


def pagerank(src, dst, n: int, alpha: float = 0.3, tol: float = 1e-5,
             dtype=torch.float64, snapshots=(), max_steps: int = 300):
    """``src``, ``dst``: 0-based edges (tensors).  Returns ``(pr, steps,
    snaps)``: the vector where the run stopped, its steps, and the vector
    after each step count in ``snapshots`` (run on past the stop where
    one asks for it)."""
    src = src.long()
    dst = dst.long()
    deg = torch.bincount(src, minlength=n).to(dtype)
    has_in = torch.bincount(dst, minlength=n) > 0
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0).to(dtype)
    pr = torch.full((n,), 0.3, dtype=dtype, device=src.device)
    want = set(snapshots)
    snaps, steps, step = {}, None, 0
    last = max(want, default=0)
    while step < max_steps and (steps is None or step < last):
        y = torch.zeros(n, dtype=dtype, device=src.device)
        y.index_add_(0, dst, (pr * inv)[src])
        new = torch.where(has_in, alpha + (1.0 - alpha) * y, pr)
        moved = bool(((new - pr).abs() > tol)[has_in].any())
        pr = new
        step += 1
        if step in want:
            snaps[step] = pr.clone()
        if steps is None and not moved:
            steps, stop_pr = step, pr.clone()
    if steps is None:
        steps, stop_pr = step, pr
    return stop_pr, steps, snaps
