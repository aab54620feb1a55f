"""PageRank as GraphMat runs it, :mod:`.pagerank`'s mathematics over the
edge list a chunk at a time.

The same degrees, initial value, step, apply and stop as
``reference/pagerank.py``; each step gathers and adds ``CHUNK`` edges at
a time, so that the float64 run takes a few vectors of ``n`` and a chunk
beside the edge list, however long the list.  Only the order of the
float64 additions differs from the one-shot reference.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 27


def _edges(src, dst, base: int, chunk: int):
    """0-based int64 ``(src, dst)`` chunks of ``base``-based ids."""
    for lo in range(0, src.numel(), chunk):
        yield (src[lo:lo + chunk].long() - base,
               dst[lo:lo + chunk].long() - base)


def pagerank(src, dst, n: int, alpha: float = 0.3, tol: float = 1e-5,
             dtype=torch.float64, snapshots=(), max_steps: int = 300,
             base: int = 0, chunk: int = CHUNK):
    """``src``, ``dst``: edges with ``base``-based ids (tensors).
    Returns ``(pr, steps, snaps)`` as ``reference.pagerank.pagerank``
    does."""
    dev = src.device
    out_deg = torch.zeros(n, dtype=torch.int64, device=dev)
    in_deg = torch.zeros(n, dtype=torch.int64, device=dev)
    for s, d in _edges(src, dst, base, chunk):
        out_deg += torch.bincount(s, minlength=n)
        in_deg += torch.bincount(d, minlength=n)
    deg = out_deg.to(dtype)
    has_in = in_deg > 0
    del out_deg, in_deg
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0).to(dtype)
    pr = torch.full((n,), 0.3, dtype=dtype, device=dev)
    want = set(snapshots)
    snaps, steps, step = {}, None, 0
    last = max(want, default=0)
    while step < max_steps and (steps is None or step < last):
        y = torch.zeros(n, dtype=dtype, device=dev)
        w = pr * inv
        for s, d in _edges(src, dst, base, chunk):
            y.index_add_(0, d, w[s])
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
