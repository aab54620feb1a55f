"""GAP's ``kron``: the Graph500 Kronecker generator's pairs, symmetrised,
drawn on the device from a seed.

The stream and the label permutation are :mod:`.kron`'s (``kron_keys``,
``label_permutation``); each drawn pair is added in both directions, and
self loops and duplicate pairs are dropped: an undirected graph stored as
its directed pairs, as the GAP suite makes ``kron``
(arXiv:1508.03619).  The output is sorted by (src, dst).

The permuted draws stay on the device as int64 keys; the pairs are then
sorted one range of senders at a time (``BUCKET_KEYS`` pairs or so each),
so that the sort never holds the whole symmetrised list.  Drawing on the
CPU stops at ``CPU_SCALE``: past it the draw wants tens of GB of memory.
"""

from __future__ import annotations

import torch

from .kron import CHUNK, kron_keys, label_permutation

_LO32 = (1 << 32) - 1
BUCKET_KEYS = 1 << 28    # pairs sorted at once: bounds the sort's memory
CPU_SCALE = 20


def make(cfg: dict, seed: int, device) -> dict:
    """The configuration's undirected graph as directed pairs: ``src``,
    ``dst`` (int32, 0-based, sorted by (src, dst), each pair in both
    directions, no self loops, no duplicates) and ``n``."""
    scale = int(cfg["scale"])
    if torch.device(device).type == "cpu" and scale > CPU_SCALE:
        raise ValueError(f"kron_undirected draws scale {scale} on a card "
                         f"only; the CPU takes up to {CPU_SCALE}")
    n = 1 << scale
    total = n * int(cfg["edge_factor"])
    perm = label_permutation(n, seed, device)
    keys = torch.empty(total, dtype=torch.int64, device=device)
    for start in range(0, total, CHUNK):
        k = kron_keys(scale, min(CHUNK, total - start), cfg["a"], cfg["b"],
                      cfg["c"], seed, device, start)
        keys[start:start + k.numel()] = (perm[k >> 32] << 32) | perm[
            k & _LO32]
    del perm, k
    # every pair twice at most: room for the output, cut to size at the end
    src = torch.empty(2 * total, dtype=torch.int32, device=device)
    dst = torch.empty_like(src)
    buckets = max(1, -(-2 * total // BUCKET_KEYS))
    width = -(-n // buckets)
    m = 0
    for lo in range(0, n, width):
        hi = lo + width
        part = []
        for start in range(0, total, CHUNK):
            k = keys[start:start + CHUNK]
            s, d = k >> 32, k & _LO32
            for u, v in ((s, d), (d, s)):
                sel = (u >= lo) & (u < hi) & (u != v)
                part.append((u[sel] << 32) | v[sel])
        b = torch.sort(torch.cat(part)).values
        del part
        keep = torch.ones_like(b, dtype=torch.bool)
        keep[1:] = b[1:] != b[:-1]
        b = b[keep]
        src[m:m + b.numel()] = b >> 32
        dst[m:m + b.numel()] = b & _LO32
        m += b.numel()
        del b, keep
    return {"src": src[:m], "dst": dst[:m], "n": n}
