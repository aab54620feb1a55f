"""Synthetic graph generators (fixtures and benchmark inputs).

Counterpart of ``graphmat_tpu/utils/generators.py``.  ``chain_edgelist``
and ``random_edgelist`` are numpy and give the same edges as the JAX
package for the same arguments.  ``rmat_edgelist`` runs on a given torch
device with a given ``torch.Generator``: it follows the JAX package's
quadrant rule, but draws another random stream, so its graph differs
from JAX's for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.edgelist import EdgeList, edgelist_from_arrays
from ..io.transforms import remove_duplicate_edges, remove_selfedges

__all__ = ["chain_edgelist", "random_edgelist", "rmat_edgelist"]


def chain_edgelist(n: int, wdtype=np.int32, weight=1) -> EdgeList:
    """Path graph 1→2→...→n."""
    src = np.arange(1, n, dtype=np.int32)
    return edgelist_from_arrays(src, src + 1,
                                np.full(n - 1, weight, wdtype), m=n, n=n)


def random_edgelist(n: int, avg_degree: int, seed: int = 0,
                    weight_range: int = 0, wdtype=np.int32) -> EdgeList:
    """~n*avg_degree random edges, duplicates removed, no self loops.

    ``weight_range > 0`` draws integer weights in [1, weight_range];
    otherwise all weights are 1.
    """
    rng = np.random.default_rng(seed)
    nnz = n * avg_degree
    src = rng.integers(1, n + 1, nnz).astype(np.int32)
    dst = rng.integers(1, n + 1, nnz).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if weight_range > 0:
        val = rng.integers(1, weight_range + 1, src.shape[0]).astype(wdtype)
    else:
        val = np.ones(src.shape[0], wdtype)
    return remove_duplicate_edges(edgelist_from_arrays(src, dst, val,
                                                       m=n, n=n))


def rmat_edgelist(scale: int, edge_factor: int = 16,
                  a: float = 0.57, b: float = 0.19, c: float = 0.19,
                  seed: int = 0, dedup: bool = True, device="cpu",
                  generator: torch.Generator | None = None) -> EdgeList:
    """Graph500-style RMAT on ``device``: 2^scale vertices and
    edge_factor·2^scale drawn edges, self-edges dropped, duplicates
    dropped when ``dedup``.

    At each of ``scale`` levels every edge picks a quadrant with
    probabilities (a, b, c, 1-a-b-c): the source bit is set with
    probability c+d, and the destination bit with probability b/(a+b)
    when the source bit is clear and d/(c+d) when it is set (the rule of
    graphmat_tpu/utils/generators.py:113-126).  The random numbers come
    from ``generator``, or from a new one seeded with ``seed`` on
    ``device``.  The result holds int32 torch tensors on ``device``, with
    unit weights.
    """
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    n = 1 << scale
    nnz = n * edge_factor
    src = torch.zeros(nnz, dtype=torch.int64, device=device)
    dst = torch.zeros(nnz, dtype=torch.int64, device=device)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for _ in range(scale):
        r1 = torch.rand(nnz, generator=generator, device=device)
        r2 = torch.rand(nnz, generator=generator, device=device)
        src_bit = r1 > ab
        dst_bit = torch.where(src_bit, r2 > c_norm, r2 > a_norm)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
        del r1, r2
    src = (src + 1).to(torch.int32)
    dst = (dst + 1).to(torch.int32)
    val = torch.ones(nnz, dtype=torch.int32, device=device)
    e = remove_selfedges(EdgeList(n, n, src, dst, val))
    if dedup:
        e = remove_duplicate_edges(e)
    return e
