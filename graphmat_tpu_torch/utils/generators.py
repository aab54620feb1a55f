"""Synthetic graph generators (fixtures and benchmark inputs).

Counterpart of ``graphmat_tpu/utils/generators.py``.
``identity_edgelist``, ``chain_edgelist``, ``circular_chain_edgelist``,
``random_edgelist``, ``upper_triangular_edgelist`` and ``dense_edgelist``
are numpy and give the same edges as the JAX package for the same
arguments.  ``rmat_edgelist`` gives the JAX package's graph too, drawn
on a torch device, the card unless asked otherwise: by default the
native generator's splitmix64 stream (``gm_rmat_gen``; the kernel of
``csrc/rmat.cu`` on the card), with ``native=False`` the numpy stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.edgelist import EdgeList, edgelist_from_arrays
from ..io.transforms import remove_duplicate_edges
from ..ops.rmat import rmat_keys, rmat_weights

__all__ = ["identity_edgelist", "chain_edgelist", "circular_chain_edgelist",
           "random_edgelist", "upper_triangular_edgelist", "dense_edgelist",
           "rmat_edgelist"]


def identity_edgelist(n: int, wdtype=np.int32) -> EdgeList:
    """n self loops with weight 1 (``generator.h`` identity matrix)."""
    ids = np.arange(1, n + 1, dtype=np.int32)
    return edgelist_from_arrays(ids, ids, np.ones(n, wdtype), m=n, n=n)


def chain_edgelist(n: int, wdtype=np.int32, weight=1) -> EdgeList:
    """Path graph 1→2→...→n."""
    src = np.arange(1, n, dtype=np.int32)
    return edgelist_from_arrays(src, src + 1,
                                np.full(n - 1, weight, wdtype), m=n, n=n)


def circular_chain_edgelist(n: int, wdtype=np.int32) -> EdgeList:
    """Ring 1→2→...→n→1 (``generator.h`` circular chain)."""
    src = np.arange(1, n + 1, dtype=np.int32)
    dst = np.concatenate([np.arange(2, n + 1), [1]]).astype(np.int32)
    return edgelist_from_arrays(src, dst, np.ones(n, wdtype), m=n, n=n)


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


def upper_triangular_edgelist(n: int, wdtype=np.int32) -> EdgeList:
    """Complete DAG: edge (i, j) for every i < j."""
    src, dst = np.triu_indices(n, k=1)
    return edgelist_from_arrays(src.astype(np.int32) + 1,
                                dst.astype(np.int32) + 1,
                                np.ones(src.shape[0], wdtype), m=n, n=n)


def dense_edgelist(n: int, wdtype=np.int32) -> EdgeList:
    """Complete graph, self loops included."""
    src, dst = np.mgrid[1:n + 1, 1:n + 1]
    return edgelist_from_arrays(src.ravel().astype(np.int32),
                                dst.ravel().astype(np.int32),
                                np.ones(n * n, wdtype), m=n, n=n)


def rmat_edgelist(scale: int, edge_factor: int = 16,
                  a: float = 0.57, b: float = 0.19, c: float = 0.19,
                  seed: int = 0, dedup: bool = True,
                  weight_range: int = 0, wdtype=np.int32,
                  native: bool | None = None, device="cuda") -> EdgeList:
    """Graph500-style RMAT: 2^scale vertices, ~edge_factor·2^scale edges,
    the JAX package's graph (``graphmat_tpu/utils/generators.py:84``) for
    the same arguments, on ``device``.

    At each of ``scale`` levels every edge picks a quadrant with
    probabilities (a, b, c, 1-a-b-c).  Self loops are always dropped,
    duplicates when ``dedup``; ``weight_range > 0`` gives integer weights
    in [1, weight_range], else every weight is 1 (as ``wdtype``).

    ``native=None`` (the default) or ``True`` draws ``gm_rmat_gen``'s
    counter-based splitmix64 stream bit for bit, the JAX default:
    :mod:`graphmat_tpu_torch.ops.rmat`'s kernel on the card, its plain
    version on the CPU; with ``dedup`` the edges come sorted by (src,
    dst), without it in generation order.  ``native=False`` draws the
    JAX numpy stream (``default_rng(seed)``) on the host, with its
    duplicate rule (the first of a pair wins), and moves it to
    ``device``.  The result holds torch tensors on ``device``, the card
    by default; without one it raises rather than draw on the CPU
    unasked.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rmat_edgelist: no CUDA device is available for the default "
            "device='cuda'; pass device=\"cpu\" to draw the graph on the "
            "CPU")
    n = 1 << scale
    nnz = n * edge_factor
    vdtype = torch.from_numpy(np.zeros(0, wdtype)).dtype
    if native is False:
        e = _rmat_numpy(scale, nnz, a, b, c, seed, dedup, weight_range,
                        wdtype)
        return EdgeList(n, n, *(torch.as_tensor(x, device=device)
                                for x in e.astuple()))
    keys = rmat_keys(scale, nnz, a, b, c, seed, device)
    if dedup:
        keys = torch.sort(keys).values
    keep = (keys >> 32) != (keys & 0xFFFFFFFF)
    if dedup and keys.numel() > 1:
        keep[1:] &= keys[1:] != keys[:-1]
    keys = keys[keep]
    del keep
    val = (rmat_weights(keys, seed, weight_range) if weight_range > 0
           else torch.ones(keys.numel(), dtype=torch.int32, device=device))
    src = ((keys >> 32) + 1).to(torch.int32)
    dst = ((keys & 0xFFFFFFFF) + 1).to(torch.int32)
    return EdgeList(n, n, src, dst, val.to(vdtype))


def _rmat_numpy(scale, nnz, a, b, c, seed, dedup, weight_range, wdtype):
    """The JAX package's numpy path (``graphmat_tpu/utils/generators.py:
    110-137``), draw for draw: a numpy :class:`EdgeList`."""
    n = 1 << scale
    rng = np.random.default_rng(seed)
    src = np.zeros(nnz, np.int64)
    dst = np.zeros(nnz, np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    for _ in range(scale):
        r1 = rng.random(nnz)
        r2 = rng.random(nnz)
        src_bit = r1 > ab
        dst_bit = np.where(src_bit, r2 > c_norm, r2 > (a / ab))
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    keep = src != dst
    src, dst = src[keep] + 1, dst[keep] + 1
    if weight_range > 0:
        val = rng.integers(1, weight_range + 1, src.shape[0]).astype(wdtype)
    else:
        val = np.ones(src.shape[0], wdtype)
    e = edgelist_from_arrays(src.astype(np.int32), dst.astype(np.int32), val,
                             m=n, n=n)
    if dedup:
        e = remove_duplicate_edges(e)
    return e
