"""Debug mode: the reference's ``debug=1`` build flag.

Counterpart of ``graphmat_tpu/utils/debug.py``.  The reference's
``__DEBUG`` compiles in partition cross-checks and asserts
(``Makefile:22``, ``COOSIMD32Tile.h:320-362``); the JAX package checks its
TPU kernel plans on the host after each is built.  The port has none of
those plans: its kernels read the CSRs and the work splits built from
them.  So with ``GRAPHMAT_DEBUG=1`` every CSR is checked when it is built
(:func:`validate_csr`: a ``Graph``'s directions, a ``DistGraph``'s tiles
in their local ids, the sender-major indexes) and every work split when
``CSR.plan`` builds it (:func:`validate_plan`: K1's row groups and hub
chunks, the push's chunks), catching a build bug before it becomes a
silent wrong answer in a kernel.  :func:`validate_graph` checks a built
graph whole.  Each check runs as torch ops on the CSR's device and
raises ``AssertionError`` naming the invariant; with the variable unset
nothing runs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["debug_enabled", "assert_all_finite", "validate_csr",
           "validate_plan", "validate_graph"]


def debug_enabled() -> bool:
    return os.environ.get("GRAPHMAT_DEBUG", "0") not in ("", "0", "false")


def assert_all_finite(name: str, arr) -> None:
    """Raise if a tensor or array holds a NaN or an infinity."""
    t = torch.as_tensor(np.asarray(arr) if not isinstance(
        arr, torch.Tensor) else arr)
    if t.is_floating_point() and not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{name} contains non-finite values")


def _need(ok, invariant: str) -> None:
    if not bool(ok):
        raise AssertionError(f"invariant violated: {invariant}")


def validate_csr(csr, nnz=None) -> None:
    """The invariants of a CSR (``core.graph.CSR``), in its own ids:

    * ``rowptr starts at 0``, ``rowptr does not decrease`` and ``rowptr
      ends at nnz`` (with ``row`` and ``val`` one entry per edge);
    * ``row matches rowptr``: each edge's receiver is its row's;
    * ``col lies in [0, n_send)``;
    * ``nnz equals the edge count`` given as ``nnz`` (the edge list's
      count for that direction, or the tile's);
    * a compacted CSR's ``col_ext``, ``src_of_pos`` and ``n_aux`` agree:
      ``compaction buffers have their sizes`` and ``compaction: a diverted
      edge reads its own sender`` (an edge that is not diverted reads
      ``col``)."""
    from ..ops.compact import QUAD
    rp = csr.rowptr.long()
    e = csr.col.numel()
    _need(rp.numel() >= 1 and rp[0] == 0, "rowptr starts at 0")
    _need((rp.diff() >= 0).all(), "rowptr does not decrease")
    _need(rp[-1] == e and csr.row.numel() == e and csr.val.shape[0] == e,
          "rowptr ends at nnz")
    rows = torch.repeat_interleave(
        torch.arange(rp.numel() - 1, device=rp.device), rp.diff(),
        output_size=e)
    _need(torch.equal(rows, csr.row.long()), "row matches rowptr")
    col = csr.col.long()
    _need(e == 0 or (int(col.min()) >= 0 and int(col.max()) < csr.n_send),
          "col lies in [0, n_send)")
    if nnz is not None:
        _need(e == int(nnz), "nnz equals the edge count")
    if csr.col_ext is None:
        _need(csr.src_of_pos is None and csr.n_aux == 0,
              "compaction buffers have their sizes")
        return
    pos = csr.src_of_pos.long()
    n_ext = pos.numel()
    _need(csr.col_ext.numel() == e and 0 < csr.n_aux <= n_ext
          and n_ext % QUAD == 0 and csr.x_ext is not None
          and csr.x_ext.numel() == n_ext and csr.sent_ext is not None
          and csr.sent_ext.numel() == n_ext,
          "compaction buffers have their sizes")
    ext = csr.col_ext.long()
    div = ext >= csr.n_send
    p = ext[div] - csr.n_send
    _need((p < csr.n_aux).all() and torch.equal(ext[~div], col[~div])
          and torch.equal(pos[p], col[div])
          and (n_ext == 0 or (int(pos.min()) >= 0
                              and int(pos.max()) < csr.n_send)),
          "compaction: a diverted edge reads its own sender")


def _validate_k1_plan(rowptr, plan) -> None:
    """K1's split (``ops/spmv2u.py: k1_plan``): every row in one group, a
    short row in the lane group of its length class, a hub row's chunks
    its edges in order, no warp above C edges."""
    from ..ops.spmv2u import CHUNK_EDGES as C, MAX_LEN
    rp = rowptr.long()
    dev = rp.device
    n_rows = rp.numel() - 1
    lens = rp.diff()
    rows, hubs = plan.rows.long(), plan.long_rows.long()
    _need(torch.equal(torch.sort(torch.cat((rows, hubs)))[0],
                      torch.arange(n_rows, device=dev)),
          "k1 plan: every row in one group")
    _need(sum(plan.counts) == rows.numel(), "k1 plan: every row in one group")
    # a warp takes 32 / width rows of at most MAX_LEN edges each, so a
    # short row in its class keeps its warp at C edges or fewer
    lo = 0
    for w, count in enumerate(plan.counts):
        seg = lens[rows[lo:lo + count]]
        floor = MAX_LEN[w - 1] if w else -1
        _need(((seg > floor) & (seg <= MAX_LEN[w])).all(),
              "k1 plan: a row in its length class")
        lo += count
    first = plan.long_first.long()
    n_chunk = (lens[hubs] + C - 1) // C
    _need((lens[hubs] > C).all() and first.numel() == hubs.numel() + 1
          and first[0] == 0 and torch.equal(first.diff(), n_chunk)
          and first[-1] == plan.chunk_row.numel(),
          "k1 plan: a hub row's chunks cover it")
    h = torch.repeat_interleave(torch.arange(hubs.numel(), device=dev),
                                n_chunk, output_size=int(first[-1]))
    k = torch.arange(h.numel(), device=dev) - first[h]
    _need(torch.equal(plan.chunk_row.long(), hubs[h])
          and torch.equal(plan.chunk_start.long(), rp[hubs[h]] + k * C),
          "k1 plan: a hub row's chunks cover it")


def _validate_push_plan(rowptr, plan) -> None:
    """The push's split (``ops/spmv2.py: push_plan``): a tile of senders
    takes chunk 0 and the plan's further chunks ``1 .. ceil(edges / C) -
    1``, each once, so every edge lies in one chunk of at most C edges."""
    from ..ops.spmv2 import CHUNK_EDGES as C, TILE
    rp = rowptr.long()
    dev = rp.device
    n_send = rp.numel() - 1
    t = torch.arange((n_send + TILE - 1) // TILE, device=dev)
    edges = rp[torch.clamp(t * TILE + TILE, max=n_send)] - rp[t * TILE]
    need = ((edges + C - 1) // C - 1).clamp(min=0)
    tile, k = plan.extra_tile.long(), plan.extra_k.long()
    _need(tile.numel() == 0 or (int(tile.min()) >= 0
                                and int(tile.max()) < t.numel()),
          "push plan: covers every edge once")
    span = int(need.max()) + 1 if need.numel() else 1
    key = torch.sort(tile * span + k)[0]
    _need((k >= 1).all() and (tile.numel() == 0 or (k <= need[tile]).all())
          and torch.equal(torch.bincount(tile, minlength=t.numel()), need)
          and (key.diff() > 0).all(),
          "push plan: covers every edge once")


def validate_plan(name: str, rowptr, plan) -> None:
    """The invariants of a work split that ``CSR.plan`` built under
    ``name``: ``"k1"`` (K1's) or ``"push"`` (the push's); a ``"receiver"``
    CSR is checked when it is built."""
    if name == "k1":
        _validate_k1_plan(rowptr, plan)
    elif name == "push":
        _validate_push_plan(rowptr, plan)


def _validate_held(c) -> None:
    for name, plan in c._plans.items():
        validate_plan(name, c.rowptr, plan)


def validate_graph(graph) -> None:
    """Every CSR a ``Graph`` or ``DistGraph`` holds, and the work splits
    kept on them.  A Graph's directions hold ``n_pad`` rows over ``n_pad``
    senders and the edge list's count each; a DistGraph's tiles ``C * S``
    rows over ``R * S`` senders in local ids, their counts summing to the
    edge list's over the mesh (one collective)."""
    from ..core.graph import Graph
    if isinstance(graph, Graph):
        for recv, c in graph._csr.items():
            _need(c.n_rows == graph.n_pad and c.n_send == graph.n_pad,
                  "a direction holds n_pad rows over n_pad senders")
            validate_csr(c, graph.nnz)
            _validate_held(c)
        for c in graph._sender.values():
            validate_csr(c, graph.nnz)
            _validate_held(c)
        return
    shape = (graph.C * graph.S, graph.R * graph.S)
    for recv, tiles in graph._tiles.items():
        counts = []
        for c in tiles:
            _need((c.n_rows, c.n_send) == shape,
                  "a tile holds C * S rows over R * S senders")
            validate_csr(c)
            _validate_held(c)
            counts.append(torch.tensor([c.nnz], device=c.col.device))
        _need(int(graph.mesh.all_reduce(counts, "sum")) == graph.nnz,
              "nnz equals the edge count")
    for tiles in graph._sender.values():
        for c in tiles:
            validate_csr(c)
            _validate_held(c)
