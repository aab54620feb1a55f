"""K6/K7: the frontier push SpMV
``y[r] = ⊕_{s→r, sent[s]} process(x[s], val)``.

Counterpart of ``graphmat_tpu/ops/pallas_spmv2.py`` (``spmv2``, the sum
kernel K6, and ``spmv2m``, the min/max kernel K7), the JAX Engine's route
under ``GRAPHMAT_KERNEL=v2``.  The function is K1's (⊕ sum, min or max
over float32 with identities 0, +inf, -inf; ⊗ from
:data:`~graphmat_tpu_torch.ops.spmv2u.PROCESS_OPS`); what differs is the
input and the work: the kernel reads a direction's sender-major index
(:meth:`graphmat_tpu_torch.core.graph.Graph.sender_csr`: ``rowptr`` over
senders, ``col`` the receiver of each edge, ``val``) and pushes only the
active senders' out-edges.

* dense: every sender pushes;
* sparse (``sent`` given, uint8 per sender): only senders that sent;
  ``want_got`` (sum only) adds an int32 count per receiver of the edges
  from senders that sent.

A sum is combined by atomics, so its order, and its last bits, change from
run to run (ROADMAP H1); min, max, integer payloads below 2^24 and the
counts are exact.

Work goes to warps by chunks (:func:`push_plan`): at most
:data:`CHUNK_EDGES` consecutive edges of a tile of 32 senders, so no warp
takes more than that many edges, however large a sender's out-degree.

:func:`spmv_push_csr` launches ``graphmat_tpu_torch/csrc/spmv2.cu`` on CUDA
tensors and runs :func:`spmv_push_csr_reference` on CPU tensors;
:func:`spmv_push` is the entry on a graph's sender-major index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib
from .spmv2u import (IDENTITY, PROCESS_OPS, _PROCESS_CODE, _REDUCE_CODE,
                     _SCATTER)
from .spmv2u import _check as _check_k1

__all__ = ["spmv_push", "spmv_push_reference", "spmv_push_csr",
           "spmv_push_csr_reference", "push_plan", "plan_for", "PushPlan",
           "CHUNK_EDGES", "TILE", "LAUNCHES"]

# launches of the push kernel by mode; only spmv_push_csr adds to them, one
# per call
LAUNCHES = {"dense": 0, "sparse": 0, "sparse_got": 0}

CHUNK_EDGES = 1024   # C, the most edges a warp takes (csrc/spmv2.cu)
TILE = 32            # senders a warp reads the sent bytes of, one per lane


class PushPlan(NamedTuple):
    """The push kernel's chunks past the first of each tile.  Chunk ``k``
    of tile ``t`` covers the edges of senders ``[TILE * t, TILE * (t +
    1))`` that lie in ``[lo + k * CHUNK_EDGES, lo + (k + 1) *
    CHUNK_EDGES)``, ``lo`` the tile's first edge.  Warp ``t`` takes chunk 0
    of tile ``t``; warp ``n_tiles + i`` chunk ``extra_k[i]`` of tile
    ``extra_tile[i]``.  Every edge lies in one chunk."""

    extra_tile: torch.Tensor   # int32[n_extra]
    extra_k: torch.Tensor      # int32[n_extra], each >= 1


def push_plan(rowptr: torch.Tensor) -> PushPlan:
    """The chunks of a sender-major CSR (``rowptr`` int32[n_send + 1]),
    built with torch ops on its device (one host read, for the count)."""
    dev = rowptr.device
    n_send = rowptr.numel() - 1
    rp = rowptr.long()
    t = torch.arange((n_send + TILE - 1) // TILE, device=dev)
    lo = rp[t * TILE]
    hi = rp[torch.clamp(t * TILE + TILE, max=n_send)]
    extra = ((hi - lo + CHUNK_EDGES - 1) // CHUNK_EDGES - 1).clamp(min=0)
    tile = torch.repeat_interleave(t, extra)
    start = torch.cumsum(extra, 0) - extra
    k = 1 + torch.arange(tile.numel(), device=dev) - start[tile]
    return PushPlan(tile.to(torch.int32), k.to(torch.int32))


def plan_for(sender_csr) -> PushPlan:
    """The push plan of a graph's sender-major index, built on first use
    and kept on it."""
    return sender_csr.plan("push", push_plan)


def _check(rowptr, col, x, n_recv, reduce_kind, process_op, val, sent,
           want_got, bits):
    """K1's argument checks, then the push's own: one x per sender row."""
    _check_k1(rowptr, col, x, reduce_kind, process_op, val, sent, want_got,
              bits=bits)
    if x.numel() != rowptr.numel() - 1:
        raise ValueError("x must hold one value per sender row of rowptr")
    if n_recv < 0:
        raise ValueError("n_recv must be >= 0")


def spmv_push_csr_reference(rowptr, col, x, n_recv, reduce_kind, process_op,
                            val=None, sent=None, want_got=False, src=None,
                            bits=0):
    """Plain version of the push kernel: gather ``x`` at each edge's
    sender, ⊗, drop edges whose sender did not send, then
    ``scatter_reduce_`` into an identity-filled ``y[n_recv]`` by receiver.
    ``src`` (the sender of each edge) is derived from ``rowptr`` when not
    given."""
    if src is None:
        src = torch.repeat_interleave(
            torch.arange(rowptr.numel() - 1, device=x.device),
            rowptr.diff().long())
    srcx = src.long()
    colx = col.long()
    u = PROCESS_OPS[process_op](x[srcx], val, bits)
    if sent is not None:
        ok = sent[srcx].bool()
        u, colx = u[ok], colx[ok]
    y = torch.full((n_recv,), IDENTITY[reduce_kind], dtype=torch.float32,
                   device=x.device)
    y.scatter_reduce_(0, colx, u, _SCATTER[reduce_kind], include_self=False)
    if not want_got:
        return y
    got = torch.zeros(n_recv, dtype=torch.int32, device=x.device)
    got.index_add_(0, colx, torch.ones_like(colx, dtype=torch.int32))
    return y, got


def spmv_push_csr(rowptr, col, x, n_recv, reduce_kind, process_op, val=None,
                  sent=None, want_got=False, src=None, bits=0, plan=None):
    """The push kernel on a sender-major CSR: ``rowptr`` int32[n_send+1],
    ``col`` int32[nnz] (each < ``n_recv``; the Graph guarantees it), ``x``
    float32[n_send], ``val`` float32[nnz] when ⊗ reads it, ``sent`` uint8
    like ``x``, ``bits`` the shift of ``key_add_val``.  Returns ``y``
    float32[n_recv], and with ``want_got`` also the int32 count.  ``src``
    is used only by the plain version; ``plan`` (:func:`push_plan` of
    ``rowptr``) only by the kernel, which builds it (with a host read)
    when not given."""
    _check(rowptr, col, x, n_recv, reduce_kind, process_op, val, sent,
           want_got, bits)
    if x.device.type == "cpu":
        return spmv_push_csr_reference(rowptr, col, x, n_recv, reduce_kind,
                                       process_op, val, sent, want_got, src,
                                       bits)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmv_push has no kernel for {x.device}")
    if col.numel() > 2 ** 31 - 1 - CHUNK_EDGES:
        raise ValueError("spmv_push takes fewer than 2^31 - 1025 edges")
    y = torch.full((n_recv,), IDENTITY[reduce_kind], dtype=torch.float32,
                   device=x.device)
    got = (torch.zeros(n_recv, dtype=torch.int32, device=x.device)
           if want_got else None)
    if x.numel() == 0 or n_recv == 0:
        return (y, got) if want_got else y
    if plan is None:
        plan = push_plan(rowptr)
    mode = "dense" if sent is None else ("sparse_got" if want_got
                                         else "sparse")
    lib = _lib.load()
    rc = lib.gm_spmv_push(
        rowptr.data_ptr(), col.data_ptr(),
        val.data_ptr() if process_op != "x" else None, x.data_ptr(),
        sent.data_ptr() if sent is not None else None, y.data_ptr(),
        got.data_ptr() if want_got else None, plan.extra_tile.data_ptr(),
        plan.extra_k.data_ptr(), plan.extra_tile.numel(), x.numel(),
        _REDUCE_CODE[reduce_kind], _PROCESS_CODE[process_op],
        {"dense": 0, "sparse": 1, "sparse_got": 2}[mode], bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(lib, rc, "spmv_push")
    LAUNCHES[mode] += 1
    return (y, got) if want_got else y


def spmv_push(sender_csr, x, reduce_kind, process_op, val=None, sent=None,
              want_got=False, bits=0):
    """The push kernel over a graph's sender-major index (a
    ``core.graph.CSR`` from ``Graph.sender_csr``): ``x`` and ``sent`` hold
    one entry per sender, the result one per receiver (both ``n_pad``)."""
    plan = plan_for(sender_csr) if x.device.type == "cuda" else None
    return spmv_push_csr(sender_csr.rowptr, sender_csr.col, x,
                         sender_csr.n_send, reduce_kind, process_op, val=val,
                         sent=sent, want_got=want_got, src=sender_csr.row,
                         bits=bits, plan=plan)


def spmv_push_reference(sender_csr, x, reduce_kind, process_op, val=None,
                        sent=None, want_got=False, bits=0):
    """Plain version of :func:`spmv_push`."""
    return spmv_push_csr_reference(sender_csr.rowptr, sender_csr.col, x,
                                   sender_csr.n_send, reduce_kind,
                                   process_op, val, sent, want_got,
                                   sender_csr.row, bits)
