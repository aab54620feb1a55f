"""K6/K7: the frontier push SpMV
``y[r] = ⊕_{s→r, sent[s]} process(x[s], val)``.

Counterpart of ``graphmat_tpu/ops/pallas_spmv2.py`` (``spmv2``, the sum
kernel K6, and ``spmv2m``, the min/max kernel K7), the JAX Engine's route
under ``GRAPHMAT_KERNEL=v2``.  The function is K1's (⊕ sum, min or max
over float32 with identities 0, +inf, -inf; ⊗ from
:data:`~graphmat_tpu_torch.ops.spmv2u.PROCESS_OPS`); what differs is the
input and the work: the push reads a direction's sender-major index
(:meth:`graphmat_tpu_torch.core.graph.Graph.sender_csr`: ``rowptr`` over
senders, ``col`` the receiver of each edge, ``val``) and walks only the
active senders' out-edges.

* dense: every sender pushes;
* sparse (``sent`` given, uint8 per sender): only senders that sent;
  ``want_got`` (sum only) adds an int32 count per receiver of the edges
  from senders that sent.

Min and max are combined by atomics (``csrc/spmv2.cu``), which are
order-free.  A sum has one order, the same from launch to launch
(ROADMAP P6): K1's (``csrc/spmv2u.cu``) over the direction's receiver CSR.
The dense sum is K1's dense sweep.  A sparse sum first runs the push's
mark pass (:func:`push_mark`): it walks the sent senders' out-edges and
clears a byte per receiver they reach; then K1's sparse sweep skips the
rows left marked, as it skips the rows a program holds final.  So the
push's sums and counts equal K1's bit for bit.  The receiver CSR is the
one the Engine already holds (``recv_csr``); a direct caller that passes
none gets one built once from the sender index and kept on it
(:func:`receiver_csr`).

Work goes to warps by chunks (:func:`push_plan`): at most
:data:`CHUNK_EDGES` consecutive edges of a tile of 32 senders, so no warp
takes more than that many edges, however large a sender's out-degree.

:func:`spmv_push_csr` (min/max) and :func:`push_mark` launch
``graphmat_tpu_torch/csrc/spmv2.cu`` on CUDA tensors and run
:func:`spmv_push_csr_reference` and :func:`push_mark_reference` on CPU
tensors; :func:`spmv_push` is the entry on a graph's sender-major index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib
from .spmv2u import (IDENTITY, PROCESS_OPS, _PROCESS_CODE, _REDUCE_CODE,
                     _SCATTER, spmv, spmv_csr_reference)
from .spmv2u import _check as _check_k1

__all__ = ["spmv_push", "spmv_push_reference", "spmv_push_csr",
           "spmv_push_csr_reference", "push_mark", "push_mark_reference",
           "receiver_csr", "push_plan", "plan_for", "PushPlan",
           "CHUNK_EDGES", "TILE", "LAUNCHES"]

# launches of the push kernel: min/max by mode, and the sums' mark pass;
# only spmv_push_csr and push_mark add to them, one per call (a sum's K1
# sweep counts in spmv2u.LAUNCHES)
LAUNCHES = {"dense": 0, "sparse": 0, "mark": 0}

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


def receiver_csr(sender_csr):
    """The receiver CSR of a sender-major index: its edges sorted by
    (receiver, sender) as the Graph sorts a direction, with their values,
    built on first use and kept on the index (a direct caller's; the
    Engine passes the receiver CSR it holds)."""
    from ..core.graph import _build_csr

    def build(_rowptr):
        c = sender_csr
        return _build_csr(c.row.long(), c.col.long(), c.val, c.n_send,
                          c.n_rows, False, None)
    return sender_csr.plan("receiver", build)


def _check(rowptr, col, x, n_recv, reduce_kind, process_op, val, sent,
           want_got, bits):
    """K1's argument checks, then the push's own: one x per sender row."""
    _check_k1(rowptr, col, x, reduce_kind, process_op, val, sent, want_got,
              bits=bits)
    if x.numel() != rowptr.numel() - 1:
        raise ValueError("x must hold one value per sender row of rowptr")
    if n_recv < 0:
        raise ValueError("n_recv must be >= 0")


def _src_of(rowptr):
    return torch.repeat_interleave(
        torch.arange(rowptr.numel() - 1, device=rowptr.device),
        rowptr.diff().long())


def push_mark_reference(rowptr, col, sent, n_recv, src=None):
    """Plain version of the mark pass: uint8[n_recv], 0 where some edge of
    a sender that sent arrives, else 1.  ``src`` (the sender of each
    edge) is derived from ``rowptr`` when not given."""
    if src is None:
        src = _src_of(rowptr)
    mark = torch.ones(n_recv, dtype=torch.uint8, device=sent.device)
    mark[col.long()[sent[src.long()].bool()]] = 0
    return mark


def push_mark(rowptr, col, sent, n_recv, src=None, plan=None):
    """The mark pass of a sparse sum on a sender-major CSR (``rowptr``
    int32[n_send + 1], ``col`` int32 receivers, each < ``n_recv``,
    ``sent`` uint8[n_send]): uint8[n_recv], 0 for every receiver a sender
    that sent reaches, 1 elsewhere.  ``src`` is used only by the plain
    version; ``plan`` (:func:`push_plan` of ``rowptr``) only by the
    kernel, which builds it when not given."""
    for t, dtype, name in ((rowptr, torch.int32, "rowptr"),
                           (col, torch.int32, "col"),
                           (sent, torch.uint8, "sent")):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D {dtype}")
        if t.device != sent.device:
            raise ValueError(f"{name} is on {t.device}, sent on "
                             f"{sent.device}")
    if sent.numel() != rowptr.numel() - 1:
        raise ValueError("sent must hold one flag per sender row of rowptr")
    if sent.device.type == "cpu":
        return push_mark_reference(rowptr, col, sent, n_recv, src)
    if sent.device.type != "cuda":
        raise RuntimeError(f"push_mark has no kernel for {sent.device}")
    if col.numel() > 2 ** 31 - 1 - CHUNK_EDGES:
        raise ValueError("push_mark takes fewer than 2^31 - 1025 edges")
    mark = torch.ones(n_recv, dtype=torch.uint8, device=sent.device)
    if sent.numel() == 0 or n_recv == 0:
        return mark
    if plan is None:
        plan = push_plan(rowptr)
    _lib.launch(
        "gm_push_mark", sent.device,
        rowptr.data_ptr(), col.data_ptr(), sent.data_ptr(), mark.data_ptr(),
        plan.extra_tile.data_ptr(), plan.extra_k.data_ptr(),
        plan.extra_tile.numel(), sent.numel())
    LAUNCHES["mark"] += 1
    return mark


def spmv_push_csr_reference(rowptr, col, x, n_recv, reduce_kind, process_op,
                            val=None, sent=None, want_got=False, src=None,
                            bits=0, recv_csr=None, recv_final=None):
    """Plain version of the push.  Min and max: gather ``x`` at each
    edge's sender, ⊗, drop edges whose sender did not send, then
    ``scatter_reduce_`` into an identity-filled ``y[n_recv]`` by receiver.
    A sum: K1's plain version over ``recv_csr``, the receiver CSR of these
    edges (its own values), skipping the rows the plain mark pass leaves
    marked and those of ``recv_final``.  ``src`` (the sender of each edge)
    is derived from ``rowptr`` when not given."""
    if src is None:
        src = _src_of(rowptr)
    if reduce_kind == "sum":
        if recv_csr is None:
            raise ValueError("a push sum's plain version reads the "
                             "receiver CSR: pass recv_csr")
        final = None
        if sent is not None:
            final = push_mark_reference(rowptr, col, sent, n_recv, src)
            if recv_final is not None:
                final |= recv_final
        return spmv_csr_reference(
            recv_csr.rowptr, recv_csr.col, x, "sum", process_op,
            recv_csr.val_f32 if process_op != "x" else None, sent, want_got,
            recv_csr.row, final, bits)
    srcx = src.long()
    colx = col.long()
    u = PROCESS_OPS[process_op](x[srcx], val, bits)
    if sent is not None:
        ok = sent[srcx].bool()
        u, colx = u[ok], colx[ok]
    y = torch.full((n_recv,), IDENTITY[reduce_kind], dtype=torch.float32,
                   device=x.device)
    y.scatter_reduce_(0, colx, u, _SCATTER[reduce_kind], include_self=False)
    return y


def spmv_push_csr(rowptr, col, x, n_recv, reduce_kind, process_op, val=None,
                  sent=None, src=None, bits=0, plan=None):
    """The min/max push kernel on a sender-major CSR: ``rowptr``
    int32[n_send+1], ``col`` int32[nnz] (each < ``n_recv``; the Graph
    guarantees it), ``x`` float32[n_send], ``val`` float32[nnz] when ⊗
    reads it, ``sent`` uint8 like ``x``, ``bits`` the shift of
    ``key_add_val``.  Returns ``y`` float32[n_recv].  A sum is
    :func:`spmv_push`'s (K1 over the receiver CSR).  ``src`` is used only
    by the plain version; ``plan`` (:func:`push_plan` of ``rowptr``) only
    by the kernel, which builds it (with a host read) when not given."""
    _check(rowptr, col, x, n_recv, reduce_kind, process_op, val, sent,
           False, bits)
    if reduce_kind == "sum":
        raise ValueError("spmv_push_csr takes min and max; a sum runs K1 "
                         "over the receiver CSR: call spmv_push")
    if x.device.type == "cpu":
        return spmv_push_csr_reference(rowptr, col, x, n_recv, reduce_kind,
                                       process_op, val, sent, False, src,
                                       bits)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmv_push has no kernel for {x.device}")
    if col.numel() > 2 ** 31 - 1 - CHUNK_EDGES:
        raise ValueError("spmv_push takes fewer than 2^31 - 1025 edges")
    y = torch.full((n_recv,), IDENTITY[reduce_kind], dtype=torch.float32,
                   device=x.device)
    if x.numel() == 0 or n_recv == 0:
        return y
    if plan is None:
        plan = push_plan(rowptr)
    mode = "dense" if sent is None else "sparse"
    _lib.launch(
        "gm_spmv_push", x.device,
        rowptr.data_ptr(), col.data_ptr(),
        val.data_ptr() if process_op != "x" else None, x.data_ptr(),
        sent.data_ptr() if sent is not None else None, y.data_ptr(),
        plan.extra_tile.data_ptr(), plan.extra_k.data_ptr(),
        plan.extra_tile.numel(), x.numel(), _REDUCE_CODE[reduce_kind],
        _PROCESS_CODE[process_op], {"dense": 0, "sparse": 1}[mode], bits)
    LAUNCHES[mode] += 1
    return y


def _sum_args(sender_csr, x, process_op, val, recv_csr, recv_final, sent):
    """The receiver CSR a push sum runs K1 on, after the checks that tie
    it to the sender index."""
    if process_op != "x" and val is not sender_csr.val_f32:
        raise ValueError("a push sum reads the edge values from the "
                         "receiver CSR, the same edges as the sender "
                         "index: pass val=sender_csr.val_f32")
    if recv_final is not None and sent is None:
        raise ValueError("recv_final is honoured in the sparse modes "
                         "only: pass sent")
    recv = receiver_csr(sender_csr) if recv_csr is None else recv_csr
    if (recv.n_rows, recv.n_send, recv.nnz) != (
            sender_csr.n_send, sender_csr.n_rows, sender_csr.nnz):
        raise ValueError("recv_csr must hold the sender index's edges: "
                         f"{recv.n_rows} receivers over {recv.n_send} "
                         f"senders, {recv.nnz} edges")
    return recv


def spmv_push(sender_csr, x, reduce_kind, process_op, val=None, sent=None,
              want_got=False, bits=0, recv_csr=None, recv_final=None):
    """The push over a graph's sender-major index (a ``core.graph.CSR``
    from ``Graph.sender_csr``): ``x`` and ``sent`` hold one entry per
    sender, the result one per receiver.  ``val`` is the index's own
    ``val_f32`` where ⊗ reads it.  A sum runs K1 over ``recv_csr``, the
    direction's receiver CSR (built from the index and kept when not
    given), after the mark pass when ``sent`` is given; ``recv_final``
    (uint8 per receiver, sparse sums only) adds rows the program holds
    final to those the mark pass leaves."""
    _check(sender_csr.rowptr, sender_csr.col, x, sender_csr.n_send,
           reduce_kind, process_op, val, sent, want_got, bits)
    cuda = x.device.type == "cuda"
    if reduce_kind != "sum":
        if recv_csr is not None or recv_final is not None:
            raise ValueError("recv_csr and recv_final serve the push's "
                             "sums only")
        return spmv_push_csr(sender_csr.rowptr, sender_csr.col, x,
                             sender_csr.n_send, reduce_kind, process_op,
                             val=val, sent=sent, src=sender_csr.row,
                             bits=bits,
                             plan=plan_for(sender_csr) if cuda else None)
    recv = _sum_args(sender_csr, x, process_op, val, recv_csr, recv_final,
                     sent)
    final = None
    if sent is not None:
        final = push_mark(sender_csr.rowptr, sender_csr.col, sent,
                          sender_csr.n_send, src=sender_csr.row,
                          plan=plan_for(sender_csr) if cuda else None)
        if recv_final is not None:
            final |= recv_final
    return spmv(recv, x, "sum", process_op,
                val=recv.val_f32 if process_op != "x" else None, sent=sent,
                want_got=want_got, recv_final=final, bits=bits)


def spmv_push_reference(sender_csr, x, reduce_kind, process_op, val=None,
                        sent=None, want_got=False, bits=0, recv_csr=None,
                        recv_final=None):
    """Plain version of :func:`spmv_push`."""
    if reduce_kind == "sum":
        recv_csr = _sum_args(sender_csr, x, process_op, val, recv_csr,
                             recv_final, sent)
    return spmv_push_csr_reference(
        sender_csr.rowptr, sender_csr.col, x, sender_csr.n_send, reduce_kind,
        process_op, val, sent, want_got, sender_csr.row, bits, recv_csr,
        recv_final)
