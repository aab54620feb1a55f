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

:func:`spmv_push_csr` launches ``graphmat_tpu_torch/csrc/spmv2.cu`` on CUDA
tensors and runs :func:`spmv_push_csr_reference` on CPU tensors;
:func:`spmv_push` is the entry on a graph's sender-major index.
"""

from __future__ import annotations

import torch

from . import _lib
from .spmv2u import (IDENTITY, PROCESS_OPS, _PROCESS_CODE, _REDUCE_CODE,
                     _SCATTER)
from .spmv2u import _check as _check_k1

__all__ = ["spmv_push", "spmv_push_reference", "spmv_push_csr",
           "spmv_push_csr_reference", "LAUNCHES"]

# launches of the push kernel by mode; only spmv_push_csr adds to them
LAUNCHES = {"dense": 0, "sparse": 0, "sparse_got": 0}


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
                  sent=None, want_got=False, src=None, bits=0):
    """The push kernel on a sender-major CSR: ``rowptr`` int32[n_send+1],
    ``col`` int32[nnz] (each < ``n_recv``; the Graph guarantees it), ``x``
    float32[n_send], ``val`` float32[nnz] when ⊗ reads it, ``sent`` uint8
    like ``x``, ``bits`` the shift of ``key_add_val``.  Returns ``y``
    float32[n_recv], and with ``want_got`` also the int32 count.  ``src``
    is used only by the plain version."""
    _check(rowptr, col, x, n_recv, reduce_kind, process_op, val, sent,
           want_got, bits)
    if x.device.type == "cpu":
        return spmv_push_csr_reference(rowptr, col, x, n_recv, reduce_kind,
                                       process_op, val, sent, want_got, src,
                                       bits)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmv_push has no kernel for {x.device}")
    y = torch.full((n_recv,), IDENTITY[reduce_kind], dtype=torch.float32,
                   device=x.device)
    got = (torch.zeros(n_recv, dtype=torch.int32, device=x.device)
           if want_got else None)
    if x.numel() == 0 or n_recv == 0:
        return (y, got) if want_got else y
    mode = "dense" if sent is None else ("sparse_got" if want_got
                                         else "sparse")
    lib = _lib.load()
    rc = lib.gm_spmv_push(
        rowptr.data_ptr(), col.data_ptr(),
        val.data_ptr() if process_op != "x" else None, x.data_ptr(),
        sent.data_ptr() if sent is not None else None, y.data_ptr(),
        got.data_ptr() if want_got else None, x.numel(),
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
    return spmv_push_csr(sender_csr.rowptr, sender_csr.col, x,
                         sender_csr.n_send, reduce_kind, process_op, val=val,
                         sent=sent, want_got=want_got, src=sender_csr.row,
                         bits=bits)


def spmv_push_reference(sender_csr, x, reduce_kind, process_op, val=None,
                        sent=None, want_got=False, bits=0):
    """Plain version of :func:`spmv_push`."""
    return spmv_push_csr_reference(sender_csr.rowptr, sender_csr.col, x,
                                   sender_csr.n_send, reduce_kind,
                                   process_op, val, sent, want_got,
                                   sender_csr.row, bits)
