"""K1: the generalized SpMV ``y[r] = ⊕_{s→r} process(x[s], val_e)``.

Counterpart of ``graphmat_tpu/ops/pallas_spmv2u.py``.  ⊕ is sum, min or
max over float32, with identities 0, +inf and -inf: a receiver with no
contributing edge gets the identity.  ⊗ is one of :data:`PROCESS_OPS`;
``key_add_val`` (packed-key BFS) adds ``(val - 1) << bits`` to the int32
bit pattern of x, only inside ``[KEY_BIAS, KEY_BIAS + KEY_SPAN)``.

* dense: every edge contributes;
* sparse (``sent`` given, uint8 per sender): an edge contributes only when
  its sender sent.  ``want_got`` (sum only) adds an int32 count, per
  receiver, of the edges whose sender sent.  ``recv_final`` (uint8 per
  receiver row) marks rows the program holds final
  (``GraphProgram.receiver_final``): such a row is not read and gets the
  identity (and a count of 0).  The JAX kernel skips a receiver block
  only when every row in it is final; skipping single rows is exact for
  the same reason (the program's apply is a no-op there).

Work goes to lane groups by row length (:func:`k1_plan`, built once per
CSR): a row of at most 16, 32, 64 or :data:`CHUNK_EDGES` edges to 4, 8,
16 or 32 lanes, a longer row to warps of :data:`CHUNK_EDGES` edges each
whose partials a second pass combines in a fixed order, so no warp takes
more than :data:`CHUNK_EDGES` edges and a sum is the same from run to run.

:func:`spmv_csr` launches the hand-written kernel
``graphmat_tpu_torch/csrc/spmv2u.cu`` on CUDA tensors and runs
:func:`spmv_csr_reference` on CPU tensors.  :func:`spmv` is the graph-level
entry: it first extends the operand through the compaction gather
(:mod:`.compact`) when the graph's CSR carries one.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _lib
from .compact import aux_gather

__all__ = ["PROCESS_OPS", "IDENTITY", "KEY_BIAS", "KEY_SPAN", "spmv",
           "spmv_reference", "spmv_csr", "spmv_csr_reference", "k1_plan",
           "plan_for", "K1Plan", "CHUNK_EDGES", "WIDTHS", "MAX_LEN",
           "LAUNCHES"]

# packed keys live at KEY_BIAS + (depth << bits | parent): the bias keeps
# every key a normal float32 (no denormals) and is divisible by 2^21, so
# the depth-field arithmetic never touches it (graphmat_tpu/apps/bfs.py)
KEY_BIAS = 0x20000000
KEY_SPAN = 1 << 28


def _key_add_val(x, v, bits=0):
    """Packed-key ⊗: the edge weight lands on the depth field of a real
    key; the +inf fill and INF keys pass through untouched."""
    u = x.view(torch.int32)
    ok = (u >= KEY_BIAS) & (u < KEY_BIAS + KEY_SPAN)
    w = v.to(torch.int32) - 1
    return torch.where(ok, u + (w << bits), u).view(torch.float32)


# ⊗: the closed set the kernel takes, with the torch function of each;
# ``bits`` is read by key_add_val only
PROCESS_OPS = {
    "x": lambda x, v, bits=0: x,
    "x_mul_val": lambda x, v, bits=0: x * v,
    "x_add_val": lambda x, v, bits=0: x + v,
    "key_add_val": _key_add_val,
}
IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
_REDUCE_CODE = {"sum": 0, "min": 1, "max": 2}
_PROCESS_CODE = {"x": 0, "x_mul_val": 1, "x_add_val": 2, "key_add_val": 3}
_SCATTER = {"sum": "sum", "min": "amin", "max": "amax"}

# launches of the SpMV kernel by mode (``_final``: with recv_final); only
# spmv_csr adds to them, one per call (two launches with hub rows)
LAUNCHES = {"dense": 0, "sparse": 0, "sparse_got": 0, "sparse_final": 0,
            "sparse_got_final": 0}

CHUNK_EDGES = 1024   # C, the most edges a warp takes (csrc/spmv2u.cu)
WIDTHS = (4, 8, 16, 32)            # lanes per row, by row length class
MAX_LEN = (16, 32, 64, CHUNK_EDGES)  # the longest row of each width


class K1Plan(NamedTuple):
    """K1's work split.  ``rows`` lists the rows read by groups of 4, 8,
    16 and 32 lanes, ``counts[w]`` of them for ``WIDTHS[w]``, in that
    order; a hub row (more than ``CHUNK_EDGES`` edges) ``long_rows[h]``
    owns chunks ``long_first[h]`` to ``long_first[h + 1]``, chunk ``c``
    being edges ``[chunk_start[c], chunk_start[c] + CHUNK_EDGES)`` of row
    ``chunk_row[c]`` (cut at the row's end).  Every row is in ``rows`` or
    ``long_rows`` once; every int32."""

    rows: torch.Tensor
    counts: Tuple[int, int, int, int]
    long_rows: torch.Tensor
    long_first: torch.Tensor
    chunk_row: torch.Tensor
    chunk_start: torch.Tensor


def k1_plan(rowptr: torch.Tensor) -> K1Plan:
    """The work split of a receiver CSR (``rowptr`` int32[n_rows + 1]),
    built with torch ops on its device (host reads for the counts only)."""
    dev = rowptr.device
    i32 = torch.int32
    lens = rowptr.diff().long()
    cls = torch.bucketize(lens, torch.tensor(MAX_LEN, device=dev))
    order = torch.argsort(cls, stable=True).to(i32)
    counts = torch.bincount(cls, minlength=len(WIDTHS) + 1).tolist()
    n_short = sum(counts[:len(WIDTHS)])
    long_rows = order[n_short:]
    n_chunk = (lens[long_rows.long()] + CHUNK_EDGES - 1) // CHUNK_EDGES
    long_first = torch.zeros(long_rows.numel() + 1, dtype=torch.int64,
                             device=dev)
    torch.cumsum(n_chunk, 0, out=long_first[1:])
    n_chunks = int(long_first[-1])
    h = torch.repeat_interleave(torch.arange(long_rows.numel(), device=dev),
                                n_chunk, output_size=n_chunks)
    chunk_row = long_rows[h]
    chunk_start = (rowptr[chunk_row.long()].long() + CHUNK_EDGES * (
        torch.arange(n_chunks, device=dev) - long_first[h]))
    return K1Plan(order[:n_short], tuple(counts[:len(WIDTHS)]), long_rows,
                  long_first.to(i32), chunk_row, chunk_start.to(i32))


def plan_for(graph_csr) -> K1Plan:
    """K1's plan of one direction of a graph, built on first use and kept
    on its CSR."""
    return graph_csr.plan("k1", k1_plan)


def _check(rowptr, col, x, reduce_kind, process_op, val, sent, want_got,
           recv_final=None, bits=0):
    if reduce_kind not in _REDUCE_CODE:
        raise ValueError(f"reduce_kind {reduce_kind!r} is not one of "
                         f"{sorted(_REDUCE_CODE)}")
    if process_op not in _PROCESS_CODE:
        raise ValueError(f"process_op {process_op!r} is not one of "
                         f"{sorted(_PROCESS_CODE)}")
    if want_got and (sent is None or reduce_kind != "sum"):
        raise ValueError("want_got needs the sent mask and reduce_kind "
                         "'sum'")
    need = [(rowptr, torch.int32, "rowptr"), (col, torch.int32, "col"),
            (x, torch.float32, "x")]
    if process_op != "x":
        if val is None:
            raise ValueError(f"process_op {process_op!r} reads val")
        need.append((val, torch.float32, "val"))
    if sent is not None:
        need.append((sent, torch.uint8, "sent"))
    if recv_final is not None:
        if sent is None:
            raise ValueError("recv_final is honoured in the sparse modes "
                             "only: pass sent")
        need.append((recv_final, torch.uint8, "recv_final"))
    if not 0 <= bits < 32:
        raise ValueError(f"bits={bits} must lie in [0, 32)")
    for t, dtype, name in need:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if process_op != "x" and val.shape != col.shape:
        raise ValueError("val must hold one value per edge")
    if sent is not None and sent.shape != x.shape:
        raise ValueError("sent must hold one flag per sender of x")
    if rowptr.numel() < 1:
        raise ValueError("rowptr needs n_rows + 1 entries")
    if recv_final is not None and recv_final.numel() != rowptr.numel() - 1:
        raise ValueError("recv_final must hold one flag per receiver row")


def spmv_csr_reference(rowptr, col, x, reduce_kind, process_op, val=None,
                       sent=None, want_got=False, row=None, recv_final=None,
                       bits=0):
    """Plain version of K1: gather ``x[col]``, ⊗, then ``scatter_reduce_``
    into an identity-filled ``y``; rows marked in ``recv_final`` get the
    identity and a count of 0.  ``row`` (the receiver of each edge) is
    derived from ``rowptr`` when not given."""
    n_rows = rowptr.numel() - 1
    if row is None:
        row = torch.repeat_interleave(
            torch.arange(n_rows, device=x.device), rowptr.diff().long())
    colx = col.long()
    rowx = row.long()
    u = PROCESS_OPS[process_op](x[colx], val, bits)
    if sent is not None:
        ok = sent[colx].bool()
        u, rowu = u[ok], rowx[ok]
    else:
        rowu = rowx
    y = torch.full((n_rows,), IDENTITY[reduce_kind], dtype=torch.float32,
                   device=x.device)
    y.scatter_reduce_(0, rowu, u, _SCATTER[reduce_kind], include_self=False)
    final = recv_final.bool() if recv_final is not None else None
    if final is not None:
        y.masked_fill_(final, IDENTITY[reduce_kind])
    if not want_got:
        return y
    got = torch.zeros(n_rows, dtype=torch.int32, device=x.device)
    got.index_add_(0, rowx, sent[colx].to(torch.int32))
    if final is not None:
        got.masked_fill_(final, 0)
    return y, got


def spmv_csr(rowptr, col, x, reduce_kind, process_op, val=None, sent=None,
             want_got=False, row=None, recv_final=None, bits=0, plan=None):
    """K1 on a CSR: ``rowptr`` int32[n_rows+1], ``col`` int32[nnz] (each
    < len(x); the Graph constructor guarantees it), ``x`` float32, ``val``
    float32[nnz] when ⊗ reads it, ``sent`` uint8 like ``x``,
    ``recv_final`` uint8[n_rows] (sparse modes only), ``bits`` the shift
    of ``key_add_val``.  Returns ``y`` float32[n_rows], and with
    ``want_got`` also the int32 count.  ``row`` is used only by the plain
    version; ``plan`` (:func:`k1_plan` of ``rowptr``) only by the kernel,
    which builds it (with host reads) when not given."""
    _check(rowptr, col, x, reduce_kind, process_op, val, sent, want_got,
           recv_final, bits)
    if x.device.type == "cpu":
        return spmv_csr_reference(rowptr, col, x, reduce_kind, process_op,
                                  val, sent, want_got, row, recv_final, bits)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmv has no kernel for {x.device}")
    if col.numel() > 2 ** 31 - 1 - CHUNK_EDGES:
        raise ValueError("spmv takes fewer than 2^31 - 1025 edges")
    n_rows = rowptr.numel() - 1
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    got = (torch.empty(n_rows, dtype=torch.int32, device=x.device)
           if want_got else None)
    if n_rows == 0:
        return (y, got) if want_got else y
    if plan is None:
        plan = k1_plan(rowptr)
    mode = "dense" if sent is None else ("sparse_got" if want_got
                                         else "sparse")
    n_chunks = plan.chunk_row.numel()
    part = torch.empty(n_chunks, dtype=torch.float32, device=x.device)
    part_cnt = (torch.empty(n_chunks, dtype=torch.int32, device=x.device)
                if want_got else None)
    lib = _lib.load()
    rc = lib.gm_spmv(
        rowptr.data_ptr(), col.data_ptr(),
        val.data_ptr() if process_op != "x" else None, x.data_ptr(),
        sent.data_ptr() if sent is not None else None,
        recv_final.data_ptr() if recv_final is not None else None,
        y.data_ptr(), got.data_ptr() if want_got else None,
        plan.rows.data_ptr(), plan.chunk_row.data_ptr(),
        plan.chunk_start.data_ptr(), plan.long_rows.data_ptr(),
        plan.long_first.data_ptr(), part.data_ptr(),
        part_cnt.data_ptr() if want_got else None, *plan.counts, n_chunks,
        plan.long_rows.numel(),
        _REDUCE_CODE[reduce_kind], _PROCESS_CODE[process_op],
        {"dense": 0, "sparse": 1, "sparse_got": 2}[mode], bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(lib, rc, "spmv")
    LAUNCHES[mode + ("_final" if recv_final is not None else "")] += 1
    return (y, got) if want_got else y


def _operand(graph_csr, x, sent):
    """The operand (and sent mask) the kernel reads: ``x`` itself, or,
    for a compacted CSR, ``x`` followed by the compaction gather's
    extension, written into the CSR's preallocated buffers."""
    c = graph_csr
    if c.src_of_pos is None:
        return c.col, x, sent
    ns = c.n_send
    c.x_ext[:ns].copy_(x)
    aux_gather(x, c.src_of_pos, c.x_ext[ns:])
    sent_ext = None
    if sent is not None:
        sent_ext = c.sent_ext
        sent_ext[:ns].copy_(sent)
        aux_gather(sent, c.src_of_pos, sent_ext[ns:])
    return c.col_ext, c.x_ext, sent_ext


def _check_operand(graph_csr, x, sent):
    if x.shape != (graph_csr.n_send,):
        raise ValueError(f"x has shape {tuple(x.shape)}, the graph has "
                         f"{graph_csr.n_send} senders")
    if sent is not None and sent.shape != x.shape:
        raise ValueError("sent must hold one flag per sender")


def spmv(graph_csr, x, reduce_kind, process_op, val=None, sent=None,
         want_got=False, recv_final=None, bits=0):
    """K1 over one direction of a graph (a ``core.graph.CSR``): ``x`` and
    ``sent`` hold one entry per sender (``graph_csr.n_send``),
    ``recv_final`` one per receiver row.  On a compacted CSR this runs K2
    into the operand extension first."""
    _check_operand(graph_csr, x, sent)
    col, x_op, sent_op = _operand(graph_csr, x, sent)
    plan = plan_for(graph_csr) if x.device.type == "cuda" else None
    return spmv_csr(graph_csr.rowptr, col, x_op, reduce_kind, process_op,
                    val=val, sent=sent_op, want_got=want_got,
                    row=graph_csr.row, recv_final=recv_final, bits=bits,
                    plan=plan)


def spmv_reference(graph_csr, x, reduce_kind, process_op, val=None,
                   sent=None, want_got=False, recv_final=None, bits=0):
    """Plain version of :func:`spmv`, on the uncompacted senders."""
    _check_operand(graph_csr, x, sent)
    return spmv_csr_reference(graph_csr.rowptr, graph_csr.col, x,
                              reduce_kind, process_op, val, sent, want_got,
                              graph_csr.row, recv_final, bits)
