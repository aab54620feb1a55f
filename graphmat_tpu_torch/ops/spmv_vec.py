"""K4: the K-wide three-operand SpMV of an ACTIVE_ONLY program,

    y[r, :] = Σ_{s→r, sent[s]} process(x[s, :], val_e, vp[r, :], extra)
    got[r]  = #{s→r : sent[s]}

Counterpart of ``graphmat_tpu/ops/pallas_spmv_vec.py`` (``spmv_vec``),
together with the got pass the JAX engine runs after it through
``graphmat_tpu/ops/pallas_spmv.py`` (K5; see :mod:`.spmv`).  ⊗ is one of
K3's ops (:data:`~graphmat_tpu_torch.ops.spmv_vec2.VEC_PROCESS_OPS`), with
its ``params``.

An edge whose sender did not send contributes nothing, for every op, as
on the JAX XLA path.  The JAX K4 instead reads the zeroed row of such a
sender and adds ``process(0, val, vp_r)``, which is not zero for
``sgd_sqerr``, ``lda`` and ``lda_loglik`` (ROADMAP R4); the port does not
copy that.

:func:`spmv_vec_sparse_csr` launches the sparse mode of
``graphmat_tpu_torch/csrc/spmv_vec2.cu`` on CUDA tensors, which computes
the count in the same pass, and runs :func:`spmv_vec_sparse_csr_reference`
on CPU tensors.  :func:`spmv_vec_sparse` is the graph-level entry.
"""

from __future__ import annotations

import torch

from .spmv2u import plan_for
from .spmv_vec2 import (VEC_PROCESS_OPS, check, check_operand, launch,
                        spmv_vec_csr_reference)

__all__ = ["spmv_vec_sparse", "spmv_vec_sparse_reference",
           "spmv_vec_sparse_csr", "spmv_vec_sparse_csr_reference",
           "LAUNCHES"]

# launches of the sparse mode by op; only spmv_vec_sparse_csr adds to them,
# one per call (two launches with rows of more than CHUNK_EDGES edges)
LAUNCHES = {op: 0 for op in VEC_PROCESS_OPS}


def _check_sent(sent, x):
    if sent.dtype != torch.uint8:
        raise TypeError(f"sent must be torch.uint8, not {sent.dtype}")
    if sent.shape != (x.shape[0],) or not sent.is_contiguous():
        raise ValueError("sent must hold one flag per sender of x")
    if sent.device != x.device:
        raise ValueError(f"sent is on {sent.device}, x on {x.device}")


def spmv_vec_sparse_csr_reference(rowptr, col, val, x, op, sent, vp=None,
                                  extra=None, params=None, row=None):
    """Plain version of the sparse mode: K3's plain version with the edges
    of senders that did not send dropped before ⊗, and the count of the
    others by ``index_add_``.  Returns ``(y, got)``."""
    return spmv_vec_csr_reference(rowptr, col, val, x, op, vp, extra,
                                  params, row, sent=sent)


def spmv_vec_sparse_csr(rowptr, col, val, x, op, sent, vp=None, extra=None,
                        params=None, row=None, plan=None):
    """The sparse mode on a CSR: the operands of
    :func:`~graphmat_tpu_torch.ops.spmv_vec2.spmv_vec_csr` and ``sent``,
    uint8 per sender of ``x``.  Returns ``(y float32[n_rows,
    out_width(op, K)], got int32[n_rows])``.  ``row`` is used only by the
    plain version, ``plan`` only by the kernel (the dense mode's split: a
    chunk counts its own sent edges, the combine sums the counts)."""
    check(rowptr, col, val, x, op, vp, extra, params)
    _check_sent(sent, x)
    if x.device.type == "cpu":
        return spmv_vec_sparse_csr_reference(rowptr, col, val, x, op, sent,
                                             vp, extra, params, row)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmv_vec_sparse has no kernel for {x.device}")
    out = launch(rowptr, col, val, x, op, vp, extra, params, sent=sent,
                 plan=plan)
    if rowptr.numel() > 1:
        LAUNCHES[op] += 1
    return out


def spmv_vec_sparse(graph_csr, x, op, sent, vp=None, extra=None,
                    params=None):
    """The sparse mode over one direction of a graph (a
    ``core.graph.CSR``, read through its own senders, also where K1
    compacts it): ``x`` and ``sent`` hold one row or flag per sender,
    ``vp`` one row per receiver; edge values are ``graph_csr.val_f32``."""
    check_operand(graph_csr, x)
    plan = plan_for(graph_csr) if x.device.type == "cuda" else None
    return spmv_vec_sparse_csr(graph_csr.rowptr, graph_csr.col,
                               graph_csr.val_f32, x, op, sent, vp, extra,
                               params, row=graph_csr.row, plan=plan)


def spmv_vec_sparse_reference(graph_csr, x, op, sent, vp=None, extra=None,
                              params=None):
    """Plain version of :func:`spmv_vec_sparse`."""
    check_operand(graph_csr, x)
    check(graph_csr.rowptr, graph_csr.col, graph_csr.val_f32, x, op, vp,
          extra, params)
    _check_sent(sent, x)
    return spmv_vec_sparse_csr_reference(graph_csr.rowptr, graph_csr.col,
                                         graph_csr.val_f32, x, op, sent, vp,
                                         extra, params, graph_csr.row)
