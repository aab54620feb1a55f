"""K3: the K-wide three-operand SpMV
``y[r, :] = Σ_{s→r} process(x[s, :], val_e, vp[r, :], extra)``.

Counterpart of ``graphmat_tpu/ops/pallas_spmv_vec2.py`` (``spmv_vec2``).
⊕ is sum.  ⊗ is one of :data:`VEC_PROCESS_OPS`, a closed set of named ops
(the JAX kernel traces an arbitrary closure; a CUDA kernel needs the set
fixed).  Each op's torch function is written from the JAX programs'
processes (``apps/sgd.py:36-47, 103-117``; ``apps/lda.py:62-153``) and
works on gathered per-edge rows:

* ``sgd``: ``x·(val − ⟨x, vp_r⟩)``, K columns;
* ``sgd_sqerr``: ``(val − ⟨x, vp_r⟩)²``, one column;
* ``lda_init``: the per-edge gamma of ``rand_r(val)``, normalised, times
  ``val``, K columns (x and vp unused);
* ``lda``: x and vp have K = topics + 1 columns, column ``K-1`` of vp
  holding the receiver's is_doc flag; ``extra`` is the global topic
  totals; K-1 columns;
* ``lda_loglik``: ``val·log(Σ_k φ_k θ_k / Σθ)`` with ``extra`` the
  smoothed topic totals, one column.

``params`` carries the ops' scalars (``alpha``, ``eta``, ``vocab_size``).

:func:`spmv_vec_csr` launches ``graphmat_tpu_torch/csrc/spmv_vec2.cu`` on
CUDA tensors and runs :func:`spmv_vec_csr_reference` on CPU tensors.  Any
width runs that int32 component indices address (:data:`MAX_WIDTH`): the
kernel keeps up to 256 components of an edge in registers and loops over
slabs of wider rows.
:func:`spmv_vec` is the graph-level entry; it reads the CSR's own senders
(``csr.col``), also on a CSR that K1 compacts: K3 needs no compaction
while its operand sits in the H100's L2.

Up to 256 components, a row of at most ``CHUNK_EDGES`` edges is one
warp's, and a longer row is cut into the chunks of K1's work split of the
CSR (:func:`~graphmat_tpu_torch.ops.spmv2u.k1_plan`, kept on the CSR), of
``CHUNK_EDGES`` edges and one warp each, whose partials a second launch
sums in chunk order.  So no warp walks a hub row alone, and a sum is the
same from launch to launch.
"""

from __future__ import annotations

import torch

from ..utils.reference_rng import RAND_MAX, rand_r_torch
from . import _lib
from .spmv2u import k1_plan, plan_for

__all__ = ["VEC_PROCESS_OPS", "MAX_WIDTH", "out_width", "spmv_vec",
           "spmv_vec_reference", "spmv_vec_csr", "spmv_vec_csr_reference",
           "LAUNCHES"]

# the widest row the kernel's int32 component indices address (its slab
# loop steps 128 components past the last)
MAX_WIDTH = 2 ** 31 - 1 - 128
# the most edges its int32 edge indices address past a row's last span
MAX_EDGES = 2 ** 31 - 1 - 256
REF_CHUNK = 1 << 22  # edges per step of the plain version (bounds memory)
# the widest row the kernel holds in registers and walks by the split; a
# wider one takes the slab kernel, one warp a row (csrc/spmv_vec2.cu)
REG_WIDTH = 256


def _sgd(x, v, vp, extra, p):
    est = (x * vp).sum(1, keepdim=True)
    return x * (v[:, None] - est)


def _sgd_sqerr(x, v, vp, extra, p):
    err = v - (x * vp).sum(1)
    return (err * err)[:, None]


def _lda_init(x, v, vp, extra, p):
    # the JAX kernel seeds from int32(val), its XLA path from uint32(val):
    # they agree for the non-negative integer counts LDA has
    if not bool(((v >= 0) & (v == torch.floor(v)) & (v < 2 ** 31)).all()):
        raise ValueError("lda_init seeds rand_r with the edge value: it "
                         "must be a non-negative integer count")
    gamma = rand_r_torch(v.to(torch.int64), x.shape[1]).to(
        torch.float32) / float(RAND_MAX)
    gamma = gamma / gamma.sum(1, keepdim=True)
    return gamma * v[:, None]


def _lda(x, v, vp, extra, p):
    k = x.shape[1] - 1
    is_doc = (vp[:, k] > 0.5)[:, None]
    alpha, eta = x.new_tensor(p["alpha"]), x.new_tensor(p["eta"])
    my_off = torch.where(is_doc, alpha, eta)
    other_off = torch.where(is_doc, eta, alpha)
    denom = extra + p["vocab_size"] * (p["eta"] - 1.0)
    gamma = ((vp[:, :k] + my_off - 1.0) * (x[:, :k] + other_off - 1.0)
             / denom)
    gamma = gamma / gamma.sum(1, keepdim=True)
    return gamma * v[:, None]


def _lda_loglik(x, v, vp, extra, p):
    em1 = p["eta"] - 1.0
    phi = (vp + em1) / extra
    theta = x + em1
    theta = theta / theta.sum(1, keepdim=True)
    return (v * torch.log((phi * theta).sum(1)))[:, None]


# ⊗: the closed set the kernel takes, with the torch function of each,
# ``(x_e [E, K], val_e [E], vp_e [E, K] or None, extra or None, params)``
VEC_PROCESS_OPS = {
    "sgd": _sgd,
    "sgd_sqerr": _sgd_sqerr,
    "lda_init": _lda_init,
    "lda": _lda,
    "lda_loglik": _lda_loglik,
}
_OP_CODE = {"sgd": 0, "sgd_sqerr": 1, "lda_init": 2, "lda": 3,
            "lda_loglik": 4}
_NEEDS_VP = {"sgd", "sgd_sqerr", "lda", "lda_loglik"}
_PARAMS = {"lda": ("alpha", "eta", "vocab_size"), "lda_loglik": ("eta",)}

# launches of the K3 kernel by op; only spmv_vec_csr adds to them, one per
# call (two launches with rows of more than CHUNK_EDGES edges)
LAUNCHES = {op: 0 for op in VEC_PROCESS_OPS}


def out_width(op: str, k: int) -> int:
    """Columns of ``y`` for ``op`` on rows of width ``k``."""
    if op in ("sgd_sqerr", "lda_loglik"):
        return 1
    return k - 1 if op == "lda" else k


def _extra_len(op: str, k: int):
    return {"lda": k - 1, "lda_loglik": k}.get(op)


def check(rowptr, col, val, x, op, vp, extra, params):
    """Raise on operands the kernel does not take."""
    if op not in VEC_PROCESS_OPS:
        raise ValueError(f"process_op {op!r} is not one of "
                         f"{sorted(VEC_PROCESS_OPS)}")
    missing = [n for n in _PARAMS.get(op, ()) if n not in (params or {})]
    if missing:
        raise ValueError(f"process_op {op!r} needs params {missing}")
    if x.dim() != 2:
        raise ValueError("x must be [n_send, K]")
    k = x.shape[1]
    if out_width(op, k) < 1:
        raise ValueError(f"K={k} is outside what {op!r} takes")
    if k > MAX_WIDTH:
        raise ValueError(f"K={k} is past what int32 component indices "
                         f"address (at most {MAX_WIDTH} columns)")
    need = [(rowptr, torch.int32, 1, "rowptr"), (col, torch.int32, 1, "col"),
            (val, torch.float32, 1, "val"), (x, torch.float32, 2, "x")]
    if op in _NEEDS_VP:
        if vp is None:
            raise ValueError(f"process_op {op!r} reads vp")
        need.append((vp, torch.float32, 2, "vp"))
    n_extra = _extra_len(op, k)
    if n_extra is not None:
        if extra is None:
            raise ValueError(f"process_op {op!r} reads extra")
        need.append((extra, torch.float32, 1, "extra"))
    for t, dtype, dim, name in need:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if val.shape != col.shape:
        raise ValueError("val must hold one value per edge")
    if col.numel() > MAX_EDGES:
        raise ValueError(f"{col.numel()} edges are past what int32 edge "
                         f"indices address (at most {MAX_EDGES})")
    if rowptr.numel() < 1:
        raise ValueError("rowptr needs n_rows + 1 entries")
    if op in _NEEDS_VP and vp.shape != (rowptr.numel() - 1, k):
        raise ValueError(f"vp must be [n_rows, {k}], not {tuple(vp.shape)}")
    if n_extra is not None and extra.shape != (n_extra,):
        raise ValueError(f"extra must hold {n_extra} values for {op!r}")


def spmv_vec_csr_reference(rowptr, col, val, x, op, vp=None, extra=None,
                           params=None, row=None, sent=None):
    """Plain version of K3: per block of edges, gather ``x[col]`` and
    ``vp[row]``, apply ⊗, ``index_add_`` into a zero ``y``.  ``row`` (the
    receiver of each edge) is derived from ``rowptr`` when not given.
    With ``sent`` (uint8 per sender; the sparse mode), the edges whose
    sender did not send are dropped before ⊗, and the int32 count of the
    others per row is returned too: ``(y, got)``."""
    n_rows = rowptr.numel() - 1
    if row is None:
        row = torch.repeat_interleave(
            torch.arange(n_rows, device=x.device), rowptr.diff().long())
    fn = VEC_PROCESS_OPS[op]
    y = torch.zeros((n_rows, out_width(op, x.shape[1])),
                    dtype=torch.float32, device=x.device)
    got = (torch.zeros(n_rows, dtype=torch.int32, device=x.device)
           if sent is not None else None)
    for e0 in range(0, col.numel(), REF_CHUNK):
        c = col[e0:e0 + REF_CHUNK].long()
        r = row[e0:e0 + REF_CHUNK].long()
        v = val[e0:e0 + REF_CHUNK]
        if sent is not None:
            ok = sent[c].bool()
            got.index_add_(0, r, ok.to(torch.int32))
            c, r, v = c[ok], r[ok], v[ok]
        vp_e = vp[r] if op in _NEEDS_VP else None
        y.index_add_(0, r, fn(x[c], v, vp_e, extra, params))
    return y if sent is None else (y, got)


def _scalars(op, params):
    """The kernel's three float scalars for ``op`` (see the .cu file)."""
    if op == "lda":
        return (params["alpha"], params["eta"],
                params["vocab_size"] * (params["eta"] - 1.0))
    if op == "lda_loglik":
        return (params["eta"] - 1.0, 0.0, 0.0)
    return (0.0, 0.0, 0.0)


def launch(rowptr, col, val, x, op, vp, extra, params, sent=None,
           plan=None):
    """One launch of ``csrc/spmv_vec2.cu`` on checked CUDA tensors (two
    where rows are cut into chunks): the dense mode, or with ``sent`` the
    sparse mode, which returns ``(y, got)``.  ``plan`` is
    :func:`~graphmat_tpu_torch.ops.spmv2u.k1_plan` of ``rowptr``, built
    here (with host reads) when not given.  The callers count the launch.
    Where x's width is not a multiple of 4, x is first copied into rows of
    the next multiple of 4 (zeros after), so that the kernel gathers a row
    with 16-byte loads."""
    n_rows = rowptr.numel() - 1
    k = x.shape[1]
    w = out_width(op, k)
    y = torch.empty((n_rows, w), dtype=torch.float32, device=x.device)
    got = (torch.empty(n_rows, dtype=torch.int32, device=x.device)
           if sent is not None else None)
    if n_rows == 0:
        return y if sent is None else (y, got)
    if k % 4 and op != "lda_init":
        x = torch.nn.functional.pad(x, (0, -k % 4))
    n_chunks = 0
    if (k - 1 if op == "lda" else k) <= REG_WIDTH:
        plan = k1_plan(rowptr) if plan is None else plan
        n_chunks = plan.chunk_row.numel()
    if n_chunks:
        part = torch.empty((n_chunks, w), device=x.device, dtype=(
            torch.float64 if op == "lda_init" else torch.float32))
        part_cnt = (torch.empty(n_chunks, dtype=torch.int32,
                                device=x.device)
                    if sent is not None else None)
        split_args = (plan.chunk_row.data_ptr(), plan.chunk_start.data_ptr(),
                      plan.long_rows.data_ptr(), plan.long_first.data_ptr(),
                      part.data_ptr(),
                      part_cnt.data_ptr() if part_cnt is not None else None,
                      n_rows, n_chunks, plan.long_rows.numel())
    else:
        split_args = (None,) * 6 + (n_rows, 0, 0)
    _lib.launch(
        "gm_spmv_vec2", x.device,
        rowptr.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(),
        vp.data_ptr() if op in _NEEDS_VP else None,
        extra.data_ptr() if extra is not None else None,
        sent.data_ptr() if sent is not None else None, y.data_ptr(),
        got.data_ptr() if got is not None else None, *split_args, k,
        x.shape[1], _OP_CODE[op], *_scalars(op, params))
    return y if sent is None else (y, got)


def spmv_vec_csr(rowptr, col, val, x, op, vp=None, extra=None, params=None,
                 row=None, plan=None):
    """K3 on a CSR: ``rowptr`` int32[n_rows+1], ``col`` int32[nnz] (each
    < len(x)), ``val`` float32[nnz], ``x`` float32[n_send, K], ``vp``
    float32[n_rows, K] when ⊗ reads it, ``extra`` float32 when it reads
    one.  Returns float32[n_rows, out_width(op, K)].  ``row`` is used only
    by the plain version; ``plan`` (:func:`k1_plan` of ``rowptr``) only by
    the kernel, which builds it (with host reads) when not given."""
    check(rowptr, col, val, x, op, vp, extra, params)
    if x.device.type == "cpu":
        return spmv_vec_csr_reference(rowptr, col, val, x, op, vp, extra,
                                      params, row)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmv_vec has no kernel for {x.device}")
    y = launch(rowptr, col, val, x, op, vp, extra, params, plan=plan)
    if rowptr.numel() > 1:
        LAUNCHES[op] += 1
    return y


def check_operand(graph_csr, x):
    """Raise unless ``x`` holds one row per sender of ``graph_csr``."""
    if x.dim() != 2 or x.shape[0] != graph_csr.n_send:
        raise ValueError(f"x has shape {tuple(x.shape)}, the graph has "
                         f"{graph_csr.n_send} senders")


def spmv_vec(graph_csr, x, op, vp=None, extra=None, params=None):
    """K3 over one direction of a graph (a ``core.graph.CSR``): ``x`` has
    one row per sender, ``vp`` one per receiver; edge values are
    ``graph_csr.val_f32``."""
    check_operand(graph_csr, x)
    plan = plan_for(graph_csr) if x.device.type == "cuda" else None
    return spmv_vec_csr(graph_csr.rowptr, graph_csr.col, graph_csr.val_f32,
                        x, op, vp, extra, params, row=graph_csr.row,
                        plan=plan)


def spmv_vec_reference(graph_csr, x, op, vp=None, extra=None, params=None):
    """Plain version of :func:`spmv_vec`."""
    check_operand(graph_csr, x)
    check(graph_csr.rowptr, graph_csr.col, graph_csr.val_f32, x, op, vp,
           extra, params)
    return spmv_vec_csr_reference(graph_csr.rowptr, graph_csr.col,
                                  graph_csr.val_f32, x, op, vp, extra,
                                  params, graph_csr.row)
