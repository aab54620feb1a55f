"""K5: the scalar SpMV with the identity ⊗, ``y[r] = ⊕_{s→r} x[s]``.

Counterpart of ``graphmat_tpu/ops/pallas_spmv.py`` (``spmv``), for ⊕ ∈
{sum, min, max}; a receiver with no edge gets the ⊕ identity (0, +inf,
-inf).  The JAX package calls it in one place, the got pass of the
ACTIVE_ONLY K-wide route (``graphmat_tpu/core/runtime.py:566-573``: the
sum of the sent bits, then ``> 0``).  The port computes that count inside
the sparse mode of the K-wide kernel (:mod:`.spmv_vec`), in the same pass.

Alone, K5's function is K1 with op ``x``: :func:`spmv` runs the port's K1
(``graphmat_tpu_torch/csrc/spmv2u.cu``, counted in
:data:`graphmat_tpu_torch.ops.spmv2u.LAUNCHES`) on CUDA tensors and its
plain version on CPU tensors; :func:`spmv_reference` is a gather and a
``scatter_reduce_``, written independently of K1.
"""

from __future__ import annotations

import torch

from . import spmv2u

__all__ = ["spmv", "spmv_reference"]

_SCATTER = {"sum": "sum", "min": "amin", "max": "amax"}


def spmv(graph_csr, x, reduce_kind: str = "sum"):
    """``y[r] = ⊕_{s→r} x[s]`` over one direction of a graph (a
    ``core.graph.CSR``); ``x`` float32, one entry per sender."""
    return spmv2u.spmv(graph_csr, x, reduce_kind, "x")


def spmv_reference(graph_csr, x, reduce_kind: str = "sum"):
    """Plain version of :func:`spmv`: ``x[col]`` scattered by
    ``scatter_reduce_`` into an identity-filled ``y``."""
    if reduce_kind not in _SCATTER:
        raise ValueError(f"reduce_kind {reduce_kind!r} is not one of "
                         f"{sorted(_SCATTER)}")
    if x.shape != (graph_csr.n_send,) or x.dtype != torch.float32:
        raise ValueError(f"x must be float32[{graph_csr.n_send}], not "
                         f"{x.dtype}{list(x.shape)}")
    y = torch.full((graph_csr.n_rows,), spmv2u.IDENTITY[reduce_kind],
                   dtype=torch.float32, device=x.device)
    return y.scatter_reduce_(0, graph_csr.row.long(),
                             x[graph_csr.col.long()], _SCATTER[reduce_kind],
                             include_self=False)
