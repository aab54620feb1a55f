"""The Graph: receiver-sorted CSR on one device, plus vertex state.

Counterpart of ``graphmat_tpu/core/graph.py``.  For each direction the
graph keeps a CSR over receivers (``rowptr``; ``col`` holding each edge's
sender; ``val``), with edges sorted by (receiver, sender):

* receiver = dst, for ``Direction.OUT_EDGES``;
* receiver = src, for ``Direction.IN_EDGES``.

Vertex properties are a dict of ``[n_pad]`` tensors and the frontier a
bool ``[n_pad]`` tensor.  Vertex ids are 1-based in the public API and
0-based inside; with a permutation, the internal id of original vertex
``i`` (0-based) is ``perm[i]``.  The TPU kernel plans of the JAX package
have no counterpart: the kernels read the CSR.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..io.edgelist import EdgeList
from ..ops.compact import compact_enabled, divert_stragglers

__all__ = ["Graph", "CSR", "round_up"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class CSR:
    """One direction of a graph, sorted by (receiver, sender).

    ``col_ext``/``src_of_pos`` exist when the direction is compacted: a
    diverted edge reads sender ``n_send + p`` of an operand extension
    whose position ``p`` holds sender ``src_of_pos[p]``; ``x_ext`` and
    ``sent_ext`` are that operand's preallocated buffers."""

    rowptr: torch.Tensor        # int32[n_rows + 1]
    col: torch.Tensor           # int32[nnz], sender of each edge
    row: torch.Tensor           # int32[nnz], receiver of each edge
    val: torch.Tensor           # [nnz], the edge list's values and dtype
    n_send: int
    col_ext: Optional[torch.Tensor] = None
    src_of_pos: Optional[torch.Tensor] = None
    x_ext: Optional[torch.Tensor] = None
    sent_ext: Optional[torch.Tensor] = None
    _val_f32: Optional[torch.Tensor] = None
    _got_static: Optional[torch.Tensor] = None

    @property
    def n_rows(self) -> int:
        return self.rowptr.numel() - 1

    @property
    def nnz(self) -> int:
        return self.col.numel()

    @property
    def val_f32(self) -> torch.Tensor:
        """Edge values as the float32 the kernel reads (made once)."""
        if self._val_f32 is None:
            self._val_f32 = self.val.to(torch.float32).contiguous()
        return self._val_f32

    @property
    def got_static(self) -> torch.Tensor:
        """bool[n_rows]: the receiver has at least one edge."""
        if self._got_static is None:
            self._got_static = self.rowptr.diff() > 0
        return self._got_static


def _build_csr(senders, receivers, vals, n_pad: int, compact,
               compact_kw) -> CSR:
    """Sort 0-based COO (int64 tensors) by (receiver, sender) into a CSR,
    and compact it when ``compact`` says so."""
    order = torch.argsort(receivers * n_pad + senders, stable=True)
    col = senders[order].to(torch.int32)
    row = receivers[order].to(torch.int32)
    val = vals[order]
    del order
    counts = torch.bincount(receivers, minlength=n_pad)
    rowptr = torch.zeros(n_pad + 1, dtype=torch.int32,
                         device=senders.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    csr = CSR(rowptr, col, row, val, n_pad)
    if compact == "auto":
        compact = compact_enabled(n_pad)
    if compact and csr.nnz:
        col_ext, src_of_pos = divert_stragglers(col, row, n_pad,
                                                **(compact_kw or {}))
        n_aux = src_of_pos.numel()
        if n_aux:
            dev = col.device
            csr.col_ext = col_ext
            csr.src_of_pos = src_of_pos
            csr.x_ext = torch.empty(n_pad + n_aux, dtype=torch.float32,
                                    device=dev)
            csr.sent_ext = torch.empty(n_pad + n_aux, dtype=torch.uint8,
                                       device=dev)
    return csr


class Graph:
    """A graph on one device.

    Parameters
    ----------
    edgelist : EdgeList
        1-based COO edges (numpy arrays or torch tensors).  The graph is
        squared to ``max(m, n)`` vertices like ``Graph::ReadMTX``.
    build_in_edges, build_out_edges : bool
        Whether to build the receiver=src and receiver=dst directions.
    n_align : int
        Vertex-count padding multiple.
    permute : False, "degree", True or an [n] permutation
        Relabel vertices: "degree" puts high out-degree senders at low
        ids, True draws the JAX package's seeded permutation, an array
        gives ``perm[original0] = internal0``.
    device : torch device of every tensor of the graph.
    compact : "auto", True or False
        Operand compaction (:mod:`graphmat_tpu_torch.ops.compact`):
        "auto" turns it on at the JAX package's trigger (8192 operand
        rows of 128 vertices, about 1M vertices).
    compact_kw : dict
        Parameters of :func:`~graphmat_tpu_torch.ops.compact.divert_stragglers`
        (``wr``, ``hub``, ``divert_min``, ``bpsb``, ``w_div``).
    """

    def __init__(self, edgelist: EdgeList, build_in_edges: bool = True,
                 build_out_edges: bool = True, n_align: int = 128,
                 permute=False, device="cpu", compact="auto",
                 compact_kw: Optional[dict] = None):
        self.device = torch.device(device)
        dev = self.device
        n = max(edgelist.m, edgelist.n)
        self.n = n
        self.nnz = edgelist.nnz
        self.n_pad = max(round_up(n, n_align), n_align)

        src0 = torch.as_tensor(edgelist.src, device=dev).long() - 1
        dst0 = torch.as_tensor(edgelist.dst, device=dev).long() - 1
        vals = torch.as_tensor(edgelist.val, device=dev)
        if self.nnz and (int(torch.minimum(src0.min(), dst0.min())) < 0
                         or int(torch.maximum(src0.max(), dst0.max())) >= n):
            raise ValueError("edge list has vertex ids outside [1, n]")

        self.perm = None
        if permute is not False and permute is not None and n > 0:
            if isinstance(permute, (np.ndarray, torch.Tensor)):
                perm = torch.as_tensor(permute, device=dev).long()
                if perm.shape != (n,):
                    raise ValueError(f"permutation must have {n} entries")
            elif permute == "degree":
                deg = torch.bincount(src0, minlength=n)
                order = torch.argsort(-deg, stable=True)
                perm = torch.empty(n, dtype=torch.int64, device=dev)
                perm[order] = torch.arange(n, device=dev)
            elif permute is True:
                rng = np.random.default_rng(5)
                perm = torch.as_tensor(rng.permutation(n), device=dev).long()
            else:
                raise ValueError(f"permute={permute!r}: use False, "
                                 "'degree', True or a permutation")
            self.perm = perm
            src0 = perm[src0]
            dst0 = perm[dst0]

        self._csr = {}
        if build_out_edges:
            self._csr["dst"] = _build_csr(src0, dst0, vals, self.n_pad,
                                          compact, compact_kw)
        if build_in_edges:
            self._csr["src"] = _build_csr(dst0, src0, vals, self.n_pad,
                                          compact, compact_kw)

        self.valid_vertex = torch.arange(self.n_pad, device=dev) < n
        self.vp: Dict[str, torch.Tensor] = {}
        self.active = torch.zeros(self.n_pad, dtype=torch.bool, device=dev)

    @classmethod
    def from_numpy_state(cls, edgelist: EdgeList, perm, vp, active,
                         device="cpu", **graph_kw) -> "Graph":
        """A graph that carries on from another package's graph, given as
        host arrays: its edge list, its permutation (``perm[original0] =
        internal0``, or None), its vertex properties in ORIGINAL order
        (length n) and its frontier in INTERNAL order (length n_pad)."""
        g = cls(edgelist, permute=(False if perm is None
                                   else np.asarray(perm)),
                device=device, **graph_kw)
        g.init_vertexproperty(**{k: np.asarray(v) for k, v in vp.items()})
        act = torch.as_tensor(np.array(active, bool))   # a writable copy
        if act.shape != (g.n_pad,):
            raise ValueError(f"active has shape {tuple(act.shape)}, the "
                             f"graph pads to {g.n_pad} vertices")
        g.active = act.to(g.device)
        return g

    # -------------------------------------------------------------- edges

    def csr(self, receiver: str) -> CSR:
        """The direction whose receiver is 'dst' (OUT_EDGES) or 'src'
        (IN_EDGES)."""
        if receiver not in self._csr:
            raise ValueError(
                f"graph was built without the receiver={receiver} "
                f"direction; pass build_"
                f"{'out' if receiver == 'dst' else 'in'}_edges=True")
        return self._csr[receiver]

    # ----------------------------------------------------------------- vp

    def init_vertexproperty(self, **fields) -> None:
        """Initialize the vertex properties.  Each field is a scalar
        (broadcast) or an array of length ``n`` in ORIGINAL vertex order."""
        vp = {}
        for name, value in fields.items():
            if isinstance(value, np.ndarray):
                value = value.copy()   # torch takes no read-only arrays
            arr = torch.as_tensor(value, device=self.device)
            if arr.dim() == 0 or arr.shape[0] != self.n:
                full = arr.expand((self.n_pad,) + tuple(arr.shape)).clone()
            else:
                full = torch.zeros((self.n_pad,) + tuple(arr.shape[1:]),
                                   dtype=arr.dtype, device=self.device)
                if self.perm is None:
                    full[: self.n] = arr
                else:
                    full[self.perm] = arr
            vp[name] = full
        self.vp = vp

    def _idx(self, vid1: int) -> int:
        i = vid1 - 1
        return int(self.perm[i]) if self.perm is not None else i

    def get_vertexproperty(self, vid1: int) -> Dict[str, Any]:
        """One vertex's properties (1-based id), as numpy values."""
        i = self._idx(vid1)
        return {k: v[i].cpu().numpy() for k, v in self.vp.items()}

    def set_vertexproperty(self, vid1: int, **fields) -> None:
        """Set fields of one vertex (1-based id).  The changed fields are
        copied first, so no other holder of the old tensors sees it."""
        i = self._idx(vid1)
        vp = dict(self.vp)
        for k, val in fields.items():
            vp[k] = vp[k].clone()
            vp[k][i] = val
        self.vp = vp

    def vp_numpy(self) -> Dict[str, np.ndarray]:
        """Host copies of the vertex properties in ORIGINAL order."""
        if self.perm is None:
            return {k: v[: self.n].cpu().numpy() for k, v in self.vp.items()}
        return {k: v[self.perm].cpu().numpy() for k, v in self.vp.items()}

    # ------------------------------------------------------------- active

    def set_all_active(self) -> None:
        self.active = self.valid_vertex.clone()

    def set_active(self, vid1: int) -> None:
        self.active = self.active.clone()
        self.active[self._idx(vid1)] = True

    def __repr__(self):
        return (f"Graph(n={self.n}, nnz={self.nnz}, n_pad={self.n_pad}, "
                f"device={self.device})")
