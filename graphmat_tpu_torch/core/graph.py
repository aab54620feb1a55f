"""The Graph: receiver-sorted CSR on one device, plus vertex state.

Counterpart of ``graphmat_tpu/core/graph.py``.  For each direction the
graph keeps a CSR over receivers (``rowptr``; ``col`` holding each edge's
sender; ``val``), with edges sorted by (receiver, sender):

* receiver = dst, for ``Direction.OUT_EDGES``;
* receiver = src, for ``Direction.IN_EDGES``.

Vertex properties are a dict of ``[n_pad]`` tensors (held in a box that
two graphs can share) and the frontier a bool ``[n_pad]`` tensor.  Vertex
ids are 1-based in the public API and 0-based inside; with a permutation, the internal id of original vertex
``i`` (0-based) is ``perm[i]``.  The TPU kernel plans of the JAX package
have no counterpart: the kernels read the CSR.  The push kernel
(:mod:`graphmat_tpu_torch.ops.spmv2`) reads a direction's sender-major
index instead (:meth:`Graph.sender_csr`).

A graph lives on the card unless the caller asks for the CPU
(``device="cpu"``); with no GPU the default raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..io.edgelist import EdgeList, edgelist_from_arrays
from ..ops.compact import compact_auto, divert_stragglers, pad_positions
from ..utils.debug import debug_enabled, validate_csr, validate_plan
from ..utils.timing import NULL_SPAN, copied, count, recording, span

__all__ = ["Graph", "CSR", "round_up"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class CSR:
    """One direction of a graph, sorted by (receiver, sender).

    ``col_ext``/``src_of_pos`` exist when the direction is compacted: a
    diverted edge reads sender ``n_send + p`` of an operand extension
    whose position ``p`` holds sender ``src_of_pos[p]`` (``n_aux``
    positions, padded with sender 0 to a multiple of
    :data:`~graphmat_tpu_torch.ops.compact.QUAD`); ``x_ext`` and
    ``sent_ext`` are the extension's buffers, of that padded length:
    the compaction gather writes them, K1 reads them beside the operand
    itself."""

    rowptr: torch.Tensor        # int32[n_rows + 1]
    col: torch.Tensor           # int32[nnz], sender of each edge
    row: torch.Tensor           # int32[nnz], receiver of each edge
    val: torch.Tensor           # [nnz], the edge list's values and dtype
    n_send: int
    col_ext: Optional[torch.Tensor] = None
    src_of_pos: Optional[torch.Tensor] = None
    n_aux: int = 0
    x_ext: Optional[torch.Tensor] = None
    sent_ext: Optional[torch.Tensor] = None
    _val_f32: Optional[torch.Tensor] = None
    _got_static: Optional[torch.Tensor] = None
    _plans: Dict[str, Any] = field(default_factory=dict)

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

    def plan(self, name: str, build: Callable[[torch.Tensor], Any]) -> Any:
        """A kernel's work split of this CSR, ``build(rowptr)``, made on
        first use and kept (it reads the structure only, which never
        changes)."""
        if name not in self._plans:
            plan = build(self.rowptr)
            if debug_enabled():
                validate_plan(name, self.rowptr, plan)
            self._plans[name] = plan
        return self._plans[name]

    @property
    def got_static(self) -> torch.Tensor:
        """bool[n_rows]: the receiver has at least one edge."""
        if self._got_static is None:
            self._got_static = self.rowptr.diff() > 0
        return self._got_static


def _graph_device(device) -> torch.device:
    """The graph's device: the card by default, and never the CPU unless
    asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Graph: no CUDA device is available for the default "
            "device='cuda'; pass device=\"cpu\" to build the graph on the "
            "CPU")
    return dev


def _upload(values):
    """The ``graph.upload`` span around a copy of ``values`` to the graph,
    with the host arrays among them (numpy arrays and scalars, CPU
    tensors) counted as ``copy.htod``, whatever the graph's device; the
    shared null context when the recorder is off or nothing is on the
    host."""
    if not recording():
        return NULL_SPAN
    host = [v for v in values if isinstance(v, (np.ndarray, np.generic))
            or (isinstance(v, torch.Tensor) and v.device.type == "cpu")]
    if not host:
        return NULL_SPAN
    copied("htod", *host)
    return span("graph.upload")


def _host_allocs() -> int:
    """Blocks the caching host allocator has page-locked so far."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


def _readback(device: torch.device, tensors) -> list:
    """Host copies of ``tensors`` (on ``device``) as numpy arrays, counted
    as ``copy.dtoh``.  On the card each lands in a page-locked block of
    PyTorch's caching host allocator, one DMA a tensor and one
    synchronise for all: a block comes back to the pool when the caller
    drops the array that holds it, so a later readback of the same shapes
    finds it resident and page-locked, and never writes into an array a
    caller still holds.  ``copy.pinned.n`` counts the blocks handed out,
    ``copy.pinned.new`` those the pool had to page-lock anew."""
    if device.type != "cuda":
        out = [t.cpu().numpy() for t in tensors]
    else:
        rec = recording()
        before = _host_allocs() if rec else 0
        dst = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
               for t in tensors]
        if rec:
            count("copy.pinned.n", len(dst))
            count("copy.pinned.new", _host_allocs() - before)
        for d, t in zip(dst, tensors):
            d.copy_(t, non_blocking=True)
        for dev in {t.device for t in tensors}:
            torch.cuda.current_stream(dev).synchronize()
        out = [d.numpy() for d in dst]
    copied("dtoh", *out)
    return out


class _VpRef:
    """The box holding a graph's vertex properties, so that two graphs can
    share one store (``Graph.share_vertex_property``)."""

    __slots__ = ("vp",)

    def __init__(self, vp):
        self.vp = vp


def _build_csr(senders, receivers, vals, n_rows: int, n_send: int,
               compact, compact_kw) -> CSR:
    """Sort 0-based COO (int64 tensors) by (receiver, sender) into a CSR of
    ``n_rows`` receivers over ``n_send`` senders (a tile of a sharded graph
    has ``n_rows != n_send``), and compact it when ``compact`` says so.
    Under ``GRAPHMAT_DEBUG=1`` the CSR is validated (its edge count that
    of the COO given)."""
    order = torch.argsort(receivers * n_send + senders, stable=True)
    col = senders[order].to(torch.int32)
    row = receivers[order].to(torch.int32)
    val = vals[order]
    del order
    counts = torch.bincount(receivers, minlength=n_rows)
    rowptr = torch.zeros(n_rows + 1, dtype=torch.int32,
                         device=senders.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    csr = CSR(rowptr, col, row, val, n_send)
    if compact == "auto":
        compact = compact_auto(n_send, col.device)
    if compact and csr.nnz:
        col_ext, src_of_pos = divert_stragglers(col, row, n_send,
                                                **(compact_kw or {}))
        if src_of_pos.numel():
            csr.col_ext = col_ext
            csr.n_aux = src_of_pos.numel()
            csr.src_of_pos = pad_positions(src_of_pos)
            n_ext = csr.src_of_pos.numel()
            csr.x_ext = torch.empty(n_ext, dtype=torch.float32,
                                    device=col.device)
            csr.sent_ext = torch.empty(n_ext, dtype=torch.uint8,
                                       device=col.device)
    if debug_enabled():
        validate_csr(csr, senders.numel())
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
    device : torch device of every tensor of the graph; the card
        (``"cuda"``) by default, which raises without a GPU.
    compact : "auto", True or False
        Operand compaction (:mod:`graphmat_tpu_torch.ops.compact`):
        "auto" leaves it off on the card, where it does not pay
        (:func:`~graphmat_tpu_torch.ops.compact.compact_auto`), and
        elsewhere turns it on at the JAX package's trigger (8192 operand
        rows of 128 vertices, about 1M vertices).
    compact_kw : dict
        Parameters of :func:`~graphmat_tpu_torch.ops.compact.divert_stragglers`
        (``wr``, ``hub``, ``divert_min``, ``bpsb``, ``w_div``).
    """

    def __init__(self, edgelist: EdgeList, build_in_edges: bool = True,
                 build_out_edges: bool = True, n_align: int = 128,
                 permute=False, device="cuda", compact="auto",
                 compact_kw: Optional[dict] = None):
        self.device = _graph_device(device)
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
                                          self.n_pad, compact, compact_kw)
        if build_in_edges:
            self._csr["src"] = _build_csr(dst0, src0, vals, self.n_pad,
                                          self.n_pad, compact, compact_kw)

        self._sender = {}   # sender-major indexes built on first use
        self.valid_vertex = torch.arange(self.n_pad, device=dev) < n
        self._vpref = _VpRef({})
        self.active = torch.zeros(self.n_pad, dtype=torch.bool, device=dev)

    @classmethod
    def from_numpy_state(cls, edgelist: EdgeList, perm, vp, active,
                         device="cuda", **graph_kw) -> "Graph":
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

    def sender_csr(self, receiver: str) -> CSR:
        """The sender-major index of the direction whose receiver is
        ``receiver``: the same edges keyed by sender (``rowptr`` over
        senders; ``col`` holding each edge's receiver; ``val``), read by
        the push kernel.  Where the graph holds the opposite direction,
        that CSR is the index (its own ``col``, not the compacted one);
        otherwise the index is built once, uncompacted, on first use."""
        opposite = "src" if receiver == "dst" else "dst"
        if opposite in self._csr:
            return self._csr[opposite]
        if receiver not in self._sender:
            c = self.csr(receiver)
            self._sender[receiver] = _build_csr(
                c.row.long(), c.col.long(), c.val, self.n_pad, self.n_pad,
                False, None)
        return self._sender[receiver]

    def _all_csrs(self):
        """(receiver role, CSR) of every CSR the graph holds: a sender-major
        index of receiver ``r`` plays the opposite receiver's role."""
        out = list(self._csr.items())
        for recv, c in self._sender.items():
            out.append(("src" if recv == "dst" else "dst", c))
        return out

    @property
    def nvertices(self) -> int:
        return self.n

    def get_edges(self) -> EdgeList:
        """The edges as a 1-based EdgeList in original ids (``SpMat::
        get_edges``), from the receiver=dst direction when built, sorted
        by (receiver, sender) of that direction."""
        recv = "dst" if "dst" in self._csr else "src"
        c = self._csr[recv]
        s, r = c.col.long(), c.row.long()
        src, dst = (s, r) if recv == "dst" else (r, s)
        if self.perm is not None:
            inv = torch.empty(self.n, dtype=torch.int64, device=self.device)
            inv[self.perm] = torch.arange(self.n, device=self.device)
            src, dst = inv[src], inv[dst]
        return edgelist_from_arrays((src + 1).cpu().numpy(),
                                    (dst + 1).cpu().numpy(),
                                    c.val.cpu().numpy(), m=self.n, n=self.n)

    # ----------------------------------------------------------------- vp

    @property
    def vp(self) -> Dict[str, torch.Tensor]:
        return self._vpref.vp

    @vp.setter
    def vp(self, value) -> None:
        self._vpref.vp = value

    def init_vertexproperty(self, **fields) -> None:
        """Initialize the vertex properties.  Each field is a scalar
        (broadcast) or an array of length ``n`` in ORIGINAL vertex order."""
        vp = {}
        with _upload(fields.values()):
            for name, value in fields.items():
                if isinstance(value, np.ndarray):
                    value = value.copy()   # torch takes no read-only arrays
                arr = torch.as_tensor(value, device=self.device)
                if arr.dim() == 0 or arr.shape[0] != self.n:
                    full = arr.expand((self.n_pad,)
                                      + tuple(arr.shape)).clone()
                else:
                    full = torch.zeros((self.n_pad,) + tuple(arr.shape[1:]),
                                       dtype=arr.dtype, device=self.device)
                    if self.perm is None:
                        full[: self.n] = arr
                    else:
                        full[self.perm] = arr
                vp[name] = full
        self.vp = vp

    def set_all_vertexproperty(self, **fields) -> None:
        self.init_vertexproperty(**fields)

    def share_vertex_property(self, other: "Graph") -> None:
        """Alias this graph's vertex properties to ``other``'s
        (``Graph.h:301-305``): both graphs then read and write one store."""
        if other.n_pad != self.n_pad:
            raise ValueError("shareVertexProperty requires matching padded "
                             "size")
        if (self.perm is None) != (other.perm is None) or (
                self.perm is not None
                and not torch.equal(self.perm.cpu(), other.perm.cpu())):
            raise ValueError(
                "shareVertexProperty requires the same vertex permutation "
                "on both graphs; build the second graph with "
                "permute=first.perm (or permute=False on both)")
        self._vpref = other._vpref

    def _idx(self, vid1: int) -> int:
        i = vid1 - 1
        return int(self.perm[i]) if self.perm is not None else i

    def get_vertexproperty(self, vid1: int) -> Dict[str, Any]:
        """One vertex's properties (1-based id), as numpy values."""
        i = self._idx(vid1)
        with span("graph.readback"):
            out = {k: v[i].cpu().numpy() for k, v in self.vp.items()}
            copied("dtoh", *out.values())
        return out

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
        with span("graph.readback"):
            if self.perm is None:
                vals = [v[: self.n] for v in self.vp.values()]
            else:
                vals = [v[self.perm] for v in self.vp.values()]
            return dict(zip(self.vp, _readback(self.device, vals)))

    # ------------------------------------------------------------- active

    def active_numpy(self) -> np.ndarray:
        """The frontier as a host bool[n] in ORIGINAL order."""
        with span("graph.readback"):
            if self.perm is None:
                a, = _readback(self.device, [self.active])
                return a[: self.n]
            a, perm = _readback(self.device, [self.active, self.perm])
            return a[perm]

    def set_all_active(self) -> None:
        self.active = self.valid_vertex.clone()

    def set_all_inactive(self) -> None:
        self.active = torch.zeros(self.n_pad, dtype=torch.bool,
                                  device=self.device)

    def set_active(self, vid1: int) -> None:
        self.active = self.active.clone()
        self.active[self._idx(vid1)] = True

    def set_inactive(self, vid1: int) -> None:
        self.active = self.active.clone()
        self.active[self._idx(vid1)] = False

    def set_active_mask(self, mask) -> None:
        """Set the frontier from a bool[n] mask in ORIGINAL vertex order."""
        if not isinstance(mask, torch.Tensor):
            mask = np.array(mask, bool)
        with _upload((mask,)):
            mask = torch.as_tensor(mask, device=self.device).bool()
        if mask.shape != (self.n,):
            raise ValueError(f"mask has {mask.shape[0]} entries, graph has "
                             f"{self.n} vertices")
        full = torch.zeros(self.n_pad, dtype=torch.bool, device=self.device)
        if self.perm is None:
            full[: self.n] = mask
        else:
            full[self.perm] = mask
        self.active = full

    def __repr__(self):
        return (f"Graph(n={self.n}, nnz={self.nnz}, n_pad={self.n_pad}, "
                f"device={self.device})")
