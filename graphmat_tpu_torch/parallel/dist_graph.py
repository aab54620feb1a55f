"""The 2D-sharded graph.

Counterpart of ``graphmat_tpu/parallel/dist_graph.py``, after the
reference's ``SpMat<DCSCTile>`` tile grid and ``SpVec<DenseSegment>``
(``GMDP/matrices/SpMat.h:50-396``, ``GMDP/vectors/SpVec.h:42-388``).

Layout (the JAX package's, exactly)
-----------------------------------
With an (R, C) mesh and segment size
``S = max(round_up(ceil(n / RC), seg_align), seg_align)``, the padded
vertex count is ``n_pad = R * C * S`` and global vertex order is row-block
major: segment ``t = i * C + j`` covers ``[t * S, (t + 1) * S)`` and lives
with tile (i, j).  So:

* row block i is segments (i, 0..C-1), a contiguous slice of ``C * S``
  ids; a tile stores its receivers row-local;
* column block j is segments (0..R-1, j), in the order an all-gather
  along 'r' gives them; a tile stores its senders column-local, as
  ``i' * S + k`` for sender ``k`` of segment (i', j).

Tile (i, j) holds the edges whose receiver lies in row block i and whose
sender lies in column block j, one :class:`~graphmat_tpu_torch.core.graph.CSR`
per direction with ``C * S`` receiver rows over ``R * S`` senders, at its
exact size (the reference's per-tile sizes, ``SpMat.h:97-278``; the JAX
package pads every tile to the largest, a static-shape trade of
``shard_map`` that is not copied).  The push kernel reads a tile's own
sender-major index (``R * S`` sender rows over ``C * S`` receivers),
built on first use.

Vertex properties and the frontier live per segment: ``vp`` is a list with
one dict of ``[S, ...]`` tensors per local tile, ``active`` and
``valid_vertex`` lists of bool ``[S]``, each on its tile's device.

``permute="auto"`` applies the segment-strided degree permute when the
natural layout's largest tile holds more than twice the mean (the JAX
rule, dist_graph.py:128-148); ``"degree"`` always does; ``True`` draws the
seeded random permutation; an array gives ``perm[original0] = internal0``.
``perm`` equals the JAX package's for the same edge list.

The build reads the edge list :data:`BUILD_CHUNK` edges at a time: a
first pass checks the ids and counts what ``permute`` needs (each tile's
edges, each sender's degree), a second routes each chunk's edges of both
directions to their tiles' devices as int32 local ids; each tile's CSR
is then sorted on its own device.  So no device holds the whole list as
int64, and the tiles are those of a build from the whole list at once,
bit for bit: a tile's edges keep the list's order into the stable sort.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.graph import CSR, _build_csr, _readback, _VpRef, round_up
from ..io.edgelist import EdgeList
from ..utils.timing import span
from .mesh import Mesh

__all__ = ["DistGraph", "BUILD_CHUNK"]

# edges the build reads at once: bounds its transient memory on the
# first device (about 80 B an edge)
BUILD_CHUNK = 1 << 26


def _tile_edges(send, recv, R: int, C: int, S: int):
    """Each edge's tile and its local ids: ``(tile, send_local,
    recv_local)`` (int64 tensors) for 0-based senders and receivers."""
    seg_recv = recv // S
    seg_send = send // S
    tile_i = seg_recv // C
    tile = tile_i * C + seg_send % C
    recv_local = recv - tile_i * (C * S)
    send_local = (seg_send // C) * S + send % S
    return tile, send_local, recv_local


def _chunks(edgelist: EdgeList, dev):
    """The edge list :data:`BUILD_CHUNK` edges at a time on ``dev``:
    0-based int64 ``(src, dst)`` and the values; one empty chunk for an
    empty list."""
    src, dst, val = edgelist.astuple()
    for lo in range(0, max(edgelist.nnz, 1), BUILD_CHUNK):
        hi = min(lo + BUILD_CHUNK, edgelist.nnz)
        yield (torch.as_tensor(src[lo:hi], device=dev).long() - 1,
               torch.as_tensor(dst[lo:hi], device=dev).long() - 1,
               torch.as_tensor(val[lo:hi], device=dev))


class DistGraph:
    """A graph 2D-sharded over a :class:`~graphmat_tpu_torch.parallel.mesh.Mesh`.

    The API is :class:`~graphmat_tpu_torch.core.graph.Graph`'s (1-based
    vertex ids, properties in original order at the edges of the API);
    ``compact`` and ``compact_kw`` are its operand compaction, per tile.
    Every process reads the whole edge list, chunk by chunk, and keeps
    its own tiles.
    """

    def __init__(self, edgelist: EdgeList, mesh: Mesh,
                 build_in_edges: bool = True, build_out_edges: bool = True,
                 seg_align: int = 128, permute="auto", permute_seed: int = 5,
                 compact="auto", compact_kw: Optional[dict] = None):
        self.mesh = mesh
        R, C = mesh.shape
        self.R, self.C = R, C
        self.local: List[int] = list(mesh.local)
        self.devices: List[torch.device] = list(mesh.devices)
        self.device = self.devices[0]
        dev = self.device
        n = max(edgelist.m, edgelist.n)
        self.n = n
        self.nnz = edgelist.nnz
        S = self.S = max(round_up(-(-n // (R * C)), seg_align), seg_align)
        self.n_pad = R * C * S

        # the first pass: the ids checked; the natural layout's edges per
        # tile ("auto") and each sender's out-degree ("degree") counted
        auto = (isinstance(permute, str) and permute == "auto"
                and R * C > 1 and self.nnz > 0)
        by_degree = auto or (isinstance(permute, str)
                             and permute == "degree")
        per_tile = torch.zeros(R * C, dtype=torch.int64, device=dev)
        deg = (torch.zeros(n, dtype=torch.int64, device=dev) if by_degree
               else None)
        for src0, dst0, _ in _chunks(edgelist, dev):
            if src0.numel() and (
                    int(torch.minimum(src0.min(), dst0.min())) < 0
                    or int(torch.maximum(src0.max(), dst0.max())) >= n):
                raise ValueError("edge list has vertex ids outside [1, n]")
            if auto:
                per_tile += torch.bincount(
                    ((dst0 // S) // C) * C + (src0 // S) % C,
                    minlength=R * C)
            if by_degree:
                deg += torch.bincount(src0, minlength=n)
        del src0, dst0

        if isinstance(permute, str) and permute == "auto":
            permute = self._auto_permute(per_tile) if auto else False
        self.perm: Optional[torch.Tensor] = None   # perm[orig0] = internal0
        if permute is not False and permute is not None:
            if isinstance(permute, (np.ndarray, torch.Tensor)):
                perm = torch.as_tensor(permute, device=dev).long()
                if perm.shape != (n,):
                    raise ValueError(f"permutation must have {n} entries")
            elif isinstance(permute, str) and permute == "degree":
                # the reference's vertexToNative striding (Graph.h:112-150):
                # the k-th hottest sender goes to segment k % RC at offset
                # k // RC, so every tile row and column gets an equal share
                # of the hubs
                order = torch.argsort(-deg, stable=True)
                k = torch.arange(n, device=dev)
                perm = torch.empty(n, dtype=torch.int64, device=dev)
                perm[order] = (k % (R * C)) * S + k // (R * C)
            else:
                rng = np.random.default_rng(permute_seed)
                perm = torch.as_tensor(rng.permutation(n), device=dev).long()
            self.perm = perm
        del deg

        # the second pass: each chunk's edges routed to their tiles, both
        # directions at once
        recvs = [r for r, on in (("dst", build_out_edges),
                                 ("src", build_in_edges)) if on]
        parts = {r: [[] for _ in self.local] for r in recvs}
        for src0, dst0, vals in _chunks(edgelist, dev):
            if self.perm is not None:
                src0, dst0 = self.perm[src0], self.perm[dst0]
            for recv in recvs:
                send, rec = (src0, dst0) if recv == "dst" else (dst0, src0)
                self._route(send, rec, vals, parts[recv])
        del src0, dst0, vals, send, rec
        self._tiles: Dict[str, List[CSR]] = {
            recv: self._build_tiles(parts[recv], compact, compact_kw)
            for recv in recvs}
        self._sender: Dict[str, List[CSR]] = {}
        # a dense sweep's got per set of directions (the engine's, made
        # once: the structure never changes)
        self._got_static: Dict[tuple, List[torch.Tensor]] = {}

        vv = torch.zeros(self.n_pad, dtype=torch.bool, device=dev)
        if self.perm is None:
            vv[:n] = True
        else:
            vv[self.perm] = True
        self.valid_vertex: List[torch.Tensor] = self._split(vv)
        self._vpref = _VpRef([{} for _ in self.local])
        self.set_all_inactive()

    # ------------------------------------------------------------- build

    def _auto_permute(self, per_tile):
        """The JAX rule: "degree" when the natural layout's largest tile
        (receiver = dst), whose edges ``per_tile`` counts, holds more than
        twice the mean, else False."""
        cnt = per_tile.double()
        mean = max(float(cnt.mean()), 1.0)
        if float(cnt.max()) <= 2.0 * mean:
            return False
        from ..utils.logging import get_logger
        get_logger().info(
            "dist tile skew %.1fx mean -> applying the segment-strided "
            "degree permute (permute=False to disable)",
            float(cnt.max()) / mean)
        return "degree"

    def _route(self, send, recv, vals, parts):
        """Append to ``parts[p]`` local tile ``p``'s edges of one chunk of
        the direction whose receivers are ``recv``: int32 local senders
        and receivers and the values, on the tile's device, in the
        chunk's order."""
        R, C, S = self.R, self.C, self.S
        tile, send_local, recv_local = _tile_edges(send, recv, R, C, S)
        order = torch.argsort(tile, stable=True)
        bounds = [0] + torch.cumsum(torch.bincount(
            tile, minlength=R * C), 0).tolist()
        for p, (t, d) in enumerate(zip(self.local, self.devices)):
            sel = order[bounds[t]:bounds[t + 1]]
            parts[p].append((send_local[sel].to(torch.int32).to(d),
                             recv_local[sel].to(torch.int32).to(d),
                             vals[sel].to(d)))

    def _build_tiles(self, parts, compact, compact_kw):
        """One CSR per local tile from its routed pieces, each sorted on
        the tile's device; the pieces are freed as their tile is built."""
        C, S = self.C, self.S
        out = []
        for p in range(len(parts)):
            pieces, parts[p] = parts[p], None
            send, recv, vals = (torch.cat(x) for x in zip(*pieces))
            del pieces
            send, recv = send.long(), recv.long()
            out.append(_build_csr(send, recv, vals, C * S, self.R * S,
                                  compact, compact_kw))
            del send, recv, vals
        return out

    # ------------------------------------------------------------- edges

    def csrs(self, receiver: str) -> List[CSR]:
        """The local tiles' CSRs of the direction whose receiver is 'dst'
        (OUT_EDGES) or 'src' (IN_EDGES)."""
        if receiver not in self._tiles:
            raise ValueError(
                f"graph was built without the receiver={receiver} "
                f"direction; pass build_"
                f"{'out' if receiver == 'dst' else 'in'}_edges=True")
        return self._tiles[receiver]

    def sender_csrs(self, receiver: str) -> List[CSR]:
        """The local tiles' sender-major indexes of that direction (``R *
        S`` sender rows, ``col`` the row-local receiver), read by the push
        kernel; built once, uncompacted, on first use.  A tile's opposite
        direction holds other edges, so it is never the index."""
        if receiver not in self._sender:
            self._sender[receiver] = [
                _build_csr(c.row.long(), c.col.long(), c.val, c.n_send,
                           c.n_rows, False, None)
                for c in self.csrs(receiver)]
        return self._sender[receiver]

    def to_global(self, t: int, send_local, recv_local):
        """Global internal ids of tile ``t``'s local senders and
        receivers."""
        C, S = self.C, self.S
        ti, tj = divmod(t, C)
        send = ((send_local // S) * C + tj) * S + send_local % S
        return send, ti * (C * S) + recv_local

    @property
    def nvertices(self) -> int:
        return self.n

    def get_edges(self) -> EdgeList:
        """Export back to a 1-based EdgeList in original ids
        (``SpMat::get_edges``, ``SpMat.h:343-376``), from the receiver=dst
        direction when built; every process gets every edge."""
        recv = "dst" if "dst" in self._tiles else "src"
        parts = []
        for t, c in zip(self.local, self._tiles[recv]):
            s, r = self.to_global(t, c.col.long(), c.row.long())
            src, dst = (s, r) if recv == "dst" else (r, s)
            parts.append((src.cpu().numpy(), dst.cpu().numpy(),
                          c.val.cpu().numpy()))
        parts = [p for ps in self.mesh.gather_objects(parts) for p in ps]
        src = np.concatenate([p[0] for p in parts])
        dst = np.concatenate([p[1] for p in parts])
        val = np.concatenate([p[2] for p in parts])
        if self.perm is not None:
            inv = np.empty(self.n, np.int64)
            inv[self._perm_np()] = np.arange(self.n)
            src, dst = inv[src], inv[dst]
        return EdgeList(self.n, self.n, (src + 1).astype(np.int32),
                        (dst + 1).astype(np.int32), val)

    # ---------------------------------------------------------- segments

    def _split(self, full: torch.Tensor) -> List[torch.Tensor]:
        """The local segments of an ``[n_pad, ...]`` tensor, each its own
        copy on its tile's device."""
        S = self.S
        return [full[t * S:(t + 1) * S].clone().to(d)
                for t, d in zip(self.local, self.devices)]

    def _full(self, segs) -> torch.Tensor:
        """Every segment of a per-segment quantity, ``[n_pad, ...]``."""
        return self.mesh.gather_segments(list(segs))

    def _perm_np(self) -> np.ndarray:
        if not hasattr(self, "_perm_host"):
            self._perm_host = self.perm.cpu().numpy()
        return self._perm_host

    def _to_original(self, a: np.ndarray) -> np.ndarray:
        return a[self._perm_np()] if self.perm is not None else a[: self.n]

    def _from_original(self, arr: torch.Tensor) -> torch.Tensor:
        """An ``[n, ...]`` tensor in original order as ``[n_pad, ...]`` in
        internal order (zeros at the pads)."""
        full = torch.zeros((self.n_pad,) + tuple(arr.shape[1:]),
                           dtype=arr.dtype, device=arr.device)
        if self.perm is None:
            full[: self.n] = arr
        else:
            full[self.perm] = arr
        return full

    def _idx(self, vid1: int) -> int:
        i = vid1 - 1
        return int(self.perm[i]) if self.perm is not None else i

    def _local_pos(self, i: int):
        """(local position, offset) of internal id ``i``, or None where
        another process holds it."""
        t, k = divmod(i, self.S)
        return (self.local.index(t), k) if t in self.local else None

    # ----------------------------------------------------------------- vp

    @property
    def vp(self) -> List[Dict[str, Any]]:
        return self._vpref.vp

    @vp.setter
    def vp(self, value) -> None:
        self._vpref.vp = value

    def init_vertexproperty(self, **fields) -> None:
        """Each field a scalar (broadcast) or an array of length ``n`` in
        ORIGINAL vertex order."""
        vp = [{} for _ in self.local]
        for name, value in fields.items():
            if isinstance(value, np.ndarray):
                value = value.copy()   # torch takes no read-only arrays
            arr = torch.as_tensor(value, device=self.device)
            if arr.dim() == 0 or arr.shape[0] != self.n:
                segs = [arr.to(d).expand((self.S,) + tuple(arr.shape))
                        .clone() for d in self.devices]
            else:
                segs = self._split(self._from_original(arr))
            for p, seg in enumerate(segs):
                vp[p][name] = seg
        self.vp = vp

    def share_vertex_property(self, other: "DistGraph") -> None:
        """Alias this graph's vertex properties to ``other``'s
        (``Graph.h:301-305``): both graphs need the same mesh, padded size
        and vertex permutation."""
        if other.n_pad != self.n_pad or other.mesh is not self.mesh:
            raise ValueError("shareVertexProperty requires matching mesh "
                             "and padded size")
        if (self.perm is None) != (other.perm is None) or (
                self.perm is not None
                and not torch.equal(self.perm.cpu(), other.perm.cpu())):
            raise ValueError(
                "shareVertexProperty requires the same vertex permutation "
                "on both graphs; build the second graph with "
                "permute=first.perm (or permute=False on both)")
        self._vpref = other._vpref

    def get_vertexproperty(self, vid1: int) -> Dict[str, Any]:
        """One vertex's properties (1-based id), as numpy values, on every
        process."""
        i = self._idx(vid1)
        return {k: self._full([v[k] for v in self.vp])[i].cpu().numpy()
                for k in self.vp[0]}

    def set_vertexproperty(self, vid1: int, **fields) -> None:
        """Set fields of one vertex (1-based id), in the process that holds
        it; the changed segments are copied first."""
        where = self._local_pos(self._idx(vid1))
        if where is None:
            return
        p, k = where
        vp = list(self.vp)
        seg = dict(vp[p])
        for name, val in fields.items():
            seg[name] = seg[name].clone()
            seg[name][k] = val
        vp[p] = seg
        self.vp = vp

    def vp_numpy(self) -> Dict[str, np.ndarray]:
        """Host copies of the vertex properties in ORIGINAL order, on every
        process (the ``graph.readback`` span, as ``Graph``'s)."""
        with span("graph.readback"):
            fields = list(self.vp[0])
            full = _readback(self.device, [
                self._full([v[k] for v in self.vp]) for k in fields])
            return {k: self._to_original(a) for k, a in zip(fields, full)}

    # ------------------------------------------------------------- active

    def active_numpy(self) -> np.ndarray:
        """The frontier as a host bool[n] in ORIGINAL order."""
        with span("graph.readback"):
            a, = _readback(self.device, [self._full(self.active)])
            return self._to_original(a)

    def set_all_active(self) -> None:
        self.active = [v.clone() for v in self.valid_vertex]

    def set_all_inactive(self) -> None:
        self.active = [torch.zeros(self.S, dtype=torch.bool, device=d)
                       for d in self.devices]

    def set_active(self, vid1: int) -> None:
        where = self._local_pos(self._idx(vid1))
        if where is None:
            return   # another process holds the vertex
        p, k = where
        self.active = list(self.active)
        self.active[p] = self.active[p].clone()
        self.active[p][k] = True

    def set_active_mask(self, mask) -> None:
        """Set the frontier from a bool[n] mask in ORIGINAL vertex order."""
        mask = torch.as_tensor(np.array(mask, bool) if not isinstance(
            mask, torch.Tensor) else mask, device=self.device).bool()
        if mask.shape != (self.n,):
            raise ValueError(f"mask has {mask.shape[0]} entries, graph has "
                             f"{self.n} vertices")
        self.active = self._split(self._from_original(mask))

    def __repr__(self):
        return (f"DistGraph(n={self.n}, nnz={self.nnz}, mesh={self.R}x"
                f"{self.C}, S={self.S})")
