"""Edge-list container and file I/O.

PyTorch-package counterpart of ``graphmat_tpu/io/edgelist.py``, numpy
only.  File formats (``edgelist.h:89-240`` of the reference):

* **binary**: optional 12-byte header of int32 ``(m, n, nnz)`` followed by
  triples ``(src:int32, dst:int32, val:W)``; with ``edgeweights=False``
  the value column is absent and every weight is 1.
* **text**: optional ``"m n nnz"`` header line, then ``"src dst [val]"``
  rows.
* Vertex ids are **1-based**.
* A sharded dataset is a series ``prefix0, prefix1, ...``;
  :func:`load_edgelist` accepts an exact path or such a prefix.

The shipped ``data/*.bin.mtx`` files hold ``nnz+1`` triples with the last
one repeated; the header count is honoured, which drops it.

An :class:`EdgeList` built by :mod:`graphmat_tpu_torch.utils.generators`
on a device holds torch tensors instead of numpy arrays; the loaders and
writers here take and give numpy.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "EdgeList",
    "load_edgelist",
    "write_edgelist",
    "edgelist_from_arrays",
]


@dataclass
class EdgeList:
    """A COO edge list with 1-based vertex ids (struct-of-arrays): an
    ``m x n`` matrix with ``nnz`` entries.  ``src``, ``dst`` and ``val``
    are numpy arrays, or torch tensors on one device."""

    m: int = 0
    n: int = 0
    src: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    dst: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    val: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    def copy(self) -> "EdgeList":
        def dup(a):   # numpy copy() or torch clone()
            return a.clone() if hasattr(a, "clone") else a.copy()
        return EdgeList(self.m, self.n, dup(self.src), dup(self.dst),
                        dup(self.val))

    def validate(self) -> None:
        """Raise if an id lies outside ``[1, m]`` / ``[1, n]``."""
        if self.nnz:
            if int(self.src.min()) < 1 or int(self.src.max()) > self.m:
                raise ValueError("src out of range")
            if int(self.dst.min()) < 1 or int(self.dst.max()) > self.n:
                raise ValueError("dst out of range")

    def __repr__(self):
        return (f"EdgeList(m={self.m}, n={self.n}, nnz={self.nnz}, "
                f"valdtype={self.val.dtype})")


def edgelist_from_arrays(src, dst, val=None, m=None, n=None) -> EdgeList:
    """Build an EdgeList from arrays of 1-based ids; dims default to max id."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if val is None:
        val = np.ones(src.shape[0], np.int32)
    else:
        val = np.asarray(val)
        if val.shape[0] != src.shape[0]:
            raise ValueError("val length mismatch")
    m = int(m if m is not None else (src.max() if src.size else 0))
    n = int(n if n is not None else (dst.max() if dst.size else 0))
    e = EdgeList(m, n, src, dst, val)
    e.validate()
    return e


def _shard_paths(path: str) -> list:
    """Resolve a path or shard prefix to the ordered list of files to read."""
    if os.path.exists(path):
        return [path]
    shards = []
    for p in glob.glob(glob.escape(path) + "*"):
        suffix = p[len(path):]
        if re.fullmatch(r"\d+", suffix):
            shards.append((int(suffix), p))
    shards.sort()
    if not shards:
        raise FileNotFoundError(f"no file or shard series found at '{path}'")
    # read shards 0..k and stop at the first missing index, as the
    # reference does (edgelist.h:250-263)
    out = []
    for i, (idx, p) in enumerate(shards):
        if idx != i:
            break
        out.append(p)
    return out


def _read_one_binary(path, header, weights, wdtype):
    raw = np.fromfile(path, dtype=np.uint8)
    off = 0
    m = n = nnz = None
    if header:
        hdr = raw[:12].view(np.int32)
        m, n, nnz = int(hdr[0]), int(hdr[1]), int(hdr[2])
        off = 12
    fields = [("src", np.int32), ("dst", np.int32)]
    if weights:
        fields.append(("val", wdtype))
    rec = np.dtype(fields)
    body = raw[off: off + ((raw.size - off) // rec.itemsize) * rec.itemsize]
    triples = body.view(rec)
    if nnz is not None:
        triples = triples[:nnz]
    src = triples["src"].astype(np.int32)
    dst = triples["dst"].astype(np.int32)
    val = (triples["val"].copy() if weights
           else np.ones(src.shape[0], wdtype))
    if m is None:
        m = int(src.max()) if src.size else 0
        n = int(dst.max()) if dst.size else 0
    return m, n, src, dst, val


def _read_one_text(path, header, weights, wdtype):
    first = b""
    if header:
        with open(path, "rb") as f:
            first = f.readline()
    ncols = 3 if weights else 2
    data = np.loadtxt(path, skiprows=(1 if header else 0), ndmin=2,
                      dtype=np.float64 if np.issubdtype(
                          np.dtype(wdtype), np.floating) else np.int64)
    if data.size == 0:
        data = data.reshape(0, ncols)
    src = data[:, 0].astype(np.int32)
    dst = data[:, 1].astype(np.int32)
    val = (data[:, 2].astype(wdtype) if weights
           else np.ones(src.shape[0], wdtype))
    if header:
        hm, hn, hnnz = (int(float(x)) for x in first.split()[:3])
        src, dst, val = src[:hnnz], dst[:hnnz], val[:hnnz]
        m, n = hm, hn
    else:
        m = int(src.max()) if src.size else 0
        n = int(dst.max()) if dst.size else 0
    return m, n, src, dst, val


def load_edgelist(path: str, binaryformat: bool = True, header: bool = True,
                  edgeweights: bool = True, wdtype=np.int32) -> EdgeList:
    """Load an edge list from a file or a ``prefix0, prefix1, ...`` series.

    As ``load_edgelist`` in ``edgelist.h:242-334``: per-shard dims are
    max-reduced, nnz summed, weights default to 1 when absent.
    """
    wdtype = np.dtype(wdtype)
    read = _read_one_binary if binaryformat else _read_one_text
    M = N = 0
    srcs, dsts, vals = [], [], []
    for p in _shard_paths(path):
        m, n, s, d, v = read(p, header, edgeweights, wdtype)
        M, N = max(M, m), max(N, n)
        srcs.append(s)
        dsts.append(d)
        vals.append(v)
    return EdgeList(M, N,
                    np.concatenate(srcs) if srcs else np.empty(0, np.int32),
                    np.concatenate(dsts) if dsts else np.empty(0, np.int32),
                    np.concatenate(vals) if vals else np.empty(0, wdtype))


def write_edgelist(edgelist: EdgeList, path: str, binaryformat: bool = True,
                   header: bool = True, edgeweights: bool = True,
                   nshards: int | None = None) -> list:
    """Write an edge list; returns the list of files written.

    With ``nshards`` set, writes ``path0..path{nshards-1}`` (the reference's
    per-rank files, ``edgelist.h:208-240``); otherwise a single ``path``.
    """
    src, dst, val = (np.asarray(a) for a in
                     (edgelist.src, edgelist.dst, edgelist.val))
    if nshards is None:
        chunks = [(path, slice(None))]
    else:
        bounds = np.linspace(0, edgelist.nnz, nshards + 1).astype(np.int64)
        chunks = [(f"{path}{i}", slice(int(bounds[i]), int(bounds[i + 1])))
                  for i in range(nshards)]
    written = []
    for p, sl in chunks:
        s, d, v = src[sl], dst[sl], val[sl]
        if binaryformat:
            with open(p, "wb") as f:
                if header:
                    np.array([edgelist.m, edgelist.n, s.shape[0]],
                             np.int32).tofile(f)
                rec_fields = [("src", np.int32), ("dst", np.int32)]
                if edgeweights:
                    rec_fields.append(("val", v.dtype))
                rec = np.empty(s.shape[0], np.dtype(rec_fields))
                rec["src"], rec["dst"] = s, d
                if edgeweights:
                    rec["val"] = v
                rec.tofile(f)
        else:
            with open(p, "w") as f:
                if header:
                    f.write(f"{edgelist.m} {edgelist.n} {s.shape[0]}\n")
                if not edgeweights:
                    rows = (f"{a} {b}" for a, b in zip(s, d))
                elif np.issubdtype(v.dtype, np.floating):
                    rows = (f"{a} {b} {c}" for a, b, c in zip(s, d, v))
                else:
                    rows = (f"{a} {b} {int(c)}" for a, b, c in zip(s, d, v))
                f.write("\n".join(rows))
                if s.shape[0]:
                    f.write("\n")
        written.append(p)
    return written
