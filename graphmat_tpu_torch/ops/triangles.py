"""Exact triangle counting: degree orientation and the core-bitmap split.

Counterpart of ``graphmat_tpu/ops/triangles.py``, the scalable route of
TriangleCounting (the engine route materialises a ``[n, max_degree]``
neighbour matrix):

* **Degree orientation.**  Each undirected edge {u, v} points to the
  endpoint of larger (degree, id), which bounds every out-degree by
  O(sqrt(m)); the sum over oriented edges (u, v) of |N+(u) ∩ N+(v)|
  counts each triangle once.
* **Core bitmaps (part 1, T1).**  The top ``h`` ranks form the core.  A
  core vertex's out-neighbours are all core, so every hub-hub
  intersection lives in core-rank space: each vertex's core
  out-neighbourhood is an ``h``-bit row of a bitmap (rows only for the
  vertices that have one, and a last row of zeros), and every edge counts
  |N+(u) ∩ N+(v) ∩ C| by AND and popcount of two rows.  A second level
  beside the bitmap, a summary row of a bit per bitmap word (set where
  the word is not 0), lets T1 read only the words that are nonzero in
  both rows: the sender's row is a random one of millions, and at
  h = 4096 the two rows share a few dozen nonzero words of 128.
* **Tail lists (part 2, T2).**  Out-neighbours below the core form short
  per-sender lists, sorted and padded to the width of a class of a
  ladder of powers of two; |N+(u) ∩ N+(v) ∩ T| runs over the edges whose
  two ends both have a tail list (the probes), grouped by class pair.
  T2 gives a probe 8 lanes when both its lists are of width 64 or more
  and 4 otherwise (the preps list the narrow pairs' probes first, and a
  warp finds where the wide ones start), copies the wider list (up to 256 ids) into shared memory when
  the narrower one is wide enough to pay for it, and looks the narrower
  list's ids up by bisection, four in step a lane.

Two preps, as in the JAX package:

* ``impl="device"`` (the default): the whole prep runs on the tensor's
  device in plain PyTorch, where XLA stands in the JAX package: dedup,
  ranks, orientation, tallies and a stats vector (:func:`_tc_stats`); one
  small host read of that vector fixes the sizes (:func:`_group_cfg`);
  then the bitmap and its summaries, part 1, the tail lists and part 2
  (:func:`_kernel_args`).  Self loops and duplicates become edges of
  sender ``n`` that count 0; nothing is compacted.
* ``impl="host"``: the host prep packs the bitmap (and
  :func:`_tc_summary_host` its summaries) and the lists on the host
  (:func:`_prep`) and the same two kernels count on the device.  It is
  the independent oracle of the device prep.  As in the JAX package it
  runs the native C++/OpenMP prep (:func:`_tc_prep_native`, the port's
  copy of ``gm_tc_create``/``gm_tc_fill`` in ``native/tc_prep.cpp``),
  and the numpy prep (:func:`_tc_prep_numpy`), whose outputs are the
  same array for array, only for an empty edge list.

The JAX package's TPU upload layouts (5- and 6-byte edge planes) and its
hi/lo 512-wide partial sums are not copied: here the edges are int64
tensors and the total is one int64 sum with one scalar read.

The two hot loops are kernels written for Hopper in
``graphmat_tpu_torch/csrc/triangles.cu``: :func:`core_count` (T1) and
:func:`tail_count` (T2).  A CUDA tensor launches them; a CPU tensor runs
their plain versions :func:`core_count_reference` and
:func:`tail_count_reference`.  There is no fallback: a kernel that fails
to build or launch raises.

Per-vertex counts attribute each triangle to its degree-minimum vertex
(the oriented sender); the engine route attributes at the id-middle
vertex.  Totals agree.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _lib
from .neighbors import PAD_ID
from ..utils.timing import copied

__all__ = ["count_triangles_bucketed", "core_count", "tail_count",
           "core_count_reference", "tail_count_reference",
           "LAUNCHES", "CORE_H"]

CORE_H = 4096        # core size: a bitmap row is CORE_H / 32 words
_PART1_B = 1 << 18   # edges per chunk of T1's plain version
_NC = 21
_LADDER = tuple(8 << i for i in range(_NC))   # 8 .. 2^23
_SLAB = 1 << 24      # compares per slab of T2's plain version
# T2 runs a probe with 8 lanes when both its lists are of a class this
# wide or wider, else with 4; the preps hand it the narrow pairs' probes
# first
_TAIL_WIDE_FROM = 64

# launches of the two kernels; only core_count and tail_count add to it
LAUNCHES = {"core_count": 0, "tail_count": 0}

# bits set in each byte value: T1's plain popcount on a uint8 view
_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int32)


def _pow2ceil(x):
    return 1 << max(int(x) - 1, 0).bit_length()


def _round4(w: int) -> int:
    return -(-w // 4) * 4


# ------------------------------------------------------------------ T1

def _summary_words(w4: int) -> int:
    """The words of a summary row over ``w4`` bitmap words: a bit each."""
    return -(-w4 // 32)


def core_count_reference(bm, sm, iu, iv, s, pv):
    """Plain version of T1: ``pv[s[e]] += Σ_j [bit j of sm[iu[e]] &
    sm[iv[e]]] · popcount(bm[iu[e], j] & bm[iv[e], j])`` over every edge,
    in chunks of 2^18 edges (the whole gather would take 2 x E x W x 4
    bytes).  With summaries that mark the nonzero words, that is the
    popcount of the two rows' AND.  Returns ``pv``."""
    lut = _POPCOUNT8.to(bm.device)
    w4 = bm.shape[1]
    j = torch.arange(w4, device=bm.device)
    for c0 in range(0, iu.numel(), _PART1_B):
        a, b = iu[c0:c0 + _PART1_B].long(), iv[c0:c0 + _PART1_B].long()
        x = bm[a] & bm[b]
        words = lut[x.view(torch.uint8).int()].view(a.numel(), w4, 4).sum(
            2, dtype=torch.int32)
        both = (sm[a] & sm[b])[:, j >> 5]
        words = words * ((both >> (j & 31)) & 1)
        pv.index_add_(0, s[c0:c0 + _PART1_B].long(), words.sum(
            1, dtype=torch.int32))
    return pv


def _check_int32(what, *ts):
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{what} takes int32 tensors, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        if t.device != dev:
            raise ValueError(f"{what}'s tensors must share one device")


def core_count(bm, sm, iu, iv, s, pv):
    """T1, the core count: ``pv[s[e]] += Σ_j popc(bm[iu[e], j] &
    bm[iv[e], j])`` over the words ``j`` whose bit is set in both rows'
    summaries, for every edge ``e``.

    ``bm`` is the int32 bitmap ``[rows, W4]`` (read as uint32; ``W4`` a
    multiple of 4, padded with zero words; the last row all zeros and
    every edge without a row pointing at it); ``sm`` its int32 summaries
    ``[rows, ceil(W4 / 32)]``, bit ``j`` of a row set where word ``j`` of
    its bitmap row is not 0 (:func:`_tc_summary`); ``iu``, ``iv`` and
    ``s`` are int32 ``[E]``, ``pv`` int32, added to in place and
    returned.  The indices must lie inside ``bm`` and ``pv`` (the prep
    guarantees it; it is not checked per call).  A CUDA tensor launches
    the kernel, a CPU tensor runs :func:`core_count_reference`."""
    _check_int32("core_count", bm, sm, iu, iv, s, pv)
    if bm.dim() != 2 or bm.shape[1] % 4 or bm.shape[0] < 1:
        raise ValueError(f"core_count: bm must be [rows >= 1, W4] with W4 a "
                         f"multiple of 4, not {tuple(bm.shape)}")
    if tuple(sm.shape) != (bm.shape[0], _summary_words(bm.shape[1])):
        raise ValueError(f"core_count: sm must be [rows, ceil(W4 / 32)] = "
                         f"{(bm.shape[0], _summary_words(bm.shape[1]))}, not "
                         f"{tuple(sm.shape)}")
    if not iu.shape == iv.shape == s.shape or iu.dim() != 1:
        raise ValueError("core_count: iu, iv and s must be 1-D of one length")
    if bm.device.type == "cpu":
        return core_count_reference(bm, sm, iu, iv, s, pv)
    if bm.device.type != "cuda":
        raise RuntimeError(f"core_count has no kernel for {bm.device}")
    if iu.numel() == 0 or bm.shape[1] == 0:   # no edge, or no core (h = 0)
        return pv
    _lib.launch(
        "gm_tc_core_count", bm.device,
        bm.data_ptr(), bm.shape[1], sm.data_ptr(), sm.shape[1],
        bm.shape[0] - 1, iu.data_ptr(), iv.data_ptr(), s.data_ptr(),
        iu.numel(), pv.data_ptr())
    LAUNCHES["core_count"] += 1
    return pv


# ------------------------------------------------------------------ T2

def tail_count_reference(mats, ladder, gk, fa, fb, sp, pv):
    """Plain version of T2, the JAX broadcast equality: for each probe
    ``p``, the pairs ``(i, j)`` with ``A[i] == B[j] != PAD_ID``, where
    ``A = mats[fa[p]:fa[p] + Ds]``, ``B = mats[fb[p]:fb[p] + Dr]`` and
    the widths are ``ladder[gk[p] // len(ladder)]`` and ``ladder[gk[p] %
    len(ladder)]``; ``pv[sp[p]]`` gains the count.  On duplicate-free
    lists that is ``|{i : A[i] != PAD_ID, A[i] ∈ B}|``, sorted or not.
    Slabs of at most 2^24 compares.  Returns ``pv``."""
    ncls = len(ladder)
    for g in torch.unique(gk).tolist():
        sel = torch.nonzero(gk == g).flatten()
        Ds, Dr = int(ladder[g // ncls]), int(ladder[g % ncls])
        ca, cb = min(Ds, 4096), min(Dr, 4096)
        bc = max(1, _SLAB // (ca * cb))
        for p0 in range(0, sel.numel(), bc):
            ps = sel[p0:p0 + bc]
            ra, rb = fa[ps].long(), fb[ps].long()
            cnt = torch.zeros(ps.numel(), dtype=torch.int32,
                              device=mats.device)
            for a0 in range(0, Ds, ca):
                a = mats[ra[:, None] + torch.arange(
                    a0, a0 + ca, device=mats.device)]
                av = (a != PAD_ID)[:, :, None]
                for b0 in range(0, Dr, cb):
                    b = mats[rb[:, None] + torch.arange(
                        b0, b0 + cb, device=mats.device)]
                    eq = (a[:, :, None] == b[:, None, :]) & av
                    cnt += eq.sum((1, 2), dtype=torch.int32)
            pv.index_add_(0, sp[ps].long(), cnt)
    return pv


def tail_count(mats, ladder, gk, fa, fb, sp, pv):
    """T2, the tail count: ``pv[sp[p]] += |{i : A[i] != PAD_ID, A[i] ∈
    B}|`` for every probe ``p``, with ``A = mats[fa[p]:fa[p] + Ds]`` and
    ``B = mats[fb[p]:fb[p] + Dr]``, the widths those of the class pair
    ``gk[p] = cs * len(ladder) + cr``.

    ``mats`` is int32: the tail lists, each duplicate-free, SORTED
    ascending (the kernel searches them) and padded with ``PAD_ID`` to its
    class width; ``ladder`` the class widths (a sequence of at most 32
    ints); ``gk``, ``fa``, ``fb``, ``sp`` int32 ``[P]``; ``pv`` int32,
    added to in place and returned.  A CUDA tensor launches the kernel, a
    CPU tensor runs :func:`tail_count_reference`."""
    _check_int32("tail_count", mats, gk, fa, fb, sp, pv)
    ladder = [int(w) for w in ladder]
    if not 0 < len(ladder) <= 32 or min(ladder) <= 0:
        raise ValueError("tail_count: the ladder holds 1 to 32 widths > 0")
    if not gk.shape == fa.shape == fb.shape == sp.shape or gk.dim() != 1:
        raise ValueError("tail_count: gk, fa, fb and sp must be 1-D of one "
                         "length")
    if mats.device.type == "cpu":
        return tail_count_reference(mats, ladder, gk, fa, fb, sp, pv)
    if mats.device.type != "cuda":
        raise RuntimeError(f"tail_count has no kernel for {mats.device}")
    if gk.numel() == 0:
        return pv
    lad = (ctypes.c_int * len(ladder))(*ladder)
    _lib.launch(
        "gm_tc_tail_count", mats.device,
        mats.data_ptr(), lad, len(ladder), _TAIL_WIDE_FROM, gk.data_ptr(),
        fa.data_ptr(), fb.data_ptr(), sp.data_ptr(), gk.numel(),
        pv.data_ptr())
    LAUNCHES["tail_count"] += 1
    return pv


# ------------------------------------------------------------ host prep

def _tc_prep_native(src0, dst0, n, h, assume_canonical):
    """The host prep through the port's host library
    (``graphmat_tpu/ops/triangles.py:73-108``): the outputs of
    :func:`_tc_prep_numpy`, array for array; None for an empty edge list,
    which the numpy prep takes."""
    if not len(src0):
        return None
    from ..native import load
    lib = load()
    u = np.ascontiguousarray(src0, np.int32)
    v = np.ascontiguousarray(dst0, np.int32)
    m_out, m2_out = ctypes.c_int64(), ctypes.c_int64()
    ncr_out = ctypes.c_int32()
    hd = lib.gm_tc_create(u.ctypes.data, v.ctypes.data, len(u), n, h,
                          1 if assume_canonical else 0,
                          ctypes.byref(m_out), ctypes.byref(m2_out),
                          ctypes.byref(ncr_out))
    m, m2, ncr = int(m_out.value), int(m2_out.value), int(ncr_out.value)
    W = (min(h, n) + 31) // 32
    try:
        out = dict(s_all=np.empty(m, np.int32), r_all=np.empty(m, np.int32),
                   iu_row=np.empty(m, np.int32), iv_row=np.empty(m, np.int32),
                   bitmap=np.zeros((ncr + 1, W), np.uint32),
                   s2=np.empty(m2, np.int32), r2=np.empty(m2, np.int32),
                   t2rank=np.empty(m2, np.int32), t_of=np.empty(n, np.int32),
                   odeg=np.empty(n, np.int32))
        lib.gm_tc_fill(hd, *(out[k].ctypes.data for k in (
            "s_all", "r_all", "iu_row", "iv_row", "bitmap", "s2", "r2",
            "t2rank", "t_of", "odeg")))
    finally:
        lib.gm_tc_destroy(hd)
    return dict(m=m, ncr=ncr, W=W, **out)


def _tc_prep_numpy(src0, dst0, n, h, assume_canonical):
    """The host prep in numpy (``graphmat_tpu/ops/triangles.py:111``):
    dedup, ranks, orientation, the bitmap and the tail ranks."""
    u = np.asarray(src0, np.int64)
    v = np.asarray(dst0, np.int64)
    keep = u != v
    u, v = u[keep], v[keep]
    key = np.minimum(u, v) * np.int64(n) + np.maximum(u, v)
    if not assume_canonical:
        key = np.sort(key)
        if len(key):
            key = key[np.r_[True, key[1:] != key[:-1]]]
    a, b = key // n, key % n
    deg = (np.bincount(a, minlength=n)
           + np.bincount(b, minlength=n)).astype(np.int64)
    order = np.lexsort((np.arange(n), deg))
    rank_of = np.empty(n, np.int64)
    rank_of[order] = np.arange(n)
    fwd = rank_of[a] < rank_of[b]
    s = np.where(fwd, a, b)
    r = np.where(fwd, b, a)
    so = np.argsort(s, kind="stable")
    s, r = s[so], r[so]
    m = len(s)
    odeg = np.bincount(s, minlength=n).astype(np.int32)

    h_eff = min(h, n)
    core_lo = n - h_eff
    W = (h_eff + 31) // 32
    rk = rank_of[r]
    is_core = rk >= core_lo
    t_of = np.bincount(s[~is_core], minlength=n).astype(np.int32)
    core_cnt = odeg - t_of
    crow = np.full(n, -1, np.int64)
    has_core = np.flatnonzero(core_cnt > 0)
    crow[has_core] = np.arange(len(has_core))
    ncr = len(has_core)

    bitmap = np.zeros((ncr + 1) * W, np.uint32)
    bit = (rk[is_core] - core_lo).astype(np.int64)
    word = crow[s[is_core]] * W + (bit >> 5)
    np.bitwise_or.at(bitmap, word, np.uint32(1) << (bit & 31).astype(
        np.uint32))
    bitmap = bitmap.reshape(ncr + 1, W)

    iu_row = np.where(crow[s] < 0, ncr, crow[s]).astype(np.int32)
    iv_row = np.where(crow[r] < 0, ncr, crow[r]).astype(np.int32)
    s2 = s[~is_core].astype(np.int32)
    r2 = r[~is_core].astype(np.int32)
    t2off = np.concatenate([[0], np.cumsum(t_of, dtype=np.int64)])
    t2rank = (np.arange(len(s2)) - t2off[s2]).astype(np.int32)
    return dict(m=m, s_all=s.astype(np.int32), r_all=r.astype(np.int32),
                iu_row=iu_row, iv_row=iv_row, bitmap=bitmap, s2=s2,
                r2=r2, t2rank=t2rank, t_of=t_of,
                odeg=odeg, ncr=ncr, W=W)


def _prep(src0, dst0, n, h=None, assume_canonical=False):
    """The host route's packing (``graphmat_tpu/ops/triangles.py:168``):
    the bitmap, the per-edge rows, the tail-class ladder and matrices
    (``[rows + 1, D]`` each, its lists sorted ascending, a last row of
    pads) and one entry per nonempty class pair: ``(cs, cr, sender,
    row_s, row_r)`` of its probes."""
    if h is None:
        h = CORE_H
    d = _tc_prep_native(src0, dst0, n, h, assume_canonical)
    if d is None:
        d = _tc_prep_numpy(src0, dst0, n, h, assume_canonical)
    t_of = d["t_of"]
    s2, r2 = d["s2"], d["r2"]
    probe = t_of[r2] > 0           # t_of[s2] > 0 by construction
    sp, rp = s2[probe], r2[probe]

    tmax = int(t_of.max()) if n else 0
    ladder = [c for c in (16, 64, 256, 1024, 4096) if c < tmax]
    ladder = sorted(set(ladder + ([_pow2ceil(tmax)] if tmax else [])))
    mats = []
    row_in_cls = np.full(n, -1, np.int64)
    if tmax:
        cls_of = np.searchsorted(ladder, np.maximum(t_of, 1))
        cls_edge = cls_of[s2]
        for ci, D in enumerate(ladder):
            vs = np.flatnonzero((cls_of == ci) & (t_of > 0))
            row_in_cls[vs] = np.arange(len(vs))
            mat = np.full((max(len(vs), 1) + 1, D), PAD_ID, np.int32)
            if len(vs):
                em = cls_edge == ci
                mat[row_in_cls[s2[em]], d["t2rank"][em]] = r2[em]
            mats.append(np.sort(mat, axis=1))   # T2 searches sorted lists

    groups = []
    if len(sp):
        cls_s = cls_of[sp]
        cls_r = cls_of[rp]
        gkey = cls_s * len(ladder) + cls_r
        for gk in np.flatnonzero(np.bincount(gkey,
                                             minlength=len(ladder) ** 2)):
            sel = np.flatnonzero(gkey == gk)
            cs, cr = divmod(int(gk), len(ladder))
            groups.append((cs, cr, sp[sel], row_in_cls[sp[sel]],
                           row_in_cls[rp[sel]]))
    return dict(bitmap=d["bitmap"], iu=d["iu_row"], iv=d["iv_row"],
                s=d["s_all"], ladder=ladder, mats=mats, groups=groups)


def _tail_order(ladder, cs, cr):
    """The place of class pair ``(cs, cr)``'s probes among T2's: the
    narrow pairs' before the wide pairs', each by ``cs * len(ladder) +
    cr``."""
    n = len(ladder)
    wide = min(ladder[cs], ladder[cr]) >= _TAIL_WIDE_FROM
    return (n * n if wide else 0) + cs * n + cr


# the device prep's sort key of a probe's ``gkey`` (no probe, ``_NC *
# _NC``, last)
_TAIL_RANK = torch.tensor([_tail_order(_LADDER, g // _NC, g % _NC)
                           for g in range(_NC * _NC)] + [2 * _NC * _NC],
                          dtype=torch.int32)


def _count_host(host, nacc, device):
    """The host route's count on ``device``: T1 over every edge, T2 over
    the probes of every class pair; int32 ``[nacc]``."""
    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)
    bm = host["bitmap"]
    W4 = _round4(bm.shape[1])
    bmp = np.zeros((bm.shape[0], W4), np.uint32)
    bmp[:, :bm.shape[1]] = bm
    pv = torch.zeros(nacc, dtype=torch.int32, device=device)
    core_count(up(bmp.view(np.int32)), up(_tc_summary_host(bmp)),
               up(host["iu"]), up(host["iv"]), up(host["s"]), pv)
    if host["groups"]:
        ladder, mats = host["ladder"], host["mats"]
        sizes = [m.size for m in mats]
        base = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        if sum(sizes) >= 2 ** 31:
            raise ValueError("tail lists past 2^31 entries")
        L = len(ladder)
        gk, fa, fb, sp = [], [], [], []
        for cs, cr, snd, ru, rv in sorted(
                host["groups"],
                key=lambda g: _tail_order(ladder, g[0], g[1])):
            gk.append(np.full(len(snd), cs * L + cr))
            fa.append(base[cs] + ru * ladder[cs])
            fb.append(base[cr] + rv * ladder[cr])
            sp.append(snd)
        flat = np.concatenate([m.reshape(-1) for m in mats])
        tail_count(up(flat), ladder, *(up(np.concatenate(x))
                                       for x in (gk, fa, fb, sp)), pv)
    return pv


# ---------------------------------------------------------- device prep

def _tc_stats(u, v, n, h, canonical):
    """The first half of the device prep (``graphmat_tpu/ops/
    triangles.py:300``): dedup (sentinelised), (degree, id) ranks,
    orientation, per-vertex tallies and the per-edge planes.  ``u`` and
    ``v`` are int64 tensors.  Returns the int32 edge planes ``s, r,
    rk_r, iu, iv, gkey, frs, frr`` and the int64 stats vector (``ncr``,
    the rows of each class, the size of each class pair's group).
    Self loops and duplicates become edges (n, n), which count 0."""
    dev = u.device
    i32 = torch.int32
    h_eff = min(h, n)
    core_lo = n - h_eff
    valid = u != v
    a = torch.where(valid, torch.minimum(u, v), n)
    b = torch.where(valid, torch.maximum(u, v), n)
    del valid
    if not canonical:
        key = torch.sort(a * (n + 1) + b).values
        a, b = key // (n + 1), key % (n + 1)
        dup = torch.zeros_like(key, dtype=torch.bool)
        dup[1:] = key[1:] == key[:-1]
        del key
        a = a.masked_fill(dup, n)
        b = b.masked_fill(dup, n)
        del dup
    deg = (torch.bincount(a, minlength=n + 1)
           + torch.bincount(b, minlength=n + 1))
    iota_n = torch.arange(n, device=dev)
    order = torch.sort(deg[:n] * (n + 1) + iota_n).values % (n + 1)
    rank_of = torch.empty(n + 1, dtype=torch.int64, device=dev)
    rank_of[order] = iota_n
    rank_of[n] = n
    del deg, order
    ra, rb = rank_of[a], rank_of[b]
    fwd = ra < rb
    s = torch.where(fwd, a, b)
    r = torch.where(fwd, b, a)
    rk_r = torch.where(fwd, rb, ra)
    live = a < n
    del a, b, ra, rb, fwd
    is_tail = live & (rk_r < core_lo)
    is_core = live & (rk_r >= core_lo)
    del live
    t_of = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, s, is_tail.long())[:n]
    core_cnt = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, s, is_core.long())[:n]
    del is_core

    has_core = core_cnt > 0
    csum = torch.cumsum(has_core.long(), 0)
    ncr = csum[-1]
    crow_v = torch.where(has_core, csum - 1, ncr)

    ladder = torch.tensor(_LADDER, dtype=torch.int64, device=dev)
    cls_of = torch.searchsorted(ladder, t_of.clamp(min=1)).clamp_(
        max=_NC - 1)
    has_t = t_of > 0
    rowc = torch.zeros(_NC, dtype=torch.int64, device=dev).index_add_(
        0, cls_of, has_t.long())
    # a tailed vertex's row within its class: its place, by id, among
    # the tailed vertices of that class
    ck = torch.where(has_t, cls_of, _NC)
    by_cls = torch.sort(ck, stable=True).indices
    start = torch.cumsum(torch.bincount(ck, minlength=_NC + 1), 0)
    start = start - torch.bincount(ck, minlength=_NC + 1)
    row_in_cls = torch.empty(n, dtype=torch.int64, device=dev)
    row_in_cls[by_cls] = iota_n - start[ck[by_cls]]
    row_in_cls = torch.where(has_t, row_in_cls, 0)
    del ck, by_cls, start
    sizes_c = torch.where(rowc > 0, (rowc + 1) * ladder, 0)
    base_c = torch.cumsum(sizes_c, 0) - sizes_c
    flatrow_v = base_c[cls_of] + row_in_cls * ladder[cls_of]

    def ext(x):   # a per-vertex column with the sentinel row n (0)
        return torch.cat((x.to(i32), x.new_zeros(1, dtype=i32)))
    crow_x = ext(crow_v)
    crow_x[n] = ncr.to(i32)
    tail_x, cls_x, flat_x = ext(has_t), ext(cls_of), ext(flatrow_v)
    iu, iv = crow_x[s], crow_x[r]
    frs, frr = flat_x[s], flat_x[r]
    probe = is_tail & (tail_x[s] > 0) & (tail_x[r] > 0)
    gkey = torch.where(probe, cls_x[s] * _NC + cls_x[r], _NC * _NC)
    gsizes = torch.bincount(gkey.long(), minlength=_NC * _NC + 1)
    stats = torch.cat((ncr.reshape(1), rowc, gsizes))
    return (s.to(i32), r.to(i32), rk_r.to(i32), iu, iv, gkey.to(i32), frs,
            frr, stats)


def _group_cfg(stats):
    """The host side of the seam between the two halves: the sizes the
    second half allocates, from the stats vector (``graphmat_tpu/ops/
    triangles.py:387``).  Returns ``(ncr, mats_size, nprobe)``: the
    bitmap's rows, the tail lists' entries and the probes."""
    stats = torch.as_tensor(stats).cpu().numpy().astype(np.int64)
    rowc = stats[1:1 + _NC]
    mats_size = np.where(rowc > 0, (rowc + 1) * np.asarray(_LADDER), 0)
    return (int(stats[0]), int(mats_size.sum()),
            int(stats[1 + _NC:1 + _NC + _NC * _NC].sum()))


def _pack_summary(nz):
    """T1's summaries from a 0/1 uint8 ``[rows, W4]`` of the bitmap's
    nonzero words: int32 ``[rows, ceil(W4 / 32)]``, bit ``j`` of a row
    for word ``j`` (8 words a byte, little-endian)."""
    rows, w4 = nz.shape
    sw = _summary_words(w4)
    if sw == 0:   # no core (h = 0)
        return torch.zeros((rows, 0), dtype=torch.int32, device=nz.device)
    if sw * 32 != w4:
        nz = torch.nn.functional.pad(nz, (0, sw * 32 - w4))
    pow2 = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                        device=nz.device)
    packed = (nz.reshape(rows, sw * 4, 8) * pow2).sum(-1, dtype=torch.uint8)
    return packed.contiguous().view(torch.int32)


def _tc_summary_host(bm):
    """The host prep's T1 summaries of a uint32 bitmap ``[rows, W4]``."""
    rows, w4 = bm.shape
    packed = np.zeros((rows, _summary_words(w4) * 4), np.uint8)
    if w4:
        bits = np.packbits(bm != 0, axis=1, bitorder="little")
        packed[:, :bits.shape[1]] = bits
    return packed.view(np.int32)


def _tc_bitmap(s, rk_r, iu, n, h, ncr):
    """The core bitmap, int32 ``[ncr + 1, W4]``: a bit per core rank, its
    words built by adding distinct powers of two (bit 31 is INT_MIN and
    nothing carries; T1 reads them as uint32), ``W`` padded to ``W4``, a
    multiple of 4, with zero words, and a last row of zeros; and its
    summaries (:func:`_pack_summary`), marked from the same core edges'
    words.  Returns ``(bm, sm)``."""
    h_eff = min(h, n)
    core_lo = n - h_eff
    W4 = _round4((h_eff + 31) // 32)
    # only the core edges add: the others, the tail edges most of all,
    # would pile their zeros onto one word, whose atomics serialise
    # (PERF.md, section 6)
    is_core = (s < n) & (rk_r >= core_lo)
    bit = (rk_r[is_core] - core_lo).long()
    word = iu[is_core].long() * W4 + (bit >> 5)
    bitv = torch.bitwise_left_shift(torch.ones_like(bit), bit & 31)
    bitv = (bitv - ((bitv >> 31) << 32)).to(torch.int32)  # 2^31: INT_MIN
    bm = torch.zeros((ncr + 1) * W4, dtype=torch.int32, device=s.device)
    bm.index_add_(0, word, bitv)
    del bitv
    nz = torch.zeros((ncr + 1) * W4, dtype=torch.uint8, device=s.device)
    nz[word] = 1
    return bm.view(ncr + 1, W4), _pack_summary(nz.view(ncr + 1, W4))


def _tc_tails(s, r, rk_r, gkey, frs, frr, n, h, mats_size, nprobe):
    """The tail lists and the probes, T2's arguments ``(mats, gk, fa, fb,
    sp)``: a sort on (flat row, receiver) packs each sender's tail list
    ascending at its flat row of ``mats`` (the rest of the row pads), and
    a stable sort on the class pair lists the probes first, by pair, the
    narrow pairs' before the wide pairs' (:func:`_tail_order`)."""
    if mats_size >= 2 ** 31:
        raise ValueError("tail lists past 2^31 entries")
    dev = s.device
    is_tail = (s < n) & (rk_r < n - min(h, n))
    big = torch.iinfo(torch.int64).max
    key = torch.where(is_tail, frs.long() * (n + 1) + r.long(), big)
    key = torch.sort(key).values
    valid = key < big
    tk = key // (n + 1)
    r_s = (key % (n + 1)).to(torch.int32)
    del key, is_tail
    # an entry's rank in its list: its place less its list's first place,
    # by a search of the sorted keys (torch.cummax is far slower on the
    # card; PERF.md, section 6)
    t2rank = torch.arange(tk.numel(), device=dev) - torch.searchsorted(
        tk, tk)
    midx = torch.where(valid, tk + t2rank, mats_size)
    del tk, t2rank
    mats = torch.full((mats_size + 1,), PAD_ID, dtype=torch.int32,
                      device=dev)
    mats[midx] = r_s   # the entries past the lists land on the spare
    mats[mats_size] = PAD_ID
    del midx, r_s, valid
    idx = torch.sort(_TAIL_RANK.to(dev)[gkey.long()],
                     stable=True).indices[:nprobe]
    return mats, gkey[idx], frs[idx], frr[idx], s[idx]


def _kernel_args(u, v, n, h=None, canonical=False):
    """The device prep (``graphmat_tpu/ops/triangles.py:300-511``) of the
    int64 edges ``u``, ``v`` (core size ``h``, default CORE_H): yields
    T1's arguments ``(bm, sm, iu, iv, s)``, then, when some edge probes, T2's
    ``(mats, ladder, gk, fa, fb, sp)``.  A generator, so that the bitmap
    can go before the tail lists are built; the count and the card's
    checks of the kernels both run on it."""
    h = CORE_H if h is None else h
    s, r, rk_r, iu, iv, gkey, frs, frr, stats = _tc_stats(u, v, n, h,
                                                          canonical)
    ncr, mats_size, nprobe = _group_cfg(stats)
    yield *_tc_bitmap(s, rk_r, iu, n, h, ncr), iu, iv, s
    if nprobe:
        mats, *probes = _tc_tails(s, r, rk_r, gkey, frs, frr, n, h,
                                  mats_size, nprobe)
        yield (mats, _LADDER, *probes)


def _total(pv, n) -> int:
    """The exact sum of the first ``n`` counts, read to the host."""
    total = pv[:n].sum(dtype=torch.int64)
    copied("dtoh", total)
    return int(total)


def _count_triangles_devprep(u, v, n, n_pad, h, assume_canonical):
    nacc = max(n_pad, n) + 1   # bin n takes nothing: every count there is 0
    pv = torch.zeros(nacc, dtype=torch.int32, device=u.device)
    if u.numel() == 0:
        return pv[:n_pad], 0
    args = _kernel_args(u, v, n, h, bool(assume_canonical))
    core_count(*next(args), pv)
    for t2 in args:
        tail_count(*t2, pv)
    return pv[:n_pad], _total(pv, n)


def _device(src0):
    if isinstance(src0, torch.Tensor):
        return src0.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "count_triangles_bucketed: no CUDA device is available for "
            "numpy input; pass CPU tensors to count on the CPU")
    return torch.device("cuda")


def count_triangles_bucketed(src0, dst0, n, n_pad=None, h=None,
                             assume_canonical=False, impl="device"):
    """Exact triangle counts from a 0-based edge list (any orientation;
    duplicates and self loops are dropped unless ``assume_canonical``
    promises unique ``src0 < dst0`` pairs, which skips the dedup sort).

    ``src0`` and ``dst0`` are numpy arrays or torch tensors.  The count
    runs on the tensors' device, or on the card for numpy input (which
    raises without a GPU).  Returns ``(per_vertex, total)``:
    ``per_vertex`` an int32 tensor of length ``n_pad`` (default ``n``) on
    that device, attributing each triangle to its degree-minimum vertex,
    and ``total`` an exact Python int.
    ``impl="device"`` (the default) preps on the device;
    ``impl="host"`` preps on the host, natively (see the module
    docstring)."""
    if n_pad is None:
        n_pad = n
    dev = _device(src0)
    if impl == "device":
        u = torch.as_tensor(src0, device=dev).long()
        v = torch.as_tensor(dst0, device=dev).long()
        return _count_triangles_devprep(u, v, n, n_pad, h,
                                        assume_canonical)
    if impl != "host":
        raise ValueError(f"impl={impl!r}: use 'device' or 'host'")

    def host(a):
        return (a.cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))
    hst = _prep(host(src0), host(dst0), n, h=h,
                assume_canonical=assume_canonical)
    pv = _count_host(hst, max(n_pad, n) + 1, dev)
    return pv[:n_pad], _total(pv, n)
