"""K2: operand compaction for the SpMV, and its gather kernel.

Counterpart of ``graphmat_tpu/ops/pallas_compact.py``.  On the TPU,
straggler edges (a sender window that holds few of a receiver block's
edges) read their sender's value from a compacted copy of the operand
that one gather pass builds per super-block of receiver blocks, so the
SpMV walks dense windows.  Here the same rule picks the same edges, and
the copy is an extension beside the operand: position ``p`` holds
``x[src_of_pos[p]]`` (and, in the sparse modes, ``sent[src_of_pos[p]]``),
and a diverted edge reads sender ``n_send + p``.  K1 reads the other
senders from the operand itself, so nothing copies it.

:func:`aux_gather` launches the hand-written kernel
``graphmat_tpu_torch/csrc/compact.cu`` on a CUDA tensor, once per SpMV
for the value and the flag together, and runs
:func:`aux_gather_reference` on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["H_COMPACT_MIN", "QUAD", "compact_enabled", "compact_auto",
           "divert_stragglers", "pad_positions", "aux_gather",
           "aux_gather_reference", "LAUNCHES"]

LANE = 128
# the JAX trigger (pallas_compact.py:64, pallas_spmv2u.py:706 and 731):
# compaction is on from 8192 operand rows of 128 senders
H_COMPACT_MIN = 8192
HUB_MAX = 16 * LANE   # build_spmv2u_plan clamps the hub to this
QUAD = 4   # positions a K2 thread takes; the CSR pads src_of_pos to it

# launches of the compaction gather kernel; only aux_gather adds to it
LAUNCHES = {"aux_gather": 0}


def compact_enabled(n_send: int) -> bool:
    """The JAX rule for ``compact="auto"``: ceil(n/128), rounded up to a
    multiple of 128, reaches :data:`H_COMPACT_MIN`."""
    rows = -(-n_send // LANE)
    h = max(-(-rows // LANE) * LANE, LANE)
    return h >= H_COMPACT_MIN


def compact_auto(n_send: int, device) -> bool:
    """What ``compact="auto"`` does for an operand of ``n_send`` senders
    on ``device``: on the card, never compact; elsewhere the JAX rule
    (:func:`compact_enabled`), as the port's parity tests expect.

    On an H100 (80GB HBM3, 700 W) compaction pays at neither scale
    measured, below or above the card's 50 MB L2 (PERF.md §6): the
    dense PageRank step on a degree-permuted RMAT-22 (a 16.8 MB operand)
    is never faster compacted (0.03-0.10 ms slower in four runs of six,
    within the noise in the others), and on RMAT-24 (67 MB, with 17.2M
    extension positions) 1.4-3% slower in every run.  K1 alone gains at
    most 1.5% there, less than the gather costs.  ``compact=True`` still
    compacts, with the same results bitwise."""
    if torch.device(device).type == "cuda":
        return False
    return compact_enabled(n_send)


def divert_stragglers(senders: torch.Tensor, receivers: torch.Tensor,
                      n_send: int, wr: int = 4096, hub: int = 2048,
                      divert_min: int = 6000, bpsb: int = 32,
                      w_div: int = 2048):
    """Rewrite straggler edges to read a compacted operand extension.

    The rule of ``pallas_compact.py:divert_stragglers`` (175-198): an edge
    diverts when its sender id is at least ``hub`` (clamped to 2048, as
    ``build_spmv2u_plan`` does) and its cell, the pair (receiver block of
    ``wr`` ids, sender window of ``w_div * 128`` ids), holds fewer than
    ``divert_min`` edges.  The extension's positions are the distinct
    (super-block of ``bpsb`` receiver blocks, sender) pairs of the diverted
    edges, in super-block order and then sender order.

    Returns ``(senders_ext, src_of_pos)``: int32 senders where each
    diverted edge reads ``n_send + position``, and the int32 sender of each
    position (empty when nothing diverts).
    """
    s = senders.long()
    r = receivers.long()
    hub = min(hub, HUB_MAX)
    h = -(-n_send // LANE)
    nwin = max(-(-h // w_div), 1)
    blk = r // wr
    cell = blk * nwin + (s // LANE) // w_div
    cnt = torch.bincount(cell)
    div = (s >= hub) & (cnt[cell] < divert_min)
    del cell, cnt
    if not bool(div.any()):
        return senders.to(torch.int32), torch.empty(
            0, dtype=torch.int32, device=senders.device)
    key = ((blk[div] // bpsb) << 34) | s[div]
    uniq, pos = torch.unique(key, sorted=True, return_inverse=True)
    src_of_pos = (uniq & ((1 << 34) - 1)).to(torch.int32)
    s_ext = s.clone()
    s_ext[div] = n_send + pos
    return s_ext.to(torch.int32), src_of_pos


def pad_positions(src_of_pos: torch.Tensor) -> torch.Tensor:
    """``src_of_pos`` padded with sender 0 to a multiple of :data:`QUAD`
    positions, so that K2's threads take whole quads; no edge reads a
    pad position."""
    pad = -src_of_pos.numel() % QUAD
    if not pad:
        return src_of_pos
    return torch.cat((src_of_pos, src_of_pos.new_zeros(pad)))


def aux_gather_reference(x: torch.Tensor, src_of_pos: torch.Tensor,
                         sent: torch.Tensor = None):
    """Plain version of K2: ``x[src_of_pos]``, and with ``sent`` also
    ``sent[src_of_pos]``."""
    idx = src_of_pos.long()
    return x[idx] if sent is None else (x[idx], sent[idx])


def _check(x, src_of_pos, out, sent, sent_out):
    if x.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"aux_gather takes a float32 x and out, not "
                        f"{x.dtype} and {out.dtype}")
    if src_of_pos.dtype != torch.int32:
        raise TypeError("src_of_pos must be int32")
    if (sent is None) != (sent_out is None):
        raise ValueError("aux_gather takes sent and sent_out together")
    ts = [(x, 1), (src_of_pos, 16), (out, 16)]
    if sent is not None:
        if sent.dtype != torch.uint8 or sent_out.dtype != torch.uint8:
            raise TypeError("sent and sent_out must be uint8")
        if sent.shape != x.shape:
            raise ValueError("sent must hold one flag per sender of x")
        ts += [(sent, 1), (sent_out, 4)]
    for t, align in ts:
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("aux_gather takes contiguous 1-D tensors")
        if t.device != x.device:
            raise ValueError("aux_gather's tensors must share one device")
        if t.data_ptr() % align:
            raise ValueError(f"aux_gather: src_of_pos and out must start "
                             f"on a 16-byte boundary, sent_out on a 4-byte "
                             f"one (a tensor starts at {t.data_ptr():#x})")
    for t in (out, sent_out):
        if t is not None and t.shape != src_of_pos.shape:
            raise ValueError("out and sent_out must match src_of_pos")


def aux_gather(x: torch.Tensor, src_of_pos: torch.Tensor,
               out: torch.Tensor, sent: torch.Tensor = None,
               sent_out: torch.Tensor = None):
    """``out[p] = x[src_of_pos[p]]`` for a float32 operand, copied bit for
    bit, and with ``sent`` (uint8, one flag per sender) also ``sent_out[p]
    = sent[src_of_pos[p]]`` in the same launch.  Returns ``out``, or
    ``(out, sent_out)``.  ``src_of_pos`` and ``out`` start on a 16-byte
    boundary and ``sent_out`` on a 4-byte one (fresh tensors do);
    ``src_of_pos`` must index into ``x`` (the Graph constructor guarantees
    it; it is not re-checked per call)."""
    _check(x, src_of_pos, out, sent, sent_out)
    res = out if sent is None else (out, sent_out)
    if x.device.type == "cpu":
        ref = aux_gather_reference(x, src_of_pos, sent)
        if sent is None:
            return out.copy_(ref)
        out.copy_(ref[0])
        sent_out.copy_(ref[1])
        return res
    if x.device.type != "cuda":
        raise RuntimeError(f"aux_gather has no kernel for {x.device}")
    n = src_of_pos.numel()
    if n == 0:
        return res
    _lib.launch(
        "gm_aux_gather", x.device,
        x.data_ptr(), None if sent is None else sent.data_ptr(),
        src_of_pos.data_ptr(), out.data_ptr(),
        None if sent_out is None else sent_out.data_ptr(), n)
    LAUNCHES["aux_gather"] += 1
    return res
