"""K2: operand compaction for the SpMV, and its gather kernel.

Counterpart of ``graphmat_tpu/ops/pallas_compact.py``.  On the TPU,
straggler edges (a sender window that holds few of a receiver block's
edges) read their sender's value from a compacted copy of the operand
that one gather pass builds per super-block of receiver blocks, so the
SpMV walks dense windows.  Here the same rule picks the same edges, and
the copy is a flat extension of the operand: position ``p`` holds
``x[src_of_pos[p]]``, and a diverted edge reads sender ``n_send + p``.

:func:`aux_gather` launches the hand-written kernel
``graphmat_tpu_torch/csrc/compact.cu`` on a CUDA tensor and runs
:func:`aux_gather_reference` on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["H_COMPACT_MIN", "compact_enabled", "divert_stragglers",
           "aux_gather", "aux_gather_reference", "LAUNCHES"]

LANE = 128
# the JAX trigger (pallas_compact.py:64, pallas_spmv2u.py:706 and 731):
# compaction is on from 8192 operand rows of 128 senders
H_COMPACT_MIN = 8192
HUB_MAX = 16 * LANE   # build_spmv2u_plan clamps the hub to this

# launches of the compaction gather kernel; only aux_gather adds to it
LAUNCHES = {"aux_gather": 0}


def compact_enabled(n_send: int) -> bool:
    """The JAX rule for ``compact="auto"``: ceil(n/128), rounded up to a
    multiple of 128, reaches :data:`H_COMPACT_MIN`."""
    rows = -(-n_send // LANE)
    h = max(-(-rows // LANE) * LANE, LANE)
    return h >= H_COMPACT_MIN


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


def aux_gather_reference(x: torch.Tensor,
                         src_of_pos: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: ``x[src_of_pos]``."""
    return x[src_of_pos.long()]


def aux_gather(x: torch.Tensor, src_of_pos: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """``out[p] = x[src_of_pos[p]]`` for a float32 operand or a uint8
    mask; returns ``out``.  ``src_of_pos`` must index into ``x`` (the
    Graph constructor guarantees it; it is not re-checked per call)."""
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"aux_gather takes float32 or uint8, not {x.dtype}")
    if src_of_pos.dtype != torch.int32:
        raise TypeError("src_of_pos must be int32")
    if out.dtype != x.dtype or out.shape != src_of_pos.shape:
        raise ValueError("out must match x's dtype and src_of_pos's shape")
    for t in (x, src_of_pos, out):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("aux_gather takes contiguous 1-D tensors")
        if t.device != x.device:
            raise ValueError("aux_gather's tensors must share one device")
    if x.device.type == "cpu":
        return out.copy_(aux_gather_reference(x, src_of_pos))
    if x.device.type != "cuda":
        raise RuntimeError(f"aux_gather has no kernel for {x.device}")
    n = src_of_pos.numel()
    if n == 0:
        return out
    lib = _lib.load()
    rc = lib.gm_aux_gather(x.data_ptr(), src_of_pos.data_ptr(),
                           out.data_ptr(), n, x.element_size(),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(lib, rc, "aux_gather")
    LAUNCHES["aux_gather"] += 1
    return out
