"""Segment reductions over edges: the ⊕ of a program with no semiring.

Counterpart of ``graphmat_tpu/ops/segment.py``.  Contributions are
reduced into their receivers with ``scatter_reduce_`` over an
identity-filled output (``include_self=True``), leafwise over dicts,
lists and tuples of tensors.  A generic :class:`Monoid` (an arbitrary
associative ``combine_fn``) reduces by a log-depth segmented scan over
receiver-sorted edges (:func:`_generic_segment_reduce`), the counterpart
of the JAX package's ``lax.associative_scan``.  A vector-message
program's ⊕ is the concat reduce, :func:`segment_concat`.
"""

from __future__ import annotations

import torch

from ..core.tree import tree_map
from ..core.types import Monoid

__all__ = ["segment_reduce", "segment_reduce_tree", "segment_any",
           "segment_concat", "segment_concat_tree", "masked_fill_identity"]

_SCATTER = {"sum": "sum", "min": "amin", "any": "amin", "max": "amax"}


def _bcast(mask, like):
    """Broadcast a 1-D edge mask against trailing feature dims."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _generic_segment_reduce(monoid: Monoid, data, seg_ids,
                            num_segments: int):
    """Sorted-segment reduce for an arbitrary associative combine
    (``graphmat_tpu/ops/segment.py:60-80``): a segmented inclusive scan of
    the pairs ``(segment-start flag, value)`` whose operator restarts at a
    flag, in Hillis-Steele form on the tensors' device.  Step ``d`` (1,
    2, 4, ...) sets ``v[i] = combine(v[i - d], v[i])`` where no flag lies
    in ``(i - d, i]``, so after ``ceil(log2(L))`` steps, ``L`` the longest
    segment (one host read), each segment's last position holds its
    total in edge order; ``combine_fn`` runs once per step on whole
    tensors.  ``seg_ids`` must ascend; ids outside ``[0, num_segments)``
    drop."""
    e = data.shape[0]
    out = torch.full((num_segments,) + tuple(data.shape[1:]),
                     monoid.identity(data.dtype), dtype=data.dtype,
                     device=data.device)
    if e == 0:
        return out
    seg = seg_ids.long()
    flag = torch.ones(e, dtype=torch.bool, device=data.device)
    flag[1:] = seg[1:] != seg[:-1]
    last = torch.ones_like(flag)
    last[:-1] = flag[1:]
    starts = torch.nonzero(flag).squeeze(1)
    longest = int(torch.diff(starts, append=starts.new_tensor([e])).max())
    v, d = data, 1
    while d < longest:
        later = v[d:]
        step = torch.where(_bcast(flag[d:], later), later,
                           monoid.combine(v[:-d], later))
        v = torch.cat((v[:d], step.to(data.dtype)))
        flag = torch.cat((flag[:d], flag[d:] | flag[:-d]))
        d *= 2
    ids = seg[last]
    keep = (ids >= 0) & (ids < num_segments)
    out[ids[keep]] = v[last][keep]
    return out


def segment_reduce(monoid: Monoid, data, seg_ids, num_segments: int):
    """Reduce ``data`` (leading edge dim) into ``num_segments`` buckets;
    a bucket no edge reaches holds the identity.  A generic monoid needs
    ascending ``seg_ids`` (receiver-sorted edges)."""
    if monoid.kind == "or":
        return segment_any(data.bool(), seg_ids, num_segments)
    if monoid.kind == "generic":
        return _generic_segment_reduce(monoid, data, seg_ids, num_segments)
    if monoid.kind not in _SCATTER:
        raise ValueError(f"unknown monoid kind {monoid.kind}")
    out = torch.full((num_segments,) + tuple(data.shape[1:]),
                     monoid.identity(data.dtype), dtype=data.dtype,
                     device=data.device)
    idx = _bcast(seg_ids.long(), data).expand_as(data)
    return out.scatter_reduce_(0, idx, data, _SCATTER[monoid.kind],
                               include_self=True)


def segment_reduce_tree(monoid, data_tree, seg_ids, num_segments: int):
    """Leafwise :func:`segment_reduce`; ``monoid`` is one Monoid for
    every leaf or a tree of monoids shaped like ``data_tree``."""
    if isinstance(monoid, Monoid):
        return tree_map(lambda leaf: segment_reduce(
            monoid, leaf, seg_ids, num_segments), data_tree)
    return tree_map(lambda m, leaf: segment_reduce(
        m, leaf, seg_ids, num_segments), monoid, data_tree)


def segment_any(mask, seg_ids, num_segments: int):
    """Per-segment OR of a boolean edge mask (``got_message``)."""
    out = torch.zeros(num_segments, dtype=torch.bool, device=mask.device)
    out[seg_ids[mask].long()] = True
    return out


def segment_concat(data, ok, seg_ids, num_segments: int, width: int, pad):
    """Concat reduce: each segment's OK contributions collected into a
    padded row of static ``width``, the form the reference's
    variable-length messages reduced by vector append take here
    (``src/TriangleCounting.cpp:92-109``).

    ``data`` is ``[e, ...]`` in receiver-sorted edge order, ``ok`` a bool
    ``[e]`` (the sender sent), ``pad`` the fill value (cast to the
    dtype).  Returns ``[num_segments, width, ...]``: a row's first k slots
    hold its k OK contributions in edge order; contributions past
    ``width`` drop."""
    seg = seg_ids.long()
    okx = ok.to(torch.int64)
    c = torch.cumsum(okx, 0) - okx   # OK edges before this one
    # seg_ids ascend, so a segment's least c is at its first edge
    base = torch.zeros(num_segments, dtype=torch.int64, device=c.device)
    base.scatter_reduce_(0, seg, c, "amin", include_self=False)
    rank = c - base[seg]
    row = torch.where(ok, seg, num_segments - 1)
    col = torch.where(ok & (rank < width), rank, width)
    out = torch.full((num_segments, width + 1) + tuple(data.shape[1:]),
                     pad, dtype=data.dtype, device=data.device)
    # the dropped and the not-OK contributions land in the extra column
    out[row, col] = data
    return out[:, :width]


def segment_concat_tree(data_tree, ok, seg_ids, num_segments: int,
                        width: int, pad):
    """Leafwise :func:`segment_concat` (``pad`` cast to each leaf)."""
    return tree_map(lambda leaf: segment_concat(
        leaf, ok, seg_ids, num_segments, width, pad), data_tree)


def masked_fill_identity(monoid, data_tree, mask):
    """Replace the contributions of edges where ``mask`` is False with the
    monoid's identity."""
    def fill(m: Monoid, leaf):
        return leaf.masked_fill(~_bcast(mask, leaf), m.identity(leaf.dtype))

    if isinstance(monoid, Monoid):
        return tree_map(lambda leaf: fill(monoid, leaf), data_tree)
    return tree_map(fill, monoid, data_tree)
