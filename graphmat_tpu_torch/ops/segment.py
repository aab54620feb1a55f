"""Segment reductions over edges: the ⊕ of a program with no semiring.

Counterpart of ``graphmat_tpu/ops/segment.py``.  Contributions are
reduced into their receivers with ``scatter_reduce_`` over an
identity-filled output (``include_self=True``), leafwise over dicts,
lists and tuples of tensors.  The generic associative-scan reduce and
the concat reduce of vector messages are not ported yet.
"""

from __future__ import annotations

import torch

from ..core.tree import tree_map
from ..core.types import Monoid

__all__ = ["segment_reduce", "segment_reduce_tree", "segment_any",
           "masked_fill_identity"]

_SCATTER = {"sum": "sum", "min": "amin", "any": "amin", "max": "amax"}


def _bcast(mask, like):
    """Broadcast a 1-D edge mask against trailing feature dims."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def segment_reduce(monoid: Monoid, data, seg_ids, num_segments: int):
    """Reduce ``data`` (leading edge dim) into ``num_segments`` buckets;
    a bucket no edge reaches holds the identity."""
    if monoid.kind == "or":
        return segment_any(data.bool(), seg_ids, num_segments)
    if monoid.kind not in _SCATTER:
        raise NotImplementedError(
            f"Monoid kind {monoid.kind!r} has no segment reduce in "
            "graphmat_tpu_torch yet")
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


def masked_fill_identity(monoid, data_tree, mask):
    """Replace the contributions of edges where ``mask`` is False with the
    monoid's identity."""
    def fill(m: Monoid, leaf):
        return leaf.masked_fill(~_bcast(mask, leaf), m.identity(leaf.dtype))

    if isinstance(monoid, Monoid):
        return tree_map(lambda leaf: fill(monoid, leaf), data_tree)
    return tree_map(fill, monoid, data_tree)
