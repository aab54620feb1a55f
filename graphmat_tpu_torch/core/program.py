"""The GraphProgram vertex-program API.

Counterpart of ``graphmat_tpu/core/program.py``.  The reference's per-element
virtuals (``include/GraphProgram.h:38-101``) are vectorized torch functions
on whole tensors (leading dim = vertices or edges):

==============================  =============================================
reference (per element)          here (vectorized)
==============================  =============================================
``bool send_message(V, T&)``     ``send_message(state, vp) -> (msg, mask)``
``process_message(T,E,V,U&)``    ``process_message(state, msg, evals, vp_r)``
``reduce_function(U&, U)``       ``reduce`` — a :class:`Monoid` (or a dict
                                 of monoids)
``apply(U, V&)``                 ``apply(state, reduced, vp) -> vp``
``operator!=``                   ``changed(old_vp, new_vp) -> bool[n]``
``do_every_iteration(int)``      ``do_every_iteration(state, vp, it, ctx)``
==============================  =============================================

Vertex properties and messages are tensors or dicts of tensors; program
state is any such container.  A program that declares a :class:`Semiring`
runs its SpMV on the hand-written kernel; one that does not runs the
plain segment reduce of :mod:`graphmat_tpu_torch.ops.segment`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.spmv2u import PROCESS_OPS
from .tree import tree_leaves, tree_map
from .types import Activity, Direction, SUM

__all__ = ["GraphProgram", "IterationContext", "Semiring"]


def _identity_codec(x):
    return x


@dataclass(frozen=True)
class Semiring:
    """A program's semiring in the form the SpMV kernel executes.

    * ``reduce_kind`` ∈ {'sum', 'min', 'max', 'or', 'any'}: ⊕ over float32.
      'or' runs as max (encodings must be 0.0/1.0) and 'any' as min.
    * ``process_op``: the name of ⊗ in the kernel's closed set
      (:data:`~graphmat_tpu_torch.ops.spmv2u.PROCESS_OPS`: ``"x"``,
      ``"x_mul_val"``, ``"x_add_val"``); :attr:`process` is its torch
      function.  ⊗ must absorb the ⊕ identity.
    * ``encode(msg)`` maps the message to one float32 tensor of senders;
      ``decode(y)`` maps the reduced float32 tensor back to what ``apply``
      takes.  Integer payloads are exact below 2^24.
    * ``uses_edge_value``: False when ⊗ ignores the edge value; the
      engine then passes the kernel no values.
    """

    reduce_kind: str = "sum"
    process_op: str = "x"
    encode: Callable = _identity_codec
    decode: Callable = _identity_codec
    uses_edge_value: bool = True

    def __post_init__(self):
        if self.reduce_kind not in ("sum", "min", "max", "or", "any"):
            raise ValueError(f"Semiring reduce_kind {self.reduce_kind!r} "
                             "has no kernel (sum/min/max/or/any)")
        if self.process_op not in PROCESS_OPS:
            raise ValueError(f"Semiring process_op {self.process_op!r} is "
                             f"not one of {sorted(PROCESS_OPS)}")
        if self.process_op != "x" and not self.uses_edge_value:
            raise ValueError(f"process_op {self.process_op!r} reads the "
                             "edge value; uses_edge_value must be True")

    @property
    def process(self) -> Callable:
        """⊗ as a torch function ``(x, edge_val) -> contribution``."""
        return PROCESS_OPS[self.process_op]


class IterationContext:
    """Facilities available to ``do_every_iteration``.  On one device the
    cross-device reduce is the identity."""

    def all_reduce_sum(self, tree):
        return tree

    def masked_vertex_sum(self, values, valid_vertex):
        """Sum an ``[n_pad, ...]`` tensor (or tree) over valid vertices."""
        def one(leaf):
            mask = valid_vertex.reshape(
                valid_vertex.shape + (1,) * (leaf.dim() - 1))
            return torch.where(mask, leaf, torch.zeros_like(leaf)).sum(0)
        return self.all_reduce_sum(tree_map(one, values))


class GraphProgram:
    """Base class for vertex programs.  Subclass and override.

    * ``order``: :class:`Direction` (default OUT_EDGES)
    * ``activity``: :class:`Activity` (default ACTIVE_ONLY)
    * ``reduce``: the ⊕ monoid, or a dict of monoids shaped like the
      reduced message
    * ``process_requires_vertexprop``: False when ``process_message``
      ignores the receiver's property (skips a gather)
    """

    order: Direction = Direction.OUT_EDGES
    activity: Activity = Activity.ACTIVE_ONLY
    reduce: Any = SUM
    process_requires_vertexprop: bool = True
    vector_message: bool = False

    def init_state(self, graph) -> Any:
        """Initial program state."""
        return ()

    def send_message(self, state, vp) -> Tuple[Any, Optional[Any]]:
        """The message of every vertex ([n_pad] leading dim) and an
        optional bool send mask (None = all send).  Only vertices that are
        active and pass the mask reach any receiver."""
        raise NotImplementedError

    def process_message(self, state, msg, edge_vals, vp_receiver) -> Any:
        """⊗ on gathered sender messages ([nnz] leading dim), edge values
        and, with ``process_requires_vertexprop``, the receivers'
        gathered properties."""
        raise NotImplementedError

    def apply(self, state, reduced, vp) -> Any:
        """The new vertex properties from the reduced messages; the engine
        keeps the old property wherever no message arrived."""
        raise NotImplementedError

    def changed(self, old_vp, new_vp) -> Any:
        """Per-vertex bool: did the property change?  Default: any leaf
        differs."""
        acc = None
        for o, nw in zip(tree_leaves(old_vp), tree_leaves(new_vp)):
            neq = o != nw
            if neq.dim() > 1:
                neq = neq.flatten(1).any(dim=1)
            acc = neq if acc is None else (acc | neq)
        return acc

    def do_every_iteration(self, state, vp, it, ctx: IterationContext):
        """Per-iteration state update, after apply."""
        return state

    def receiver_final(self, state, vp, it):
        """Optional receiver-finality mask for a sparse SpMV skip; None
        here.  The port's kernel has no such skip yet."""
        return None

    def semiring(self) -> Optional[Semiring]:
        """A :class:`Semiring` to run the SpMV on the kernel, or None for
        the plain segment reduce."""
        return None
