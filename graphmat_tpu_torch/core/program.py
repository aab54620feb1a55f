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
runs its SpMV on a hand-written scalar kernel: K1 by default, the push
kernel (K6/K7) under ``GRAPHMAT_KERNEL=v2``; an ALL_VERTICES program that
declares a :class:`VecSemiring` runs it on the K-wide kernel (K3); any
other runs the plain segment reduce of
:mod:`graphmat_tpu_torch.ops.segment`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.spmv2u import PROCESS_OPS
from ..ops.spmv_vec2 import VEC_PROCESS_OPS
from .tree import tree_leaves, tree_map
from .types import Activity, Direction, SUM

__all__ = ["GraphProgram", "IterationContext", "Semiring", "VecSemiring"]


def _identity_codec(x):
    return x


@dataclass(frozen=True)
class Semiring:
    """A program's semiring in the form the SpMV kernel executes.

    * ``reduce_kind`` ∈ {'sum', 'min', 'max', 'or', 'any'}: ⊕ over float32.
      'or' runs as max (encodings must be 0.0/1.0) and 'any' as min.
    * ``process_op``: the name of ⊗ in the kernel's closed set
      (:data:`~graphmat_tpu_torch.ops.spmv2u.PROCESS_OPS`: ``"x"``,
      ``"x_mul_val"``, ``"x_add_val"``, and ``"key_add_val"``, packed-key
      BFS's op: it adds ``(val - 1) << bits`` to the int32 bit pattern of
      x inside ``[KEY_BIAS, KEY_BIAS + 2^28)``); :attr:`process` is its
      torch function.  ⊗ must absorb the ⊕ identity.
    * ``bits``: ``key_add_val``'s shift (the parent-id field width).
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
    bits: int = 0

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
        if not 0 <= self.bits < 32:
            raise ValueError(f"Semiring bits={self.bits} must lie in "
                             "[0, 32)")

    @property
    def process(self) -> Callable:
        """⊗ as a torch function ``(x, edge_val) -> contribution``."""
        return functools.partial(PROCESS_OPS[self.process_op],
                                 bits=self.bits)


@dataclass(frozen=True)
class VecSemiring:
    """A K-wide, three-operand program's semiring in the form the K3
    kernel executes; the counterpart of ``PallasVec2Semiring``.

    ⊕ is sum; the engine zeroes the rows of senders that did not send, so
    ⊗ must absorb a zero message.  Only ALL_VERTICES programs run it (got
    comes from the graph's structure).

    * ``k``: the row width of the encoded message (and of ``vp``);
    * ``process_op``: the name of ⊗ in the kernel's closed set
      (:data:`~graphmat_tpu_torch.ops.spmv_vec2.VEC_PROCESS_OPS`);
    * ``encode(state, msg)`` -> float32 ``[n, k]``;
      ``encode_vp(state, vp)`` -> float32 ``[n, k]`` when ``needs_vp``;
      ``decode(y)`` maps the reduced ``[n, out_width]`` tensor to what
      ``apply`` takes;
    * ``extra_fn(state)``: the op's float32 extra operand (LDA's topic
      totals), or None;
    * ``params``: the op's scalars (``alpha``, ``eta``, ``vocab_size``).
    """

    k: int
    process_op: str
    encode: Callable
    encode_vp: Optional[Callable] = None
    decode: Callable = _identity_codec
    needs_vp: bool = False
    extra_fn: Optional[Callable] = None
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.process_op not in VEC_PROCESS_OPS:
            raise ValueError(f"VecSemiring process_op {self.process_op!r} "
                             f"is not one of {sorted(VEC_PROCESS_OPS)}")
        if self.needs_vp and self.encode_vp is None:
            raise ValueError("needs_vp=True needs encode_vp")


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
        """Optional exact receiver-finality mask, or None (the default).

        Return a bool ``[n_pad]`` mask of receivers whose vertex property
        can no longer change at sweep ``it`` (0-based within the run).  On
        the default kernel route (K1, ``GRAPHMAT_KERNEL=v2u``) the sparse
        SpMV then does not read those receivers' rows: each gets the ⊕
        identity and no message (the reference's y-bitvector early-out,
        ``singlenode/spmspv.h:64-81``, generalised to dead receivers).
        Pad vertices count as final.  Dense sweeps and the push route
        ignore the mask.

        The mask must be EXACT: every skipped update would have been a
        no-op, so results (reduce tie-breaks included) are bit-identical
        with and without it.  Only monotone programs whose apply is a
        no-op once a vertex is final can give one (e.g. BFS: ``depth <
        INF``; packed-key BFS: ``key_depth <= it``, since a sweep-``it``
        message always carries depth >= it + 1)."""
        return None

    def semiring(self) -> Optional[Semiring]:
        """A :class:`Semiring` to run the SpMV on the kernel, or None for
        the plain segment reduce."""
        return None

    def vec_semiring(self) -> Optional[VecSemiring]:
        """A :class:`VecSemiring` to run a K-wide SpMV on the K3 kernel
        (preferred over :meth:`semiring`), or None."""
        return None
