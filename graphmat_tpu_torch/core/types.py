"""Core enums and the ⊕ monoids.

PyTorch counterpart of ``graphmat_tpu/core/types.py``.  A semiring's ⊕ is
a :class:`Monoid` that knows its identity and its ``scatter_reduce_``
name, or, for an arbitrary associative combine (GraphMat's user
``reduce_function``), its ``combine_fn``; ⊗ is a program hook (see
:mod:`graphmat_tpu_torch.core.program`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

import torch

__all__ = [
    "Direction",
    "Activity",
    "Monoid",
    "SUM",
    "MIN",
    "MAX",
    "ANY",
    "LOR",
    "UNTIL_CONVERGENCE",
    "has_generic",
]

UNTIL_CONVERGENCE = -1  # reference: GraphMatRuntime.h:51


class Direction(enum.Enum):
    """Which edges a vertex program runs over (``GraphProgram.h:34``).

    * ``OUT_EDGES``: sender = src, receiver = dst.
    * ``IN_EDGES``: sender = dst, receiver = src.
    * ``ALL_EDGES``: both, reduced into the same result.
    """

    OUT_EDGES = "out"
    IN_EDGES = "in"
    ALL_EDGES = "all"


class Activity(enum.Enum):
    """Whether all vertices or only active ones send each iteration
    (``GraphProgram.h:36``)."""

    ACTIVE_ONLY = "active_only"
    ALL_VERTICES = "all_vertices"


def _min_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _max_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


@dataclass(frozen=True)
class Monoid:
    """An associative reduction with identity.

    ``kind`` is one of ``'sum' | 'min' | 'max' | 'or' | 'any' |
    'generic'``; ``'any'`` (the reference's overwrite-reduce,
    ``src/BFS.cpp:74-76``) is taken deterministically as ``min``.
    ``'generic'`` folds with ``combine_fn(a, b)``, an associative
    elementwise function of two tensors that returns a tensor (``a`` the
    earlier operand), whose identity is ``identity_fn(dtype)``: the
    segment reduce then runs a log-depth segmented scan
    (:mod:`graphmat_tpu_torch.ops.segment`), never a kernel.
    """

    kind: str = "sum"
    combine_fn: Optional[Callable] = None
    identity_fn: Optional[Callable] = None   # dtype -> scalar, for generic

    def identity(self, dtype: torch.dtype):
        """The identity as a Python scalar of ``dtype``'s kind."""
        if self.kind == "sum":
            return False if dtype == torch.bool else 0
        if self.kind in ("min", "any"):
            return _min_identity(dtype)
        if self.kind == "max":
            return _max_identity(dtype)
        if self.kind == "or":
            return False
        if self.kind == "generic":
            if self.identity_fn is None:
                raise ValueError("generic Monoid needs identity_fn")
            return torch.as_tensor(self.identity_fn(dtype),
                                   dtype=dtype).item()
        raise ValueError(f"unknown monoid kind {self.kind}")

    def combine(self, a, b):
        if self.kind == "sum":
            return a + b
        if self.kind in ("min", "any"):
            return torch.minimum(a, b)
        if self.kind == "max":
            return torch.maximum(a, b)
        if self.kind == "or":
            return torch.logical_or(a, b)
        if self.kind == "generic":
            return self.combine_fn(a, b)
        raise ValueError(f"unknown monoid kind {self.kind}")


SUM = Monoid("sum")
MIN = Monoid("min")
MAX = Monoid("max")
ANY = Monoid("any")  # overwrite-reduce; deterministic min tie-break
LOR = Monoid("or")


def has_generic(monoid) -> bool:
    """Whether ``monoid`` (one Monoid, or a dict, list or tuple of them)
    holds a generic one."""
    if isinstance(monoid, Monoid):
        return monoid.kind == "generic"
    if isinstance(monoid, dict):
        return any(has_generic(m) for m in monoid.values())
    if isinstance(monoid, (list, tuple)):
        return any(has_generic(m) for m in monoid)
    return False
