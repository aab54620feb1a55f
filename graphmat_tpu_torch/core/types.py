"""Core enums and the ⊕ monoids.

PyTorch counterpart of ``graphmat_tpu/core/types.py``.  A semiring's ⊕ is
a :class:`Monoid` that knows its identity and its ``scatter_reduce_``
name; ⊗ is a program hook (see :mod:`graphmat_tpu_torch.core.program`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

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

    ``kind`` is one of ``'sum' | 'min' | 'max' | 'or' | 'any'``; ``'any'``
    (the reference's overwrite-reduce, ``src/BFS.cpp:74-76``) is taken
    deterministically as ``min``.  The JAX package's ``'generic'`` kind
    (an arbitrary combine) is not ported yet.
    """

    kind: str = "sum"

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
        raise ValueError(f"unknown monoid kind {self.kind}")


SUM = Monoid("sum")
MIN = Monoid("min")
MAX = Monoid("max")
ANY = Monoid("any")  # overwrite-reduce; deterministic min tie-break
LOR = Monoid("or")
