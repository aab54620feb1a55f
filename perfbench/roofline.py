"""Published peaks of the card and the bytes each job's step has to move.

The bytes are the work of the algorithm, counted from the graph's sizes
(vertices ``n``, edges ``nnz``, factor width ``k``), never from how a
kernel lays its data out: every input read once, every output written
once.  So a share reads the same whatever implements the step.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its full 700 W: HBM3 bandwidth, and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
I32 = 4   # bytes of an int32 index and of a float32 value


def pagerank_step_bytes(n: int, nnz: int) -> int:
    """One dense PageRank iteration: each edge's sender index once, the
    row pointer, then the operand, the result and apply's two vectors
    (pagerank, degree) once each."""
    return I32 * nnz + I32 * (n + 1) + 4 * I32 * n


def sgd_sweep_bytes(n: int, nnz: int, k: int) -> int:
    """One SGD sweep in both directions: per direction each rating's
    sender index and value once and the row pointer; over the two
    directions every vertex's K-wide factors read once as a sender and
    written once as a receiver."""
    return 2 * (2 * I32 * nnz + I32 * (n + 1)) + 2 * I32 * n * k


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes at
    peak bandwidth and the float32 operations at peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
