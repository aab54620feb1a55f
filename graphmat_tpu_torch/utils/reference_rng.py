"""Bit-exact replica of glibc's ``rand_r`` (TYPE_0 LCG).

Counterpart of ``graphmat_tpu/utils/reference_rng.py``.  The reference
seeds deterministic per-vertex and per-edge randomness with ``rand_r``
(SGD init ``src/SGD.cpp:176-184``, LDA's per-edge gamma
``src/LDA.cpp:92-97``); replicating it lets SGD and LDA start from the same
state as the reference binaries and the JAX package.

glibc rand_r: three LCG steps ``next = next*1103515245 + 12345`` (mod
2^32) give 11+10+10 bits::

    result = ((next1/65536) % 2048) << 20
           ^ ((next2/65536) % 1024) << 10
           ^ ((next3/65536) % 1024)

RAND_MAX = 2**31 - 1.  torch has no full uint32 arithmetic, so
:func:`rand_r_torch` carries the state in int64 masked to 32 bits (the
product of a 32-bit state and the 31-bit multiplier fits in 63 bits).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["RAND_MAX", "LCG_A", "LCG_C", "rand_r_np", "rand_r_uniform_np",
           "rand_r_torch"]

RAND_MAX = 2 ** 31 - 1
LCG_A = 1103515245
LCG_C = 12345
_MASK32 = 0xFFFFFFFF


def rand_r_np(seeds, count: int) -> np.ndarray:
    """For each seed, ``count`` successive rand_r values: int64
    ``[len(seeds), count]`` in [0, RAND_MAX]."""
    a, c = np.uint32(LCG_A), np.uint32(LCG_C)
    next_ = np.asarray(seeds, np.uint32).copy()
    out = np.empty((next_.shape[0], count), np.int64)
    with np.errstate(over="ignore"):
        for k in range(count):
            next_ = next_ * a + c
            r = ((next_ >> np.uint32(16)) % np.uint32(2048)).astype(np.int64)
            next_ = next_ * a + c
            r = (r << 10) ^ ((next_ >> np.uint32(16))
                             % np.uint32(1024)).astype(np.int64)
            next_ = next_ * a + c
            r = (r << 10) ^ ((next_ >> np.uint32(16))
                             % np.uint32(1024)).astype(np.int64)
            out[:, k] = r
    return out


def rand_r_uniform_np(seeds, count: int, dtype=np.float64) -> np.ndarray:
    """``(double)rand_r(&s) / RAND_MAX``, the reference's uniform draw."""
    return (rand_r_np(seeds, count) / RAND_MAX).astype(dtype)


def rand_r_torch(seeds: torch.Tensor, count: int) -> torch.Tensor:
    """:func:`rand_r_np` on ``seeds``' device: int64 ``[len(seeds),
    count]``.  Seeds are taken modulo 2^32, as a ``uint32`` cast would."""
    next_ = seeds.to(torch.int64) & _MASK32
    out = torch.empty((next_.shape[0], count), dtype=torch.int64,
                      device=seeds.device)
    for k in range(count):
        next_ = (next_ * LCG_A + LCG_C) & _MASK32
        r = (next_ >> 16) & 2047
        next_ = (next_ * LCG_A + LCG_C) & _MASK32
        r = (r << 10) ^ ((next_ >> 16) & 1023)
        next_ = (next_ * LCG_A + LCG_C) & _MASK32
        r = (r << 10) ^ ((next_ >> 16) & 1023)
        out[:, k] = r
    return out
