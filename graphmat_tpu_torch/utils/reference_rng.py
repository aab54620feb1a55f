"""Bit-exact replicas of glibc's ``rand_r`` (TYPE_0 LCG) and of its
``srand``/``rand`` (TYPE_3 additive feedback).

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

The reference converter's vertex-id shuffle draws from ``srand(seed)`` and
``rand()`` instead (:func:`glibc_rand_np`, :func:`glibc_square_mapping`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["RAND_MAX", "LCG_A", "LCG_C", "rand_r_np", "rand_r_uniform_np",
           "rand_r_torch", "glibc_rand_np", "glibc_square_mapping_np",
           "glibc_square_mapping"]

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


def glibc_rand_np(seed: int, n: int) -> np.ndarray:
    """Bit-exact glibc ``srand(seed)``/``rand()`` sequence (TYPE_3
    additive-feedback generator, glibc stdlib/random_r.c): 31-word state
    seeded by a Park-Miller LCG (Schrage's method), 310 warm-up outputs
    discarded, then ``out = (r[f] += r[p]) >> 1`` over the ring.

    The reference's ``randomize_edgelist_square`` consumes exactly this
    sequence (``edgelist.h:337-366``: ``srand(5)`` + ``rand() % m``), so
    replicating it makes vertex-id randomization byte-identical to the
    reference binaries.  Sequential by construction (the additive ring
    has a lag-3 dependency); the port's native library carries the fast C
    version of the mapping (``native/glibc.cpp``).
    """
    r = np.zeros(31, np.uint32)
    word = np.int64(seed if seed != 0 else 1)
    r[0] = np.uint32(word)
    for i in range(1, 31):
        hi, lo = word // 127773, word % 127773
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        r[i] = np.uint32(word)
    rl = r.tolist()   # python ints: fast wrap-free loop, mask to 32 bits
    f, p = 3, 0
    for _ in range(310):
        rl[f] = (rl[f] + rl[p]) & 0xFFFFFFFF
        f = (f + 1) % 31
        p = (p + 1) % 31
    out = np.empty(n, np.int64)
    for i in range(n):
        v = (rl[f] + rl[p]) & 0xFFFFFFFF
        rl[f] = v
        out[i] = v >> 1
        f = (f + 1) % 31
        p = (p + 1) % 31
    return out


def glibc_square_mapping_np(m: int, seed: int = 5) -> np.ndarray:
    """The reference's seeded id permutation (``edgelist.h:337-366``):
    ``rval[i] = rand() % m`` then sequential swap
    ``mapping[i] <-> mapping[rval[i]]``.  Returns mapping[m] (0-based:
    old id i maps to mapping[i])."""
    rval = (glibc_rand_np(seed, m) % m).astype(np.int64)
    mapping = np.arange(m, dtype=np.int64)
    ml = mapping.tolist()
    rl = rval.tolist()
    for i in range(m):
        j = rl[i]
        ml[i], ml[j] = ml[j], ml[i]
    return np.asarray(ml, np.int64)


def glibc_square_mapping(m: int, seed: int = 5, native=None) -> np.ndarray:
    """:func:`glibc_square_mapping_np` as int32[m]: from the port's C copy
    (``native/glibc.cpp``) when ``native`` is None or True, whose build
    raises if it fails; from the numpy loop only when ``native`` is
    False."""
    if native is False:
        return glibc_square_mapping_np(int(m), seed).astype(np.int32)
    from ..native import load
    mapping = np.empty(int(m), np.int32)
    load().gm_glibc_square_mapping(int(m), seed & 0xFFFFFFFF,
                                   mapping.ctypes.data)
    return mapping
