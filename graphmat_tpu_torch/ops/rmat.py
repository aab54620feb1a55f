"""The RMAT edge stream of the JAX package's native generator.

``graphmat_tpu/utils/generators.py: rmat_edgelist`` draws its graphs,
by default, from ``gm_rmat_gen`` (``graphmat_tpu/native/planner.cpp:
1614-1697``): a counter-based splitmix64 stream, deterministic for a
seed.  Here the same stream is drawn bit for bit:

* :func:`rmat_keys` gives the ``(s << 32) | d`` key (0-based ids) of
  every drawn edge, in generation order;
* :func:`rmat_weights` gives a kept key's weight, ``1 + splitmix64(seed
  ^ key) % weight_range``.

A CUDA tensor launches the hand-written kernels of
``graphmat_tpu_torch/csrc/rmat.cu``; the CPU runs their plain versions
:func:`rmat_keys_reference` and :func:`rmat_weights_reference`, torch
int64 arithmetic: an int64 product wraps as a uint64 product does, a
logical right shift is the arithmetic shift masked (torch has no uint64
shift on the CPU), and the unsigned 64-bit modulo is taken from the two
32-bit halves.  There is no fallback: a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["splitmix64", "rmat_keys", "rmat_keys_reference",
           "rmat_weights", "rmat_weights_reference", "LAUNCHES"]

# launches of the two kernels; only rmat_keys and rmat_weights add to it
LAUNCHES = {"keys": 0, "weights": 0}

_M64 = (1 << 64) - 1
_LO32 = (1 << 32) - 1
_STREAM = 0xD1342543DE82EF95   # edge i's state: splitmix64(seed * this + i)


def _i64(x: int) -> int:
    """The int64 whose bits are those of the uint64 ``x mod 2^64``."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """The logical right shift of int64 ``x`` read as uint64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 (``planner.cpp:1614-1619``) of int64 ``x`` read as
    uint64, the result's bits as int64."""
    x = x + _i64(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def _thresholds(a: float, b: float, c: float):
    ab = a + b
    return ab, c / (1.0 - ab), a / ab


def rmat_keys_reference(scale: int, nnz: int, a: float, b: float,
                        c: float, seed: int, device="cpu") -> torch.Tensor:
    """Plain version of :func:`rmat_keys`: int64 ``[nnz]`` keys."""
    ab, c_norm, a_norm = _thresholds(a, b, c)
    state = splitmix64(torch.arange(nnz, dtype=torch.int64, device=device)
                       + _i64(seed * _STREAM))
    s = torch.zeros(nnz, dtype=torch.int64, device=device)
    d = torch.zeros_like(s)
    for _ in range(scale):
        state = splitmix64(state)
        r1 = _shr(state, 32).double() * 2.0 ** -32
        r2 = (state & _LO32).double() * 2.0 ** -32
        sb = r1 > ab
        db = torch.where(sb, r2 > c_norm, r2 > a_norm)
        s = (s << 1) | sb
        d = (d << 1) | db
    return (s << 32) | d


def rmat_keys(scale: int, nnz: int, a: float, b: float, c: float,
              seed: int, device) -> torch.Tensor:
    """The keys ``(s << 32) | d`` of the ``nnz`` edges of an
    RMAT-``scale`` draw with quadrant probabilities ``(a, b, c,
    1-a-b-c)``, in generation order: int64 ``[nnz]`` on ``device`` (the
    kernel on a CUDA device, :func:`rmat_keys_reference` on the CPU)."""
    if not 0 <= scale <= 31:
        raise ValueError(f"rmat_keys: scale {scale} outside 0..31")
    device = torch.device(device)
    if device.type == "cpu":
        return rmat_keys_reference(scale, nnz, a, b, c, seed, device)
    if device.type != "cuda":
        raise RuntimeError(f"rmat_keys has no kernel for {device}")
    keys = torch.empty(nnz, dtype=torch.int64, device=device)
    if nnz == 0:
        return keys
    ab, c_norm, a_norm = _thresholds(a, b, c)
    _lib.launch("gm_rmat_keys", device, scale, nnz, ab, c_norm, a_norm,
                seed & _M64, keys.data_ptr())
    LAUNCHES["keys"] += 1
    return keys


def rmat_weights_reference(keys: torch.Tensor, seed: int,
                           weight_range: int) -> torch.Tensor:
    """Plain version of :func:`rmat_weights`: the unsigned 64-bit
    ``z % w`` is ``((hi % w) * (2^32 % w) + lo % w) % w`` over z's 32-bit
    halves, every term below 2^62."""
    w = int(weight_range)
    z = splitmix64(keys ^ _i64(seed))
    r = ((_shr(z, 32) % w) * ((1 << 32) % w) + (z & _LO32) % w) % w
    return (1 + r).to(torch.int32)


def rmat_weights(keys: torch.Tensor, seed: int,
                 weight_range: int) -> torch.Tensor:
    """The weights ``1 + splitmix64(seed ^ key) % weight_range`` of the
    int64 keys ``keys``: int32, on their device (the kernel on a CUDA
    device, :func:`rmat_weights_reference` on the CPU)."""
    if not 0 < weight_range < 2 ** 31:
        raise ValueError(f"rmat_weights: weight_range {weight_range} "
                         "outside 1..2^31-1")
    if keys.dtype != torch.int64 or not keys.is_contiguous():
        raise TypeError("rmat_weights takes a contiguous int64 tensor")
    if keys.device.type == "cpu":
        return rmat_weights_reference(keys, seed, weight_range)
    if keys.device.type != "cuda":
        raise RuntimeError(f"rmat_weights has no kernel for {keys.device}")
    val = torch.empty(keys.numel(), dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:
        return val
    _lib.launch("gm_rmat_weights", keys.device, keys.data_ptr(),
                keys.numel(), seed & _M64, int(weight_range),
                val.data_ptr())
    LAUNCHES["weights"] += 1
    return val

