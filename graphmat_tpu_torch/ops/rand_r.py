"""glibc ``rand_r``'s uniform draw, ``rand_r(&s) / RAND_MAX``, on a
device.

Counterpart of ``graphmat_tpu/utils/reference_rng.py:
rand_r_uniform_np``, which the JAX package runs on the host to give SGD's
initial factors (vertex ``v``'s ``k`` factors from ``rand_r`` seeded ``v
+ 1``).  :func:`rand_r_uniform` draws them where the graph lives: a CUDA
device launches the hand-written kernel of
``graphmat_tpu_torch/csrc/rand_r.cu``; the CPU runs its plain version
:func:`rand_r_uniform_reference`.  float32 and float64 come out bit for
bit equal to ``rand_r_uniform_np(seeds, k).astype(dtype)``; no other
dtype is drawn.  There is no fallback: a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import torch

from ..utils.reference_rng import RAND_MAX, rand_r_torch
from . import _lib

__all__ = ["rand_r_uniform", "rand_r_uniform_reference", "LAUNCHES"]

# launches of the kernel; only rand_r_uniform adds to it
LAUNCHES = {"uniform": 0}

_DTYPES = (torch.float32, torch.float64)


def rand_r_uniform_reference(first_seed: int, n: int, k: int,
                             dtype=torch.float64,
                             device="cpu") -> torch.Tensor:
    """Plain version of :func:`rand_r_uniform`: :func:`rand_r_torch` on
    int64 seeds, divided in float64 by ``RAND_MAX``, cast to ``dtype``."""
    seeds = torch.arange(n, dtype=torch.int64, device=device) + first_seed
    return (rand_r_torch(seeds, k).to(torch.float64) / RAND_MAX).to(dtype)


def rand_r_uniform(first_seed: int, n: int, k: int, dtype,
                   device) -> torch.Tensor:
    """``[n, k]`` of ``dtype`` (float32 or float64) on ``device``, whose
    row ``v`` holds the ``k`` uniforms ``rand_r(&s) / RAND_MAX`` of ``s =
    first_seed + v`` (mod 2^32): the kernel on a CUDA device,
    :func:`rand_r_uniform_reference` on the CPU."""
    if n < 0 or k < 0:
        raise ValueError(f"rand_r_uniform: shape ({n}, {k})")
    if dtype not in _DTYPES:
        # torch casts float64 to float16 through float32, rounding twice,
        # where numpy's astype rounds once: not the reference's bits
        raise ValueError(f"rand_r_uniform draws float32 or float64, not "
                         f"{dtype}")
    device = torch.device(device)
    if device.type == "cpu":
        return rand_r_uniform_reference(first_seed, n, k, dtype, device)
    if device.type != "cuda":
        raise RuntimeError(f"rand_r_uniform has no kernel for {device}")
    out = torch.empty((n, k), dtype=dtype, device=device)
    if n * k:
        _lib.launch("gm_rand_r_uniform", device, first_seed & 0xFFFFFFFF,
                    n, k, int(dtype == torch.float64), out.data_ptr())
        LAUNCHES["uniform"] += 1
    return out
