"""SGD matrix factorisation as GraphMat's SGD (``src/SGD.cpp``).

Vertex ``i`` (1-based) starts from ``K`` draws of glibc's ``rand_r``
seeded with ``i``, each divided by ``RAND_MAX`` and held as float32 (the
configured precision).  A step, for every rating ``(u, v, r)`` at once:
``e = r - <lv_u, lv_v>``, ``u`` gathers ``lv_v * e`` and ``v`` gathers
``lv_u * e``; then every vertex with a rating takes
``lv += step * (-lambda * lv + gathered)``.  RMSE is
``sqrt(sum of e^2 / ratings)``.
"""

from __future__ import annotations

import numpy as np
import torch

RAND_MAX = 2 ** 31 - 1
BLOCK = 1 << 22      # ratings per block: bounds the gathers' memory


def rand_r_uniform(n: int, k: int) -> np.ndarray:
    """``rand_r(&s) / RAND_MAX`` for ``s = i`` (1-based), ``k`` in turn:
    float64 ``[n, k]``.  glibc's ``rand_r``: three LCG steps give 11 + 10
    + 10 bits."""
    state = np.arange(1, n + 1, dtype=np.uint64)
    out = np.empty((n, k), np.float64)
    m32 = np.uint64(0xFFFFFFFF)

    def step(x):
        return (x * np.uint64(1103515245) + np.uint64(12345)) & m32
    for j in range(k):
        state = step(state)
        r = (state >> np.uint64(16)) % np.uint64(2048)
        state = step(state)
        r = (r << np.uint64(10)) ^ ((state >> np.uint64(16)) % np.uint64(1024))
        state = step(state)
        r = (r << np.uint64(10)) ^ ((state >> np.uint64(16)) % np.uint64(1024))
        out[:, j] = r.astype(np.float64) / RAND_MAX
    return out


def initial_factors(n: int, k: int, dtype, device):
    lv = torch.as_tensor(rand_r_uniform(n, k)).to(torch.float32)
    return lv.to(device=device, dtype=dtype)


def rmse(src, dst, val, lv) -> float:
    err = torch.zeros((), dtype=lv.dtype, device=lv.device)
    for b in range(0, src.numel(), BLOCK):
        s, d = src[b:b + BLOCK], dst[b:b + BLOCK]
        e = val[b:b + BLOCK].to(lv.dtype) - (lv[s] * lv[d]).sum(1)
        err = err + (e * e).sum()
    return float(torch.sqrt(err.double() / src.numel()))


def sgd(src, dst, val, n: int, k: int = 20, iterations: int = 10,
        lambda_: float = 0.001, step: float = 3.5e-7,
        dtype=torch.float64):
    """Returns ``(lv0, lv, rmse_before, rmse_after)``; ``lv0``, ``lv``
    float64 ``[n, k]``."""
    src, dst = src.long(), dst.long()
    lv = initial_factors(n, k, dtype, src.device)
    lv0 = lv.double()
    has = (torch.bincount(src, minlength=n) + torch.bincount(
        dst, minlength=n)) > 0
    r0 = rmse(src, dst, val, lv)
    for _ in range(iterations):
        acc = torch.zeros_like(lv)
        for b in range(0, src.numel(), BLOCK):
            s, d = src[b:b + BLOCK], dst[b:b + BLOCK]
            xs, xd = lv[s], lv[d]
            e = (val[b:b + BLOCK].to(dtype) - (xs * xd).sum(1))[:, None]
            acc.index_add_(0, d, xs * e)
            acc.index_add_(0, s, xd * e)
        lv = torch.where(has[:, None], lv + step * (-lambda_ * lv + acc), lv)
    return lv0, lv.double(), r0, rmse(src, dst, val, lv)
