"""The package's logger and counters.

Counterpart of ``graphmat_tpu/utils/logging.py``: a standard-library
logger that emits on process 0 only (the reference prints from every MPI
rank, ``SpMat.h:107``), whose level comes from ``GRAPHMAT_TPU_LOG``
(default INFO); :class:`Counters` for the numbers the reference tracks
per iteration (frontier sizes, updated vertices, edges processed); and
:func:`log_iteration`, the reference's per-iteration line.

The tracing recorder (:mod:`graphmat_tpu_torch.utils.timing`) keeps its
counters in a :class:`Counters`: ``engine.steps`` and the host copies
``copy.dtoh.bytes``, ``copy.dtoh.n``, ``copy.htod.bytes``,
``copy.htod.n``.  They count only while the recorder is on (a
``torch.profiler`` session, or ``GRAPHMAT_TPU_TIMING=1``); off, a count
costs one flag check.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict

__all__ = ["get_logger", "Counters", "log_iteration"]

_LOGGER = None


def _is_rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def get_logger(name: str = "graphmat_tpu_torch") -> logging.Logger:
    """The process-0-only logger, made on first use."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    level = os.environ.get("GRAPHMAT_TPU_LOG", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    if not _is_rank0():
        logger.setLevel(logging.CRITICAL)
    logger.propagate = False
    _LOGGER = logger
    return logger


class Counters:
    """Accumulating named counters (edges processed, frontier sizes, ...)."""

    def __init__(self):
        self.values: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def add(self, name: str, amount: float = 1.0) -> None:
        self.values[name] = self.values.get(name, 0.0) + amount

    def rate(self, name: str) -> float:
        """The count per second since the counters were made."""
        dt = time.perf_counter() - self._t0
        return self.values.get(name, 0.0) / dt if dt > 0 else 0.0

    def summary(self) -> str:
        return " ".join(f"{k}={v:.6g}" for k, v in sorted(self.values.items()))


def log_iteration(it: int, nupdated: int | None = None,
                  nactive: int | None = None, ms: float | None = None):
    """The reference's per-iteration line (``GraphMatRuntime.h:246-248``)."""
    msg = f"Iteration {it}"
    if ms is not None:
        msg += f" :: {ms:.3f} msec"
    if nupdated is not None:
        msg += f" :: updated {nupdated} vertices"
    if nactive is not None:
        msg += f" :: changed {nactive} vertices"
    get_logger().info(msg)
