"""The package's logger.

Counterpart of ``get_logger`` in ``graphmat_tpu/utils/logging.py``: a
standard-library logger that emits on process 0 only (the reference
prints from every MPI rank, ``SpMat.h:107``).  The level comes from
``GRAPHMAT_TPU_LOG`` (default INFO).
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["get_logger"]

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
