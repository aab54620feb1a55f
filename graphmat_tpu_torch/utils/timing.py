"""Per-phase timing.

Counterpart of ``graphmat_tpu/utils/timing.py``.  The reference gates
``gettimeofday`` phase prints behind ``-D__TIMING`` (``Makefile:37-40``,
``GraphMatRuntime.h:125-248``):

* :class:`PhaseTimer`: host wall-clock phases (graph build, run, ...) and
  rates from them (edges/s), with the JAX package's names and summary
  text.  CUDA launches return before the card finishes, so where CUDA is
  initialized a phase synchronizes the current device before it reads
  the clock at its start and at its end: a phase then counts the device
  work it launched, as the reference's phases count their work;
* :func:`profile_trace`: a ``torch.profiler`` run around a block, for the
  per-kernel timeline, written as a Chrome trace.

Enable with ``GRAPHMAT_TPU_TIMING=1`` (the ``timing=1`` make variable) or
explicitly.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

__all__ = ["PhaseTimer", "timing_enabled", "profile_trace"]


def timing_enabled() -> bool:
    return os.environ.get("GRAPHMAT_TPU_TIMING", "0") not in ("0", "", "false")


def _sync() -> None:
    """Wait for the current CUDA device, where CUDA is initialized."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase; prints a GraphMat-style
    summary."""

    enabled: bool = True
    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def rate(self, name: str, units: float) -> float:
        """units per second for a phase (e.g. edges processed)."""
        t = self.totals.get(name, 0.0)
        return units / t if t > 0 else float("inf")

    def summary(self) -> str:
        lines = []
        for name, t in sorted(self.totals.items()):
            lines.append(f"{name} time = {t * 1e3:.3f} ms "
                         f"(n={self.counts[name]})")
        return "\n".join(lines)

    def report(self) -> None:
        if self.enabled:
            print(self.summary())


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where it is
    available), its Chrome trace written into ``logdir``; yields the
    profiler, whose ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
