"""Per-phase timing, and the port's tracing: spans and copy counters.

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

The recorder (:func:`span`, :func:`count`, :func:`copied`,
:func:`snapshot`, :func:`reset`) is the port's one tracing layer; the
apps, ``Graph`` and ``Engine`` call it at their boundaries:

* it is on while a ``torch.profiler`` session is active (read at each
  call) or when :func:`timing_enabled` (``GRAPHMAT_TPU_TIMING``, read at
  import and at :func:`reset`);
* a span records its name, its id, the id of its parent span (0 for a
  root), the id of its root span (every span of one app call shares it)
  and its start and end in ``time.time_ns()``, the Unix clock to which
  the profiler converts its host events.  It also enters
  ``torch.profiler.record_function(name)``, so that it sits in any
  profiler trace (:func:`profile_trace`'s too) on the same clock as the
  kernels and copies.  Spans nest by a stack: one thread records;
* counters are a :class:`~graphmat_tpu_torch.utils.logging.Counters`;
  :func:`copied` counts ``copy.<dtoh|htod>.bytes`` and ``.n`` where the
  program copies between the host and the device; ``Graph``'s readbacks
  on the card count ``copy.pinned.n``, the page-locked destinations
  they take, and ``copy.pinned.new``, those the caching host allocator
  had to page-lock anew;
* past :data:`SPAN_CAP` spans it keeps only each name's count and total
  time, and counts the spans it dropped;
* off, a span costs one flag check and returns a shared null context:
  no ``record_function``, no clock read, no synchronise, no copy; a copy
  count returns before any byte arithmetic.

:func:`phase_timer` gives the recorder's totals as a :class:`PhaseTimer`,
whose ``summary()`` is the GraphMat-style text of every span name.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass, field
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

from .logging import Counters

__all__ = ["PhaseTimer", "timing_enabled", "profile_trace", "Recorder",
           "RECORDER", "SPAN_CAP", "recording", "span", "traced", "count",
           "copied", "snapshot", "reset", "phase_timer"]


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


# ------------------------------------------------------------ the recorder

SPAN_CAP = 200_000      # raw spans kept; past it, totals only
NULL_SPAN = contextlib.nullcontext()


class Recorder:
    """Spans and counters held in memory (see the module docstring).
    ``spans``: ``(name, id, parent, root, start_ns, end_ns)`` in the
    order they closed; ``totals``: name -> ``[count, ns]``;
    ``forced``: on without a profiler (``GRAPHMAT_TPU_TIMING``)."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self.reset()

    def reset(self) -> None:
        self.spans = []
        self.totals: Dict[str, list] = {}
        self.counters = Counters()
        self.dropped = 0
        self.forced = timing_enabled()
        self._stack = []       # (id, root) of each open span
        self._next = 1

    def close(self, name, sid, parent, root, t0, t1) -> None:
        tot = self.totals.setdefault(name, [0, 0])
        tot[0] += 1
        tot[1] += t1 - t0
        if len(self.spans) < self.cap:
            self.spans.append((name, sid, parent, root, t0, t1))
        else:
            self.dropped += 1


RECORDER = Recorder()


def recording() -> bool:
    """Whether the recorder is on: a profiler session is active, or
    ``GRAPHMAT_TPU_TIMING`` was set at import or at the last reset."""
    return _autograd_profiler._is_profiler_enabled or RECORDER.forced


class _Span:
    __slots__ = ("rec", "name", "sid", "parent", "root", "rf", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        self.sid = rec._next
        rec._next += 1
        self.parent, self.root = (rec._stack[-1] if rec._stack
                                  else (0, self.sid))
        rec._stack.append((self.sid, self.root))
        self.rf = torch.profiler.record_function(self.name)
        # the profiler stamps the annotation's ends inside __enter__ and
        # __exit__, with its own work on either side (its event buffers
        # grow in steps): the middle of each call is the best guess
        t = time.time_ns()
        self.rf.__enter__()
        self.t0 = (t + time.time_ns()) // 2
        return self

    def __exit__(self, *exc):
        t = time.time_ns()
        self.rf.__exit__(*exc)
        t1 = (t + time.time_ns()) // 2
        rec = self.rec
        if rec._stack and rec._stack[-1][0] == self.sid:
            rec._stack.pop()
        rec.close(self.name, self.sid, self.parent, self.root, self.t0, t1)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name``, a
    child of the innermost open span; the shared null context when the
    recorder is off."""
    if not recording():
        return NULL_SPAN
    return _Span(RECORDER, name)


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def count(name: str, amount: float = 1.0) -> None:
    """Add ``amount`` to the counter ``name`` while the recorder is on."""
    if recording():
        RECORDER.counters.add(name, amount)


def copied(direction: str, *arrays) -> None:
    """Count one copy between the host and the device per array (numpy
    arrays or tensors): ``copy.<direction>.n`` and their bytes,
    ``copy.<direction>.bytes``; ``direction`` is ``"dtoh"`` or
    ``"htod"``."""
    if not recording():
        return
    c = RECORDER.counters
    c.add(f"copy.{direction}.bytes", float(sum(a.nbytes for a in arrays)))
    c.add(f"copy.{direction}.n", float(len(arrays)))


def snapshot() -> dict:
    """What the recorder holds: ``spans`` (tuples as in
    :class:`Recorder`), ``counters`` (name -> value), ``totals`` (name ->
    ``(count, ns)``) and ``dropped``."""
    r = RECORDER
    return {"spans": list(r.spans), "counters": dict(r.counters.values),
            "totals": {k: tuple(v) for k, v in r.totals.items()},
            "dropped": r.dropped}


def reset() -> None:
    """Empty the recorder and read ``GRAPHMAT_TPU_TIMING`` again."""
    RECORDER.reset()


def phase_timer(snap: dict | None = None) -> PhaseTimer:
    """The totals of ``snap`` (default: :func:`snapshot`) as a
    :class:`PhaseTimer`: a phase per span name."""
    snap = snapshot() if snap is None else snap
    timer = PhaseTimer()
    for name, (n, ns) in snap["totals"].items():
        timer.record(name, ns * 1e-9)
        timer.counts[name] = n
    return timer
