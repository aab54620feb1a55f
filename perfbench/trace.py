"""The traced window: ``torch.profiler`` over a bounded number of whole
jobs, reduced to plain lists that the per-layer readers and the
breakdown take.

Device events are the profiler's kernels, copies and fills; their union
within the window is the device's busy time (the method of the port's
``chip_smoke.py: profile_run``, on intervals rather than sums, so that
overlapping events count once).  Host events are the profiler's operator
spans, used to name what the host was doing in each idle gap.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB_SPAN = "perfbench.job"
HOST_IDLE = "host: python"   # a gap that no operator span covers


@dataclass
class Trace:
    """Events in seconds on the profiler's clock.  ``device``: (name,
    start, end); ``host``: (name, start, end) of operator spans;
    ``jobs``: (start, end) of each profiled job; ``info``: what the
    driver said of each profiled job (its iterations, its searches)."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    jobs: list = field(default_factory=list)
    info: list = field(default_factory=list)

    @property
    def window(self):
        return (min(s for s, _ in self.jobs), max(e for _, e in self.jobs))

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def device_in_window(self):
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device
                if e > lo and s < hi]

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device_in_window()])

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def device_time(self, pred) -> float:
        """Seconds of the window's device events whose name ``pred``
        accepts (summed; events of one stream do not overlap)."""
        return sum(e - s for n, s, e in self.device_in_window() if pred(n))

    def count(self, pred) -> int:
        return sum(1 for n, _, _ in self.device_in_window() if pred(n))


def union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(tr: Trace):
    """The window's gaps between device events, each named by the
    innermost host operator span covering its midpoint: [(name,
    seconds)]."""
    lo, hi = tr.window
    busy = sorted((s, e) for _, s, e in tr.device_in_window())
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = [(he - hs, n) for n, hs, he in tr.host if hs <= mid <= he]
        named.append((min(cover)[1] if cover else HOST_IDLE, e - s))
    return named


def short_name(name: str) -> str:
    """A device event's name without its signature: a kernel of the
    program keeps its template arguments (``spmv_kernel<0, 0, 0>``); a
    kernel of PyTorch or CUB gives its own name and the operators in its
    template arguments
    (``vectorized_elementwise_kernel[where_kernel_impl]``)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    bare = name[5:] if name.startswith("void ") else name
    bare = bare.replace("(anonymous namespace)::", "")
    if not bare.startswith(("at::", "at_cuda_detail::", "cub::")):
        return bare.split("(", 1)[0]
    head = re.split(r"[<(]", bare, maxsplit=1)[0].split("::")[-1]
    inner = [x for x in dict.fromkeys(re.findall(
        r"at::native::(?:binary_internal::)?([A-Za-z]\w+)",
        bare[len(head):])) if x != head and x not in _NOT_OPS]
    return head + (f"[{','.join(inner[:2])}]" if inner else "")


_NOT_OPS = ("detail", "memory", "func_wrapper_t", "binary_internal",
            "gpu_kernel_impl_nocast", "BinaryFunctor", "AUnaryFunctor")


def top(pairs, k=10):
    """Seconds summed by name, largest first, at most ``k``."""
    acc = {}
    for name, sec in pairs:
        acc[name] = acc.get(name, 0.0) + sec
    return [[n, s] for n, s in sorted(acc.items(), key=lambda x: -x[1])][:k]


def breakdown(tr: Trace) -> dict:
    return {"device_ops": top((short_name(n), e - s)
                              for n, s, e in tr.device_in_window()),
            "idle_gaps": top(idle_gaps(tr))}


def from_chrome(doc: dict) -> Trace:
    """A :class:`Trace` from the profiler's chrome-trace document."""
    tr = Trace()
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append((ev["name"], s, e))
        elif cat == "user_annotation" and ev["name"] == JOB_SPAN:
            tr.jobs.append((s, e))
        elif cat == "cpu_op":
            tr.host.append((ev["name"], s, e))
    tr.jobs.sort()
    return tr


class Profiler:
    """Profiles the jobs run inside :meth:`job`, up to ``limit`` of them;
    :meth:`finish` stops it and returns the :class:`Trace`."""

    def __init__(self, limit: int):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.limit = limit
        self.done = 0
        self.info = []
        self._record = torch.profiler.record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._open = True

    @property
    def active(self) -> bool:
        return self._open and self.done < self.limit

    @contextlib.contextmanager
    def job(self):
        if not self.active:
            yield
            return
        with self._record(JOB_SPAN):
            yield
        self.done += 1
        if self.done == self.limit:
            self._stop()

    def _stop(self):
        import torch
        if self._open:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._open = False

    def finish(self) -> Trace:
        self._stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        tr = from_chrome(doc)
        tr.info = self.info
        return tr
