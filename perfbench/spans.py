"""The program's own spans and counters over the traced window: what
``graphmat_tpu_torch.utils.timing`` recorded inside the apps, ``Graph``
and ``Engine``, placed on the device trace's clock.

The recorder is on while a profiler session is active, so in a traced
run it holds the profiled jobs alone.  It stamps its spans with
``time.time_ns()``; the :class:`~perfbench.trace.Trace` counts seconds
from the profiler's own base.  One offset joins them: for each profiled
job, the one that puts the middle of its root spans (first start to last
end) on the middle of its ``perfbench.job`` span; the median over the
jobs.  The job's span opens a few microseconds before its first root and
closes a few after its last, so the error is half their difference.

:func:`view` gives the aligned spans and the counters; :func:`idle_by_span`
names the device's idle time inside the jobs by the innermost span over
it, logged once a traced run as a table.  The per-layer readers
``metrics/init_ms_per_job.py``, ``readback_ms_per_job.py``,
``engine_idle_share.py``, ``host_copy_mb_per_job.py`` and
``host_reads_per_iteration.pagerank.py`` read it; each gives ``None``
where the recorder holds no span (a program without the recorder).
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field

OUTSIDE = "(job, outside the program's spans)"


@dataclass
class Span:
    """One recorded span, in seconds on the trace's clock."""
    name: str
    sid: int
    parent: int
    root: int
    start: float
    end: float


@dataclass
class View:
    """The spans of the profiled jobs, on the trace's clock, in the
    order they closed; the recorder's counters; the jobs profiled."""
    spans: list
    counters: dict
    jobs: int
    dropped: int = 0
    _self: dict = field(default=None, repr=False)

    def seconds(self, name: str) -> float:
        """The summed duration of every span called ``name``."""
        return sum(s.end - s.start for s in self.spans if s.name == name)

    def intervals(self, name: str) -> list:
        return sorted((s.start, s.end) for s in self.spans if s.name == name)

    def self_intervals(self) -> list:
        """(start, end, span) of each span's own time, its children's
        left out; they do not overlap, since spans nest."""
        if self._self is None:
            kids = {}
            for s in self.spans:
                kids.setdefault(s.parent, []).append((s.start, s.end))
            out = []
            for s in self.spans:
                t = s.start
                for cs, ce in sorted(kids.get(s.sid, ())):
                    if cs > t:
                        out.append((t, cs, s))
                    t = max(t, ce)
                if s.end > t:
                    out.append((t, s.end, s))
            out.sort(key=lambda x: x[0])
            self._self = out
        return self._self


def snapshot():
    """The program's recorder, or None where the program has none."""
    try:
        from graphmat_tpu_torch.utils.timing import snapshot as snap
    except ImportError:
        return None
    return snap()


def merge(intervals) -> list:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def subtract(xs, ys) -> list:
    """``xs`` less ``ys``, both sorted and disjoint."""
    out, j = [], 0
    for s, e in xs:
        t = s
        while j < len(ys) and ys[j][1] <= t:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < e:
            if ys[k][0] > t:
                out.append((t, ys[k][0]))
            t = max(t, ys[k][1])
            k += 1
        if t < e:
            out.append((t, e))
    return out


def overlap(xs, ys) -> float:
    """The length of the intersection of two sorted, disjoint lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _roots_in_jobs(jobs, roots, d):
    """For each job, the extent (first start, last end) of the roots
    whose middle, shifted by ``d``, lies in it: [(job, extent, ids)]."""
    mids = [0.5 * (s + e) + d for _, s, e in roots]
    out = []
    for js, je in jobs:
        lo = bisect.bisect_left(mids, js)
        hi = bisect.bisect_right(mids, je)
        if hi > lo:
            got = roots[lo:hi]
            out.append(((js, je), (min(s for _, s, _ in got),
                                   max(e for _, _, e in got)),
                        {r for r, _, _ in got}))
    return out


def align(jobs, roots):
    """The offset from the recorder's clock to the trace's, and the ids
    of the roots inside the jobs: ``(d, ids)``, or ``None``.  ``jobs``:
    sorted ``(start, end)`` on the trace's clock; ``roots``: ``(id,
    start, end)`` on the recorder's, sorted by start.  A first guess puts
    some root's start on the first job's start (the recorder may also
    have run outside the jobs); of the guesses that place roots in the
    most jobs, the one whose jobs' offsets agree best is kept."""
    best, key = None, None
    for _, s, _ in roots[:max(1, len(roots) - len(jobs) + 1)]:
        offs = [0.5 * (js + je - rs - re) for (js, je), (rs, re), _ in
                _roots_in_jobs(jobs, roots, jobs[0][0] - s)]
        if offs and (key is None
                     or (len(offs), min(offs) - max(offs)) > key):
            best, key = offs, (len(offs), min(offs) - max(offs))
    if best is None:
        return None
    d = statistics.median(best)
    return d, set().union(*(ids for _, _, ids in
                            _roots_in_jobs(jobs, roots, d)))


_LAST = [None, None]    # the last trace viewed, and its view


def view(tr, snap=None):
    """The :class:`View` of the traced window ``tr``; ``None`` without
    profiled jobs or recorded spans.  Without ``snap`` it reads the
    program's recorder once a trace and logs :func:`table`."""
    if snap is None and _LAST[0] is tr:
        return _LAST[1]
    cached = snap is None
    snap = snapshot() if snap is None else snap
    v = _make_view(tr, snap)
    if cached:
        _LAST[:] = [tr, v]
        from .harness import log, percentile
        if tr.jobs:
            ms = [(e - s) * 1e3 for s, e in tr.jobs]
            log(f"spans: {len(ms)} profiled jobs, ms median "
                f"{percentile(ms, 50):.1f} max {max(ms):.1f}")
        for line in table(tr, v) if v is not None else ():
            log(f"spans: {line}")
    return v


def _make_view(tr, snap):
    if not snap or not snap.get("spans") or not tr.jobs:
        return None
    raw = snap["spans"]
    ref = min(r[4] for r in raw)
    sec = [(n, i, p, r, (s - ref) * 1e-9, (e - ref) * 1e-9)
           for n, i, p, r, s, e in raw]
    roots = sorted(((i, s, e) for _, i, p, _, s, e in sec if p == 0),
                   key=lambda x: x[1])
    if not roots:
        return None
    found = align(sorted(tr.jobs), roots)
    if found is None:
        return None
    d, ids = found
    spans = [Span(n, i, p, r, s + d, e + d) for n, i, p, r, s, e in sec
             if r in ids]
    return View(spans, dict(snap.get("counters", {})), len(tr.jobs),
                int(snap.get("dropped", 0)))


@dataclass
class Idle:
    """The device's idle seconds inside the profiled jobs: ``by_name``,
    by the innermost span over them (``OUTSIDE`` where no span of the
    program is); ``own``, each span name's own time; ``total``; and
    ``root_self``, the idle under a root span's own time."""
    by_name: dict
    own: dict
    total: float
    root_self: float

    def below_root_share(self):
        """The share of the idle time under a span below the job's root
        span, or ``None`` where the device never idled."""
        if self.total <= 0:
            return None
        return (self.total - self.by_name[OUTSIDE]
                - self.root_self) / self.total


def idle_by_span(tr, v) -> Idle:
    idle = subtract(merge(tr.jobs), merge((s, e) for _, s, e in tr.device))
    by_name, own, root_self = {}, {}, 0.0
    selfs = v.self_intervals()
    for s, e, sp in selfs:
        own[sp.name] = own.get(sp.name, 0.0) + (e - s)
    # the idle intervals against the spans' own time, both sorted
    j = 0
    for s, e, sp in selfs:
        while j < len(idle) and idle[j][1] <= s:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < e:
            lo, hi = max(s, idle[k][0]), min(e, idle[k][1])
            if hi > lo:
                by_name[sp.name] = by_name.get(sp.name, 0.0) + (hi - lo)
                if sp.parent == 0:
                    root_self += hi - lo
            k += 1
    total = sum(e - s for s, e in idle)
    by_name[OUTSIDE] = max(0.0, total - sum(by_name.values()))
    return Idle(by_name, own, total, root_self)


def table(tr, v) -> list:
    """The idle-by-span table's lines, largest idle first, per job."""
    idle = idle_by_span(tr, v)
    by_name, own, total = idle.by_name, idle.own, idle.total
    share = idle.below_root_share()
    n = {}
    for s in v.spans:
        n[s.name] = n.get(s.name, 0) + 1
    jobs = v.jobs
    lines = [f"{jobs} jobs, {len(v.spans)} spans ({v.dropped} dropped); "
             f"device idle inside the jobs {total * 1e3 / jobs:.3f} ms a "
             "job, under a span below the job's root "
             + ("n/a" if share is None else f"{100 * share:.1f}%"),
             f"{'span':<40} {'n/job':>8} {'self ms/job':>12} "
             f"{'idle ms/job':>12} {'idle %':>7}"]
    for name in sorted(set(own) | set(by_name),
                       key=lambda x: -by_name.get(x, 0.0)):
        idle = by_name.get(name, 0.0)
        lines.append(
            f"{name:<40} {n.get(name, 0) / jobs:>8.2f} "
            f"{own.get(name, 0.0) * 1e3 / jobs:>12.3f} "
            f"{idle * 1e3 / jobs:>12.3f} "
            f"{(100 * idle / total if total > 0 else 0.0):>7.2f}")
    lines.append("counters a job: " + " ".join(
        f"{k}={c / jobs:.6g}" for k, c in sorted(v.counters.items())))
    return lines
