"""The benchmark's readers of the program's spans and counters
(``perfbench/spans.py`` and the six per-layer readers that share it) on
a synthetic trace and recorder snapshot whose values are worked out by
hand, and on empty ones, where each reads nothing."""

import pytest

from perfbench import harness
from perfbench import spans as pspans
from perfbench.trace import Trace

# the recorder's clock: Unix nanoseconds, far from the trace's seconds
BASE_NS = 1_790_000_000_250_000_000


def _ns(t):
    return BASE_NS + round(t * 1e9)


def _job_spans(t, first_id):
    """One job's spans at trace time ``t`` (the job runs t to t + 1):
    (name, id, parent, start, end) relative to ``t``."""
    i = first_id
    rows = [("app.bfs", i, 0, 0.1, 0.9),
            ("app.init", i + 1, i, 0.1, 0.3),
            ("graph.upload", i + 2, i + 1, 0.2, 0.3),
            ("engine.run", i + 3, i, 0.3, 0.7),
            ("engine.step", i + 4, i + 3, 0.3, 0.5),
            ("engine.converge", i + 5, i + 4, 0.45, 0.5),
            ("graph.readback", i + 6, i, 0.7, 0.9)]
    return [(n, sid, p, i, _ns(t + s), _ns(t + e)) for n, sid, p, s, e in rows]


def _snapshot():
    return {"spans": _job_spans(10.0, 1) + _job_spans(12.0, 8),
            "counters": {"copy.dtoh.bytes": 3e6, "copy.htod.bytes": 1e6,
                         "copy.dtoh.n": 6.0, "engine.steps": 2.0,
                         "copy.pinned.n": 8.0, "copy.pinned.new": 2.0},
            "totals": {}, "dropped": 0}


def _trace():
    dev = []
    for t in (10.0, 12.0):
        dev += [("spmv_kernel<0, 0, 0>", t + 0.3, t + 0.4),
                ("Memcpy DtoH (Device -> Pageable)", t + 0.7, t + 0.8)]
    return Trace(device=dev, host=[], jobs=[(10.0, 11.0), (12.0, 13.0)],
                 info=[{"iterations": 2}, {"iterations": 2}])


READERS = {
    # Σ app.init per job: 0.2 s
    "init_ms_per_job.bfs": 200.0,
    # Σ graph.readback per job: 0.2 s
    "readback_ms_per_job.bfs": 200.0,
    # engine.run 0.3-0.7 holds device work 0.3-0.4: idle 0.3 of 0.4
    "engine_idle_share.bfs": 75.0,
    # (3e6 + 1e6) bytes over 2 jobs
    "host_copy_mb_per_job.bfs": 2.0,
    # 6 reads over 4 iterations
    "host_reads_per_iteration.pagerank": 1.5,
    # 2 new blocks of 8 destinations
    "pinned_hit_share.bfs": 75.0,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_synthetic_trace(name, monkeypatch):
    snap = _snapshot()
    monkeypatch.setattr(pspans, "snapshot", lambda: snap)
    got = harness.module("metrics", name).read(_trace(), {})
    assert got == pytest.approx(READERS[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("snap", [None, {"spans": [], "counters": {}}],
                         ids=["no recorder", "no span"])
def test_reader_reads_nothing_without_spans(name, snap, monkeypatch):
    monkeypatch.setattr(pspans, "snapshot", lambda: snap)
    m = harness.module("metrics", name)
    assert m.read(_trace(), {}) is None
    assert m.read(Trace(), {}) is None


def test_pinned_hit_share_reads_nothing_without_pinned_readbacks(
        monkeypatch):
    """Spans but no pinned destination (a CPU graph, or a program that
    reads back into pageable memory): no share."""
    snap = _snapshot()
    for k in ("copy.pinned.n", "copy.pinned.new"):
        del snap["counters"][k]
    monkeypatch.setattr(pspans, "snapshot", lambda: snap)
    m = harness.module("metrics", "pinned_hit_share.bfs")
    assert m.read(_trace(), {}) is None


def test_alignment_puts_each_span_back_on_the_trace_clock():
    v = pspans.view(_trace(), _snapshot())
    assert v.jobs == 2 and len(v.spans) == 14
    init = [(s.start, s.end) for s in v.spans if s.name == "app.init"]
    assert init == [pytest.approx((10.1, 10.3), abs=1e-6),
                    pytest.approx((12.1, 12.3), abs=1e-6)]


def test_spans_outside_the_jobs_are_left_out():
    snap = _snapshot()
    # a call recorded before the profiled window (GRAPHMAT_TPU_TIMING=1)
    snap["spans"] = _job_spans(2.0, 100) + snap["spans"]
    v = pspans.view(_trace(), snap)
    assert len(v.spans) == 14 and min(s.sid for s in v.spans) == 1


def test_idle_by_the_innermost_span():
    tr = _trace()
    idle = pspans.idle_by_span(tr, pspans.view(tr, _snapshot()))
    # per job: idle 0-0.3, 0.4-0.7, 0.8-1.0 (0.8 s); by innermost span
    want = {pspans.OUTSIDE: 0.2, "app.init": 0.1, "graph.upload": 0.1,
            "engine.step": 0.05, "engine.converge": 0.05,
            "engine.run": 0.2, "graph.readback": 0.1}
    assert idle.total == pytest.approx(1.6)
    assert set(idle.by_name) == set(want)
    for name, sec in want.items():
        assert idle.by_name[name] == pytest.approx(2 * sec), name
    assert idle.root_self == pytest.approx(0.0, abs=1e-9)
    assert idle.below_root_share() == pytest.approx(0.75)
    # each name's own time: engine.step less its converge read
    assert idle.own["engine.step"] == pytest.approx(2 * 0.15)
    lines = pspans.table(tr, pspans.view(tr, _snapshot()))
    assert "75.0%" in lines[0] and "engine.run" in "".join(lines)


def test_interval_helpers():
    assert pspans.merge([(3, 4), (1, 2), (1.5, 2.5)]) == [(1, 2.5), (3, 4)]
    assert pspans.subtract([(0, 10)], [(1, 2), (5, 12)]) == [(0, 1), (2, 5)]
    assert pspans.overlap([(0, 2), (3, 5)], [(1, 4)]) == 2
