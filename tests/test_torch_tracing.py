"""The port's tracing recorder (``graphmat_tpu_torch/utils/timing.py``)
on the main path: off, a span is the shared null context, reads no clock
and enters no ``record_function``; on, under a CPU ``torch.profiler``,
each app call is one tree of well-nested spans, ``engine.step`` counts
the iterations, the copy counters equal the bytes that crossed, the
spans lie within 100 us of their own annotations in the exported Chrome
trace once ``perfbench/spans.py`` places them on the trace's clock, the
apps' inits hand ``Graph`` arrays made on its device, and the answers
equal the answers with tracing off."""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from graphmat_tpu_torch.apps.bfs import init_bfs_graph, run_bfs
from graphmat_tpu_torch.apps.pagerank import run_pagerank
from graphmat_tpu_torch.apps.sgd import init_sgd_graph, run_sgd
from graphmat_tpu_torch.apps.triangle_counting import run_triangle_counting
from graphmat_tpu_torch.core.graph import Graph
from graphmat_tpu_torch.utils import timing
from graphmat_tpu_torch.utils.generators import rmat_edgelist
from perfbench import spans as pspans
from perfbench.trace import JOB_SPAN, from_chrome

APPS = {
    "pagerank": (lambda g: run_pagerank(g), "app.pagerank"),
    "bfs": (lambda g: run_bfs(g, 1), "app.bfs"),
    "sgd": (lambda g: run_sgd(g, k=4, iterations=3), "app.sgd"),
    "tc_bucketed": (lambda g: run_triangle_counting(g, method="bucketed"),
                    "app.tc"),
    "tc_engine": (lambda g: run_triangle_counting(g, method="engine"),
                  "app.tc"),
}


@pytest.fixture(scope="module")
def graph():
    return Graph(rmat_edgelist(9, 8, seed=3, device="cpu"), device="cpu")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.delenv("GRAPHMAT_TPU_TIMING", raising=False)
    timing.reset()
    yield
    monkeypatch.delenv("GRAPHMAT_TPU_TIMING", raising=False)
    timing.reset()


def _profiled(fn, g, jobs=1):
    """``jobs`` calls of ``fn(g)`` under a CPU profiler, each inside the
    benchmark's job annotation: (answers, profiler)."""
    out = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):    # the first annotation is slow
            pass
        for _ in range(jobs):
            with record_function(JOB_SPAN):
                out.append(fn(g))
    return out, prof


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_off_a_span_is_the_shared_null_context(graph):
    assert not timing.recording()
    assert timing.span("x") is timing.NULL_SPAN
    with timing.span("x"):
        timing.count("n")
    for fn, _ in APPS.values():
        fn(graph)
    snap = timing.snapshot()
    assert snap == {"spans": [], "counters": {}, "totals": {}, "dropped": 0}


def test_off_no_record_function_no_clock_no_nbytes(graph, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("read while the recorder is off")

    class Boom:
        @property
        def nbytes(self):
            boom()
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(timing, "time", types.SimpleNamespace(
        time_ns=boom, perf_counter=boom))
    timing.copied("dtoh", Boom())
    for fn, _ in APPS.values():
        fn(graph)
    assert timing.snapshot()["spans"] == []


def _check_tree(recs, root_name):
    by_id = {r[1]: r for r in recs}
    assert len(by_id) == len(recs)
    roots = [r for r in recs if r[2] == 0]
    assert [r[0] for r in roots] == [root_name]
    root = roots[0][1]
    for name, sid, parent, rid, t0, t1 in recs:
        assert rid == root and t0 <= t1
        if parent:
            p = by_id[parent]
            assert p[4] <= t0 and t1 <= p[5], (name, p[0])


@pytest.mark.parametrize("app", sorted(APPS))
def test_one_tree_of_spans_a_call_and_the_counts(graph, app, monkeypatch):
    fn, root_name = APPS[app]
    read, took = [], []
    vp_numpy, init_vp = Graph.vp_numpy, Graph.init_vertexproperty

    def spy_read(self):
        out = vp_numpy(self)
        read.append(sum(a.nbytes for a in out.values()))
        return out

    def spy_init(self, **fields):
        took.append(sum(
            v.nbytes for v in fields.values()
            if isinstance(v, (np.ndarray, np.generic))
            or (isinstance(v, torch.Tensor) and v.device.type == "cpu")))
        return init_vp(self, **fields)
    monkeypatch.setattr(Graph, "vp_numpy", spy_read)
    monkeypatch.setattr(Graph, "init_vertexproperty", spy_init)
    (answer,), _ = _profiled(fn, graph)
    snap = timing.snapshot()
    recs = snap["spans"]
    _check_tree(recs, root_name)
    names = [r[0] for r in recs]
    steps = names.count("engine.step")
    c = snap["counters"]
    assert c.get("engine.steps", 0) == steps
    assert names.count("engine.send") == names.count("engine.spmv") \
        == names.count("engine.apply") == steps
    if app == "pagerank":          # the degree pass's one step, then PR's
        assert steps == answer[1] + 1
    elif app == "bfs":
        assert steps == answer[2]
    elif app == "sgd":             # two RMSE passes around the sweeps
        assert steps == 3 + 2
    converge = names.count("engine.converge")
    total = 8 if app == "tc_bucketed" else 0
    assert c["copy.dtoh.bytes"] == sum(read) + converge + total
    assert c["copy.dtoh.n"] == (converge + (1 if total else 0)
                                + sum(len(_vp_fields(app)) for _ in read))
    assert c.get("copy.htod.bytes", 0) == sum(took)
    assert names.count("graph.readback") == len(read)
    # the recorder's totals agree with its spans, as a PhaseTimer
    timer = timing.phase_timer(snap)
    assert timer.counts == {n: names.count(n) for n in set(names)}
    assert "engine.step time = " in timer.summary() or steps == 0


INITS = {
    "bfs": lambda g: init_bfs_graph(g, 1),
    "sgd": lambda g: init_sgd_graph(g, k=5),
}


@pytest.mark.parametrize("app", sorted(INITS))
def test_init_makes_its_arrays_on_the_graph_device(graph, app, monkeypatch):
    """``init_bfs_graph`` and ``init_sgd_graph`` hand ``Graph`` no numpy
    array: the ids and the factors are made on the graph's device, the
    fill values are 0-d tensors.  So what the recorder counts as copied up
    is those arrays, which cross nothing, and a few scalar bytes: a CPU
    graph's own device is the host, so ``Graph`` counts its tensors as
    host data here, and on a card only the scalars
    (``tests/test_torch_cuda.py``).  The recorder counts nothing else."""
    init = INITS[app]
    fields = []
    init_vp = Graph.init_vertexproperty

    def spy_init(self, **kw):
        fields.append(kw)
        return init_vp(self, **kw)
    monkeypatch.setattr(Graph, "init_vertexproperty", spy_init)
    with profile(activities=[ProfilerActivity.CPU]):
        init(graph)
    (got,) = fields
    arrays = [v for v in got.values() if v.dim() > 0]
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    assert arrays and all(v.device == graph.device
                          and v.shape[0] == graph.n for v in arrays)
    c = timing.snapshot()["counters"]
    scalars = c["copy.htod.bytes"] - sum(v.nbytes for v in arrays)
    assert 0 < scalars <= 16 and c["copy.htod.n"] == len(got)
    assert all(k.startswith("copy.") for k in c)


def _vp_fields(app):
    return {"pagerank": ("pagerank", "degree"),
            "bfs": ("depth", "parent", "id"),
            "sgd": ("lv", "sqerr"),
            "tc_bucketed": ("triangles",),
            "tc_engine": ("triangles", "neighbors")}[app]


@pytest.mark.parametrize("app", sorted(APPS))
def test_spans_align_with_their_annotations(graph, app, tmp_path):
    fn, _ = APPS[app]
    _, prof = _profiled(fn, graph, jobs=3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    tr = from_chrome(doc)
    assert len(tr.jobs) == 3
    v = pspans.view(tr, timing.snapshot())
    assert v is not None and v.jobs == 3
    assert len(v.spans) == len(timing.snapshot()["spans"])
    events = {}
    for ev in doc["traceEvents"]:
        if ev.get("cat") == "user_annotation" and ev.get("ph") == "X":
            s = float(ev["ts"]) * 1e-6
            events.setdefault(ev["name"], []).append(
                (s, s + float(ev["dur"]) * 1e-6))
    mine = {}
    for s in v.spans:
        mine.setdefault(s.name, []).append((s.start, s.end))
    # An error of the offset moves both ends of every span alike.  A span
    # whose length differs from its annotation's by more than 50 us had
    # one of its own stamps delayed (the scheduler, or the profiler
    # growing its buffers): it says nothing of the offset.  At most a
    # quarter of the spans may be such; every other lies within 100 us at
    # both ends.
    checked = delayed = 0
    for name, ivs in mine.items():
        theirs = sorted(events[name])
        assert len(theirs) == len(ivs), name
        for (s, e), (ts, te) in zip(sorted(ivs), theirs):
            if abs((e - s) - (te - ts)) > 50e-6:
                delayed += 1
                continue
            checked += 1
            assert abs(s - ts) < 100e-6 and abs(e - te) < 100e-6, (
                name, s - ts, e - te)
    assert checked >= 3 * delayed, (delayed, checked)


@pytest.mark.parametrize("app", sorted(APPS))
def test_answers_with_tracing_on_equal_answers_off(graph, app):
    fn, _ = APPS[app]
    off = fn(graph)
    (on,), _ = _profiled(fn, graph)
    assert timing.snapshot()["spans"]
    _equal(off, on)


def test_the_switch_turns_it_on_without_a_profiler(graph, monkeypatch):
    monkeypatch.setenv("GRAPHMAT_TPU_TIMING", "1")
    timing.reset()
    assert timing.recording() and timing.span("x") is not timing.NULL_SPAN
    run_pagerank(graph)
    names = [r[0] for r in timing.snapshot()["spans"]]
    assert names[-1] == "app.pagerank" and "engine.step" in names


def test_past_the_cap_it_keeps_totals_and_counts_drops(graph, monkeypatch):
    monkeypatch.setattr(timing.RECORDER, "cap", 5)
    _profiled(APPS["bfs"][0], graph)
    snap = timing.snapshot()
    kept, dropped = len(snap["spans"]), snap["dropped"]
    assert kept == 5 and dropped > 0
    assert sum(n for n, _ in snap["totals"].values()) == kept + dropped


def test_upload_and_readback_of_the_frontier(graph):
    mask = np.zeros(graph.n, bool)
    mask[::3] = True
    with profile(activities=[ProfilerActivity.CPU]):
        graph.set_active_mask(mask)
        got = graph.active_numpy()
        one = graph.get_vertexproperty(2)
    np.testing.assert_array_equal(got, mask)
    snap = timing.snapshot()
    assert [r[0] for r in snap["spans"]] == [
        "graph.upload", "graph.readback", "graph.readback"]
    c = snap["counters"]
    assert c["copy.htod.bytes"] == mask.nbytes and c["copy.htod.n"] == 1
    assert c["copy.dtoh.bytes"] == graph.n_pad + sum(
        a.nbytes for a in one.values())


@pytest.mark.parametrize("permute", [False, "degree"])
def test_readback_on_a_cpu_graph_counts_no_pinned_copy(permute):
    """On a CPU graph ``vp_numpy`` and ``active_numpy`` take no page-locked
    block: the fields come back as the tensors' own numpy views, in
    original order, counted as ``copy.dtoh`` and never as
    ``copy.pinned``."""
    g = Graph(rmat_edgelist(8, 8, seed=4, device="cpu"), device="cpu",
              permute=permute)
    n = g.n
    g.init_vertexproperty(
        i=torch.arange(n, dtype=torch.int32),
        f=torch.linspace(0, 1, n, dtype=torch.float64),
        m=torch.arange(n) % 3 == 0,
        w=torch.arange(2 * n, dtype=torch.float32).reshape(n, 2))
    g.set_active_mask(np.arange(n) % 5 == 0)
    idx = slice(None, n) if g.perm is None else g.perm
    with profile(activities=[ProfilerActivity.CPU]):
        vp = g.vp_numpy()
        act = g.active_numpy()
    assert list(vp) == ["i", "f", "m", "w"]
    for k, v in g.vp.items():
        want = v[idx].numpy()
        assert vp[k].dtype == want.dtype and vp[k].shape == want.shape
        np.testing.assert_array_equal(vp[k], want)
    np.testing.assert_array_equal(vp["i"], np.arange(n))
    np.testing.assert_array_equal(act, np.arange(n) % 5 == 0)
    c = timing.snapshot()["counters"]
    assert not [k for k in c if k.startswith("copy.pinned")]
    perm_bytes = 0 if g.perm is None else g.perm.numel() * 8
    assert c["copy.dtoh.n"] == 4 + 1 + (g.perm is not None)
    assert c["copy.dtoh.bytes"] == (sum(a.nbytes for a in vp.values())
                                    + g.n_pad + perm_bytes)
