"""The metric arithmetic: window rates, the tail, the roofline bytes, the
idle share and the readers on synthetic traces."""

import numpy as np
import pytest

from perfbench import harness, roofline
from perfbench.harness import Record
from perfbench.trace import Trace, breakdown, idle_gaps, short_name, \
    union_length


def reader(name):
    return harness.module("metrics", name)


def test_rate_is_all_work_over_all_time():
    jobs = [Record(0.5, 3e9), Record(0.25, 1e9), Record(1.0, 4e9)]
    # the window also holds the harness's time between jobs: 2 s, not 1.75
    assert harness.rate(jobs, 2.0, 1e9) == pytest.approx(4.0)


def test_p95_is_over_every_search():
    rng = np.random.default_rng(0)
    ms = list(rng.exponential(50.0, 257))
    assert harness.percentile(ms, 95) == pytest.approx(np.percentile(ms, 95))
    assert harness.percentile([7.0], 95) == 7.0
    jobs = [Record(m / 1e3, 1.0) for m in ms]
    from perfbench.drivers import bfs
    v, unit = bfs.end_to_end(jobs, 99.0)["bfs_search_ms_p95"]
    assert unit == "ms" and v == pytest.approx(np.percentile(ms, 95))


def test_roofline_bytes_from_n_and_nnz():
    n, nnz = 1 << 24, 263_431_362
    assert roofline.pagerank_step_bytes(n, nnz) == \
        4 * nnz + 4 * (n + 1) + 16 * n
    assert roofline.sgd_sweep_bytes(221_588, 25_000_095, 20) == \
        2 * (8 * 25_000_095 + 4 * 221_589) + 2 * 4 * 221_588 * 20
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12) == pytest.approx(1.0)


def _trace():
    # two jobs over [0, 10] s; device events busy 1-3, 2-4 (overlap), 6-7
    return Trace(
        device=[("spmv_kernel<0, 0, 0>", 1.0, 3.0),
                ("Memcpy DtoH (Device -> Pageable)", 2.0, 4.0),
                ("Memcpy HtoD (Pageable -> Device)", 6.0, 7.0),
                ("after the window", 11.0, 12.0)],
        host=[("aten::copy_", 4.0, 6.0), ("aten::to", 4.5, 5.5),
              ("aten::item", 7.0, 10.0)],
        jobs=[(0.0, 5.0), (5.0, 10.0)],
        info=[{"iterations": 2, "searches": 1}, {"iterations": 2,
                                                 "searches": 1}])


def test_idle_share_from_an_event_list():
    tr = _trace()
    assert union_length([(1, 3), (2, 4), (6, 7)]) == 4.0
    assert tr.window_s == 10.0 and tr.busy_s() == 4.0
    assert tr.idle_share() == pytest.approx(0.6)
    assert reader("device_idle_share.bfs").read(tr, {}) == \
        pytest.approx(60.0)
    # one reader serves every cell's idle share: a new cell adds no copy
    assert reader("device_idle_share.a_new_cell").__file__.endswith(
        "metrics/device_idle_share.py")
    assert reader("device_idle_share.bfs").read(Trace(), {}) is None


def test_idle_gaps_named_by_the_innermost_host_span():
    gaps = dict(idle_gaps(_trace()))
    assert gaps == {"host: python": 1.0, "aten::to": 2.0,
                    "aten::item": 3.0}
    b = breakdown(_trace())
    assert b["idle_gaps"][0] == ["aten::item", 3.0]
    assert [n for n, _ in b["device_ops"]][0] == "spmv_kernel<0, 0, 0>"


def test_copy_readers():
    tr = _trace()
    ctx = {"driver": "pagerank", "n": 100, "nnz": 1000}
    assert reader("dtoh_copies_per_iteration.pagerank").read(tr, ctx) == \
        pytest.approx(1 / 4)
    assert reader("htod_ms_per_search.bfs").read(
        tr, dict(ctx, driver="bfs")) == pytest.approx(500.0)


def test_roofline_share_readers():
    tr = _trace()
    n, nnz = 1 << 24, 1 << 28
    share = reader("step_roofline_share.pagerank").read(
        tr, {"driver": "pagerank", "n": n, "nnz": nnz})
    want = roofline.pagerank_step_bytes(n, nnz) / 3.35e12 * 4 / 4.0
    assert share == pytest.approx(100 * want)
    share = reader("step_roofline_share.sgd").read(
        tr, {"driver": "sgd", "n": n, "nnz": nnz, "k": 20})
    want = roofline.sgd_sweep_bytes(n, nnz, 20) / 3.35e12 * 4 / 4.0
    assert share == pytest.approx(100 * want)


def test_tc_prep_share():
    tr = Trace(device=[("core_count_kernel<2>", 0.0, 1.0),
                       ("tail_count_kernel", 1.0, 2.0),
                       ("DeviceRadixSortOnesweepKernel", 2.0, 8.0)],
               jobs=[(0.0, 10.0)], info=[{"counts": 1}])
    r = reader("tc_prep_share.tc")
    assert r.read(tr, {"driver": "tc"}) == pytest.approx(75.0)
    assert r.read(Trace(device=[("x", 0.0, 1.0)], jobs=[(0.0, 1.0)]),
                  {"driver": "tc"}) is None


def test_readers_find_nothing_without_device_events():
    tr = Trace(jobs=[(0.0, 1.0)], info=[{"iterations": 3, "searches": 1}])
    ctx = {"n": 10, "nnz": 10, "k": 2, "graph_build_s": 0.5}
    for name in harness.per_layer_names("nothing") + [
            p.stem for p in (harness.ROOT / "metrics").glob("*.py")]:
        app = name.rsplit(".", 1)[-1]
        v = reader(name).read(tr, dict(ctx, driver=app))
        assert v is None or name == "graph_build_s"


def test_short_names():
    assert short_name("void (anonymous namespace)::spmv_kernel<0, 0, 0>("
                      "(anonymous namespace)::Args)") == \
        "spmv_kernel<0, 0, 0>"
    assert short_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "BinaryFunctor<float, float, float, at::native::binary_internal::"
        "DivFunctor<float> >, std::array<char*, 3ul> >(int)") == \
        "vectorized_elementwise_kernel[DivFunctor]"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"


def test_answers_checked_are_drawn_from_the_seed():
    picks = [i for i in range(4000) if harness.mix(2 ** 40 + 9, i) % 32
             == 0]
    assert 80 < len(picks) < 170
    assert picks != [i for i in range(4000) if harness.mix(5, i) % 32 == 0]


def test_names_from_outside_are_checked():
    with pytest.raises(ValueError):
        harness.load_cell("../BENCHMARK")


def test_judge():
    res = {}
    harness.judge(res, [(0, "a", 0.1), (1, "a", 0.3), (1, "b", 0.0)],
                  {"a": 0.2, "b": 0})
    assert res["failed"] == 1 and res["correct"] is False
    assert res["checks"]["a"] == {"value": 0.3, "limit": 0.2}
    harness.judge(res, [(0, "a", float("nan")), (0, "b", 0.0)],
                  {"a": 0.2, "b": 0})
    assert res["correct"] is False
    harness.judge(res, [(0, "a", 0.1)], {"a": 0.2, "b": 0})
    assert res["correct"] is False       # a number left unread
