"""The port's utilities against the JAX package's, where their text or
values can be compared: ``PhaseTimer`` and ``timing_enabled``
(``utils/timing.py``), ``Counters`` and ``log_iteration``
(``utils/logging.py``), ``print_first`` (``apps/_cli.py``),
``debug_enabled`` and ``assert_all_finite`` (``utils/debug.py``); and the
port's own debug validators of the CSRs and work splits it builds, which
pass on good graphs and name the invariant that a CSR corrupted in one
way breaks.  Everything here is exact.
"""

import logging

import numpy as np
import pytest
import torch

from graphmat_tpu.apps import _cli as jcli
from graphmat_tpu.utils import debug as jdebug
from graphmat_tpu.utils import logging as jlogging
from graphmat_tpu.utils import timing as jtiming

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import _cli as tcli
from graphmat_tpu_torch.core import graph as tgraph
from graphmat_tpu_torch.ops import spmv2, spmv2u
from graphmat_tpu_torch.parallel.dist_graph import DistGraph
from graphmat_tpu_torch.parallel.mesh import LocalMesh
from graphmat_tpu_torch.utils import debug, logging as tlogging, timing
from graphmat_tpu_torch.utils.generators import rmat_edgelist

COMPACT_KW = dict(wr=256, hub=16, divert_min=40, bpsb=2, w_div=1)


def test_phase_timer_summary_matches_jax():
    timers = (timing.PhaseTimer(), jtiming.PhaseTimer())
    for t in timers:
        t.record("spmv", 0.0012345)
        t.record("apply", 0.5)
        t.record("spmv", 0.002)
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].counts == {"spmv": 2, "apply": 1}
    assert timers[0].rate("apply", 10.0) == timers[1].rate("apply", 10.0)
    assert timers[0].rate("none", 1.0) == float("inf")
    with timers[0].phase("build"):
        pass
    assert timers[0].counts["build"] == 1
    off = timing.PhaseTimer(enabled=False)
    with off.phase("x"):
        pass
    assert off.totals == {}


def test_phase_timer_report(capsys):
    for t in (timing.PhaseTimer(), jtiming.PhaseTimer()):
        t.record("run", 0.25)
        t.report()
    a, b = capsys.readouterr().out.splitlines()
    assert a == b == "run time = 250.000 ms (n=1)"


@pytest.mark.parametrize("value", [None, "", "0", "false", "1", "yes"])
def test_env_switches_match_jax(value, monkeypatch):
    for var in ("GRAPHMAT_TPU_TIMING", "GRAPHMAT_DEBUG"):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    assert timing.timing_enabled() == jtiming.timing_enabled()
    assert debug.debug_enabled() == jdebug.debug_enabled()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with timing.profile_trace(str(tmp_path)) as prof:
        torch.ones(64).sum()
    assert prof is not None
    assert any(f.suffix == ".json" for f in tmp_path.iterdir())


def test_counters_match_jax():
    cs = (tlogging.Counters(), jlogging.Counters())
    for c in cs:
        c.add("edges", 1234567)
        c.add("frontier")
        c.add("edges", 0.5)
    assert cs[0].summary() == cs[1].summary()
    assert cs[0].values == cs[1].values
    assert cs[0].rate("edges") > 0 and cs[0].rate("none") == 0.0


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("kw", [{}, dict(ms=1.23456),
                                dict(nupdated=7, nactive=3),
                                dict(ms=0.5, nupdated=0, nactive=12)])
def test_log_iteration_matches_jax(kw):
    lines = []
    for mod in (tlogging, jlogging):
        logger = mod.get_logger()
        cap = _Capture()
        logger.addHandler(cap)
        try:
            mod.log_iteration(4, **kw)
        finally:
            logger.removeHandler(cap)
        lines.append(cap.lines)
    assert lines[0] == lines[1] and len(lines[0]) == 1
    assert lines[0][0].startswith("Iteration 4")


@pytest.mark.parametrize("args", [dict(), dict(k=3, label="pr "),
                                  dict(k=40)])
def test_print_first_matches_jax(args, capsys):
    vals = np.arange(12, dtype=np.float32) / 7
    tcli.print_first(vals, **args)
    port = capsys.readouterr().out
    jcli.print_first(vals, **args)
    assert port == capsys.readouterr().out and port


def test_assert_all_finite_matches_jax():
    good = torch.tensor([1.0, -2.0, 0.0])
    debug.assert_all_finite("x", good)
    debug.assert_all_finite("ids", torch.arange(4))
    for bad in ([1.0, float("nan")], [float("inf")]):
        msgs = []
        for check, arr in ((debug.assert_all_finite, torch.tensor(bad)),
                           (jdebug.assert_all_finite, np.array(bad))):
            with pytest.raises(AssertionError) as exc:
                check("vec", arr)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1] == "vec contains non-finite values"


# ------------------------------------------------------------ validators

def hub_edges(n=3000, hub_degree=2600, seed=0):
    """Vertex 1 hears from ``hub_degree`` vertices (K1 splits it into
    chunks) and sends to as many (the push splits it), plus random
    edges."""
    rng = np.random.default_rng(seed)
    leaves = np.arange(2, hub_degree + 2)
    s = np.concatenate([leaves, np.ones(hub_degree, np.int64),
                        rng.integers(1, n + 1, 2000)])
    d = np.concatenate([np.ones(hub_degree, np.int64), leaves,
                        rng.integers(1, n + 1, 2000)])
    return gt.edgelist_from_arrays(s, d, np.ones(len(s), np.float32), m=n,
                                   n=n)


def planned(g):
    """Every CSR of ``g`` with K1's and the push's splits kept on it."""
    csrs = ([c for cs in g._tiles.values() for c in cs]
            if isinstance(g, DistGraph) else list(g._csr.values()))
    for c in csrs:
        spmv2u.plan_for(c)
        spmv2.plan_for(c)
    return g


GOOD = {
    "plain": lambda: gt.Graph(rmat_edgelist(10, 16, seed=2, device="cpu"),
                              device="cpu", compact=False),
    "compacted": lambda: gt.Graph(
        rmat_edgelist(10, 16, seed=2, device="cpu"), device="cpu",
        compact=True, compact_kw=COMPACT_KW),
    "hub": lambda: gt.Graph(hub_edges(), device="cpu", compact=False),
    "tiles": lambda: DistGraph(rmat_edgelist(10, 16, seed=2, device="cpu"),
                               LocalMesh(["cpu"] * 4, (2, 2))),
    "compacted_tiles": lambda: DistGraph(
        rmat_edgelist(10, 16, seed=2, device="cpu"),
        LocalMesh(["cpu"] * 4, (2, 2)), compact=True,
        compact_kw=dict(COMPACT_KW, hub=8, divert_min=10_000)),
}


@pytest.mark.parametrize("name", sorted(GOOD))
def test_validators_pass_on_good_graphs(name):
    g = planned(GOOD[name]())
    if "compacted" in name:
        csrs = g.csrs("dst") if isinstance(g, DistGraph) else [g.csr("dst")]
        assert any(c.src_of_pos is not None for c in csrs)
    debug.validate_graph(g)
    if name == "hub":
        assert spmv2u.plan_for(g.csr("dst")).long_rows.numel() > 0
        assert spmv2.plan_for(g.csr("src")).extra_tile.numel() > 0


def _swap(t, i, j):
    t[i], t[j] = t[j].clone(), t[i].clone()


def _diverted(c):
    return int(torch.nonzero(c.col_ext >= c.n_send)[0, 0])


def _corrupt_push(c):
    p = spmv2.plan_for(c)
    c._plans["push"] = spmv2.PushPlan(p.extra_tile[1:], p.extra_k[1:])


def _corrupt_k1_group(c):
    p = spmv2u.plan_for(c)
    c._plans["k1"] = p._replace(rows=p.rows.clone())
    c._plans["k1"].rows[0] = c._plans["k1"].rows[1]


def _corrupt_k1_class(c):
    p = spmv2u.plan_for(c)
    rows = p.rows.clone()
    _swap(rows, 0, rows.numel() - 1)   # a short row among the longest
    c._plans["k1"] = p._replace(rows=rows)


def _corrupt_k1_hub(c):
    p = spmv2u.plan_for(c)
    c._plans["k1"] = p._replace(chunk_start=p.chunk_start + 1)


# invariant -> (graph, corruption of its receiver=dst CSR, or of the
# validate_csr call)
CORRUPT = {
    "rowptr starts at 0": ("plain", lambda c: c.rowptr.__setitem__(0, 1)),
    "rowptr does not decrease": ("plain",
                                 lambda c: _swap(c.rowptr, 5, 700)),
    "rowptr ends at nnz": ("plain",
                           lambda c: c.rowptr.__setitem__(-1, c.nnz + 1)),
    "row matches rowptr": ("plain", lambda c: _swap(c.row, 0, c.nnz - 1)),
    "col lies in [0, n_send)": ("plain",
                                lambda c: c.col.__setitem__(3, c.n_send)),
    "nnz equals the edge count": ("plain", None),
    "compaction buffers have their sizes": (
        "compacted", lambda c: setattr(c, "x_ext", c.x_ext[:-1])),
    "compaction: a diverted edge reads its own sender": (
        "compacted", lambda c: c.src_of_pos.__setitem__(
            int(c.col_ext[_diverted(c)]) - c.n_send,
            (c.col[_diverted(c)] + 1) % c.n_send)),
    "k1 plan: every row in one group": ("plain", _corrupt_k1_group),
    "k1 plan: a row in its length class": ("plain", _corrupt_k1_class),
    "k1 plan: a hub row's chunks cover it": ("hub", _corrupt_k1_hub),
    "push plan: covers every edge once": ("hub", _corrupt_push),
    "a direction holds n_pad rows over n_pad senders": (
        "plain", lambda c: setattr(c, "n_send", c.n_send + 1)),
    "a tile holds C * S rows over R * S senders": (
        "tiles", lambda c: setattr(c, "n_send", c.n_send + 128)),
}


@pytest.mark.parametrize("invariant", sorted(CORRUPT))
def test_validators_name_the_broken_invariant(invariant):
    name, corrupt = CORRUPT[invariant]
    g = planned(GOOD[name]())
    c = g.csrs("dst")[0] if isinstance(g, DistGraph) else g.csr("dst")
    match = "invariant violated: " + invariant.replace("(", r"\(").replace(
        ")", r"\)").replace("[", r"\[").replace("*", r"\*")
    if corrupt is None:
        with pytest.raises(AssertionError, match=match):
            debug.validate_csr(c, c.nnz + 1)
        return
    corrupt(c)
    with pytest.raises(AssertionError, match=match):
        debug.validate_graph(g)


def test_debug_env_validates_each_build(monkeypatch):
    """GRAPHMAT_DEBUG=1: each CSR is validated when it is built (with its
    edge count) and each work split when CSR.plan builds it; unset,
    nothing is."""
    seen = []
    monkeypatch.setattr(tgraph, "validate_csr",
                        lambda c, nnz=None: seen.append(("csr", nnz)))
    monkeypatch.setattr(tgraph, "validate_plan",
                        lambda name, rp, p: seen.append(("plan", name)))
    e = rmat_edgelist(8, 4, seed=1, device="cpu")
    monkeypatch.delenv("GRAPHMAT_DEBUG", raising=False)
    spmv2u.plan_for(gt.Graph(e, device="cpu").csr("dst"))
    assert seen == []
    monkeypatch.setenv("GRAPHMAT_DEBUG", "1")
    g = gt.Graph(e, device="cpu")
    spmv2u.plan_for(g.csr("dst"))
    spmv2u.plan_for(g.csr("dst"))   # kept: built and checked once
    assert seen == [("csr", e.nnz), ("csr", e.nnz), ("plan", "k1")]
    seen.clear()
    DistGraph(e, LocalMesh(["cpu"] * 4, (2, 2)), build_in_edges=False)
    assert len(seen) == 4 and sum(n for _, n in seen) == e.nnz
