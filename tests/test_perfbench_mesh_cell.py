"""The benchmark's four-card PageRank cell, ``gapkron26.pagerank.mesh2x2``,
on the CPU at scale 10:

* ``gen/kron_undirected.py`` is symmetric, has no self loop or duplicate,
  is sorted, and equals a plain construction from the same stream, drawn
  in chunks and sorted in buckets of several sizes;
* ``reference/pagerank_chunked.py`` equals ``reference/pagerank.py``
  (steps equal, vectors to float64 rounding) at several chunk sizes;
* the driver runs end to end through ``harness.run_cell`` on a 2x2 CPU
  ``LocalMesh`` with ``correct`` true; its bfloat16 control and its
  planted fault turn ``correct`` false;
* the four new per-layer readers (and ``engine_idle_share.mesh``, read by
  the shared reader) on a synthetic trace, and on empty ones, where each
  reads nothing.
"""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench import spans as pspans
from perfbench.control import control_readings
from perfbench.gen import kron, kron_undirected
from perfbench.reference import pagerank, pagerank_chunked
from perfbench.trace import Trace

CELL = "gapkron26.pagerank.mesh2x2"
SEED = 2 ** 33 + 9


def _cfg(scale=10):
    cfg = dict(harness.load_cell(CELL).config)
    cfg["scale"] = scale
    return cfg


def _plain(cfg, seed):
    """The undirected pairs from the whole stream at once."""
    scale = cfg["scale"]
    n = 1 << scale
    keys = kron.kron_keys(scale, n * cfg["edge_factor"], cfg["a"], cfg["b"],
                          cfg["c"], seed, "cpu")
    perm = kron.label_permutation(n, seed, "cpu")
    s, d = perm[keys >> 32], perm[keys & 0xFFFFFFFF]
    u, v = torch.cat((s, d)), torch.cat((d, s))
    keep = u != v
    pairs = torch.unique((u[keep] << 32) | v[keep])
    return (pairs >> 32).to(torch.int32), (pairs & 0xFFFFFFFF).to(torch.int32)


@pytest.mark.parametrize("chunk,bucket", [(1 << 26, 1 << 28), (3000, 4096),
                                          (16384, 1000)])
def test_undirected_kron_is_the_plain_symmetrised_stream(chunk, bucket,
                                                         monkeypatch):
    monkeypatch.setattr(kron_undirected, "CHUNK", chunk)
    monkeypatch.setattr(kron_undirected, "BUCKET_KEYS", bucket)
    cfg = _cfg()
    got = kron_undirected.make(cfg, SEED, "cpu")
    src, dst = got["src"], got["dst"]
    assert got["n"] == 1024 and src.dtype == dst.dtype == torch.int32
    want_s, want_d = _plain(cfg, SEED)
    assert torch.equal(src, want_s) and torch.equal(dst, want_d)
    keys = (src.long() << 32) | dst.long()
    assert bool((keys[1:] > keys[:-1]).all())           # sorted, no dups
    assert not bool((src == dst).any())
    back = torch.sort((dst.long() << 32) | src.long()).values
    assert torch.equal(back, keys)                      # symmetric


def test_undirected_kron_refuses_a_full_scale_draw_on_the_cpu():
    with pytest.raises(ValueError, match="card"):
        kron_undirected.make(_cfg(26), SEED, "cpu")


@pytest.mark.parametrize("chunk", [61, 997, 1 << 27])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_chunked_reference_equals_the_reference(chunk, dtype):
    g = kron_undirected.make(_cfg(), SEED, "cpu")
    n = g["n"]
    src, dst = g["src"][::3], g["dst"][::3]     # directed, some in-less
    want = pagerank.pagerank(src, dst, n, 0.3, 1e-5, dtype,
                             snapshots={5, 9, 60})
    got = pagerank_chunked.pagerank(src + 1, dst + 1, n, 0.3, 1e-5, dtype,
                                    snapshots={5, 9, 60}, base=1,
                                    chunk=chunk)
    assert got[1] == want[1] and sorted(got[2]) == sorted(want[2])
    tol = 1e-12 if dtype == torch.float64 else 0.05
    for a, b in [(got[0], want[0])] + [(got[2][k], want[2][k])
                                       for k in want[2]]:
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=tol, atol=tol)


def _tiny(scale=10):
    cell = harness.load_cell(CELL)
    cell.config["scale"] = scale
    return cell


def test_the_cell_runs_correct_on_a_cpu_mesh():
    res = harness.run_cell(_tiny(), SEED, 0.3, False, "cpu")
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"pagerank_gteps", "setup_s"}
    assert res["checks"]["pr_gap"]["value"] < 1e-6


def test_the_cells_control_and_fault_fail():
    out = control_readings(_tiny(), SEED, "cpu")
    assert out["control_failed"] is True, out
    assert out["tol_100x_looser"]["failed"] is True, out
    assert out["tol_100x_looser"]["checks"]["steps_early"]["value"] > 7


def test_the_cell_runs_its_app_on_a_distgraph(monkeypatch):
    """The job is the app entry on the port's DistGraph over a 2x2
    LocalMesh, not a graph of one device."""
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from perfbench.drivers import pagerank_mesh
    cell = _tiny()
    inp = pagerank_mesh.inputs(cell.config, cell.traffic, SEED, "cpu")
    assert int(inp["src"].min()) == 1          # held 1-based
    g = pagerank_mesh.build(inp, cell.traffic, "cpu")
    assert isinstance(g, DistGraph) and g.mesh.shape == (2, 2)
    assert g.nnz == inp["src"].numel()
    out = pagerank_mesh.job(g, inp, cell.traffic, 0)
    assert out.work == g.nnz * out.info["iterations"]


# ---------------------------------------------------------- the readers

BASE_NS = 1_790_000_000_250_000_000


def _snapshot():
    """Two jobs (trace time 10 and 12, 1 s each): an engine run 0.2-0.8
    of each, inside it one mesh gather; counters over both."""
    rows = []
    for t, i in ((10.0, 1), (12.0, 10)):
        for name, sid, parent, s, e in (
                ("app.pagerank", i, 0, 0.1, 0.9),
                ("engine.run", i + 1, i, 0.2, 0.8),
                ("mesh.all_gather", i + 2, i + 1, 0.3, 0.35)):
            rows.append((name, sid, parent, i, BASE_NS + round((t + s) * 1e9),
                         BASE_NS + round((t + e) * 1e9)))
    return {"spans": rows, "counters": {"mesh.bytes": 6e6,
                                        "engine.steps": 4.0},
            "totals": {}, "dropped": 0}


def _trace():
    dev = []
    for t in (10.0, 12.0):
        # four cards' kernels 0.3-0.7 of the run, the first from 0.2;
        # a peer copy 0.2-0.3; one event outside the run
        dev += [("spmv_kernel<0, 0, 0>", t + 0.2, t + 0.7)]
        dev += [("spmv_kernel<0, 0, 0>", t + 0.3, t + 0.7)] * 3
        dev += [("Memcpy PtoP (Device -> Device)", t + 0.2, t + 0.3),
                ("Memcpy DtoH (Device -> Pageable)", t + 0.85, t + 0.95)]
    return Trace(device=dev, host=[], jobs=[(10.0, 11.0), (12.0, 13.0)],
                 info=[{"iterations": 3}, {"iterations": 5}])


CTX = {"n": 1000, "nnz": 50_000, "mesh": [2, 2]}
READERS = {
    # 6e6 bytes over 4 steps
    "exchange_mb_per_iteration.mesh": 1.5,
    # per job: events 0.5 + 3 * 0.4 + 0.1 + 0.1 = 1.9 s, the copy 0.1
    "exchange_share.mesh": 100.0 * 0.1 / 1.9,
    # inside the run 0.2-0.8: 0.5 + 1.2 + 0.1 = 1.8 s over 0.2-0.7
    "card_overlap.mesh": 1.8 / 0.5,
    # 8 iterations of the bytes bound at four cards' rate, over 2 s of jobs
    "step_roofline_share.mesh": None,
    # busy 0.2-0.7 of the run's 0.2-0.8
    "engine_idle_share.mesh": 100.0 * 0.1 / 0.6,
}


def _want(name):
    if name == "step_roofline_share.mesh":
        from perfbench import roofline
        b = roofline.pagerank_step_bytes(1000, 50_000)
        return 100.0 * b * 8 / (4 * roofline.HBM_BYTES_PER_S) / 2.0
    return READERS[name]


@pytest.mark.parametrize("name", sorted(READERS))
def test_mesh_reader_on_a_synthetic_trace(name, monkeypatch):
    snap = _snapshot()
    monkeypatch.setattr(pspans, "snapshot", lambda: snap)
    got = harness.module("metrics", name).read(_trace(), CTX)
    assert got == pytest.approx(_want(name), rel=1e-6)


@pytest.mark.parametrize("name", sorted(READERS))
def test_mesh_reader_reads_nothing_on_an_empty_trace(name, monkeypatch):
    monkeypatch.setattr(pspans, "snapshot", lambda: None)
    assert harness.module("metrics", name).read(Trace(), CTX) is None


@pytest.mark.parametrize("name", ["exchange_mb_per_iteration.mesh",
                                  "card_overlap.mesh",
                                  "engine_idle_share.mesh"])
def test_span_readers_read_nothing_without_the_programs_spans(
        name, monkeypatch):
    """A program whose engine and mesh record nothing (the parent of
    this cell) gives no reading, and no error."""
    snap = _snapshot()
    snap["spans"] = [r for r in snap["spans"] if r[0] == "app.pagerank"]
    snap["counters"] = {}
    monkeypatch.setattr(pspans, "snapshot", lambda: snap)
    assert harness.module("metrics", name).read(_trace(), CTX) is None
