"""The port's SGD collaborative filtering against the JAX package (its CPU
Engine, the XLA path) and the reference binary's golden output.

Tolerances: initial factors bitwise (both draw them with the host
rand_r); RMSE within 1e-6 relative and factors within rtol 1e-5 (float32
sums in another order: the port's K3 sums a receiver's edges in CSR
order, XLA scatters); 1e-6 for one step from a carried-over state and
1e-5 relative for its per-vertex squared errors; the golden file as
``tests/test_golden.py`` holds it."""

import re

import numpy as np
import pytest
import torch

import graphmat_tpu as gj
from graphmat_tpu.apps import sgd as jsgd
from graphmat_tpu.core.runtime import Engine as JEngine
from graphmat_tpu.utils.generators import random_edgelist

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import sgd as tsgd
from graphmat_tpu_torch.core.runtime import Engine as TEngine
from graphmat_tpu_torch.ops import spmv_vec2
from graphmat_tpu_torch.utils.generators import rmat_edgelist

from test_golden import fixture, gold, run_cli

RATINGS7 = fixture("ratings7.bin.mtx")
# compaction forced on at scale 10, as in test_torch_pagerank.py
SMALL_COMPACT = dict(wr=256, hub=16, divert_min=40, bpsb=2, w_div=1)

CASES = {
    # name: (edge list, k, permute, run_sgd keywords)
    "ratings7-k20": (lambda: gt.load_edgelist(RATINGS7), 20, False, {}),
    "random-k40": (lambda: random_edgelist(120, 6, seed=3, weight_range=5),
                   40, False, dict(step=1e-3, iterations=5)),
    "random-k20-degree": (
        lambda: random_edgelist(120, 6, seed=4, weight_range=5), 20,
        "degree", dict(step=1e-3, iterations=5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_sgd_matches_jax(case):
    make, k, permute, kw = CASES[case]
    e = make()
    gtx = gt.Graph(e, permute=permute, device="cpu")
    gjx = gj.Graph(e, permute=permute)
    tsgd.init_sgd_graph(gtx, k)
    jsgd.init_sgd_graph(gjx, k)
    lv0 = gtx.vp_numpy()["lv"]
    np.testing.assert_array_equal(lv0.view(np.uint32),
                                  gjx.vp_numpy()["lv"].view(np.uint32))
    lv_t, r0_t, r1_t = tsgd.run_sgd(gtx, k=k, **kw)
    lv_j, r0_j, r1_j = jsgd.run_sgd(gjx, k=k, **kw)
    assert abs(r0_t - r0_j) <= 1e-6 * r0_j
    assert abs(r1_t - r1_j) <= 1e-6 * r1_j
    assert not np.array_equal(lv_t, lv0)
    np.testing.assert_allclose(lv_t, lv_j, rtol=1e-5, atol=1e-7)


def test_compacted_csr_gives_the_same_sgd():
    """K3 reads the CSR's own senders: a CSR that K1 compacts gives the
    same factors and RMSE, bit for bit."""
    e = rmat_edgelist(10, 16, seed=5)
    e.val = torch.randint(1, 6, (e.nnz,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2))
    out = {}
    for compact in (False, True):
        g = gt.Graph(e, permute="degree", compact=compact,
                     compact_kw=SMALL_COMPACT if compact else None,
                     device="cpu")
        assert all((g.csr(r).src_of_pos is not None) == compact
                   for r in ("dst", "src"))
        out[compact] = tsgd.run_sgd(g, k=20, step=1e-4, iterations=3)
    np.testing.assert_array_equal(out[True][0], out[False][0])
    assert out[True][1:] == out[False][1:]


def test_cli_matches_golden(monkeypatch):
    monkeypatch.setenv("GRAPHMAT_PLATFORM", "cpu")
    monkeypatch.delenv("GRAPHMAT_MESH", raising=False)
    ref = gold("sgd_ratings7.txt")
    ours = run_cli("graphmat_tpu_torch.apps.sgd", [RATINGS7])
    pat = r"RMSE error = ([\d.]+) per edge"
    ref_rmse = [float(x) for x in re.findall(pat, ref)]
    our_rmse = [float(x) for x in re.findall(pat, ours)]
    assert len(ref_rmse) == 2 and len(our_rmse) == 2
    assert abs(our_rmse[0] - ref_rmse[0]) < 1e-5, (our_rmse, ref_rmse)
    assert abs(our_rmse[1] - ref_rmse[1]) < 1e-3, (our_rmse, ref_rmse)
    row = r"^(\d+) : ((?: +[\d.]+)+)"
    ref_tab = {int(v): np.array(r.split(), float)
               for v, r in re.findall(row, ref, re.M)}
    our_tab = {int(v): np.array(r.split(), float)
               for v, r in re.findall(row, ours, re.M)}
    assert len(ref_tab) == 7
    for v, r in ref_tab.items():
        np.testing.assert_allclose(our_tab[v], r, atol=0.015)
    assert re.search(r"^Time = [\d.]+ ms$", ours, re.M)


@pytest.mark.parametrize("permute", [False, "degree"])
def test_step_from_carried_jax_state_matches_jax(permute):
    """A JAX graph a step into SGD, carried over (lv, sqerr, frontier):
    one more SGD step and an RMSE pass agree with JAX's."""
    e = random_edgelist(150, 6, seed=8, weight_range=5)
    gjx = gj.Graph(e, permute=permute)
    jsgd.init_sgd_graph(gjx, 20)
    gjx.set_all_active()
    JEngine(jsgd.SGDProgram(step=1e-3), gjx).step_once()
    gtx = gt.Graph.from_numpy_state(e, gjx.perm, gjx.vp_numpy(),
                                    np.asarray(gjx.active), device="cpu")
    for name, v in gjx.vp_numpy().items():
        np.testing.assert_array_equal(gtx.vp_numpy()[name], v)
    before = dict(spmv_vec2.LAUNCHES)
    eng_t = TEngine(tsgd.SGDProgram(step=1e-3), gtx)
    assert eng_t._vec is not None
    _, conv_t = eng_t.step_once()
    _, conv_j = JEngine(jsgd.SGDProgram(step=1e-3), gjx).step_once()
    assert spmv_vec2.LAUNCHES == before   # CPU tensors: the plain version
    assert conv_t == conv_j
    np.testing.assert_allclose(gtx.vp_numpy()["lv"], gjx.vp_numpy()["lv"],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gtx.active.numpy(), np.asarray(gjx.active))
    TEngine(tsgd.RMSEProgram(), gtx).step_once()
    JEngine(jsgd.RMSEProgram(), gjx).step_once()
    # (rating - <x, lv>)^2 doubles the dot product's relative rounding
    np.testing.assert_allclose(gtx.vp_numpy()["sqerr"],
                               gjx.vp_numpy()["sqerr"], rtol=1e-5)


def test_active_only_vec_program_runs_the_segment_path():
    """K3 takes got from the graph's structure, so an ACTIVE_ONLY program
    with a vec semiring runs the plain segment path (JAX's K4 route is not
    ported); it still computes the same step."""

    class ActiveOnlySGD(tsgd.SGDProgram):
        activity = gt.Activity.ACTIVE_ONLY

    e = random_edgelist(80, 5, seed=9, weight_range=5)
    out = []
    for prog in (tsgd.SGDProgram(step=1e-3), ActiveOnlySGD(step=1e-3)):
        g = gt.Graph(e, device="cpu")
        tsgd.init_sgd_graph(g, 8)
        g.set_all_active()
        eng = TEngine(prog, g)
        assert (eng._vec is None) == isinstance(prog, ActiveOnlySGD)
        eng.step_once()
        out.append(g.vp_numpy()["lv"])
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-7)

