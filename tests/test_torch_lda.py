"""The port's LDA against the JAX package (its CPU Engine, the XLA path)
and the reference binary's golden output.

Tolerances: N and global_N within rtol 1e-5 and the total
log-likelihood within 1e-5 relative after the reference flow (float32
sums in other orders, through a few multiplicative iterations); 1e-6 for
one step from a carried-over state; per-vertex token totals within 1e-5
relative; the golden file within 2e-3 as ``tests/test_golden.py``
holds it."""

import re

import numpy as np
import pytest

import graphmat_tpu as gj
from graphmat_tpu.apps import lda as jlda
from graphmat_tpu.core.runtime import Engine as JEngine

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import lda as tlda
from graphmat_tpu_torch.core.runtime import Engine as TEngine

from test_golden import fixture, gold, run_cli
from test_ml_apps import bipartite_edges

NDOC, NTERMS = 9, 14


def edges(seed=11):
    return bipartite_edges(NDOC, NTERMS, seed=seed)


@pytest.mark.parametrize("k,permute", [(4, False), (40, False),
                                       (4, "degree"), (160, False),
                                       (200, False)])
def test_run_lda_matches_jax(k, permute):
    e = edges()
    gtx = gt.Graph(e, permute=permute, device="cpu")
    n_t, gn_t, ll_t = tlda.run_lda(gtx, NDOC, NTERMS, k=k, iterations=4)
    n_j, gn_j, ll_j = jlda.run_lda(gj.Graph(e, permute=permute), NDOC,
                                   NTERMS, k=k, iterations=4)
    np.testing.assert_allclose(n_t, n_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gn_t, gn_j, rtol=1e-5)
    assert np.isfinite(ll_t)
    assert abs(ll_t - ll_j) <= 1e-5 * abs(ll_j)


def test_tokens_are_conserved():
    """Each vertex's N sums to the tokens on its edges, both ways."""
    e = edges(seed=4)
    n_t, _, _ = tlda.run_lda(gt.Graph(e, device="cpu"), NDOC, NTERMS, k=6,
                             iterations=3)
    tok = np.zeros(NDOC + NTERMS)
    np.add.at(tok, e.src - 1, e.val)
    np.add.at(tok, e.dst - 1, e.val)
    np.testing.assert_allclose(n_t.sum(axis=1), tok, rtol=1e-5)


def test_cli_matches_golden(monkeypatch):
    monkeypatch.setenv("GRAPHMAT_PLATFORM", "cpu")
    monkeypatch.delenv("GRAPHMAT_MESH", raising=False)
    ref = gold("lda_ratings7.txt")
    ours = run_cli("graphmat_tpu_torch.apps.lda",
                   [fixture("ratings7.bin.mtx"), "3", "4", "10"])
    pat = r"Total Loglikelihood = (-?[\d.]+)"
    m, mo = re.search(pat, ref), re.search(pat, ours)
    assert m and mo
    assert abs(float(mo[1]) - float(m[1])) < 2e-3, (mo[1], m[1])
    assert re.search(r"^Time = [\d.]+ ms$", ours, re.M)


def _after_init(e, k, permute=False):
    g = gt.Graph(e, permute=permute, device="cpu")
    is_doc = np.arange(g.n) < NDOC
    g.init_vertexproperty(N=np.zeros((g.n, k), np.float32), is_doc=is_doc)
    TEngine(tlda.LDAInitProgram(k), g).run(iterations=1)
    vpn = g.vp_numpy()
    return g, vpn["N"][~vpn["is_doc"]].sum(axis=0)


def test_without_ndoc_runs_the_segment_path():
    """``ndoc=0`` leaves the doc/term split to the vertex property: no
    vec semiring, so the plain segment path runs, with the same result."""
    e = edges(seed=6)
    out = []
    for ndoc in (NDOC, 0):
        g, gn = _after_init(e, 5)
        prog = tlda.LDAProgram(5, vocab_size=NTERMS, ndoc=ndoc)
        eng = TEngine(prog, g)
        assert (eng._vec is None) == (ndoc == 0)
        eng.run(iterations=3, state=gn)
        out.append((g.vp_numpy()["N"], eng.final_state.numpy()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)


@pytest.mark.parametrize("permute", [False, "degree"])
def test_step_from_carried_jax_state_matches_jax(permute):
    """A JAX graph one LDA iteration in, carried over (N, is_doc, the
    frontier, and global_N as numpy program state): one more step agrees
    with JAX's, global_N included."""
    e, k = edges(seed=9), 6
    gjx = gj.Graph(e, permute=permute)
    is_doc = np.arange(gjx.n) < NDOC
    gjx.init_vertexproperty(N=np.zeros((gjx.n, k), np.float32),
                            is_doc=is_doc)
    JEngine(jlda.LDAInitProgram(k), gjx).run(iterations=1)
    vpn = gjx.vp_numpy()
    gn = vpn["N"][~vpn["is_doc"]].sum(axis=0)
    prog_j = jlda.LDAProgram(k, vocab_size=NTERMS, ndoc=NDOC)
    eng_j = JEngine(prog_j, gjx)
    eng_j.run(iterations=1, state=gn)
    state = eng_j.final_state            # numpy, from jax.device_get

    gtx = gt.Graph.from_numpy_state(e, gjx.perm, gjx.vp_numpy(),
                                    np.asarray(gjx.active), device="cpu")
    for name, v in gjx.vp_numpy().items():
        np.testing.assert_array_equal(gtx.vp_numpy()[name], v)
    st_t, _ = TEngine(tlda.LDAProgram(k, vocab_size=NTERMS, ndoc=NDOC),
                      gtx).step_once(state=state)
    st_j, _ = eng_j.step_once(state=state)
    np.testing.assert_allclose(gtx.vp_numpy()["N"], gjx.vp_numpy()["N"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=1e-6)
