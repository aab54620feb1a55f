"""The ACTIVE_ONLY K-wide route: the port's Engine on ACTIVE_ONLY
subclasses of SGD, RMSE and LDA against the JAX package's XLA Engine,
from the same numpy-seeded frontiers and the JAX weights carried over.

The JAX package ships no ACTIVE_ONLY K-wide app: the programs are its
own, with ``activity = ACTIVE_ONLY``, as ``tests/test_pallas_vec.py``
makes them.  The comparison is with the JAX XLA path, not with its K4
kernel route: K4 adds ``process(0, val, vp_r)`` for every sender that did
not send (ROADMAP R4), which the port does not copy, and
:func:`test_r4_port_equals_xla_not_k4` shows that difference.

Tolerances: 1e-5 (relative, and absolute for the [0, 1] SGD factors and
LDA counts of order 1): float32 sums in another order (the port sums a
receiver's edges in CSR order, XLA scatters); frontiers exactly, since
every change here is far above the programs' thresholds.
"""

import numpy as np
import pytest

import graphmat_tpu as gj
from graphmat_tpu.apps import lda as jlda
from graphmat_tpu.apps import sgd as jsgd
from graphmat_tpu.core.runtime import Engine as JEngine
from graphmat_tpu.utils.generators import random_edgelist

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import lda as tlda
from graphmat_tpu_torch.apps import sgd as tsgd
from graphmat_tpu_torch.core import runtime
from graphmat_tpu_torch.core.runtime import Engine as TEngine
from graphmat_tpu_torch.ops import spmv_vec

from test_golden import fixture
from test_ml_apps import bipartite_edges

K = 8
NDOC, NTERMS = 9, 14


def _active_only(cls):
    """``cls`` with ``activity = ACTIVE_ONLY``, from its own package's
    Activity."""
    return type(f"ActiveOnly{cls.__name__}", (cls,),
                {"activity": type(cls.activity).ACTIVE_ONLY})


def _frontier(n, share, seed):
    return np.random.default_rng(seed).random(n) < share


def _sgd_case(program):
    """A JAX graph with SGD factors and a frontier of a third of the
    vertices; (JAX program, port program, JAX graph, state)."""
    e = random_edgelist(120, 6, seed=12, weight_range=5)
    g = gj.Graph(e)
    jsgd.init_sgd_graph(g, K)
    g.set_active_mask(_frontier(g.n, 0.35, seed=3))
    if program == "sgd":
        return (_active_only(jsgd.SGDProgram)(step=1e-3, k=K),
                _active_only(tsgd.SGDProgram)(step=1e-3, k=K), g, e, None)
    return (_active_only(jsgd.RMSEProgram)(k=K),
            _active_only(tsgd.RMSEProgram)(k=K), g, e, None)


def _lda_case():
    """A JAX graph after LDA's init, a frontier of 40% of the vertices
    and the global topic totals as numpy state."""
    e = bipartite_edges(NDOC, NTERMS, seed=17)
    g = gj.Graph(e)
    g.init_vertexproperty(N=np.zeros((g.n, K), np.float32),
                          is_doc=np.arange(g.n) < NDOC)
    JEngine(jlda.LDAInitProgram(K), g).run(iterations=1)
    vpn = g.vp_numpy()
    gn = vpn["N"][~vpn["is_doc"]].sum(axis=0)
    g.set_active_mask(_frontier(g.n, 0.4, seed=5))
    return (_active_only(jlda.LDAProgram)(K, vocab_size=NTERMS, ndoc=NDOC),
            _active_only(tlda.LDAProgram)(K, vocab_size=NTERMS, ndoc=NDOC),
            g, e, gn)


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("program", ["sgd", "rmse", "lda"])
def test_engine_matches_jax_xla(program, iterations):
    jprog, tprog, gjx, e, state = (_lda_case() if program == "lda"
                                   else _sgd_case(program))
    gtx = gt.Graph.from_numpy_state(e, gjx.perm, gjx.vp_numpy(),
                                    np.asarray(gjx.active), device="cpu")
    before = dict(spmv_vec.LAUNCHES)
    eng = TEngine(tprog, gtx)
    assert eng._vec is not None
    eng.run(iterations=iterations, state=state)
    assert spmv_vec.LAUNCHES == before   # CPU tensors: the plain version
    eng_j = JEngine(jprog, gjx, use_pallas=False)
    eng_j.run(iterations=iterations, state=state)
    ours, theirs = gtx.vp_numpy(), gjx.vp_numpy()
    for name in theirs:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if state is not None:
        np.testing.assert_allclose(eng.final_state.numpy(),
                                   np.asarray(eng_j.final_state), rtol=1e-5)
    np.testing.assert_array_equal(gtx.active.numpy(), np.asarray(gjx.active))


def test_r4_port_equals_xla_not_k4():
    """ROADMAP R4 on ratings7 at K = 8, every third vertex active, one
    RMSE step: the port equals the JAX XLA path, and the JAX K4 route
    (interpret mode) exceeds it at each receiver by the val² of each edge
    whose sender did not send, since K4 reads that sender's zeroed row."""
    e = gt.load_edgelist(fixture("ratings7.bin.mtx"))
    mask = np.arange(e.n) % 3 == 0

    class VecOnlyRMSE(_active_only(jsgd.RMSEProgram)):
        def pallas_vec2_semiring(self):
            return None   # the K4 route

    out = {}
    for name in ("xla", "k4"):
        g = gj.Graph(e)
        jsgd.init_sgd_graph(g, K)
        g.set_active_mask(mask)
        eng = JEngine(VecOnlyRMSE(k=K), g, use_pallas=name == "k4")
        assert eng.use_pallas_vec == (name == "k4")
        eng.run(iterations=1)
        out[name] = g.vp_numpy()["sqerr"]
    gtx = gt.Graph(e, device="cpu")
    tsgd.init_sgd_graph(gtx, K)
    gtx.set_active_mask(mask)
    TEngine(_active_only(tsgd.RMSEProgram)(k=K), gtx).run(iterations=1)
    ours = gtx.vp_numpy()["sqerr"]
    np.testing.assert_allclose(ours, out["xla"], rtol=1e-5, atol=1e-6)

    # RMSE runs over IN_EDGES: src receives from dst
    src, dst = np.asarray(e.src) - 1, np.asarray(e.dst) - 1
    val = np.asarray(e.val, np.float64)
    got = np.zeros(e.n, bool)
    got[src[mask[dst]]] = True
    extra = np.zeros(e.n)
    np.add.at(extra, src, np.where(mask[dst], 0.0, val ** 2))
    extra[~got] = 0.0    # a receiver without a message keeps its sqerr
    assert extra.max() >= np.min(val ** 2)
    np.testing.assert_allclose(out["k4"] - ours, extra, rtol=2e-3,
                               atol=2e-3)


def test_routes(monkeypatch):
    """ACTIVE_ONLY with a VecSemiring reaches the sparse mode, one call
    per direction; ALL_VERTICES still reaches dense K3."""
    calls = []
    for name in ("spmv_vec", "spmv_vec_sparse"):
        fn = getattr(runtime, name)
        monkeypatch.setattr(runtime, name,
                            lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    e = random_edgelist(60, 4, seed=2, weight_range=5)
    for prog, want in ((_active_only(tsgd.SGDProgram)(k=4),
                        "spmv_vec_sparse"),
                       (tsgd.SGDProgram(k=4), "spmv_vec")):
        g = gt.Graph(e, device="cpu")
        tsgd.init_sgd_graph(g, 4)
        g.set_all_active()
        calls.clear()
        TEngine(prog, g).step_once()
        assert calls == [want, want]   # ALL_EDGES: two directions
