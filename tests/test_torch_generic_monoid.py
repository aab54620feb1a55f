"""The generic ⊕ (``Monoid(kind="generic")``, GraphMat's arbitrary
``reduce_function``) in the port against the JAX package on the CPU: the
sorted-segment reduce, the Engine's segment route on one device and on
2x2 CPU tiles of a ``LocalMesh``, and ``apply_reduce_all_vertices``.  The
JAX side runs its XLA path (``use_pallas=False``).

Inputs are drawn from numpy seeds.  Tolerances: min, max-abs and gcd
exact; sums within 1e-5 of max(1, |x|) (float32 sums in another order:
the port's scan pairs the terms otherwise than XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphmat_tpu as gj
from graphmat_tpu.apps import pagerank as jpr
from graphmat_tpu.apps import sssp as jsssp
from graphmat_tpu.core.graph_ops import \
    apply_reduce_all_vertices as japply_reduce
from graphmat_tpu.core.runtime import Engine as JEngine
from graphmat_tpu.core.types import Monoid as JMonoid
from graphmat_tpu.ops.segment import segment_reduce as jsegment_reduce
from graphmat_tpu.utils.generators import rmat_edgelist as jrmat

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import pagerank as tpr
from graphmat_tpu_torch.apps import sssp as tsssp
from graphmat_tpu_torch.core.graph_ops import apply_reduce_all_vertices
from graphmat_tpu_torch.core.runtime import engine_for
from graphmat_tpu_torch.core.types import Monoid
from graphmat_tpu_torch.ops.segment import segment_reduce
from graphmat_tpu_torch.parallel.dist_graph import DistGraph
from graphmat_tpu_torch.parallel.dist_graph_ops import \
    apply_reduce_all_vertices as dist_apply_reduce
from graphmat_tpu_torch.parallel.mesh import LocalMesh

SUM_TOL = 1e-5
INT_MAX = np.iinfo(np.int32).max


def _maxabs(where, absf):
    """Max-abs keeping the sign; the earlier operand wins a tie."""
    return lambda a, b: where(absf(a) >= absf(b), a, b)


def _int_max(dt):
    return INT_MAX


# (port monoid, JAX monoid, data dtype, trailing shape, exact)
CASES = {
    "sum": (Monoid("generic", torch.add, lambda dt: 0),
            JMonoid("generic", jnp.add, lambda dt: 0), np.float32, (),
            False),
    "maxabs": (Monoid("generic", _maxabs(torch.where, torch.abs),
                      lambda dt: 0),
               JMonoid("generic", _maxabs(jnp.where, jnp.abs),
                       lambda dt: 0), np.float32, (), True),
    "sum_2d": (Monoid("generic", torch.add, lambda dt: 0),
               JMonoid("generic", jnp.add, lambda dt: 0), np.float32,
               (3,), False),
    "gcd": (Monoid("generic", torch.gcd, lambda dt: 0),
            JMonoid("generic", jnp.gcd, lambda dt: 0), np.int32, (), True),
}


def segments(e, nseg, dtype, tail, seed):
    """Sorted segment ids over the first half of ``nseg`` only (so that
    empty segments exist, a long run among them), and seeded values."""
    rng = np.random.default_rng(seed)
    ids = np.sort(np.concatenate([rng.integers(0, nseg // 2, e - 40),
                                  np.full(40, 3)])).astype(np.int32)
    if np.issubdtype(dtype, np.integer):
        data = (rng.integers(1, 60, (e,) + tail) * 6).astype(dtype)
    else:
        data = rng.standard_normal((e,) + tail).astype(dtype)
    return ids, data


def check(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= SUM_TOL


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("e", [0, 1, 300])
def test_generic_segment_reduce_matches_jax(name, e):
    tm, jm, dtype, tail, exact = CASES[name]
    ids, data = segments(max(e, 41), 50, dtype, tail, seed=len(name))
    ids, data = ids[:e], data[:e]
    got = segment_reduce(tm, torch.from_numpy(data), torch.from_numpy(ids),
                         50)
    want = jax.jit(lambda d, i: jsegment_reduce(jm, d, i, 50))(
        jnp.asarray(data), jnp.asarray(ids))
    check(got.numpy(), want, exact)
    # a segment that no edge reaches holds the identity
    empty = np.setdiff1d(np.arange(50), ids)
    assert (got.numpy()[empty] == 0).all()


def test_generic_monoid_without_identity_raises():
    m = Monoid("generic", torch.add)
    with pytest.raises(ValueError, match="generic Monoid needs identity_fn"):
        m.identity(torch.float32)
    with pytest.raises(ValueError, match="generic Monoid needs identity_fn"):
        segment_reduce(m, torch.ones(3), torch.zeros(3, dtype=torch.int32),
                       2)


# ------------------------------------------------ the Engine's segment route

T_MIN = Monoid("generic", torch.minimum, _int_max)
T_ADD = Monoid("generic", torch.add, lambda dt: 0)


class TMinPlus(tsssp.SSSPProgram):
    """SSSP with its min as a generic ⊕ (its semiring() stays declared:
    the router must still take the segment route)."""
    reduce = T_MIN


class TGenericPageRank(tpr.PageRankProgram):
    reduce = T_ADD


class JMinPlus(jsssp.SSSPProgram):
    reduce = JMonoid("generic", jnp.minimum, _int_max)


class JGenericPageRank(jpr.PageRankProgram):
    reduce = JMonoid("generic", jnp.add, lambda dt: 0)


@pytest.fixture(scope="module")
def rmat10():
    return jrmat(10, 16, seed=6, weight_range=20)


def port_graph(e, where, **kw):
    if where == "one":
        return gt.Graph(e, device="cpu", **kw)
    return DistGraph(e, LocalMesh(["cpu"] * 4, (2, 2)), **kw)


@pytest.mark.parametrize("where", ["one", "tiles"])
def test_generic_min_plus_engine_matches_jax(rmat10, where):
    jg = gj.Graph(rmat10, build_in_edges=False)
    jsssp.init_sssp_graph(jg, 1)
    jit = JEngine(JMinPlus(), jg, use_pallas=False).run()
    g = port_graph(rmat10, where, build_in_edges=False)
    tsssp.init_sssp_graph(g, 1)
    eng = engine_for(TMinPlus(), g)
    assert eng._semiring is None and eng._vec is None
    it = eng.run()
    assert it == jit
    np.testing.assert_array_equal(g.vp_numpy()["distance"],
                                  jg.vp_numpy()["distance"])
    # and the kernel route's (K1's plain version) distances, exactly
    ref, _ = tsssp.run_sssp(gt.Graph(rmat10, device="cpu",
                                     build_in_edges=False), 1)
    np.testing.assert_array_equal(g.vp_numpy()["distance"], ref)


@pytest.mark.parametrize("where", ["one", "tiles"])
def test_generic_sum_pagerank_matches_jax(rmat10, where):
    jg = gj.Graph(rmat10)
    jpr.init_pagerank_graph(jg)
    jg.set_all_active()
    JEngine(jpr.DegreeProgram(), jg, use_pallas=False).run(iterations=1)
    JEngine(JGenericPageRank(), jg, use_pallas=False).run(iterations=10)
    g = port_graph(rmat10, where)
    tpr.init_pagerank_graph(g)
    g.set_all_active()
    engine_for(tpr.DegreeProgram(), g).run(iterations=1)
    assert engine_for(TGenericPageRank(), g).run(iterations=10) == 10
    check(g.vp_numpy()["pagerank"], jg.vp_numpy()["pagerank"], False)


# ------------------------------------------------- apply_reduce_all_vertices

def test_generic_apply_reduce_matches_jax():
    e = jrmat(8, 4, seed=9)
    jg = gj.Graph(e)
    vals = (np.arange(jg.n, dtype=np.int32) % 37 + 1) * 6
    jg.init_vertexproperty(v=vals, f=vals.astype(np.float32) / 7)
    jgcd = JMonoid("generic", jnp.gcd, lambda dt: 0)
    want = japply_reduce(jg, lambda vp: {"v": vp["v"]}, jgcd)
    mixed = {"v": jgcd, "f": "max"}
    want_mixed = japply_reduce(jg, lambda vp: vp, mixed)
    tgcd = Monoid("generic", torch.gcd, lambda dt: 0)
    for g, reduce in ((gt.Graph(e, device="cpu"), apply_reduce_all_vertices),
                      (DistGraph(e, LocalMesh(["cpu"] * 4, (2, 2))),
                       dist_apply_reduce)):
        g.init_vertexproperty(v=vals, f=vals.astype(np.float32) / 7)
        got = reduce(g, lambda vp: {"v": vp["v"]}, tgcd)
        assert int(got["v"]) == int(want["v"]) == 6
        got = reduce(g, lambda vp: vp, {"v": tgcd, "f": "max"})
        assert int(got["v"]) == int(want_mixed["v"])
        assert float(got["f"]) == float(want_mixed["f"])


def test_generic_apply_reduce_of_nothing_is_the_identity():
    e = jrmat(6, 4, seed=9)
    g = gt.Graph(e, device="cpu")
    g.init_vertexproperty(v=np.int32(5))
    g.valid_vertex = torch.zeros_like(g.valid_vertex)
    got = apply_reduce_all_vertices(
        g, lambda vp: vp["v"], Monoid("generic", torch.gcd,
                                      lambda dt: 0))
    assert int(got) == 0
