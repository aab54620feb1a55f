"""GetNeighbors and the Engine's vector messages in the port, against the
JAX package's CPU Engine on the same numpy inputs (a vector-message
program runs the XLA segment path there, never Pallas); the concat
reduce and the neighbour-list ops against their JAX counterparts; the
two generators TriangleCounting's tests use.  Everything compared is
exact: ids are integers, and the rows are compared bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphmat_tpu as gj
from graphmat_tpu.apps import get_neighbors as jgn
from graphmat_tpu.core.runtime import Engine as JEngine
from graphmat_tpu.core.types import Activity as JActivity
from graphmat_tpu.core.types import Direction as JDirection
from graphmat_tpu.ops import neighbors as jnb
from graphmat_tpu.ops import segment as jseg
from graphmat_tpu.utils import generators as jgen

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import get_neighbors as tgn
from graphmat_tpu_torch.core.runtime import Engine
from graphmat_tpu_torch.core.types import Activity, Direction
from graphmat_tpu_torch.ops import neighbors as tnb
from graphmat_tpu_torch.ops import segment as tseg
from graphmat_tpu_torch.utils import generators as tgen

PAD = tnb.PAD_ID


def _segments(seed, n_seg, n_edges, trail, dtype):
    """Receiver-sorted segment ids (some segments empty), an OK mask and
    contributions with trailing dims, from numpy."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n_seg - 2, n_edges)).astype(np.int32)
    ok = rng.random(n_edges) < 0.7
    data = rng.integers(-1000, 1000, (n_edges,) + trail).astype(dtype)
    return seg, ok, data


@pytest.mark.parametrize("trail", [(), (3,), (2, 2)])
@pytest.mark.parametrize("width", [1, 3, None])
def test_segment_concat_matches_jax(width, trail):
    seg, ok, data = _segments(1, 12, 60, trail, np.int32)
    if width is None:   # the largest count of OK contributions
        width = int(np.bincount(seg[ok]).max())
    want = jseg.segment_concat(jnp.asarray(data), jnp.asarray(ok),
                               jnp.asarray(seg), 12, width, PAD)
    got = tseg.segment_concat(torch.as_tensor(data), torch.as_tensor(ok),
                              torch.as_tensor(seg), 12, width, PAD)
    assert got.shape == (12, width) + trail
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_concat_tree_casts_pad_per_leaf():
    seg, ok, data = _segments(2, 9, 40, (), np.int32)
    tree = {"i": data, "f": data.astype(np.float32) / 7}
    want = jseg.segment_concat_tree({k: jnp.asarray(v) for k, v in
                                     tree.items()}, jnp.asarray(ok),
                                    jnp.asarray(seg), 9, 4, PAD)
    got = tseg.segment_concat_tree({k: torch.as_tensor(v) for k, v in
                                    tree.items()}, torch.as_tensor(ok),
                                   torch.as_tensor(seg), 9, 4, PAD)
    for k in tree:
        assert got[k].dtype == torch.as_tensor(tree[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("pad_to", [None, 2])
@pytest.mark.parametrize("receiver", ["src", "dst"])
@pytest.mark.parametrize("permute", [False, "degree"])
def test_neighbor_lists_match_jax(permute, receiver, pad_to):
    e = jgen.random_edgelist(90, 5, seed=4)
    gj_ = gj.Graph(e, permute=permute)
    g = gt.Graph(e, permute=permute, device="cpu")
    assert tnb.max_degree(g, receiver) == jnb.max_degree(gj_, receiver)
    want = np.asarray(jnb.collect_neighbors(gj_, receiver, pad_to=pad_to))
    got = tnb.collect_neighbors(g, receiver, pad_to=pad_to)
    np.testing.assert_array_equal(got.numpy(), want)


def test_max_degree_of_a_graph_without_edges():
    e = gt.edgelist_from_arrays(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                m=5, n=5)
    assert tnb.max_degree(gt.Graph(e, device="cpu"), "src") == 1


@pytest.mark.parametrize("width", [1, 6, 17])
def test_intersect_sorted_counts_matches_jax(width):
    rng = np.random.default_rng(width)
    rows = 50

    def sorted_rows():
        out = np.full((rows, width), PAD, np.int32)
        for i in range(rows):
            k = rng.integers(0, width + 1)
            out[i, :k] = np.sort(rng.choice(40, k, replace=False)) + 1
        return out
    a, b = sorted_rows(), sorted_rows()
    want = np.asarray(jnb.intersect_sorted_counts(jnp.asarray(a),
                                                  jnp.asarray(b)))
    got = tnb.intersect_sorted_counts(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    brute = [len((set(x) - {PAD}) & set(y)) for x, y in zip(a, b)]
    np.testing.assert_array_equal(got.numpy(), brute)


def _dense(n):
    """The complete graph with self loops, as the JAX test builds it."""
    src, dst = np.meshgrid(np.arange(1, n + 1), np.arange(1, n + 1),
                           indexing="ij")
    return gj.io.edgelist.edgelist_from_arrays(
        src.ravel(), dst.ravel(), np.ones(n * n, np.int32))


GN_CASES = {
    "dense60": (lambda: _dense(60), False),
    "random200": (lambda: jgen.random_edgelist(200, 5, seed=3), False),
    "permuted150": (lambda: jgen.random_edgelist(150, 4, seed=7), "degree"),
}


@pytest.mark.parametrize("case", sorted(GN_CASES))
def test_get_neighbors_matches_jax(case):
    make, permute = GN_CASES[case]
    e = make()
    want = jgn.run_get_neighbors(gj.Graph(e, permute=permute))
    got = tgn.run_get_neighbors(gt.Graph(e, permute=permute, device="cpu"))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "dense60":
        np.testing.assert_array_equal(got, np.tile(np.arange(1, 61),
                                                   (60, 1)))


def _run_vector_program(pkg_graph, engine_cls, prog, n, frontier=None):
    eng = engine_cls(prog, pkg_graph)
    D = eng.vector_reduced_width
    pkg_graph.init_vertexproperty(
        id=np.arange(1, n + 1, dtype=np.int32),
        neighbors=np.full((n, D), PAD, np.int32))
    if frontier is not None:
        pkg_graph.set_all_inactive()
        pkg_graph.set_active_mask(frontier)
    eng.run(iterations=1)
    return D, pkg_graph.vp_numpy()["neighbors"]


@pytest.mark.parametrize("variant", ["active_only", "all_edges", "capped"])
def test_vector_message_programs_match_jax(variant):
    """ACTIVE_ONLY (only active senders' ids arrive), ALL_EDGES (both
    directions concat into one row) and a max_message_width below the
    max in-degree (contributions past it drop)."""
    class J(jgn.GetNeighborsProgram):
        pass

    class T(tgn.GetNeighborsProgram):
        pass
    frontier = None
    if variant == "active_only":
        J.activity, T.activity = JActivity.ACTIVE_ONLY, Activity.ACTIVE_ONLY
        frontier = np.random.default_rng(0).random(120) < 0.4
    elif variant == "all_edges":
        J.order, T.order = JDirection.ALL_EDGES, Direction.ALL_EDGES
    else:
        J.max_message_width = T.max_message_width = 3
    e = jgen.random_edgelist(120, 4, seed=11)
    wj, want = _run_vector_program(gj.Graph(e), JEngine, J(), 120, frontier)
    wt, got = _run_vector_program(gt.Graph(e, device="cpu"), Engine, T(),
                                  120, frontier)
    assert wt == wj
    np.testing.assert_array_equal(got, want)


def test_vector_message_program_takes_no_kernel_route():
    class WithSemiring(tgn.GetNeighborsProgram):
        def semiring(self):
            return gt.Semiring("sum", "x")
    eng = Engine(WithSemiring(), gt.Graph(jgen.random_edgelist(30, 3, seed=1),
                                          device="cpu"))
    assert eng._semiring is None and eng._vec is None


@pytest.mark.parametrize("n", [1, 2, 7])
def test_generators_match_jax(n):
    for name in ("upper_triangular_edgelist", "dense_edgelist"):
        a, b = getattr(tgen, name)(n), getattr(jgen, name)(n)
        for f in ("src", "dst", "val"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.m, a.n) == (b.m, b.n)
