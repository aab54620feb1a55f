"""K1, the port's SpMV (plain version on the CPU), against the JAX
package's unified Pallas SpMV run in interpret mode, on the plans of
tests/test_pallas_spmv2u.py.

Tolerances:
* sum: |Δ| ≤ 2e-5 · Σ|terms| of the row — the two sum in different
  orders, and the JAX sparse path perturbs x by up to 1 ulp (ROADMAP H2);
* min and max: bitwise where JAX is finite; where JAX reads beyond
  ±5e29 the port carries the true ±inf (ROADMAP H3);
* the got count: exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphmat_tpu.ops.pallas_spmv2u import build_spmv2u_plan, spmv2u

from graphmat_tpu_torch import Graph, edgelist_from_arrays
from graphmat_tpu_torch.ops.spmv2u import (PROCESS_OPS, spmv,
                                           spmv_csr_reference,
                                           spmv_reference)

N, E = 1500, 12000
PLAN_KW = dict(wr=512, windows=(16, 64), cell_min=64, rows=32, hub=128)
JAX_PROCESS = {"x": lambda a, b: a, "x_mul_val": lambda a, b: a * b,
               "x_add_val": lambda a, b: a + b}
SUM_RTOL = 2e-5


def rand_graph(n, e, seed, skew=False):
    """The generator of tests/test_pallas_spmv2u.py."""
    rng = np.random.default_rng(seed)
    if skew:
        s = np.minimum((rng.pareto(1.0, e) * 3).astype(np.int64), n - 1)
        r = np.minimum((rng.pareto(1.2, e) * 5).astype(np.int64), n - 1)
    else:
        s = rng.integers(0, n, e)
        r = rng.integers(0, n, e)
    v = rng.normal(size=e).astype(np.float32)
    return s.astype(np.int64), r.astype(np.int64), v


@functools.lru_cache(maxsize=None)
def case(skew):
    s, r, v = rand_graph(N, E, seed=3 + skew, skew=skew)
    plan = build_spmv2u_plan(s, r, v, N, **PLAN_KW)
    g = Graph(edgelist_from_arrays(s + 1, r + 1, v, m=N, n=N),
              build_in_edges=False, compact=False, device="cpu")
    return s, r, v, plan, g


def port_graph(s, r, v, n, **kw):
    return Graph(edgelist_from_arrays(s + 1, r + 1, v, m=n, n=n),
                 build_in_edges=False, **kw, device="cpu")


def pad(a, size, fill=0):
    out = np.full(size, fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def assert_sum_close(y, ref, terms_abs):
    bound = SUM_RTOL * terms_abs
    assert (np.abs(y - ref) <= bound).all(), np.max(np.abs(y - ref) - bound)


def assert_minmax_match(y, ref_jax, kind):
    big = np.abs(ref_jax) > 5e29
    np.testing.assert_array_equal(y[~big], ref_jax[~big])
    want = np.where(ref_jax[big] > 0, np.inf, -np.inf)
    np.testing.assert_array_equal(y[big], want)
    if kind == "min":
        assert (y[big] == np.inf).all()
    else:
        assert (y[big] == -np.inf).all()


def terms_abs(g, x, op, sent=None):
    """Σ|process(x[s], v)| per receiver, over contributing edges."""
    c = g.csr("dst")
    u = PROCESS_OPS[op](x[c.col.long()], c.val_f32).abs()
    if sent is not None:
        u = u * sent[c.col.long()].float()
    return torch.zeros(c.n_rows).index_add_(0, c.row.long(), u).numpy()


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("op", ["x", "x_mul_val", "x_add_val"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_dense_matches_jax(kind, op, skew):
    s, r, v, plan, g = case(skew)
    x = (np.arange(N, dtype=np.float32) * 0.25 + 1.0) * np.where(
        np.arange(N) % 3 == 0, -1, 1).astype(np.float32)
    ref = np.asarray(spmv2u(plan, jnp.asarray(pad(x, plan.n_send_pad)),
                            kind, process=JAX_PROCESS[op],
                            interpret=True))[:N]
    c = g.csr("dst")
    xt = torch.from_numpy(pad(x, g.n_pad))
    y = spmv_reference(c, xt, kind, op, val=c.val_f32).numpy()[:N]
    if kind == "sum":
        assert_sum_close(y, ref, terms_abs(g, xt, op)[:N])
    else:
        assert_minmax_match(y, ref, kind)
    # the graph-level entry takes the same plain version on the CPU
    assert torch.equal(spmv(c, xt, kind, op, val=c.val_f32),
                       spmv_reference(c, xt, kind, op, val=c.val_f32))


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("op", ["x", "x_mul_val"])
def test_sparse_got_matches_jax(op, skew):
    s, r, v, plan, g = case(skew)
    rng = np.random.default_rng(1)
    active = rng.random(N) < 0.3
    x = rng.normal(size=N).astype(np.float32)
    sent_np = pad(active, plan.n_send_pad, False)
    y_j, got_j = spmv2u(plan, jnp.asarray(pad(x, plan.n_send_pad)), "sum",
                        process=JAX_PROCESS[op], sent=jnp.asarray(sent_np),
                        with_got=True, interpret=True)
    c = g.csr("dst")
    xt = torch.from_numpy(pad(x, g.n_pad))
    sent = torch.from_numpy(pad(active, g.n_pad, False)).to(torch.uint8)
    y, cnt = spmv_reference(c, xt, "sum", op, val=c.val_f32, sent=sent,
                            want_got=True)
    np.testing.assert_array_equal(cnt.numpy()[:N] > 0,
                                  np.asarray(got_j)[:N])
    assert_sum_close(y.numpy()[:N], np.asarray(y_j)[:N],
                     terms_abs(g, xt, op, sent)[:N])
    # the count is the number of edges from active senders
    want = np.zeros(N, np.int64)
    np.add.at(want, r, active[s])
    np.testing.assert_array_equal(cnt.numpy()[:N], want)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_sparse_equals_identity_filled_dense(kind):
    """Skipping unsent senders equals identity-filling their x, for a ⊗
    that absorbs the identity (x*val for sum, x+val for min/max)."""
    s, r, v, plan, g = case(True)
    rng = np.random.default_rng(5)
    active = torch.from_numpy(pad(rng.random(N) < 0.2, g.n_pad, False))
    x = torch.from_numpy(pad(rng.normal(size=N).astype(np.float32),
                             g.n_pad))
    ident = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[kind]
    op = "x_mul_val" if kind == "sum" else "x_add_val"
    c = g.csr("dst")
    dense = spmv_reference(c, x.masked_fill(~active, ident), kind, op,
                           val=c.val_f32)
    sparse = spmv_reference(c, x, kind, op, val=c.val_f32,
                            sent=active.to(torch.uint8))
    if kind == "sum":
        torch.testing.assert_close(sparse, dense, rtol=0, atol=1e-5)
    else:
        assert torch.equal(sparse, dense)


def test_empty_rows_get_identity_and_single_edge():
    g = port_graph(np.array([3]), np.array([7]),
                   np.array([2.5], np.float32), 300)
    c = g.csr("dst")
    x = torch.ones(g.n_pad)
    y = spmv_reference(c, x, "sum", "x_mul_val", val=c.val_f32)
    assert float(y[7]) == 2.5 and int((y != 0).sum()) == 1
    assert torch.isinf(spmv_reference(c, x, "min", "x")[:7]).all()
    assert float(spmv_reference(c, x, "max", "x")[0]) == float("-inf")


def test_wrapper_rejects_bad_arguments():
    s, r, v, plan, g = case(False)
    c = g.csr("dst")
    x = torch.zeros(g.n_pad)
    with pytest.raises(ValueError, match="process_op"):
        spmv(c, x, "sum", "x_times_two")
    with pytest.raises(ValueError, match="reduce_kind"):
        spmv(c, x, "prod", "x")
    with pytest.raises(ValueError, match="reads val"):
        spmv(c, x, "sum", "x_mul_val")
    with pytest.raises(TypeError, match="float32"):
        spmv(c, x.double(), "sum", "x")
    with pytest.raises(ValueError, match="want_got"):
        spmv(c, x, "min", "x", sent=torch.zeros(g.n_pad, dtype=torch.uint8),
             want_got=True)
    with pytest.raises(TypeError, match="uint8"):
        spmv(c, x, "sum", "x", sent=torch.zeros(g.n_pad, dtype=torch.bool))
    with pytest.raises(ValueError, match="senders"):
        spmv(c, x[:-1], "sum", "x")


def test_csr_reference_derives_rows():
    s, r, v, plan, g = case(True)
    c = g.csr("dst")
    x = torch.linspace(-1, 1, g.n_pad)
    assert torch.equal(
        spmv_csr_reference(c.rowptr, c.col, x, "max", "x"),
        spmv_csr_reference(c.rowptr, c.col, x, "max", "x", row=c.row))
