"""The push kernel's plain version (K6/K7 in the port) against the JAX
package's v2 Pallas kernels in interpret mode (``spmv2`` sum with the
frontier and got, ``spmv2m`` min/max with the frontier, as
tests/test_pallas_spmv2.py:206, 229, 270 run them), and K1's plain
version with ``recv_final`` and the packed-key ⊗ against interpret-mode
``_spmv2u_call``.

Tolerances:
* sum: |Δ| ≤ 2e-5 · Σ|terms| of the row (other summation orders; the JAX
  got path perturbs each active x by up to 1 ulp, ROADMAP H2);
* min and max, the got counts, the packed keys: exact, with the JAX
  kernels' ±1e30 clamp read back as ±inf (ROADMAP H3).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphmat_tpu.ops.pallas_spmv2 import (build_spmv2_plan,
                                           build_spmv2m_plan, spmv2, spmv2m)
from graphmat_tpu.ops.pallas_spmv2u import _spmv2u_call, plan_call_args

from graphmat_tpu_torch import Graph, edgelist_from_arrays
from graphmat_tpu_torch.ops import spmv2 as push
from graphmat_tpu_torch.ops.spmv2u import (KEY_BIAS, PROCESS_OPS,
                                           spmv_reference)

from test_torch_spmv2u import N as U_N
from test_torch_spmv2u import PLAN_KW as U_KW
from test_torch_spmv2u import JAX_PROCESS, case, pad

N, E = 1200, 9000
BIG = 1e30
SUM_RTOL = 2e-5
PLAN_KW = dict(wr=512, windows=(16, 64), cell_min=64)


def hub_graph(seed):
    """tests/test_pallas_spmv2.py's generator: a third of the edges leave
    100 hub senders."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, E).astype(np.int64)
    r = rng.integers(0, N, E).astype(np.int64)
    s[: E // 3] = rng.integers(0, 100, E // 3)
    v = rng.standard_normal(E).astype(np.float32)
    return s, r, v


@functools.lru_cache(maxsize=None)
def graphs(seed=11):
    s, r, v = hub_graph(seed)
    g = Graph(edgelist_from_arrays(s + 1, r + 1, v, m=N, n=N),
              build_in_edges=False, compact=False, device="cpu")
    return s, r, v, g


def unclamp(y):
    """The JAX kernels' ±1e30 fill read back as the true ±inf."""
    y = np.asarray(y, np.float32).copy()
    y[y >= BIG / 2] = np.inf
    y[y <= -BIG / 2] = -np.inf
    return y


def terms_abs(s, r, x, v, op, active):
    u = np.abs(PROCESS_OPS[op](torch.from_numpy(x[s]),
                               torch.from_numpy(v)).numpy())
    out = np.zeros(N)
    np.add.at(out, r, u * active[s])
    return out


@pytest.mark.parametrize("density", [0.0, 0.03, 1.0])
@pytest.mark.parametrize("op", ["x", "x_mul_val"])
def test_push_sum_with_got_matches_jax_k6(op, density):
    s, r, v, g = graphs()
    plan = build_spmv2_plan(s, r, v, N, **PLAN_KW)
    rng = np.random.default_rng(13)
    act = rng.random(N) < density
    x = rng.standard_normal(N).astype(np.float32)
    xm = np.where(act, x, 0.0).astype(np.float32)
    y_j, got_j = spmv2(plan, jnp.asarray(pad(xm, plan.n_send_pad)), "sum",
                       process=JAX_PROCESS[op], interpret=True,
                       sent=jnp.asarray(pad(act, plan.n_send_pad, False)),
                       with_got=True)
    sc = g.sender_csr("dst")
    xt = torch.from_numpy(pad(x, g.n_pad))
    sent = torch.from_numpy(pad(act, g.n_pad, False)).to(torch.uint8)
    y, cnt = push.spmv_push(sc, xt, "sum", op, val=sc.val_f32, sent=sent,
                            want_got=True)
    np.testing.assert_array_equal(cnt.numpy()[:N] > 0,
                                  np.asarray(got_j)[:N])
    want = np.zeros(N, np.int64)
    np.add.at(want, r, act[s])
    np.testing.assert_array_equal(cnt.numpy()[:N], want)
    bound = SUM_RTOL * terms_abs(s, r, x, v, op, act)
    assert (np.abs(y.numpy()[:N] - np.asarray(y_j)[:N]) <= bound).all()


@pytest.mark.parametrize("kind,op", [("min", "x_add_val"), ("min", "x"),
                                     ("max", "x_add_val")])
@pytest.mark.parametrize("density", [0.0, 0.03, 1.0])
def test_push_minmax_matches_jax_k7(kind, op, density):
    """⊗ absorbs the ±1e30 fill of the senders that did not send (the JAX
    kernel reads them inside active chunks; the port never does)."""
    s, r, v, g = graphs()
    plan = build_spmv2m_plan(s, r, v, N, **PLAN_KW)
    rng = np.random.default_rng(12)
    act = rng.random(N) < density
    x = rng.standard_normal(N).astype(np.float32)
    fill = BIG if kind == "min" else -BIG
    y_j = spmv2m(plan, jnp.asarray(pad(np.where(act, x, fill).astype(
        np.float32), plan.n_send_pad, fill)), kind,
        process=JAX_PROCESS[op], interpret=True,
        sent=jnp.asarray(pad(act, plan.n_send_pad, False)))
    sc = g.sender_csr("dst")
    y = push.spmv_push(sc, torch.from_numpy(pad(x, g.n_pad)), kind, op,
                       val=sc.val_f32,
                       sent=torch.from_numpy(pad(act, g.n_pad, False)).to(
                           torch.uint8))
    np.testing.assert_array_equal(y.numpy()[:N], unclamp(y_j)[:N])


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["min", "sum"])
def test_k1_recv_final_matches_jax(kind, share):
    """Rows the port marks final get the identity (and a count of 0); the
    JAX kernel skips whole blocks only, so the rest must agree."""
    s, r, v, plan, g = case(True)
    n = g.n_pad
    rng = np.random.default_rng(3)
    act = rng.random(n) < 0.4
    rf = rng.random(n) < share
    rf[:512] = share > 0     # a whole JAX receiver block final
    x = rng.normal(size=n).astype(np.float32)
    arrays, static = plan_call_args(plan)
    rf_j = jnp.asarray(pad(rf, plan.n_pad, True))
    sent_j = jnp.asarray(pad(act, plan.n_send_pad, False))
    c = g.csr("dst")
    sent = torch.from_numpy(act).to(torch.uint8)
    rft = torch.from_numpy(rf).to(torch.uint8)
    live = ~rf[: c.n_rows]
    if kind == "min":
        xj = np.where(act, x, BIG).astype(np.float32)
        y_j = unclamp(_spmv2u_call(
            arrays, static, jnp.asarray(pad(xj, plan.n_send_pad, BIG)),
            "min", JAX_PROCESS["x_add_val"], True, sent=sent_j,
            recv_final=rf_j))
        y = spmv_reference(c, torch.from_numpy(x), "min", "x_add_val",
                           val=c.val_f32, sent=sent, recv_final=rft).numpy()
        np.testing.assert_array_equal(y[live], y_j[: c.n_rows][live])
        assert np.isinf(y[~live]).all()
        return
    from graphmat_tpu.ops.pallas_spmv2 import encode_sent_bit
    xj = encode_sent_bit(jnp.asarray(pad(np.where(act, x, 0.0).astype(
        np.float32), plan.n_send_pad)), sent_j)
    y_j, cnt_j = _spmv2u_call(arrays, static, xj, "sum", JAX_PROCESS["x"],
                              True, sent=sent_j, want_got=True,
                              recv_final=rf_j)
    y, cnt = spmv_reference(c, torch.from_numpy(x), "sum", "x", sent=sent,
                            want_got=True, recv_final=rft)
    np.testing.assert_array_equal(cnt.numpy()[live],
                                  np.asarray(cnt_j)[: c.n_rows][live])
    assert (cnt.numpy()[~live] == 0).all() and (y.numpy()[~live] == 0).all()
    u = np.abs(x[c.col.numpy()]) * act[c.col.numpy()]
    bound = np.zeros(c.n_rows)
    np.add.at(bound, c.row.numpy(), u)
    err = np.abs(y.numpy() - np.asarray(y_j)[: c.n_rows])
    assert (err[live] <= SUM_RTOL * bound[live]).all()


def packed(n, bits, rng):
    depth = rng.integers(0, 60, n)
    keys = (KEY_BIAS + ((depth << bits) | rng.integers(0, 1 << bits, n))
            ).astype(np.int32)
    x = keys.view(np.float32).copy()
    x[rng.random(n) < 0.1] = np.inf
    return x


def test_packed_key_op_matches_jax():
    """K1's key_add_val on the packed BFS keys against the JAX kernel
    running BFSFastProgram's own ⊗ (bit-exact: keys are int patterns)."""
    from graphmat_tpu.apps.bfs import BFSFastProgram
    from graphmat_tpu.ops.pallas_spmv2u import build_spmv2u_plan
    s, r, v, plan, g = case(False)
    n = U_N
    bits = 11
    rng = np.random.default_rng(8)
    w = rng.integers(1, 8, len(s)).astype(np.float32)
    plan_w = build_spmv2u_plan(s, r, w, n, **U_KW)
    gw = Graph(edgelist_from_arrays(s + 1, r + 1, w, m=n, n=n),
               build_in_edges=False, compact=False, device="cpu")
    x = packed(n, bits, rng)
    act = rng.random(n) < 0.5
    proc = BFSFastProgram(bits).pallas_semiring().process
    xj = np.where(act, np.where(np.isinf(x), BIG, x), BIG).astype(np.float32)
    arrays, static = plan_call_args(plan_w)
    y_j = unclamp(_spmv2u_call(arrays, static, jnp.asarray(
        pad(xj, plan_w.n_send_pad, BIG)), "min", proc, True,
        sent=jnp.asarray(pad(act, plan_w.n_send_pad, False))))[:n]
    c = gw.csr("dst")
    xt = torch.from_numpy(pad(x, gw.n_pad, np.float32(np.inf)))
    sent = torch.from_numpy(pad(act, gw.n_pad, False)).to(torch.uint8)
    y = spmv_reference(c, xt, "min", "key_add_val", val=c.val_f32,
                       sent=sent, bits=bits).numpy()[:n]
    np.testing.assert_array_equal(y.view(np.int32), y_j.view(np.int32))
    # the push kernel computes the same keys
    sc = gw.sender_csr("dst")
    yp = push.spmv_push(sc, xt, "min", "key_add_val", val=sc.val_f32,
                        sent=sent, bits=bits).numpy()[:n]
    np.testing.assert_array_equal(yp.view(np.int32), y.view(np.int32))


@pytest.mark.parametrize("op", ["x", "x_mul_val", "x_add_val"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_push_equals_k1(kind, op):
    """The push over the sender-major index and K1 over the receiver CSR
    compute one function: min/max, counts and sums exactly (a push sum is
    K1's over the receiver CSR)."""
    s, r, v, g = graphs(5)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(g.n_pad).astype(np.float32))
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    for sent in (None, torch.from_numpy(rng.random(g.n_pad) < 0.2).to(
            torch.uint8)):
        got = kind == "sum" and sent is not None
        a = spmv_reference(rc, x, kind, op, val=rc.val_f32, sent=sent,
                           want_got=got)
        b = push.spmv_push(sc, x, kind, op, val=sc.val_f32, sent=sent,
                           want_got=got)
        if got:
            (a, ca), (b, cb) = a, b
            assert torch.equal(ca, cb)
        if kind == "sum":   # the push sums by K1 (ROADMAP P6)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)


def test_sender_index_reuses_the_opposite_direction():
    s, r, v, g = graphs()
    assert g.sender_csr("dst") is g.sender_csr("dst")   # built once
    both = Graph(edgelist_from_arrays(s + 1, r + 1, v, m=N, n=N),
                 compact=False, device="cpu")
    assert both.sender_csr("dst") is both.csr("src")
    assert both.sender_csr("src") is both.csr("dst")
    assert torch.equal(g.sender_csr("dst").rowptr, both.csr("src").rowptr)
    assert torch.equal(g.sender_csr("dst").col, both.csr("src").col)


def test_push_wrapper_rejects_bad_arguments():
    s, r, v, g = graphs()
    sc = g.sender_csr("dst")
    x = torch.zeros(g.n_pad)
    with pytest.raises(ValueError, match="process_op"):
        push.spmv_push(sc, x, "sum", "x_times_two")
    with pytest.raises(ValueError, match="reduce_kind"):
        push.spmv_push(sc, x, "prod", "x")
    with pytest.raises(ValueError, match="reads val"):
        push.spmv_push(sc, x, "min", "x_add_val")
    with pytest.raises(ValueError, match="want_got"):
        push.spmv_push(sc, x, "max", "x", want_got=True,
                       sent=torch.zeros(g.n_pad, dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        push.spmv_push(sc, x, "sum", "x",
                       sent=torch.zeros(g.n_pad, dtype=torch.bool))
    with pytest.raises(ValueError, match="sender row"):
        push.spmv_push(sc, x[:-1], "sum", "x")
    with pytest.raises(ValueError, match="bits"):
        push.spmv_push(sc, x, "min", "x", bits=40)
    # K1 honours recv_final in the sparse modes only
    from graphmat_tpu_torch.ops.spmv2u import spmv
    with pytest.raises(ValueError, match="sparse modes"):
        spmv(g.csr("dst"), x, "min", "x",
             recv_final=torch.zeros(g.n_pad, dtype=torch.uint8))
