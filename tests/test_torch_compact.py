"""K2, the port's operand compaction, against the JAX package's
(``pallas_compact.py``; Pallas in interpret mode) and the JAX XLA path.

The gather is a copy, so it must be bitwise equal, flags included.  A
compacted SpMV reads the same values through other sender ids, in the
same edge order: it must equal the uncompacted SpMV bitwise.  Against
JAX: min/max bitwise where JAX is finite, the got count exact, a sum
within 1e-5 (of 1, or of the row's Σ|terms| against the XLA path: the
two sum in other orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphmat_tpu.core.types import MAX, MIN, SUM
from graphmat_tpu.ops.pallas_compact import (aux_gather as jax_aux_gather,
                                             divert_stragglers as jax_divert)
from graphmat_tpu.ops.pallas_spmv2u import build_spmv2u_plan, spmv2u
from graphmat_tpu.ops.segment import masked_fill_identity, segment_reduce

from graphmat_tpu_torch import Graph, edgelist_from_arrays
from graphmat_tpu_torch.ops.compact import (QUAD, aux_gather,
                                            aux_gather_reference,
                                            compact_auto, compact_enabled,
                                            divert_stragglers)
from graphmat_tpu_torch.ops.spmv2u import (IDENTITY, PROCESS_OPS, spmv,
                                           spmv_csr)

from test_torch_spmv2u import pad, rand_graph

# the divert parameters of tests/test_pallas_spmv2u.py:382-405
DIV_KW = dict(wr=256, hub=64, divert_min=800, bpsb=2, w_div=64)


def jax_aux_case():
    n, e = 3000, 8000
    s, r, _ = rand_graph(n, e, seed=47)
    h = 128                                  # operand rows for n=3000
    s_new, aux, _ = jax_divert(s, r, 4096, DIV_KW["wr"], h, DIV_KW["hub"],
                               divert_min=DIV_KW["divert_min"],
                               bpsb=DIV_KW["bpsb"], w_div=DIV_KW["w_div"],
                               w_aux=16, rows=32)
    return n, s, r, s_new, aux, h


def jax_aux_gathered():
    """The JAX aux map's source of every position (pads included), as
    tests/test_pallas_spmv2u.py:398-405 resolves it, an operand, and the
    JAX gather of it in interpret mode."""
    n, s, r, s_new, aux, h = jax_aux_case()
    pk = np.asarray(aux.pk).reshape(-1)
    kb = np.asarray(aux.kb)
    base = (kb.astype(np.uint32) & ((1 << 22) - 1)).astype(np.int64) << 3
    pos = np.arange(pk.size)
    src = (base[pos // (32 * 128)] + (pk >> 7)) * 128 + (pk & 127)
    x = np.random.default_rng(0).normal(size=h * 128).astype(np.float32)
    want = np.asarray(jax_aux_gather(aux, jnp.asarray(x.reshape(h, 128)),
                                     interpret=True)).reshape(-1)
    return torch.from_numpy(src.astype(np.int32)), torch.from_numpy(x), want


def test_aux_gather_bitwise_equals_jax():
    src_t, xt, want = jax_aux_gathered()
    got = aux_gather(xt, src_t, torch.empty(src_t.numel()))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(aux_gather_reference(xt, src_t), got)


def test_fused_aux_gather_bitwise_equals_jax():
    """The value and flag gather of the sparse modes, in one call: the
    values as JAX's gather, the flags ``sent[src_of_pos]``."""
    src_t, xt, want = jax_aux_gathered()
    sent = torch.from_numpy(
        (np.random.default_rng(1).random(xt.numel()) < 0.3).astype(np.uint8))
    vals, flags = aux_gather(xt, src_t, torch.empty(src_t.numel()), sent,
                             torch.empty(src_t.numel(), dtype=torch.uint8))
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(flags, sent[src_t.long()])
    ref_vals, ref_flags = aux_gather_reference(xt, src_t, sent)
    assert torch.equal(ref_vals, vals) and torch.equal(ref_flags, flags)


def test_divert_picks_the_jax_edges():
    n, s, r, s_new, aux, h = jax_aux_case()
    s_ext, src_of_pos = divert_stragglers(torch.from_numpy(s),
                                          torch.from_numpy(r), 3072,
                                          **DIV_KW)
    s_ext = s_ext.long().numpy()
    div = s_ext >= 3072
    np.testing.assert_array_equal(div, s_new != s)
    assert div.any() and (s[div] >= DIV_KW["hub"]).all()
    # one position per distinct (super-block, sender) pair, as in JAX
    assert src_of_pos.numel() == aux.n_entries
    np.testing.assert_array_equal(src_of_pos.long().numpy()[s_ext[div]
                                                            - 3072], s[div])
    # positions run super-block first, then sender ascending
    sb = (r[div] // DIV_KW["wr"]) // DIV_KW["bpsb"]
    key = np.unique((sb << 34) | s[div])
    np.testing.assert_array_equal(src_of_pos.numpy(), key & ((1 << 34) - 1))


def test_aux_gather_checks_arguments():
    x = torch.zeros(10)
    src = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        aux_gather(x.double(), src, torch.empty(4, dtype=torch.float64))
    with pytest.raises(TypeError):
        aux_gather(x, src.long(), torch.empty(4))
    with pytest.raises(ValueError):
        aux_gather(x, src, torch.empty(5))
    sent = torch.arange(10, dtype=torch.uint8)
    # the mask travels with the values, never alone
    with pytest.raises(TypeError):
        aux_gather(sent, src, torch.empty(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        aux_gather(x, src, torch.empty(4), sent=sent)
    # the kernel's wide loads and stores need aligned starts
    with pytest.raises(ValueError):
        aux_gather(x, src, torch.empty(5)[1:])
    with pytest.raises(ValueError):
        aux_gather(x, torch.zeros(5, dtype=torch.int32)[1:], torch.empty(4))
    three = torch.tensor([9, 0, 3], dtype=torch.int32)
    vals, flags = aux_gather(torch.arange(10.0), three, torch.empty(3), sent,
                             torch.empty(3, dtype=torch.uint8))
    assert vals.tolist() == [9.0, 0.0, 3.0] and flags.tolist() == [9, 0, 3]
    empty = torch.empty(0)
    assert aux_gather(x, torch.empty(0, dtype=torch.int32), empty) is empty


def small_extension_graphs(n_aux, n=64):
    """A graph whose compacted direction has exactly ``n_aux`` extension
    positions, compacted and not: senders 0-15 (below the hub) reach
    every receiver, senders 16 to 16 + n_aux - 1 three receivers each,
    and every edge from the hub up diverts into one super-block."""
    s = [i % 16 for i in range(4 * n)] + [16 + i // 3
                                          for i in range(3 * n_aux)]
    r = [i % n for i in range(4 * n)] + [(7 * i + 5) % n
                                         for i in range(3 * n_aux)]
    s, r = np.array(s), np.array(r)
    v = np.linspace(0.5, 2.0, s.size).astype(np.float32)
    e = edgelist_from_arrays(s + 1, r + 1, v, m=n, n=n)
    kw = dict(wr=4096, hub=16, divert_min=1 << 30, bpsb=32, w_div=1)
    return (Graph(e, build_in_edges=False, compact=False, device="cpu"),
            Graph(e, build_in_edges=False, compact=True, compact_kw=kw,
                  device="cpu"))


@pytest.mark.parametrize("n_aux", [0, 1, 3, 4, 5])
def test_small_extensions(n_aux):
    """Extensions of 0, 1, 3, 4 and 5 positions: padded to whole quads
    with sender 0, gathered bitwise, and no edge reads a pad: pads that
    hold NaN leave K1's result bitwise the uncompacted one."""
    g0, g1 = small_extension_graphs(n_aux)
    c0, c = g0.csr("dst"), g1.csr("dst")
    rng = np.random.default_rng(n_aux)
    x = torch.from_numpy(rng.normal(size=c.n_send).astype(np.float32))
    sent = torch.from_numpy((rng.random(c.n_send) < 0.5).astype(np.uint8))
    if n_aux == 0:
        assert c.src_of_pos is None and c.n_aux == 0
        assert torch.equal(spmv(c, x, "sum", "x"), spmv(c0, x, "sum", "x"))
        return
    n_ext = -(-n_aux // QUAD) * QUAD
    assert c.n_aux == n_aux and c.src_of_pos.numel() == n_ext
    assert c.x_ext.numel() == n_ext and c.sent_ext.numel() == n_ext
    assert (c.src_of_pos[n_aux:] == 0).all()
    assert int(c.col_ext.max()) == c.n_send + n_aux - 1
    vals, flags = aux_gather(x, c.src_of_pos, torch.empty(n_ext), sent,
                             torch.empty(n_ext, dtype=torch.uint8))
    assert torch.equal(vals, x[c.src_of_pos.long()])
    assert torch.equal(flags, sent[c.src_of_pos.long()])
    vals[n_aux:] = float("nan")
    flags[n_aux:] = 1
    for kind in ("sum", "min", "max"):
        want = spmv(c0, x, kind, "x", sent=sent)
        got = spmv_csr(c.rowptr, c.col_ext, x, kind, "x", sent=sent,
                       x_aux=vals, sent_aux=flags)
        assert torch.equal(got, want)
        assert torch.equal(spmv(c, x, kind, "x"), spmv(c0, x, kind, "x"))


def test_compact_trigger_matches_jax():
    """On from 8192 operand rows of 128 vertices, the row count rounded
    up to a multiple of 128 first (pallas_spmv2u.py:706)."""
    assert not compact_enabled(8064 * 128)
    assert compact_enabled(8064 * 128 + 1)
    assert compact_enabled(8192 * 128)
    assert compact_enabled(1 << 22)
    assert not compact_enabled(1500)


@pytest.mark.parametrize("n_send", [1500, 8064 * 128, 8064 * 128 + 1,
                                    1 << 22, 1 << 24])
def test_auto_trigger_by_device(n_send):
    """``compact="auto"``: the JAX rule on the CPU, never on the card,
    where compaction paid at neither RMAT-22 nor RMAT-24."""
    assert compact_auto(n_send, "cpu") == compact_enabled(n_send)
    assert compact_auto(n_send, torch.device("cpu")) == compact_enabled(
        n_send)
    assert not compact_auto(n_send, "cuda")
    assert not compact_auto(n_send, torch.device("cuda", 0))


# the compaction setting of tests/test_pallas_spmv2u.py:311-337
N_C, E_C = 2200, 9000
JAX_KW = dict(wr=256, windows=(16, 64), cell_min=64, rows=32, hub=64)
JAX_CKW = dict(divert_min=40, bpsb=2, w_div=64, w_aux=16)
PORT_CKW = dict(wr=256, hub=64, divert_min=40, bpsb=2, w_div=64)


def compact_pair():
    s, r, v = rand_graph(N_C, E_C, seed=41, skew=True)
    e = edgelist_from_arrays(s + 1, r + 1, v, m=N_C, n=N_C)
    g0 = Graph(e, build_in_edges=False, compact=False, device="cpu")
    g1 = Graph(e, build_in_edges=False, compact=True, compact_kw=PORT_CKW,
               device="cpu")
    assert g0.csr("dst").src_of_pos is None
    assert g1.csr("dst").src_of_pos is not None
    return s, r, v, g0, g1


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_compacted_spmv_equals_uncompacted_and_jax(kind):
    s, r, v, g0, g1 = compact_pair()
    x = np.linspace(0.5, 2.0, N_C).astype(np.float32)
    xt = torch.from_numpy(pad(x, g0.n_pad))
    c0, c1 = g0.csr("dst"), g1.csr("dst")
    y0 = spmv(c0, xt, kind, "x_mul_val", val=c0.val_f32)
    y1 = spmv(c1, xt, kind, "x_mul_val", val=c1.val_f32)
    if kind == "sum":
        torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(y1, y0)
    plan = build_spmv2u_plan(s, r, v, N_C, compact=True, compact_kw=JAX_CKW,
                             **JAX_KW)
    assert plan.aux is not None
    yj = np.asarray(spmv2u(plan, jnp.asarray(pad(x, plan.n_send_pad)),
                           kind, process=lambda a, b: a * b,
                           interpret=True))[:N_C]
    y1 = y1.numpy()[:N_C]
    if kind == "sum":
        np.testing.assert_allclose(y1, yj, rtol=1e-5, atol=1e-5)
    else:
        big = np.abs(yj) > 5e29     # JAX's clamped identity (ROADMAP H3)
        np.testing.assert_array_equal(y1[~big], yj[~big])
        assert np.isinf(y1[big]).all()


def test_spmv_csr_checks_the_extension():
    """K1's extension arguments: float32 values, and flags exactly when
    both ``sent`` and ``x_aux`` are given, one per value."""
    g0, g1 = small_extension_graphs(5)
    c = g1.csr("dst")
    x = torch.ones(c.n_send)
    sent = torch.ones(c.n_send, dtype=torch.uint8)
    args = (c.rowptr, c.col_ext, x, "sum", "x")
    flags = torch.ones(c.x_ext.numel(), dtype=torch.uint8)
    with pytest.raises(TypeError):
        spmv_csr(*args, x_aux=c.x_ext.double())
    with pytest.raises(ValueError):
        spmv_csr(*args, sent=sent, x_aux=c.x_ext)
    with pytest.raises(ValueError):
        spmv_csr(*args, x_aux=c.x_ext, sent_aux=flags)
    with pytest.raises(ValueError):
        spmv_csr(*args, sent=sent, x_aux=c.x_ext, sent_aux=flags[1:])
    y = spmv_csr(*args, sent=sent, x_aux=torch.ones(c.x_ext.numel()),
                 sent_aux=flags)
    assert torch.equal(y, spmv(g0.csr("dst"), x, "sum", "x", sent=sent))


# (kind, ⊗) of each reduce, and the modes: dense; sparse; sparse with the
# got count (sum only); each sparse mode with and without recv_final
XLA_OPS = {"sum": "x_mul_val", "min": "x_add_val", "max": "x_add_val"}
XLA_MONOID = {"sum": SUM, "min": MIN, "max": MAX}
XLA_CASES = [(k, m, f) for k in ("sum", "min", "max")
             for m in ("dense", "sparse", "sparse_got")
             for f in ((False,) if m == "dense" else (False, True))
             if m != "sparse_got" or k == "sum"]


@pytest.mark.parametrize("kind,mode,final", XLA_CASES)
def test_compacted_spmv_matches_uncompacted_and_jax_xla(kind, mode, final):
    """``spmv`` on the compacted CSR equals it on the uncompacted one
    bitwise, and the JAX XLA path (the JAX Engine's ⊗ on the gathered
    senders, masked by ``sent``, through its segment reduce; rows marked
    final take the identity and a count of 0, as K1 documents)."""
    s, r, v, g0, g1 = compact_pair()
    rng = np.random.default_rng(7)
    x = pad(rng.normal(size=N_C).astype(np.float32), g0.n_pad)
    sent = pad(rng.random(N_C) < 0.4, g0.n_pad, False)
    rf = pad(rng.random(N_C) < 0.3, g0.n_pad, False)
    op = XLA_OPS[kind]
    kw = dict(val=g0.csr("dst").val_f32)
    if mode != "dense":
        kw["sent"] = torch.from_numpy(sent.astype(np.uint8))
        kw["want_got"] = mode == "sparse_got"
        if final:
            kw["recv_final"] = torch.from_numpy(rf.astype(np.uint8))
    xt = torch.from_numpy(x)
    out0 = spmv(g0.csr("dst"), xt, kind, op, **kw)
    out1 = spmv(g1.csr("dst"), xt, kind, op, **dict(
        kw, val=g1.csr("dst").val_f32))
    y, cnt = out1 if mode == "sparse_got" else (out1, None)
    for a, b in zip(out0 if cnt is not None else (out0,),
                    out1 if cnt is not None else (out1,)):
        assert torch.equal(a, b)

    c0 = g0.csr("dst")
    s0, r0 = c0.col.long().numpy(), c0.row.long().numpy()
    ok = sent[s0] if mode != "dense" else np.ones(s0.size, bool)
    proc = {"x_mul_val": lambda a, b: a * b, "x_add_val": lambda a, b: a + b}
    u = proc[op](jnp.asarray(x[s0]), jnp.asarray(c0.val_f32.numpy()))
    monoid = XLA_MONOID[kind]
    want = np.asarray(segment_reduce(
        monoid, masked_fill_identity(monoid, u, jnp.asarray(ok)),
        jnp.asarray(r0), g0.n_pad))
    want_cnt = np.bincount(r0[ok], minlength=g0.n_pad)
    if final:
        want = np.where(rf, IDENTITY[kind], want)
        want_cnt = np.where(rf, 0, want_cnt)
    y = y.numpy()
    if kind == "sum":
        terms = np.abs(PROCESS_OPS[op](torch.from_numpy(x[s0]),
                                       c0.val_f32).numpy()) * ok
        bound = 1e-5 * np.bincount(r0, terms, minlength=g0.n_pad)
        if final:
            bound = np.where(rf, 0.0, bound)
        assert (np.abs(y - want) <= bound).all()
    else:
        np.testing.assert_array_equal(y, want)
    if cnt is not None:
        np.testing.assert_array_equal(cnt.numpy(), want_cnt)


def test_compacted_sparse_got_equals_uncompacted():
    s, r, v, g0, g1 = compact_pair()
    rng = np.random.default_rng(5)
    sent = torch.from_numpy(pad(rng.random(N_C) < 0.25, g0.n_pad, False))
    sent = sent.to(torch.uint8)
    xt = torch.from_numpy(pad(np.linspace(1.0, 3.0, N_C)
                              .astype(np.float32), g0.n_pad))
    y0, n0 = spmv(g0.csr("dst"), xt, "sum", "x", sent=sent, want_got=True)
    y1, n1 = spmv(g1.csr("dst"), xt, "sum", "x", sent=sent, want_got=True)
    assert torch.equal(n0, n1)
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    ym0 = spmv(g0.csr("dst"), xt, "min", "x_add_val",
               val=g0.csr("dst").val_f32, sent=sent)
    ym1 = spmv(g1.csr("dst"), xt, "min", "x_add_val",
               val=g1.csr("dst").val_f32, sent=sent)
    assert torch.equal(ym0, ym1)
