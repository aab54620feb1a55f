"""K2, the port's operand compaction, against the JAX package's
(``pallas_compact.py``; Pallas in interpret mode).

The gather is a copy, so it must be bitwise equal.  A compacted SpMV reads
the same values through other sender ids: min/max must equal the
uncompacted SpMV bitwise, a sum within 1e-5 of it (the plain version's
scatter order may differ).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphmat_tpu.ops.pallas_compact import (aux_gather as jax_aux_gather,
                                             divert_stragglers as jax_divert)
from graphmat_tpu.ops.pallas_spmv2u import build_spmv2u_plan, spmv2u

from graphmat_tpu_torch import Graph, edgelist_from_arrays
from graphmat_tpu_torch.ops.compact import (aux_gather, aux_gather_reference,
                                            compact_enabled,
                                            divert_stragglers)
from graphmat_tpu_torch.ops.spmv2u import spmv

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


def test_aux_gather_bitwise_equals_jax():
    n, s, r, s_new, aux, h = jax_aux_case()
    # resolve the source of every position (pads included) through the
    # JAX aux map, as tests/test_pallas_spmv2u.py:398-405 does
    pk = np.asarray(aux.pk).reshape(-1)
    kb = np.asarray(aux.kb)
    base = (kb.astype(np.uint32) & ((1 << 22) - 1)).astype(np.int64) << 3
    pos = np.arange(pk.size)
    src = (base[pos // (32 * 128)] + (pk >> 7)) * 128 + (pk & 127)
    x = np.random.default_rng(0).normal(size=h * 128).astype(np.float32)
    want = np.asarray(jax_aux_gather(aux, jnp.asarray(x.reshape(h, 128)),
                                     interpret=True)).reshape(-1)
    src_t = torch.from_numpy(src.astype(np.int32))
    xt = torch.from_numpy(x)
    got = aux_gather(xt, src_t, torch.empty(src.size))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(aux_gather_reference(xt, src_t), got)


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
    out = aux_gather(sent, torch.tensor([9, 0, 3], dtype=torch.int32),
                     torch.empty(3, dtype=torch.uint8))
    assert out.tolist() == [9, 0, 3]


def test_compact_trigger_matches_jax():
    """On from 8192 operand rows of 128 vertices, the row count rounded
    up to a multiple of 128 first (pallas_spmv2u.py:706)."""
    assert not compact_enabled(8064 * 128)
    assert compact_enabled(8064 * 128 + 1)
    assert compact_enabled(8192 * 128)
    assert compact_enabled(1 << 22)
    assert not compact_enabled(1500)


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
