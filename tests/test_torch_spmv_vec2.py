"""K3's plain version (what a CPU tensor runs) against a numpy float64
per-edge oracle, for every op at K ∈ {8, 20, 40} (for ``lda``, K topics
plus the is_doc column): each row within 1e-5 of its Σ|terms| (float32
rounding of the terms and of the sum, in another order).  The same plain
version against the JAX programs' ⊗ through the XLA segment reduce is
``test_torch_spmv_vec.py: test_wide_plain_matches_jax_xla``, on the same
graph and inputs."""

import numpy as np
import pytest
import torch

from graphmat_tpu.utils.reference_rng import RAND_MAX, rand_r_np

from graphmat_tpu_torch.core.program import VecSemiring
from graphmat_tpu_torch.ops import spmv_vec2 as sv
from test_torch_spmv_vec import (ALPHA, CSR, ETA, N, OPS, PARAMS, R0, S0,
                                 VAL, VOCAB, _G, inputs, port_dense)

KS = [8, 20, 40]


def f64_terms(op, k):
    """The per-edge contributions in float64, from the reference's
    formulas (src/SGD.cpp, src/LDA.cpp)."""
    x, vp, extra = (None if a is None else a.astype(np.float64)
                    for a in inputs(op, k=k))
    v = VAL.astype(np.float64)
    xs = x[S0]
    if op in ("sgd", "sgd_sqerr"):
        err = v - np.sum(xs * vp[R0], axis=1)
        return xs * err[:, None] if op == "sgd" else (err ** 2)[:, None]
    if op == "lda_init":
        gam = rand_r_np(VAL.astype(np.uint32), k) / RAND_MAX
        return gam / gam.sum(1, keepdims=True) * v[:, None]
    if op == "lda":
        doc = vp[R0, k][:, None] > 0.5
        my, ot = np.where(doc, ALPHA, ETA), np.where(doc, ETA, ALPHA)
        gam = ((vp[R0, :k] + my - 1) * (xs[:, :k] + ot - 1)
               / (extra + VOCAB * (ETA - 1)))
        return gam / gam.sum(1, keepdims=True) * v[:, None]
    phi = (vp[R0] + ETA - 1) / extra
    theta = xs + ETA - 1
    theta /= theta.sum(1, keepdims=True)
    return (v * np.log(np.sum(phi * theta, axis=1)))[:, None]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("op", OPS)
def test_plain_k3_matches_f64_oracle(op, k):
    terms = f64_terms(op, k)
    want = np.zeros((N, terms.shape[1]))
    np.add.at(want, R0, terms)
    bound = np.zeros_like(want)
    np.add.at(bound, R0, np.abs(terms))
    got = port_dense(op, k)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * bound + 1e-30)


def test_unknown_op_raises():
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="not one of"):
        sv.spmv_vec_csr(torch.zeros(5, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                        x, "sgd_typo", vp=x)
    with pytest.raises(ValueError, match="not one of"):
        VecSemiring(k=2, process_op="x_mul_val", encode=lambda s, m: m)


def test_bad_operands_raise():
    c, x = CSR, torch.zeros(_G.n_pad, 4)
    with pytest.raises(ValueError, match="reads vp"):
        sv.spmv_vec(c, x, "sgd")
    with pytest.raises(ValueError, match="needs params"):
        sv.spmv_vec(c, x, "lda", vp=x, extra=torch.zeros(3))
    with pytest.raises(ValueError, match="extra must hold 3"):
        sv.spmv_vec(c, x, "lda", vp=x, extra=torch.zeros(4), params=PARAMS)
    # no bound on the width but int32's (it was 160)
    y = sv.spmv_vec(c, torch.zeros(_G.n_pad, 161), "lda_init")
    assert y.shape == (c.n_rows, 161) and bool(torch.isfinite(y).all())
    with pytest.raises(ValueError, match="senders"):
        sv.spmv_vec(c, torch.zeros(_G.n_pad - 1, 4), "lda_init")
    with pytest.raises(ValueError, match="non-negative integer"):
        sv.spmv_vec_csr(c.rowptr, c.col, c.val_f32 + 0.5, x, "lda_init")
