"""K3's plain version (what a CPU tensor runs) against the JAX package's
K3 in interpret mode, with the JAX programs' own processes, and against a
numpy float64 per-edge oracle; for every op at K ∈ {8, 20, 40} (for
``lda``, K topics plus the is_doc column).  The interpret-mode cases at
K = 40 (two 32-lane planes, the slowest compiles) are in
``test_torch_spmv_vec2_planes.py``, so that test workers share them.

Tolerances: 2e-3 against interpret-mode Pallas, whose sums run through
bf16 split planes (about 2^-17 relative) and a range scatter that can
cancel (ROADMAP H5), as ``tests/test_pallas_vec.py`` uses; against the
float64 oracle each row within 1e-5 of its Σ|terms| (float32 rounding of
the terms and of the sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmat_tpu.apps.lda import (_make_lda_init_process_v2,
                                   _make_lda_ll_process_v2,
                                   _make_lda_process_v2)
from graphmat_tpu.apps.sgd import _make_rmse_process_v2, _sgd_process_v2
from graphmat_tpu.ops.pallas_spmv_vec2 import build_spmv_vec2_plan, spmv_vec2
from graphmat_tpu.utils.generators import random_edgelist
from graphmat_tpu.utils.reference_rng import RAND_MAX, rand_r_np

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.core.program import VecSemiring
from graphmat_tpu_torch.ops import spmv_vec2 as sv

OPS = ["sgd", "sgd_sqerr", "lda_init", "lda", "lda_loglik"]
KS = [8, 20, 40]
ALPHA, ETA, VOCAB = 1.0, 5.0, 150
PARAMS = {"alpha": ALPHA, "eta": ETA, "vocab_size": VOCAB}

_E = random_edgelist(300, 5, seed=13, weight_range=5)
N = max(_E.m, _E.n)
S0, R0 = _E.src.astype(np.int64) - 1, _E.dst.astype(np.int64) - 1
VAL = _E.val.astype(np.float32)


def inputs(op, k, seed=5):
    """x [N, w], vp [N, w] (or None), extra (or None) for ``op``."""
    rng = np.random.default_rng(seed)
    w = k + 1 if op == "lda" else k
    if op in ("sgd", "sgd_sqerr"):
        x = (0.3 * rng.standard_normal((N, w))).astype(np.float32)
        vp = (0.3 * rng.standard_normal((N, w))).astype(np.float32)
        return x, vp, None
    if op == "lda_init":
        return np.zeros((N, w), np.float32), None, None
    # N >= 0.5: float32 (N + alpha - 1) with alpha = 1 cancels near 0,
    # in both packages alike, beyond the float64 oracle's 1e-5
    x = rng.uniform(0.5, 5, (N, w)).astype(np.float32)
    vp = rng.uniform(0.5, 5, (N, w)).astype(np.float32)
    if op == "lda":
        x[:, k] = 0.0
        vp[:, k] = (np.arange(N) < N // 2)   # the is_doc column
        return x, vp, rng.uniform(50, 100, k).astype(np.float32)
    return x, vp, rng.uniform(100, 200, k).astype(np.float32)


def plain_k3(op, k):
    """The port's K3 on CPU tensors (its plain version)."""
    x, vp, extra = inputs(op, k)
    g = gt.Graph(gt.EdgeList(_E.m, _E.n, _E.src, _E.dst, VAL),
                 build_in_edges=False, device="cpu")
    pad = g.n_pad - N

    def t(a):
        return torch.as_tensor(np.pad(a, ((0, pad), (0, 0))))
    y = sv.spmv_vec(g.csr("dst"), t(x), op,
                    vp=t(vp) if vp is not None else None,
                    extra=torch.as_tensor(extra) if extra is not None
                    else None, params=PARAMS)
    return y[:N].numpy()


# the JAX processes; one closure per k-independent op, so interpret-mode
# compiles are shared between K=8 and K=20 (one 32-lane plane) where the
# JAX process allows it
_RMSE = _make_rmse_process_v2(0)


def jax_process(op, k, extra):
    if op == "sgd":
        return _sgd_process_v2
    if op == "sgd_sqerr":
        return _RMSE
    if op == "lda_init":
        return _make_lda_init_process_v2(k, jnp.float32)
    if op == "lda":
        return _make_lda_process_v2(k, ALPHA, ETA, VOCAB, jnp.float32)
    return _make_lda_ll_process_v2(k, ETA, jnp.asarray(extra), jnp.float32)


_PLAN = {}


def jax_k3(op, k):
    x, vp, extra = inputs(op, k)
    if "plan" not in _PLAN:
        _PLAN["plan"] = build_spmv_vec2_plan(S0, R0, VAL, N)
    y = spmv_vec2(_PLAN["plan"], jnp.asarray(x), jax_process(op, k, extra),
                  jnp.asarray(vp if vp is not None else np.zeros_like(x)),
                  extra=None if extra is None else jnp.asarray(extra),
                  interpret=True)
    return np.asarray(y)[:N, :sv.out_width(op, x.shape[1])]


def f64_terms(op, k):
    """The per-edge contributions in float64, from the reference's
    formulas (src/SGD.cpp, src/LDA.cpp)."""
    x, vp, extra = (None if a is None else a.astype(np.float64)
                    for a in inputs(op, k))
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


@pytest.mark.parametrize("k", [8, 20])
@pytest.mark.parametrize("op", OPS)
def test_plain_k3_matches_interpret_pallas(op, k):
    np.testing.assert_allclose(plain_k3(op, k), jax_k3(op, k), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("op", OPS)
def test_plain_k3_matches_f64_oracle(op, k):
    terms = f64_terms(op, k)
    want = np.zeros((N, terms.shape[1]))
    np.add.at(want, R0, terms)
    bound = np.zeros_like(want)
    np.add.at(bound, R0, np.abs(terms))
    got = plain_k3(op, k)
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
    g = gt.Graph(gt.EdgeList(_E.m, _E.n, _E.src, _E.dst, VAL),
                 build_in_edges=False, device="cpu")
    c = g.csr("dst")
    x = torch.zeros(g.n_pad, 4)
    with pytest.raises(ValueError, match="reads vp"):
        sv.spmv_vec(c, x, "sgd")
    with pytest.raises(ValueError, match="needs params"):
        sv.spmv_vec(c, x, "lda", vp=x, extra=torch.zeros(3))
    with pytest.raises(ValueError, match="extra must hold 3"):
        sv.spmv_vec(c, x, "lda", vp=x, extra=torch.zeros(4), params=PARAMS)
    # no bound on the width but int32's (it was 160)
    y = sv.spmv_vec(c, torch.zeros(g.n_pad, 161), "lda_init")
    assert y.shape == (c.n_rows, 161) and bool(torch.isfinite(y).all())
    with pytest.raises(ValueError, match="senders"):
        sv.spmv_vec(c, torch.zeros(g.n_pad - 1, 4), "lda_init")
    with pytest.raises(ValueError, match="non-negative integer"):
        sv.spmv_vec_csr(c.rowptr, c.col, c.val_f32 + 0.5, x, "lda_init")
