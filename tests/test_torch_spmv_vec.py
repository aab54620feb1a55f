"""The sparse mode of the K-wide SpMV (K4 with K5's got count) and K5's
function alone, in their plain versions (what a CPU tensor runs), against
the JAX package.

* against the JAX K4 ``spmv_vec`` in interpret mode on one tiny plan,
  every sender sent (where K4 and the XLA path agree; ROADMAP R4), at
  2e-3: K4 sums bf16 split planes (H5), as ``tests/test_pallas_vec.py``
  holds it;
* against the JAX programs' own ⊗ through the XLA segment reduce, for
  every op at several shares of senders sent: each row within 1e-5 of
  its Σ|terms| (float32 sums in another order), the got count exactly;
* K5's plain version against the JAX K5 ``spmv`` in interpret mode on the
  sent bits, its one use in the JAX engine: exactly (integer sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmat_tpu.apps import lda as jlda
from graphmat_tpu.apps import sgd as jsgd
from graphmat_tpu.core.types import SUM
from graphmat_tpu.ops import pallas_spmv
from graphmat_tpu.ops.pallas_spmv_vec import spmv_vec as jax_k4
from graphmat_tpu.ops.segment import (masked_fill_identity, segment_any,
                                      segment_reduce_tree)
from graphmat_tpu.utils.generators import random_edgelist

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.ops import spmv as k5
from graphmat_tpu_torch.ops import spmv_vec as sv
from graphmat_tpu_torch.ops import spmv_vec2

OPS = ["sgd", "sgd_sqerr", "lda_init", "lda", "lda_loglik"]
SHARES = [1.0, 0.3, 0.05, 0.0]
K = 20
ALPHA, ETA, VOCAB = 1.0, 5.0, 150
PARAMS = {"alpha": ALPHA, "eta": ETA, "vocab_size": VOCAB}

_E = random_edgelist(300, 5, seed=13, weight_range=5)
N = max(_E.m, _E.n)
S0, R0 = _E.src.astype(np.int64) - 1, _E.dst.astype(np.int64) - 1
VAL = _E.val.astype(np.float32)
_G = gt.Graph(gt.EdgeList(_E.m, _E.n, _E.src, _E.dst, VAL),
              build_in_edges=False, device="cpu")
CSR = _G.csr("dst")


def inputs(op, seed=5, k=K):
    """x [N, w], vp [N, w] (or None), extra (or None) for ``op``, as in
    ``test_torch_spmv_vec2.py``."""
    rng = np.random.default_rng(seed)
    w = k + 1 if op == "lda" else k
    if op in ("sgd", "sgd_sqerr"):
        return (0.3 * rng.standard_normal((N, w))).astype(np.float32), \
            (0.3 * rng.standard_normal((N, w))).astype(np.float32), None
    if op == "lda_init":
        return np.zeros((N, w), np.float32), None, None
    x = rng.uniform(0.5, 5, (N, w)).astype(np.float32)
    vp = rng.uniform(0.5, 5, (N, w)).astype(np.float32)
    if op == "lda":
        x[:, k] = 0.0
        vp[:, k] = np.arange(N) < N // 2   # the is_doc column
        return x, vp, rng.uniform(50, 100, k).astype(np.float32)
    return x, vp, rng.uniform(100, 200, k).astype(np.float32)


def sent_mask(share, seed=3):
    return np.random.default_rng(seed).random(N) < share


def _pad(a):
    return torch.as_tensor(np.pad(a, ((0, _G.n_pad - N),)
                                  + ((0, 0),) * (a.ndim - 1)))


def port_sparse(op, sent, k=K):
    x, vp, extra = inputs(op, k=k)
    y, got = sv.spmv_vec_sparse(
        CSR, _pad(x), op, _pad(sent.astype(np.uint8)),
        vp=_pad(vp) if vp is not None else None,
        extra=torch.as_tensor(extra) if extra is not None else None,
        params=PARAMS)
    return y[:N].numpy(), got[:N].numpy()


def port_dense(op, k):
    x, vp, extra = inputs(op, k=k)
    y = spmv_vec2.spmv_vec(
        CSR, _pad(x), op, vp=_pad(vp) if vp is not None else None,
        extra=torch.as_tensor(extra) if extra is not None else None,
        params=PARAMS)
    return y[:N].numpy()


def jax_terms(op, k=K):
    """Each edge's contribution by the JAX programs' own process_message
    (the XLA path), [nnz, columns]."""
    x, vp, extra = inputs(op, k=k)
    xe, vpe = jnp.asarray(x[S0]), None if vp is None else jnp.asarray(vp[R0])
    v = jnp.asarray(VAL)
    if op == "sgd":
        u = jsgd.SGDProgram(k=k).process_message(None, xe, v, {"lv": vpe})
    elif op == "sgd_sqerr":
        u = jsgd.RMSEProgram(k=k).process_message(None, xe, v, {"lv": vpe})
    elif op == "lda_init":
        u = jlda.LDAInitProgram(k).process_message(None, xe, v, None)
    elif op == "lda":
        prog = jlda.LDAProgram(k, ALPHA, ETA, vocab_size=VOCAB, ndoc=1)
        u = prog.process_message(jnp.asarray(extra), {"N": xe[:, :k]}, v,
                                 {"N": vpe[:, :k], "is_doc": vpe[:, k] > 0.5})
    else:
        # nterms = 0: the program's smoothed totals are extra itself
        prog = jlda.LDALLProgram(extra, ETA, 0, k=k)
        u = prog.process_message(None, {"N": xe}, v, {"N": vpe})
    return u.reshape(len(S0), -1)


def xla_sums(u, sent):
    """The JAX segment reduce of the terms of the sent edges, and each
    row's Σ|terms| over them."""
    e_ok = jnp.asarray(sent[S0])
    want = np.asarray(segment_reduce_tree(
        SUM, masked_fill_identity(SUM, u, e_ok), jnp.asarray(R0), N,
        indices_are_sorted=False))
    bound = np.zeros(want.shape)
    np.add.at(bound, R0, np.abs(np.asarray(u, np.float64))
              * sent[S0][:, None])
    return want, bound


@pytest.mark.parametrize("k, mode", [
    pytest.param(k, mode, id=f"{k}-{mode}")
    for mode in ("dense", "sparse") for k in (161, 200)]
    + [pytest.param(k, "dense", id=f"{k}-dense") for k in (8, 20, 40)])
@pytest.mark.parametrize("op", OPS)
def test_wide_plain_matches_jax_xla(op, k, mode):
    """The plain dense version (K3) at K = 8, 20 and 40, and the dense
    and sparse versions at rows wider than 160 columns (the parent
    kernel's bound), against the JAX programs' ⊗ through the XLA segment
    reduce, every sender sent in the dense mode: each row within 1e-5 of
    its Σ|terms|."""
    sent = sent_mask(1.0 if mode == "dense" else 0.3)
    want, bound = xla_sums(jax_terms(op, k), sent)
    if mode == "dense":
        y = port_dense(op, k)
    else:
        y, got = port_sparse(op, sent, k)
        np.testing.assert_array_equal(got, np.bincount(
            R0, weights=sent[S0], minlength=N).astype(np.int32))
    assert y.shape == want.shape == (N, spmv_vec2.out_width(
        op, k + 1 if op == "lda" else k))
    assert np.all(np.abs(y - want) <= 1e-5 * bound + 1e-30)


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("op", OPS)
def test_sparse_plain_matches_jax_xla(op, share):
    sent = sent_mask(share)
    e_ok = jnp.asarray(sent[S0])
    want, bound = xla_sums(jax_terms(op), sent)
    y, got = port_sparse(op, sent)
    assert y.shape == want.shape
    assert np.all(np.abs(y - want) <= 1e-5 * bound + 1e-30)
    count = np.zeros(N, np.int32)
    np.add.at(count, R0, sent[S0])
    np.testing.assert_array_equal(got, count)
    np.testing.assert_array_equal(got > 0, np.asarray(segment_any(
        e_ok, jnp.asarray(R0), N, indices_are_sorted=False)))
    assert np.all(y[count == 0] == 0)


def test_sparse_plain_matches_interpret_k4_all_sent():
    """Every sender sent: the port's sparse mode against the JAX K4 kernel
    (interpret mode) with the JAX SGD program's K4 process."""
    x, vp, _ = inputs("sgd")
    plan = pallas_spmv.build_spmv_plan(S0, R0, VAL, N)
    want = np.asarray(jax_k4(plan, jnp.asarray(x), jsgd._sgd_process,
                             vp_receiver=jnp.asarray(np.pad(
                                 vp, ((0, plan.n_pad - N), (0, 0)))),
                             interpret=True))[:N]
    y, got = port_sparse("sgd", np.ones(N, bool))
    np.testing.assert_allclose(y, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got, np.bincount(R0, minlength=N))


def test_sparse_at_full_share_equals_dense_plain():
    """With every sender sent the sparse mode's plain version gives the
    dense one's result, to 1e-6 relative: the plain versions on the CPU
    were seen to differ in the last bits between two calls on the same
    input.  (The kernels give the same bits, ``tests/test_torch_cuda.py``.)"""
    full = _pad(np.ones(N, np.uint8))
    for op in OPS:
        x, vp, extra = inputs(op)
        args = dict(vp=_pad(vp) if vp is not None else None,
                    extra=torch.as_tensor(extra) if extra is not None
                    else None, params=PARAMS)
        y, got = sv.spmv_vec_sparse(CSR, _pad(x), op, full, **args)
        dense = spmv_vec2.spmv_vec(CSR, _pad(x), op, **args)
        torch.testing.assert_close(y, dense, rtol=1e-6, atol=0)
        assert torch.equal(got.bool(), CSR.got_static)


def test_sparse_bad_sent_raises():
    x = torch.zeros(_G.n_pad, 4)
    with pytest.raises(TypeError, match="uint8"):
        sv.spmv_vec_sparse(CSR, x, "lda_init", torch.ones(_G.n_pad,
                                                          dtype=torch.bool))
    with pytest.raises(ValueError, match="one flag per sender"):
        sv.spmv_vec_sparse(CSR, x, "lda_init",
                           torch.ones(_G.n_pad - 1, dtype=torch.uint8))


def test_k5_plain_matches_interpret_pallas():
    """K5's one use in the JAX engine: the sum of the sent bits."""
    bits = sent_mask(0.3).astype(np.float32)
    plan = pallas_spmv.build_spmv_plan(S0, R0, VAL, N)
    want = np.asarray(pallas_spmv.spmv(plan, jnp.asarray(bits), "sum",
                                       interpret=True))[:N]
    ours = k5.spmv_reference(CSR, _pad(bits), "sum")[:N].numpy()
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_k5_through_k1_matches_plain(kind):
    """K5's function through K1's op ``x`` (here its plain version) equals
    K5's own plain version: min and max exactly, sums to 1e-6."""
    x = _pad(np.random.default_rng(2).standard_normal(N).astype(np.float32))
    a, b = k5.spmv(CSR, x, kind), k5.spmv_reference(CSR, x, kind)
    if kind == "sum":
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    else:
        assert torch.equal(a, b)
    empty = CSR.rowptr.diff() == 0
    assert bool((b[empty] == {"sum": 0.0, "min": float("inf"),
                              "max": float("-inf")}[kind]).all())
