"""The port's RMAT stream against the JAX package's, on the CPU.

``graphmat_tpu_torch.utils.generators.rmat_edgelist`` must give the JAX
function's graph for the same arguments: ``native=True`` and ``None``
the native generator's splitmix64 stream (``gm_rmat_gen``, the JAX
default), ``native=False`` the numpy stream.  Every comparison is exact:
src, dst, val and their order.  The plain splitmix64 and the weights'
unsigned modulo are held against numpy ``uint64`` arithmetic.
"""

import numpy as np
import pytest
import torch

from graphmat_tpu.utils.generators import rmat_edgelist as jax_rmat

from graphmat_tpu_torch.ops import rmat as trmat
from graphmat_tpu_torch.utils.generators import rmat_edgelist

BIG_SEED = (1 << 40) + 12345   # above 2^32: seed * 0xD13... wraps in uint64

# (scale, edge_factor, seed, dedup, weight_range, (a, b, c))
CASES = [
    (4, 1, 0, True, 0, None),
    (5, 16, 1, False, 0, None),
    (6, 4, BIG_SEED, True, 5, None),
    (7, 16, 0, True, 255, None),
    (8, 1, 1, False, 255, None),
    (9, 4, 1, True, 0, (0.45, 0.15, 0.15)),
    (10, 16, BIG_SEED, False, 5, None),
    (10, 16, 1, True, 0, None),
    (11, 4, 0, False, 0, (0.6, 0.2, 0.1)),
    (12, 16, 1, True, 255, None),
    (12, 1, BIG_SEED, True, 0, None),
]


def _same(e_jax, e_port):
    assert (e_port.m, e_port.n) == (e_jax.m, e_jax.n)
    for a, b in zip(e_jax.astuple(), e_port.astuple()):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.numpy().dtype == np.asarray(a).dtype


def _kw(case):
    scale, ef, seed, dedup, wr, abc = case
    kw = dict(scale=scale, edge_factor=ef, seed=seed, dedup=dedup,
              weight_range=wr)
    if abc is not None:
        kw.update(zip("abc", abc))
    return kw


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_native_stream_equals_gm_rmat_gen(case):
    kw = _kw(case)
    _same(jax_rmat(native=True, **kw), rmat_edgelist(native=True,
                                                     device="cpu", **kw))


@pytest.mark.parametrize("case", CASES[::2], ids=lambda c: "-".join(
    map(str, c)))
def test_numpy_stream_equals_jax_numpy_path(case):
    kw = _kw(case)
    _same(jax_rmat(native=False, **kw), rmat_edgelist(native=False,
                                                      device="cpu", **kw))


@pytest.mark.parametrize("case", CASES[1::3], ids=lambda c: "-".join(
    map(str, c)))
def test_default_is_the_native_stream(case):
    kw = _kw(case)
    _same(rmat_edgelist(native=True, device="cpu", **kw),
          rmat_edgelist(device="cpu", **kw))
    _same(jax_rmat(**kw), rmat_edgelist(device="cpu", **kw))


@pytest.mark.parametrize("wdtype", [np.float32, np.int64])
def test_weight_dtype(wdtype):
    kw = dict(scale=8, edge_factor=4, seed=3, weight_range=7, wdtype=wdtype)
    for native in (True, False):
        _same(jax_rmat(native=native, **kw),
              rmat_edgelist(native=native, device="cpu", **kw))


def _splitmix64_np(x):
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def test_splitmix64_equals_numpy_uint64():
    edge = [0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 63,
            2 ** 63 + 1, 2 ** 64 - 1]
    rng = np.random.default_rng(0)
    xs = np.r_[np.array(edge, np.uint64),
               rng.integers(0, 2 ** 63, 1000, dtype=np.uint64) * 2 + 1]
    got = trmat.splitmix64(torch.from_numpy(xs.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  _splitmix64_np(xs))


@pytest.mark.parametrize("weight_range", [1, 5, 255, 2 ** 31 - 1])
@pytest.mark.parametrize("seed", [0, BIG_SEED, 2 ** 64 - 1])
def test_weights_equal_unsigned_modulo(seed, weight_range):
    """``1 + splitmix64(seed ^ key) % w`` of uint64, from the 32-bit
    halves, on keys that reach both ends of the uint64 range."""
    rng = np.random.default_rng(1)
    keys = np.r_[np.array([0, 1, 2 ** 62, 2 ** 63 - 1], np.int64),
                 rng.integers(0, 2 ** 62, 500)]
    got = trmat.rmat_weights(torch.from_numpy(keys), seed, weight_range)
    z = _splitmix64_np(keys.view(np.uint64) ^ np.uint64(seed))
    want = 1 + z % np.uint64(weight_range)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_keys_reference_equals_a_numpy_draw():
    """The plain keys against the generator's rule written in numpy
    uint64 for a few edges and a seed above 2^32."""
    scale, nnz, seed = 9, 300, BIG_SEED
    a, b, c = 0.57, 0.19, 0.19
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    with np.errstate(over="ignore"):
        state = _splitmix64_np(np.uint64(seed) * np.uint64(
            0xD1342543DE82EF95) + np.arange(nnz, dtype=np.uint64))
    s = np.zeros(nnz, np.uint64)
    d = np.zeros(nnz, np.uint64)
    for _ in range(scale):
        state = _splitmix64_np(state)
        r1 = (state >> np.uint64(32)).astype(np.float64) * 2.0 ** -32
        r2 = (state & np.uint64(0xFFFFFFFF)).astype(np.float64) * 2.0 ** -32
        sb = r1 > ab
        db = np.where(sb, r2 > c_norm, r2 > a_norm)
        s = (s << np.uint64(1)) | sb.astype(np.uint64)
        d = (d << np.uint64(1)) | db.astype(np.uint64)
    want = (s << np.uint64(32)) | d
    got = trmat.rmat_keys(scale, nnz, a, b, c, seed, "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_rmat_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for native in (None, False):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            rmat_edgelist(6, native=native)


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError, match="scale"):
        trmat.rmat_keys(32, 4, 0.57, 0.19, 0.19, 0, "cpu")
    with pytest.raises(ValueError, match="weight_range"):
        trmat.rmat_weights(torch.zeros(2, dtype=torch.int64), 0, 0)
    with pytest.raises(TypeError, match="int64"):
        trmat.rmat_weights(torch.zeros(2, dtype=torch.int32), 0, 5)
    e = rmat_edgelist(3, 0, device="cpu")   # no draws: an empty graph
    assert e.nnz == 0 and e.n == 8
