"""The port's glibc rand_r replica against the JAX package's: bitwise, for
seeds at the ends of the uint32 range; so too the plain route of the
device draw ``ops/rand_r.py: rand_r_uniform``, which gives SGD's initial
factors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmat_tpu.utils import reference_rng as jrng
from graphmat_tpu_torch.ops import rand_r
from graphmat_tpu_torch.utils import reference_rng as trng

SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1]
COUNT = 25


@pytest.mark.parametrize("seed", SEEDS)
def test_rand_r_np_matches_jax(seed):
    seeds = np.array([seed, seed ^ 0x5A5A5A5A], np.uint32)
    np.testing.assert_array_equal(trng.rand_r_np(seeds, COUNT),
                                  jrng.rand_r_np(seeds, COUNT))


@pytest.mark.parametrize("seed", SEEDS)
def test_rand_r_uniform_np_matches_jax(seed):
    seeds = np.array([seed], np.uint32)
    for dtype in (np.float64, np.float32):
        a = trng.rand_r_uniform_np(seeds, COUNT, dtype)
        b = jrng.rand_r_uniform_np(seeds, COUNT, dtype)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("seed", SEEDS)
def test_rand_r_torch_matches_jax(seed):
    seeds = np.array([seed, seed ^ 0x5A5A5A5A], np.uint32)
    ints = trng.rand_r_torch(torch.as_tensor(seeds.astype(np.int64)), COUNT)
    np.testing.assert_array_equal(ints.numpy(), jrng.rand_r_np(seeds,
                                                               COUNT))
    # the float32 uniform the K3 op lda_init draws, against rand_r_jnp
    uni = (ints.to(torch.float32) / float(trng.RAND_MAX)).numpy()
    want = np.asarray(jrng.rand_r_jnp(jnp.asarray(seeds), COUNT))
    np.testing.assert_array_equal(uni.view(np.uint32), want.view(np.uint32))


def test_rand_r_first_values_are_glibc():
    """glibc rand_r with seed 1 starts 476707713, 1186278907, 505671508."""
    out = trng.rand_r_torch(torch.tensor([1]), 3)
    assert out[0].tolist() == [476707713, 1186278907, 505671508]


@pytest.mark.parametrize("k", [1, 3, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_rand_r_uniform_plain_route_matches_jax(seed, dtype, k):
    """Row v is rand_r seeded ``seed + v`` mod 2^32, so the rows from 2^32
    - 1 wrap to 0; no launch on the CPU."""
    n = 300
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    seeds = ((np.arange(n, dtype=np.uint64) + seed) % 2 ** 32).astype(
        np.uint32)
    before = dict(rand_r.LAUNCHES)
    got = rand_r.rand_r_uniform(seed, n, k, dtype, "cpu")
    assert rand_r.LAUNCHES == before
    assert got.dtype == dtype and got.shape == (n, k)
    want = jrng.rand_r_uniform_np(seeds, k).astype(np_dtype)
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  want.view(np.uint8))


def test_rand_r_uniform_of_no_rows():
    assert rand_r.rand_r_uniform(1, 0, 20, torch.float32,
                                 "cpu").shape == (0, 20)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_rand_r_uniform_refuses_other_dtypes(dtype):
    """Only float32 and float64 come out with the reference's bits: torch
    would round float16 twice, through float32, where numpy rounds once."""
    with pytest.raises(ValueError, match="float32 or float64"):
        rand_r.rand_r_uniform(1, 10, 3, dtype, "cpu")
