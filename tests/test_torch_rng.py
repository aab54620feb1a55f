"""The port's glibc rand_r replica against the JAX package's: bitwise, for
seeds at the ends of the uint32 range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmat_tpu.utils import reference_rng as jrng
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
