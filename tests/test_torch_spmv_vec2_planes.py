"""K3's plain version against the JAX package's interpret-mode K3 at
K = 40, where the JAX kernel runs two 32-lane planes and couples them in
its dot products and normalisations; tolerance 2e-3 as in
``test_torch_spmv_vec2.py``, whose inputs and helpers this file shares."""

import numpy as np
import pytest

from test_torch_spmv_vec2 import OPS, jax_k3, plain_k3


@pytest.mark.parametrize("op", OPS)
def test_plain_k3_matches_interpret_pallas_two_planes(op):
    np.testing.assert_allclose(plain_k3(op, 40), jax_k3(op, 40), rtol=2e-3,
                               atol=2e-3)
