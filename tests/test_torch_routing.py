"""Which route the port's Engine gives a program with a scalar semiring,
against the JAX package's XLA Engine (``use_pallas=False``).

A scalar SpMV kernel cannot read the receiver's vertex property.  The
JAX Engine takes its kernel only when ``process_requires_vertexprop`` is
False (``graphmat_tpu/core/runtime.py:190-192``) and otherwise runs the
program's own ``process_message``; so does the port.  Results are small
integers: equal exactly."""

import numpy as np
import pytest

import graphmat_tpu as gj
from graphmat_tpu.core.program import GraphProgram as JProgram
from graphmat_tpu.core.program import PallasSemiring
from graphmat_tpu.core.runtime import Engine as JEngine
from graphmat_tpu.core.types import Activity as JActivity

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.core.program import GraphProgram as TProgram
from graphmat_tpu_torch.core.program import Semiring
from graphmat_tpu_torch.core.runtime import Engine as TEngine
from graphmat_tpu_torch.core.types import Activity as TActivity

# 1 -> 2, 1 -> 3, 2 -> 3; every vertex also hears itself
SRC, DST = [1, 1, 2, 1, 2, 3], [2, 3, 3, 1, 2, 3]
W = np.array([1.0, 2.0, 3.0], np.float32)


def edges():
    return gj.edgelist_from_arrays(SRC, DST, np.ones(len(SRC), np.float32),
                                   m=3, n=3)


class JScale(JProgram):
    """y[r] = Σ_{s→r} x[s] · w[r]: ⊗ reads the receiver's ``w``."""
    activity = JActivity.ALL_VERTICES

    def send_message(self, state, vp):
        return vp["x"], None

    def process_message(self, state, msg, edge_vals, vp_receiver):
        return msg * vp_receiver["w"]

    def apply(self, state, reduced, vp):
        return {"x": vp["x"], "w": vp["w"], "y": reduced}

    def pallas_semiring(self):
        return PallasSemiring("sum")


class TScale(TProgram):
    activity = TActivity.ALL_VERTICES

    def send_message(self, state, vp):
        return vp["x"], None

    def process_message(self, state, msg, edge_vals, vp_receiver):
        return msg * vp_receiver["w"]

    def apply(self, state, reduced, vp):
        return {"x": vp["x"], "w": vp["w"], "y": reduced}

    def semiring(self):
        return Semiring("sum")


def run_jax():
    g = gj.Graph(edges())
    g.init_vertexproperty(x=np.ones(3, np.float32), w=W,
                          y=np.zeros(3, np.float32))
    JEngine(JScale(), g, use_pallas=False).run(iterations=1)
    return g.vp_numpy()["y"]


@pytest.mark.parametrize("kernel", ["v2u", "v2"])
def test_semiring_program_reading_vp_matches_jax_xla(kernel, monkeypatch):
    monkeypatch.setenv("GRAPHMAT_KERNEL", kernel)
    g = gt.Graph(gt.edgelist_from_arrays(SRC, DST,
                                         np.ones(len(SRC), np.float32),
                                         m=3, n=3), device="cpu")
    g.init_vertexproperty(x=np.ones(3, np.float32), w=W,
                          y=np.zeros(3, np.float32))
    eng = TEngine(TScale(), g)
    assert eng._semiring is None   # the default flag: no scalar kernel
    eng.run(iterations=1)
    want = run_jax()
    np.testing.assert_array_equal(want, [1.0, 4.0, 9.0])
    np.testing.assert_array_equal(g.vp_numpy()["y"], want)


def test_semiring_program_without_vp_keeps_the_kernel_route():
    """With the flag False the semiring still selects the kernel route."""
    class NoVp(TScale):
        process_requires_vertexprop = False
    g = gt.Graph(gt.edgelist_from_arrays(SRC, DST,
                                         np.ones(len(SRC), np.float32),
                                         m=3, n=3), device="cpu")
    assert TEngine(NoVp(), g)._semiring is not None
