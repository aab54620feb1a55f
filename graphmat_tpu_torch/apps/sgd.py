"""SGD matrix completion / collaborative filtering (reference:
``src/SGD.cpp``), as in ``graphmat_tpu/apps/sgd.py``.

The rating matrix is a square graph whose vertices carry K latent factors.
ALL_EDGES + ALL_VERTICES: every rating pushes a gradient both ways each
iteration.

* message = the sender's factors ``lv``;
* ⊗: ``x·(rating − ⟨x, lv_receiver⟩)`` (op ``sgd`` of the K3 kernel);
* ⊕ = sum;
* apply: ``lv += step·(−λ·lv + Σ)`` (``src/SGD.cpp:113-117``).

RMSE is one IN_EDGES pass of ``(rating − ⟨x, lv_r⟩)²`` (op
``sgd_sqerr``), summed over vertices on the host.  The init matches the
reference and the JAX package bit for bit: vertex i's factors are
``rand_r(seed=i)/RAND_MAX``, drawn on the graph's device.  Defaults
λ=0.001, step=3.5e-7, 10 iterations.

Run as ``python -m graphmat_tpu_torch.apps.sgd ratings.mtx``; the device
comes from ``GRAPHMAT_PLATFORM`` (see :mod:`._cli`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import Graph
from ..core.program import GraphProgram, VecSemiring
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM
from ..ops.rand_r import rand_r_uniform
from ..ops.spmv_vec2 import VEC_PROCESS_OPS
from ..utils.timing import traced

__all__ = ["SGDProgram", "RMSEProgram", "run_sgd", "init_sgd_graph",
           "rmse_per_edge"]


def _msg(state, msg):
    return msg


def _lv(state, vp):
    return vp["lv"]


class SGDProgram(GraphProgram):
    order = Direction.ALL_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def __init__(self, lambda_: float = 0.001, step: float = 3.5e-7,
                 dtype=torch.float32, k: int = 20):
        self.lambda_ = lambda_
        self.step = step
        self.dtype = dtype
        self.k = k

    def vec_semiring(self):
        return VecSemiring(k=self.k, process_op="sgd", encode=_msg,
                           encode_vp=_lv, decode=self._decode, needs_vp=True)

    def _decode(self, y):
        return y.to(self.dtype)

    def send_message(self, state, vp):
        return vp["lv"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        return VEC_PROCESS_OPS["sgd"](msg, edge_vals.to(self.dtype),
                                      vp_r["lv"], None, None)

    def apply(self, state, reduced, vp):
        lv = vp["lv"]
        out = dict(vp)
        out["lv"] = lv + self.step * (-self.lambda_ * lv + reduced)
        return out

    def changed(self, old_vp, new_vp):
        return ((old_vp["lv"] - new_vp["lv"]).abs() > 1e-7).any(dim=1)


class RMSEProgram(GraphProgram):
    """Per-vertex squared error over IN_EDGES (``src/SGD.cpp:122-156``);
    ALL_VERTICES like the reference flow (``setAllActive`` + 1
    iteration)."""

    order = Direction.IN_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def __init__(self, dtype=torch.float32, k: int = 20):
        self.dtype = dtype
        self.k = k

    def vec_semiring(self):
        return VecSemiring(k=self.k, process_op="sgd_sqerr", encode=_msg,
                           encode_vp=_lv, decode=self._decode, needs_vp=True)

    def _decode(self, y):
        return y[:, 0].to(self.dtype)

    def send_message(self, state, vp):
        return vp["lv"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        return VEC_PROCESS_OPS["sgd_sqerr"](msg, edge_vals.to(self.dtype),
                                            vp_r["lv"], None, None)[:, 0]

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["sqerr"] = reduced
        return out


@traced("app.init")
def init_sgd_graph(graph: Graph, k: int = 20, dtype=torch.float32) -> None:
    """Reference init: vertex i (1-based) draws k uniforms via rand_r(i),
    on the graph's device (``ops/rand_r.py: rand_r_uniform``), so that no
    array crosses from the host; ``dtype`` is float32 or float64."""
    lv = rand_r_uniform(1, graph.n, k, dtype, graph.device)
    graph.init_vertexproperty(lv=lv, sqerr=torch.tensor(0, dtype=dtype))


@traced("sgd.rmse")
def rmse_per_edge(graph: Graph, dtype=torch.float32, k: int = 20) -> float:
    """sqrt(Σ sqerr / nnz), the reference's printed metric; the vertex
    sum runs on the host in numpy, as in the JAX package."""
    graph.set_all_active()
    engine_for(RMSEProgram(dtype=dtype, k=k), graph).run(iterations=1)
    err = float(graph.vp_numpy()["sqerr"].sum())
    return float(np.sqrt(err / graph.nnz))


@traced("app.sgd")
def run_sgd(graph: Graph, k: int = 20, lambda_: float = 0.001,
            step: float = 3.5e-7, iterations: int = 10, dtype=torch.float32):
    """The reference flow (``src/SGD.cpp:160-220``): init, RMSE,
    ``iterations`` SGD iterations, RMSE.

    Returns ``(lv[n, k] as numpy in original order, rmse_before,
    rmse_after)``.
    """
    init_sgd_graph(graph, k, dtype)
    rmse0 = rmse_per_edge(graph, dtype, k)

    graph.set_all_active()
    engine_for(SGDProgram(lambda_, step, dtype=dtype, k=k), graph).run(
        iterations=iterations)
    rmse1 = rmse_per_edge(graph, dtype, k)
    return graph.vp_numpy()["lv"], rmse0, rmse1


def _main(argv=None):
    """CLI parity with ``src/SGD.cpp``: <ratings.mtx>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("Correct format: sgd ratings.mtx")
        return 0
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    lv, rmse0, rmse1 = run_sgd(g)
    print(f"RMSE error = {rmse0:.6f} per edge (before)")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"RMSE error = {rmse1:.6f} per edge (after)")
    # the first vertices' latent factors, 2 decimals (src/SGD.cpp:244-249)
    for i in range(min(10, g.n)):
        print(f"{i + 1} : " + " ".join(f" {v:.2f}" for v in lv[i]))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
