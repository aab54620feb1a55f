"""Collapsed variational LDA on a doc-term bipartite graph (reference:
``src/LDA.cpp``), as in ``graphmat_tpu/apps/lda.py``.

Vertices 1..ndoc are documents, ndoc+1..ndoc+nterms terms; edges carry
token counts and are used both ways (ALL_EDGES + ALL_VERTICES).  Vertex
property ``N[K]`` holds per-topic expected counts; the global topic totals
``global_N[K]`` (a sum over term vertices) are program state, recomputed
in ``do_every_iteration``.

* **LDAInitProgram**: per-edge gamma from ``rand_r(edge value)``, so both
  directions of an edge agree; ``gamma/Σgamma · count``; apply overwrites
  N (K3 op ``lda_init``).
* **LDAProgram**: gamma ∝ ``(N_recv + off_r − 1)(N_send + off_s − 1) /
  (global_N + V(η−1))``, the (α, η) offsets chosen by the receiver's side;
  α=1, η=5 (K3 op ``lda``).  The receiver's side rides an encoded is_doc
  column ``k`` of vp, so the kernel's operands have ``k + 1`` columns:
  vertex ids may be permuted, so ``rid < ndoc`` would mislabel them.
* **LDALLProgram**: per-vertex token log-likelihood under the smoothed
  topic-word distributions (K3 op ``lda_loglik``).

Run as ``python -m graphmat_tpu_torch.apps.lda A.mtx NDOC NTERMS
[iterations]``; the device comes from ``GRAPHMAT_PLATFORM``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.graph import Graph
from ..core.program import GraphProgram, VecSemiring
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM
from ..ops.spmv_vec2 import VEC_PROCESS_OPS

__all__ = ["LDAInitProgram", "LDAProgram", "LDALLProgram", "run_lda"]


def _n(state, msg_or_vp):
    return msg_or_vp["N"]


class LDAInitProgram(GraphProgram):
    order = Direction.ALL_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = False

    def __init__(self, k: int = 20, dtype=torch.float32):
        self.k = k
        self.dtype = dtype

    def vec_semiring(self):
        return VecSemiring(k=self.k, process_op="lda_init", encode=_n,
                           decode=self._decode)

    def _decode(self, y):
        return y.to(self.dtype)

    def send_message(self, state, vp):
        return {"N": vp["N"]}, None

    def process_message(self, state, msg, edge_vals, vp_r):
        return VEC_PROCESS_OPS["lda_init"](msg["N"], edge_vals.to(self.dtype),
                                           None, None, None)

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["N"] = reduced
        return out


def _global_topic_totals(vp, ctx):
    """Σ over term vertices of N: ``calcGlobalN``
    (``src/LDA.cpp:140-143``)."""
    is_term = ~vp["is_doc"]
    local = torch.where(is_term[:, None], vp["N"],
                        torch.zeros_like(vp["N"])).sum(0)
    return ctx.all_reduce_sum(local)


class LDAProgram(GraphProgram):
    order = Direction.ALL_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def __init__(self, k: int = 20, alpha: float = 1.0, eta: float = 5.0,
                 vocab_size: int = 0, ndoc: int = 0, dtype=torch.float32):
        self.k = k
        self.alpha = alpha
        self.eta = eta
        self.vocab_size = vocab_size
        self.ndoc = ndoc
        self.dtype = dtype
        self.params = {"alpha": alpha, "eta": eta, "vocab_size": vocab_size}

    # k + 1 columns: column k of the encoded vp is the is_doc flag
    def _encode_msg(self, state, msg):
        return F.pad(msg["N"], (0, 1))

    def _encode_vp(self, state, vp):
        return torch.cat([vp["N"], vp["is_doc"].to(vp["N"].dtype)[:, None]],
                         dim=1)

    def vec_semiring(self):
        if self.ndoc <= 0:
            return None   # doc/term split unknown (direct engine use)
        return VecSemiring(k=self.k + 1, process_op="lda",
                           encode=self._encode_msg,
                           encode_vp=self._encode_vp, decode=self._decode,
                           needs_vp=True, extra_fn=lambda state: state,
                           params=self.params)

    def _decode(self, y):
        return y[:, : self.k].to(self.dtype)

    def init_state(self, graph):
        # global_N; run_lda computes it before the run
        return torch.zeros(self.k, dtype=self.dtype, device=graph.device)

    def send_message(self, state, vp):
        return {"N": vp["N"]}, None

    def process_message(self, state, msg, edge_vals, vp_r):
        return VEC_PROCESS_OPS["lda"](
            self._encode_msg(state, msg), edge_vals.to(self.dtype),
            self._encode_vp(state, vp_r), state, self.params)

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["N"] = reduced
        return out

    def changed(self, old_vp, new_vp):
        # operator!= tolerance 1e-3 on N (src/LDA.cpp:52-58)
        return ((old_vp["N"] - new_vp["N"]).abs() > 1e-3).any(dim=1)

    def do_every_iteration(self, state, vp, it, ctx):
        return _global_topic_totals(vp, ctx)


class LDALLProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def __init__(self, n_k, eta: float, nterms: int, k: int = 20,
                 dtype=torch.float32):
        self.k = k
        self.eta = eta
        # smoothed N_k (src/LDA.cpp:176-181)
        self.n_k_smoothed = (torch.as_tensor(n_k).to(dtype)
                             + nterms * (eta - 1.0))
        self.dtype = dtype
        self.params = {"eta": eta}

    def vec_semiring(self):
        return VecSemiring(k=self.k, process_op="lda_loglik", encode=_n,
                           encode_vp=_n, decode=self._decode, needs_vp=True,
                           extra_fn=self._extra, params=self.params)

    def _extra(self, state):
        return self.n_k_smoothed

    def _decode(self, y):
        return y[:, 0].to(self.dtype)

    def send_message(self, state, vp):
        return {"N": vp["N"]}, None

    def process_message(self, state, msg, edge_vals, vp_r):
        nks = self.n_k_smoothed.to(msg["N"].device)
        return VEC_PROCESS_OPS["lda_loglik"](
            msg["N"], edge_vals.to(self.dtype), vp_r["N"], nks,
            self.params)[:, 0]

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["token_loglik"] = reduced
        return out


def run_lda(graph: Graph, ndoc: int, nterms: int, k: int = 20,
            iterations: int = 10, alpha: float = 1.0, eta: float = 5.0,
            dtype=torch.float32):
    """The reference flow (``src/LDA.cpp:263-345``): init, ``iterations``
    LDA iterations, log-likelihood.

    Returns ``(N[n, k] as numpy in original order, global_N[k] as numpy,
    total_loglik)``.
    """
    if ndoc + nterms != graph.n:
        raise ValueError("ndoc + nterms must equal the vertex count "
                         "(src/LDA.cpp:268-271)")
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    is_doc = np.zeros(graph.n, bool)
    is_doc[:ndoc] = True
    graph.init_vertexproperty(N=np.zeros((graph.n, k), np_dtype),
                              is_doc=is_doc,
                              token_loglik=np.array(0, np_dtype))

    engine_for(LDAInitProgram(k, dtype=dtype), graph).run(iterations=1)

    prog = LDAProgram(k, alpha, eta, vocab_size=nterms, ndoc=ndoc,
                      dtype=dtype)
    eng = engine_for(prog, graph)
    # calcGlobalN() before the run (src/LDA.cpp:279), on the host from the
    # exported properties, as the JAX package does
    vpn = graph.vp_numpy()
    global_n = torch.as_tensor(vpn["N"][~vpn["is_doc"]].sum(axis=0),
                               device=graph.device)
    eng.run(iterations=iterations, state=global_n)
    global_n = eng.final_state

    engine_for(LDALLProgram(global_n, eta, nterms, k, dtype=dtype),
               graph).run(iterations=1)
    vp = graph.vp_numpy()
    total_ll = float(vp["token_loglik"].sum())
    return vp["N"], global_n.cpu().numpy(), total_ll


def _main(argv=None):
    """CLI parity with ``src/LDA.cpp``: <A.mtx> <NDOC> <NTERMS> [iters]."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 3:
        print("Correct format: lda A.mtx #DOC #TERMS "
              "{#iterations (default 10)}")
        return 0
    g = build_graph(load_graph_file(args[0]))
    iters = int(args[3]) if len(args) > 3 else 10
    t0 = time.time()
    _, _, ll = run_lda(g, int(args[1]), int(args[2]), iterations=iters)
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Total Loglikelihood = {ll:.6f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
