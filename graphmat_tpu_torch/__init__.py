"""graphmat_tpu_torch — the PyTorch/CUDA port of graphmat_tpu.

A GraphMat-style vertex-program engine: each iteration is one generalized
sparse-matrix × sparse-vector product (send a message per active vertex,
⊗ it per edge, ⊕-reduce it per receiver, apply).  Plain tensor code is
PyTorch; the scalar SpMV, the frontier push SpMV, the operand-compaction
gather and the K-wide three-operand SpMV are CUDA kernels written for
Hopper (``csrc/``), each with a plain PyTorch version that runs on CPU
tensors.  A Graph lives on the card unless the caller asks for the CPU.
The package never imports JAX.
"""

from .core.types import (Activity, Direction, Monoid, SUM, MIN, MAX, ANY, LOR,
                         UNTIL_CONVERGENCE)
from .core.graph import Graph
from .core.program import (GraphProgram, IterationContext, Semiring,
                           VecSemiring)
from .core.runtime import (Engine, engine_for, graph_program_init,
                           run_graph_program)
from .io.edgelist import EdgeList, load_edgelist, write_edgelist, \
    edgelist_from_arrays
from .io import transforms

__version__ = "0.1.0"

__all__ = [
    "Activity", "Direction", "Monoid", "SUM", "MIN", "MAX", "ANY", "LOR",
    "UNTIL_CONVERGENCE", "Graph", "GraphProgram", "IterationContext",
    "Semiring", "VecSemiring", "Engine", "engine_for", "graph_program_init",
    "run_graph_program", "EdgeList", "load_edgelist", "write_edgelist",
    "edgelist_from_arrays", "transforms",
]
