"""Apps of the PyTorch port, with the JAX package's names; each runs as
``python -m graphmat_tpu_torch.apps.<name>``.  Every app of the JAX
package is ported."""

from .bfs import BFSProgram, run_bfs
from .connected_components import (ConnectedComponentsProgram,
                                   run_connected_components)
from .delta_stepping import DeltaSteppingProgram, run_delta_stepping
from .get_neighbors import GetNeighborsProgram, run_get_neighbors
from .incremental_pagerank import DeltaPageRankProgram, \
    run_incremental_pagerank
from .lda import LDAInitProgram, LDALLProgram, LDAProgram, run_lda
from .pagerank import DegreeProgram, PageRankProgram, run_pagerank
from .sgd import RMSEProgram, SGDProgram, run_sgd
from .sssp import SSSPProgram, run_sssp
from .topological_sort import TopSortProgram, run_topological_sort
from .triangle_counting import CountTrianglesProgram, run_triangle_counting

__all__ = [
    "BFSProgram", "run_bfs",
    "ConnectedComponentsProgram", "run_connected_components",
    "DeltaSteppingProgram", "run_delta_stepping",
    "DeltaPageRankProgram", "run_incremental_pagerank",
    "GetNeighborsProgram", "run_get_neighbors",
    "LDAInitProgram", "LDALLProgram", "LDAProgram", "run_lda",
    "DegreeProgram", "PageRankProgram", "run_pagerank",
    "RMSEProgram", "SGDProgram", "run_sgd",
    "SSSPProgram", "run_sssp",
    "TopSortProgram", "run_topological_sort",
    "CountTrianglesProgram", "run_triangle_counting",
]
