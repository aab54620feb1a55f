"""The PyTorch port stands alone: importing it loads no JAX."""

import os
import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "graphmat_tpu_torch"


def test_import_loads_no_jax():
    code = ("import sys, graphmat_tpu_torch\n"
            "import graphmat_tpu_torch.apps\n"
            "import graphmat_tpu_torch.apps.pagerank\n"
            "import graphmat_tpu_torch.apps.bfs\n"
            "import graphmat_tpu_torch.apps.sssp\n"
            "import graphmat_tpu_torch.apps.connected_components\n"
            "import graphmat_tpu_torch.apps.topological_sort\n"
            "import graphmat_tpu_torch.apps.incremental_pagerank\n"
            "import graphmat_tpu_torch.apps.delta_stepping\n"
            "import graphmat_tpu_torch.core.graph_ops\n"
            "import graphmat_tpu_torch.ops.spmv2\n"
            "import graphmat_tpu_torch.ops.spmv_vec\n"
            "import graphmat_tpu_torch.ops.spmv\n"
            "import graphmat_tpu_torch.io.transforms\n"
            "import graphmat_tpu_torch.utils.generators\n"
            "import graphmat_tpu_torch.utils.reference_rng\n"
            "import graphmat_tpu_torch.io.converter\n"
            "import graphmat_tpu_torch.native\n"
            "import graphmat_tpu_torch.graft_entry\n"
            "import graphmat_tpu_torch.utils.timing\n"
            "import graphmat_tpu_torch.utils.debug\n"
            "import graphmat_tpu_torch.utils.logging\n"
            "import graphmat_tpu_torch.ops.triangles\n"
            "import graphmat_tpu_torch.parallel.dist_graph_ops\n"
            "from graphmat_tpu_torch.io.edgelist import _parse_text_native\n"
            "_parse_text_native(b'1 2 3\\n', True, 'int32')\n"
            "from graphmat_tpu_torch import read_mtx\n"
            "from graphmat_tpu_torch.utils.reference_rng import "
            "glibc_square_mapping\n"
            "glibc_square_mapping(8)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'graphmat_tpu.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b|"
                     r"import\s+graphmat_tpu\b|from\s+graphmat_tpu\b)",
                     re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders
