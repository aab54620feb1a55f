"""Shared CLI helpers for the app entry points, e.g.::

    GRAPHMAT_PLATFORM=cuda python -m graphmat_tpu_torch.apps.pagerank A.mtx

``GRAPHMAT_PLATFORM`` picks the device: ``cuda`` (the default) or ``cpu``.
With no GPU the default raises; the CPU runs only when asked for.

A sharded run keeps the same CLI, as the JAX package's does:
``GRAPHMAT_MESH=RxC`` (e.g. ``2x2``) builds the graph 2D-sharded over an
R x C mesh, ``GRAPHMAT_MESH=auto`` over every device.  Under ``torchrun``
(``WORLD_SIZE`` > 1) each process holds one tile (a ``ProcessMesh``; R x
C must equal the world size)::

    GRAPHMAT_MESH=2x2 torchrun --nproc_per_node=4 \
        -m graphmat_tpu_torch.apps.pagerank A.mtx

In one process the tiles go on the visible cards, one each (a
``LocalMesh``; R x C may not exceed them), or all on the CPU with
``GRAPHMAT_PLATFORM=cpu``.  The runners pick the distributed engine from
the graph type.
"""

from __future__ import annotations

import os
import time

import torch

from ..io.edgelist import load_edgelist

__all__ = ["device_from_env", "load_graph_file", "build_graph", "print_first"]


def device_from_env() -> torch.device:
    """The device ``GRAPHMAT_PLATFORM`` names (default ``cuda``)."""
    plat = os.environ.get("GRAPHMAT_PLATFORM", "").strip().lower() or "cuda"
    if plat == "cpu":
        return torch.device("cpu")
    if plat != "cuda":
        raise ValueError(f"GRAPHMAT_PLATFORM={plat!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("GRAPHMAT_PLATFORM is 'cuda' (the default) but "
                           "no CUDA device is available; set "
                           "GRAPHMAT_PLATFORM=cpu to run on the CPU")
    return torch.device("cuda")


def load_graph_file(path, **kw):
    t0 = time.time()
    e = load_edgelist(path, **kw)
    print(f"Read {e.nnz} edges, {max(e.m, e.n)} vertices "
          f"({time.time() - t0:.2f}s)")
    return e


def build_graph(edgelist, **graph_kw):
    """A Graph on the device of ``GRAPHMAT_PLATFORM``, or a DistGraph when
    ``GRAPHMAT_MESH`` is set (unset or empty: one device)."""
    spec = os.environ.get("GRAPHMAT_MESH", "").strip().lower()
    device = device_from_env()
    if not spec:
        from ..core.graph import Graph
        return Graph(edgelist, device=device, **graph_kw)
    from ..parallel.dist_graph import DistGraph
    from ..parallel.mesh import LocalMesh, ProcessMesh, factor2d, make_mesh
    from ..parallel.multihost import initialize
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        dev = initialize(device=device)
        ndev = world
    else:
        ndev = 1 if device.type == "cpu" else torch.cuda.device_count()
    if spec == "auto":
        shape = factor2d(ndev)
    else:
        try:
            r, c = (int(x) for x in spec.split("x"))
        except ValueError:
            raise ValueError(f"GRAPHMAT_MESH={spec!r}: use RxC (e.g. 2x2) "
                             "or auto") from None
        shape = (r, c)
    nt = shape[0] * shape[1]
    if world > 1:
        mesh = ProcessMesh(shape, device=dev)
    elif device.type == "cpu":
        mesh = LocalMesh([device] * nt, shape)
    else:   # one tile a card; raises past the visible cards
        mesh = make_mesh(shape=shape)
    print(f"mesh {shape[0]}x{shape[1]} over {nt} devices")
    return DistGraph(edgelist, mesh, **graph_kw)


def print_first(vals, k: int = 10, label: str = ""):
    """Print the first ``k`` values as ``{label}{i} : {v}``, ``i``
    1-based (``graphmat_tpu/apps/_cli.py:66-68``)."""
    for i, v in enumerate(vals[:k], start=1):
        print(f"{label}{i} : {v}")
