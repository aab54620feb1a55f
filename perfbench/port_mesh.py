"""The program under test across a host's cards: beside ``port.py``, the
one module of the benchmark that imports ``graphmat_tpu_torch``, and only
its ``DistGraph`` and ``LocalMesh``."""

from __future__ import annotations

import torch


def mesh(shape, device):
    """A ``LocalMesh`` shaped ``shape`` (R, C), tile ``t`` on card ``t``
    of the first ``R * C`` cards; on the CPU, ``R * C`` CPU tiles.  Not
    the port's ``make_mesh``, which takes every card it sees."""
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    r, c = (int(x) for x in shape)
    if torch.device(device).type == "cuda":
        devices = [torch.device("cuda", i) for i in range(r * c)]
    else:
        devices = [torch.device(device)] * (r * c)
    return LocalMesh(devices, (r, c))


def graph(edges: dict, shape, device):
    """The port's ``DistGraph``, with its defaults, of the 1-based int32
    ``src``/``dst`` edges (values 1) over :func:`mesh`.  The build reads
    the list where it lies, a chunk at a time; the values are one 1
    broadcast, which the build copies a chunk at a time too."""
    from graphmat_tpu_torch.io.edgelist import EdgeList
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    n = edges["n"]
    src, dst = edges["src"], edges["dst"]
    val = torch.ones((), dtype=torch.int32, device=src.device).expand(
        src.numel())
    return DistGraph(EdgeList(n, n, src, dst, val), mesh(shape, device))
