"""Shared CLI helpers for the app entry points, e.g.::

    GRAPHMAT_PLATFORM=cuda python -m graphmat_tpu_torch.apps.pagerank A.mtx

``GRAPHMAT_PLATFORM`` picks the device: ``cuda`` (the default) or ``cpu``.
With no GPU the default raises; the CPU runs only when asked for.
``GRAPHMAT_MESH`` (a sharded run) is not ported yet and raises.
"""

from __future__ import annotations

import os
import time

import torch

from ..io.edgelist import load_edgelist

__all__ = ["device_from_env", "load_graph_file", "build_graph"]


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
    """A one-device Graph on the device of ``GRAPHMAT_PLATFORM``."""
    if os.environ.get("GRAPHMAT_MESH", "").strip():
        raise NotImplementedError(
            "GRAPHMAT_MESH: sharded graphs are not ported to "
            "graphmat_tpu_torch yet (ROADMAP Queue 1 item 10)")
    from ..core.graph import Graph
    return Graph(edgelist, device=device_from_env(), **graph_kw)
