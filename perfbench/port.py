"""The program under test: the one module of the benchmark that imports
``graphmat_tpu_torch``, and only its ``Graph`` and its app entries."""

from __future__ import annotations

import torch


def graph(edges: dict, device, val=None):
    """The port's ``Graph``, with its defaults, of 0-based int32
    ``src``/``dst`` edges on ``device`` (values ``val``, or 1)."""
    from graphmat_tpu_torch.core.graph import Graph
    from graphmat_tpu_torch.io.edgelist import EdgeList
    n = edges["n"]
    src, dst = edges["src"], edges["dst"]
    if val is None:
        val = torch.ones(src.numel(), dtype=torch.int32, device=src.device)
    return Graph(EdgeList(n, n, src + 1, dst + 1, val), device=device)


def run_pagerank(g):
    from graphmat_tpu_torch.apps.pagerank import run_pagerank as run
    return run(g)


def run_bfs(g, source1: int):
    from graphmat_tpu_torch.apps.bfs import run_bfs as run
    return run(g, source1)


def run_sgd(g, k: int, iterations: int):
    from graphmat_tpu_torch.apps.sgd import run_sgd as run
    return run(g, k=k, iterations=iterations)


def run_triangle_counting(g, method: str):
    from graphmat_tpu_torch.apps.triangle_counting import \
        run_triangle_counting as run
    return run(g, method=method)
