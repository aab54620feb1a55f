"""Checkpoint and resume, independent of the mesh.

Counterpart of ``graphmat_tpu/utils/checkpoint.py``, in its file format:
an npz holds the edge list and its dimensions, and the vertex state (the
properties and the frontier, in ORIGINAL vertex order) saves apart from
it, so a state taken on one mesh (or one device, or by the JAX package)
restores onto any other.  The reference's per-rank Boost archives
(``Graph.h:152-208``) refuse to load under another rank count.

Also ``save_vertexproperty``, the text export of
``Graph::saveVertexproperty`` (``Graph.h:338-350``).

With several processes every process gathers the state, process 0 writes
the file and the others wait for it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io.edgelist import EdgeList

__all__ = ["save_edgelist_checkpoint", "load_edgelist_checkpoint",
           "save_graph_state", "load_graph_state", "save_vertexproperty"]

_MAGIC = "graphmat_tpu-ckpt-v1"


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _write_on_rank0(write) -> None:
    """Run ``write`` on process 0, then hold every process until it is
    done."""
    import torch.distributed as dist
    on = dist.is_initialized()
    if not on or dist.get_rank() == 0:
        write()
    if on:
        dist.barrier()


def save_edgelist_checkpoint(e: EdgeList, path: str) -> None:
    """Graph-structure checkpoint (the GraphMatBin analog, rank-agnostic)."""
    _write_on_rank0(lambda: np.savez_compressed(
        _npz(path), magic=_MAGIC, m=e.m, n=e.n, src=_host(e.src),
        dst=_host(e.dst), val=_host(e.val)))


def load_edgelist_checkpoint(path: str) -> EdgeList:
    z = np.load(_npz(path), allow_pickle=False)
    if str(z["magic"]) != _MAGIC:
        raise ValueError(f"{path}: not a graphmat_tpu checkpoint")
    return EdgeList(int(z["m"]), int(z["n"]), z["src"], z["dst"], z["val"])


def save_graph_state(graph, path: str) -> None:
    """Vertex-state checkpoint of a Graph or a DistGraph: the properties
    and the frontier, in original vertex order."""
    payload = {"magic": _MAGIC, "n": graph.n,
               "active": graph.active_numpy()}
    for k, v in graph.vp_numpy().items():
        payload[f"vp_{k}"] = v
    _write_on_rank0(lambda: np.savez_compressed(_npz(path), **payload))


def load_graph_state(graph, path: str) -> None:
    """Restore a state saved by :func:`save_graph_state` (by either
    package) onto a graph of the same vertex count, any mesh or
    padding."""
    z = np.load(_npz(path), allow_pickle=False)
    if str(z["magic"]) != _MAGIC:
        raise ValueError(f"{path}: not a graphmat_tpu checkpoint")
    n = int(z["n"])
    if n != graph.n:
        raise ValueError(f"checkpoint has {n} vertices, graph has {graph.n}")
    graph.init_vertexproperty(**{k[3:]: z[k] for k in z.files
                                 if k.startswith("vp_")})
    graph.set_active_mask(z["active"].astype(bool))


def save_vertexproperty(graph, path: str, field: str) -> None:
    """Text export, one ``<1-based id> <value>`` line per vertex
    (``saveVertexproperty``)."""
    vp = graph.vp_numpy()[field]

    def write():
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for i, v in enumerate(vp, start=1):
                if np.ndim(v) > 0:
                    v = " ".join(str(x) for x in np.ravel(v))
                f.write(f"{i} {v}\n")
        os.replace(tmp, path)
    _write_on_rank0(write)
