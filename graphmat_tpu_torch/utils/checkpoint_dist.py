"""Sharded checkpoints through ``torch.distributed.checkpoint``.

Counterpart of ``graphmat_tpu/utils/checkpoint_orbax.py``.  The npz
checkpoint (:mod:`graphmat_tpu_torch.utils.checkpoint`) gathers the vertex
state to one host; here every process writes only its own segments,
straight from the device, and a restore reads them back onto any mesh.

The state is saved in the SOURCE graph's internal layout: key
``seg{t}.vp.{name}`` holds property ``name`` of vertex segment ``t`` (a
one-device Graph is one segment of ``n_pad`` rows) and ``seg{t}.active``
its frontier.  A sidecar, ``<path>.layout.npz``, records ``n``, ``n_pad``
and the vertex permutation (empty for none), as the JAX package's does.
When the target's layout is the source's (the usual resume), each process
reads just its own segments; otherwise every process reads the whole
state and maps it through original vertex order onto its segments.

Compare the reference's ``WriteGraphMatBin`` per-rank Boost archives
(``Graph.h:152-208``), which refuse to load under another rank count:
here the mesh and the vertex layout belong to the restore.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

__all__ = ["save_sharded_state", "load_sharded_state"]

_KEY = re.compile(r"seg(\d+)\.(?:vp\.(.+)|active)$")


def _segments(graph):
    """(segment index, property dict, frontier) of every segment held
    here."""
    from ..parallel.dist_graph import DistGraph
    if isinstance(graph, DistGraph):
        return list(zip(graph.local, graph.vp, graph.active))
    return [(0, graph.vp, graph.active)]


def _no_dist(graph) -> bool:
    """One process holds the whole graph: no collectives in the save or
    the load."""
    from ..parallel.mesh import ProcessMesh
    return not isinstance(getattr(graph, "mesh", None), ProcessMesh)


def _perm(graph):
    p = getattr(graph, "perm", None)
    return None if p is None else p.cpu().numpy().astype(np.int64)


def save_sharded_state(graph, path: str) -> None:
    """Save the vertex properties and the frontier of a Graph or a
    DistGraph from the device, each process its own segments."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    state = {}
    for t, vp, active in _segments(graph):
        for k, v in vp.items():
            state[f"seg{t}.vp.{k}"] = v
        state[f"seg{t}.active"] = active
    single = _no_dist(graph)
    dcp.save(state, checkpoint_id=path, no_dist=single)
    if single or dist.get_rank() == 0:   # the sidecar is process 0's
        perm = _perm(graph)
        # a temporary file and a rename: a reader never sees a torn zip
        tmp = path + ".layout.tmp.npz"
        np.savez(tmp, n=np.int64(graph.n), n_pad=np.int64(graph.n_pad),
                 perm=perm if perm is not None else np.zeros(0, np.int64))
        os.replace(tmp, path + ".layout.npz")
    if not single:
        dist.barrier()


def _saved(path):
    """The checkpoint's segment count and ``{key: (shape, dtype)}``."""
    import torch.distributed.checkpoint as dcp
    md = dcp.FileSystemReader(path).read_metadata()
    items = {k: (tuple(m.size), m.properties.dtype)
             for k, m in md.state_dict_metadata.items() if _KEY.match(k)}
    nseg = 1 + max(int(_KEY.match(k).group(1)) for k in items)
    return nseg, items


def load_sharded_state(graph, path: str) -> None:
    """Restore onto ``graph``: a Graph or a DistGraph of any mesh and any
    vertex permutation, with the source's vertex count."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    meta = np.load(path + ".layout.npz")
    n, src_n_pad = int(meta["n"]), int(meta["n_pad"])
    src_perm = meta["perm"] if meta["perm"].size else None
    if n != graph.n:
        raise ValueError(f"checkpoint has {n} vertices, graph has {graph.n}")
    nseg, items = _saved(path)
    tgt_perm = _perm(graph)
    segs = _segments(graph)
    same_layout = (src_n_pad == graph.n_pad
                   and nseg == getattr(graph, "R", 1) * getattr(graph, "C", 1)
                   and ((src_perm is None and tgt_perm is None)
                        or (src_perm is not None and tgt_perm is not None
                            and np.array_equal(src_perm, tgt_perm))))
    if same_layout:
        # each process reads its own segments, onto their devices
        state = {}
        for t, _vp, active in segs:
            for k, (shape, dtype) in items.items():
                if k.startswith(f"seg{t}."):
                    state[k] = torch.empty(shape, dtype=dtype,
                                           device=active.device)
        dcp.load(state, checkpoint_id=path, no_dist=_no_dist(graph))
        vps, acts = [], []
        for t, _vp, _active in segs:
            vps.append({_KEY.match(k).group(2): v for k, v in state.items()
                        if k.startswith(f"seg{t}.vp.")})
            acts.append(state[f"seg{t}.active"])
        from ..parallel.dist_graph import DistGraph
        if isinstance(graph, DistGraph):
            graph.vp, graph.active = vps, acts
        else:
            graph.vp, graph.active = vps[0], acts[0]
        return
    # another layout: read every segment, put it in original order
    state = {k: torch.empty(shape, dtype=dtype)
             for k, (shape, dtype) in items.items()}
    dcp.load(state, checkpoint_id=path, no_dist=_no_dist(graph))
    names = sorted({m.group(2) for m in map(_KEY.match, state)
                    if m.group(2) is not None})

    def full(suffix):
        a = torch.cat([state[f"seg{t}.{suffix}"] for t in range(nseg)])
        a = a.numpy()
        return a[src_perm] if src_perm is not None else a[:n]
    graph.init_vertexproperty(**{k: full(f"vp.{k}") for k in names})
    graph.set_active_mask(full("active"))
