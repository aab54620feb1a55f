"""Multi-process execution: one tile per process.

Counterpart of ``graphmat_tpu/parallel/multihost.py``.  The reference
scales across nodes with ``mpirun``; the JAX package with
``jax.distributed``; here with ``torch.distributed`` as ``torchrun``
starts it:

* every process calls :func:`initialize`, which reads ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` (or
  takes them as arguments), picks its card (``torch.cuda.set_device``,
  before NCCL starts) and joins the group: NCCL on cards, gloo when the
  CPU is asked for;
* :func:`hosts_mesh` lays the mesh out so that the row axis spans hosts:
  each host holds whole tile rows, so the per-iteration reduce-scatter
  along 'c' stays inside a host and only the all-gather along 'r'
  crosses hosts;
* edge ingest is file-sharded like the reference's rank-strided
  ``load_edgelist`` (``edgelist.h:250-274``): process h reads shards
  ``prefix{h, h+P, ...}``; :func:`allgather_edgelist` then gives every
  process the union, from which each builds its own tile.

One process driving several cards (or one card several times) needs none
of this: a :class:`~graphmat_tpu_torch.parallel.mesh.LocalMesh` does it.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import numpy as np
import torch

from ..io.edgelist import EdgeList, load_edgelist
from .mesh import ProcessMesh

__all__ = ["initialize", "hosts_mesh",
           "load_edgelist_sharded", "allgather_edgelist"]


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _process_device(device=None) -> torch.device:
    """This process's device: the CPU where asked for, else card
    ``LOCAL_RANK``."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the processes on the CPU (gloo)")
    return torch.device("cuda", _env_int("LOCAL_RANK", 0))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> torch.device:
    """Join the process group (idempotent) and return this process's
    device.  Arguments default to the environment ``torchrun`` sets;
    ``coordinator_address`` is ``host:port``.  A world of one process
    with no address given is left alone (single-process runs)."""
    import torch.distributed as dist
    dev = _process_device(device)
    if dist.is_initialized():
        return dev
    world = (num_processes if num_processes is not None
             else _env_int("WORLD_SIZE", 1))
    if world <= 1 and coordinator_address is None:
        return dev
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)   # before NCCL starts
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank)
    return dev


def hosts_mesh(rows_per_host: int = 1, device=None) -> ProcessMesh:
    """A :class:`ProcessMesh` whose row axis spans hosts: with H hosts of
    L processes each (``LOCAL_WORLD_SIZE``), shape ``(H * rows_per_host,
    L // rows_per_host)``.  ``torchrun`` numbers ranks host-major, so a
    tile row's processes share a host."""
    import torch.distributed as dist
    world = dist.get_world_size()
    local = _env_int("LOCAL_WORLD_SIZE", world)
    r = (world // local) * rows_per_host
    if r < 1 or world % r:
        raise ValueError(f"cannot form a mesh of {world} processes with "
                         f"{r} rows")
    return ProcessMesh((r, world // r), device=device)


def allgather_edgelist(e: EdgeList) -> EdgeList:
    """The union of every process's partial edge list, the same on all
    (the reference shuffles loaded edges to their owners with
    Isend/Irecv, ``SpMat.h:171-217``)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return e
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (int(e.m), int(e.n), np.asarray(e.src),
                                   np.asarray(e.dst), np.asarray(e.val)))
    return EdgeList(max(p[0] for p in parts), max(p[1] for p in parts),
                    np.concatenate([p[2] for p in parts]).astype(np.int32),
                    np.concatenate([p[3] for p in parts]).astype(np.int32),
                    np.concatenate([p[4] for p in parts]))


def load_edgelist_sharded(prefix: str, **kw) -> EdgeList:
    """Rank-strided shard loading: process h reads ``prefix{h, h+P, ...}``
    (``load_edgelist``'s striding, ``edgelist.h:250-274``); a prefix with
    no numbered shards is read whole.  Follow with
    :func:`allgather_edgelist`."""
    import torch.distributed as dist
    on = dist.is_initialized()
    h = dist.get_rank() if on else 0
    nh = dist.get_world_size() if on else 1
    shards = []
    for p in glob.glob(glob.escape(prefix) + "*"):
        if re.fullmatch(r"\d+", p[len(prefix):]):
            shards.append(int(p[len(prefix):]))
    if not shards:
        return load_edgelist(prefix, **kw)
    parts = [load_edgelist(f"{prefix}{s}", **kw)
             for s in sorted(s for s in shards if s % nh == h)]
    if not parts:
        return EdgeList()
    return EdgeList(max(p.m for p in parts), max(p.n for p in parts),
                    np.concatenate([p.src for p in parts]),
                    np.concatenate([p.dst for p in parts]),
                    np.concatenate([p.val for p in parts]))
