"""Device meshes for the 2D-sharded graph engine.

Counterpart of ``graphmat_tpu/parallel/mesh.py``.  The reference lays the
adjacency out on an ``R x C`` tile grid (``GMDP/matrices/layouts.h:39-57``)
and exchanges with hand-rolled MPI; the JAX package runs one
``shard_map`` over an ``('r', 'c')`` mesh.  Here a :class:`Mesh` is the
grid and its collectives, over the tiles this process holds:

* tile ``(i, j)`` has the flattened index ``t = i * C + j``; vertex
  segment ``t`` lives with it;
* ``all_gather(ts, "r")`` gives each tile its column block (the segments
  ``(0..R-1, j)``, ``i``-major), ``all_gather(ts, "c")`` its row block;
* ``reduce_scatter(ts, "c", kind)`` folds the ``C`` partials of a row
  block with sum, min or max and gives each tile its own segment;
* ``all_to_all(ts, "c", concat_dim)`` gives each tile its segment's chunk
  of every partial of its row block, concatenated along ``concat_dim``
  (the concat ⊕ of vector messages, and any other monoid, which the
  caller folds);
* ``all_reduce(ts, kind)`` reduces one value per tile over the whole mesh
  (the convergence count).

Every collective takes and returns a list with one tensor per LOCAL tile,
in flattened order.  Two implementations:

* :class:`LocalMesh` holds every tile in one process, tile ``t`` on
  ``devices[t]`` (a list may name one device more than once): the
  counterpart of the JAX tests' virtual CPU devices, and how one card runs
  a 2x2 grid.  Its collectives are torch ops over the list;
* :class:`ProcessMesh` holds one tile per rank of ``torch.distributed``
  (NCCL on cards, gloo on the CPU), over a ``DeviceMesh`` with dimensions
  ``("r", "c")``; rank ``t`` holds tile ``t``.

Both record each collective as a span of
:mod:`graphmat_tpu_torch.utils.timing` (``mesh.all_gather``,
``mesh.reduce_scatter``, ``mesh.all_to_all``, ``mesh.all_reduce``,
``mesh.gather_segments``) and count what the tiles held here receive
from other tiles: ``mesh.bytes`` and ``mesh.n`` (tensors).  The count is
the collective's, not the implementation's: an all-gather over ``g``
tiles brings each tile ``g - 1`` tensors, a reduce-scatter or an
all-to-all ``g - 1`` chunks of ``1/g`` of each, an all-reduce ``R * C -
1`` values, a gather of segments the gathering tile (every rank, on a
:class:`ProcessMesh`) ``R * C - 1`` segments.  So a 2x2 grid on one
card, or on the CPU, counts what four ranks would send each other.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import torch

from ..utils.timing import count, traced

__all__ = ["ROW_AXIS", "COL_AXIS", "factor2d", "make_mesh", "Mesh",
           "LocalMesh", "ProcessMesh"]

ROW_AXIS = "r"
COL_AXIS = "c"

_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def factor2d(n: int) -> tuple:
    """Split n devices into the most-square (R, C) grid, the analog of
    ``factorize_int`` in ``layouts.h:39-49``."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def make_mesh(devices=None, shape: Optional[tuple] = None) -> "LocalMesh":
    """A :class:`LocalMesh` over ``devices`` (default: every visible card),
    shaped ``shape`` (default: :func:`factor2d` of their count)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices (e.g. ['cpu'] * 4)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return LocalMesh(devices, shape)


class Mesh:
    """The interface: ``shape`` (R, C), ``local`` (the tile indices held
    here, ascending) and ``devices`` (the device of each local tile)."""

    shape: tuple
    local: List[int]
    devices: List[torch.device]

    def all_gather(self, ts, axis: str) -> list:
        raise NotImplementedError

    def reduce_scatter(self, ts, axis: str, kind: str) -> list:
        raise NotImplementedError

    def all_to_all(self, ts, axis: str, concat_dim: int = 0) -> list:
        raise NotImplementedError

    def all_reduce(self, ts, kind: str = "sum") -> torch.Tensor:
        raise NotImplementedError

    def gather_segments(self, ts) -> torch.Tensor:
        """Every segment of the mesh, in order, as one tensor on the first
        local tile's device: ``[R * C * S, ...]``."""
        raise NotImplementedError

    def gather_objects(self, obj) -> list:
        """One picklable object per process, in rank order."""
        raise NotImplementedError


def _received(tiles: int, others: int, nbytes: int) -> None:
    """Count that each of ``tiles`` tiles received ``others`` tensors of
    ``nbytes`` bytes from other tiles."""
    count("mesh.bytes", float(tiles * others * nbytes))
    count("mesh.n", float(tiles * others))


def _check_kind(kind):
    if kind not in _COMBINE:
        raise ValueError(f"reduce kind {kind!r} is not one of "
                         f"{sorted(_COMBINE)}")


class LocalMesh(Mesh):
    """Every tile in this process: tile ``t`` on ``devices[t]``.

    An all-gather is computed once per (group, device) and shared by the
    tiles of the group on that device: tensors are read-only to the
    engine.  A copy between cards is a ``.to(device)``, which PyTorch
    orders on both cards' streams without waiting on the host."""

    def __init__(self, devices: Sequence, shape: Optional[tuple] = None):
        devices = [torch.device(d) for d in devices]
        if shape is None:
            shape = factor2d(len(devices))
        r, c = int(shape[0]), int(shape[1])
        if r < 1 or c < 1 or r * c > len(devices):
            raise ValueError(f"a {r}x{c} mesh needs {r * c} devices, got "
                             f"{len(devices)}")
        self.shape = (r, c)
        self.local = list(range(r * c))
        self.devices = devices[: r * c]

    def _group(self, t: int, axis: str) -> list:
        r, c = self.shape
        i, j = divmod(t, c)
        if axis == ROW_AXIS:
            return [k * c + j for k in range(r)]
        if axis == COL_AXIS:
            return [i * c + k for k in range(c)]
        raise ValueError(f"axis {axis!r} is not 'r' or 'c'")

    @traced("mesh.all_gather")
    def all_gather(self, ts, axis):
        _received(len(self.local), len(self._group(0, axis)) - 1,
                  ts[0].nbytes)
        # made once per (group, device), shared by the tiles there
        made, out = {}, []
        for t in self.local:
            g, d = self._group(t, axis), self.devices[t]
            if (g[0], d) not in made:
                made[g[0], d] = torch.cat([ts[u].to(d) for u in g])
            out.append(made[g[0], d])
        return out

    @traced("mesh.reduce_scatter")
    def reduce_scatter(self, ts, axis, kind):
        _check_kind(kind)
        n = len(self._group(0, axis))
        _received(len(self.local), n - 1, ts[0].nbytes // n)
        s = ts[0].shape[0] // n
        out = []
        for t in self.local:
            # each tile folds only its own chunk of the group's partials,
            # in group order: only that chunk crosses between cards
            g = self._group(t, axis)
            lo, d = g.index(t) * s, self.devices[t]
            out.append(functools.reduce(
                _COMBINE[kind], [ts[u][lo:lo + s].to(d) for u in g]))
        return out

    @traced("mesh.all_to_all")
    def all_to_all(self, ts, axis, concat_dim=0):
        n = len(self._group(0, axis))
        _received(len(self.local), n - 1, ts[0].nbytes // n)
        out = []
        for t in self.local:
            g = self._group(t, axis)
            pos, d = g.index(t), self.devices[t]
            s = ts[g[0]].shape[0] // n
            out.append(torch.cat([ts[u][pos * s:(pos + 1) * s].to(d)
                                  for u in g], dim=concat_dim))
        return out

    @traced("mesh.all_reduce")
    def all_reduce(self, ts, kind="sum"):
        _check_kind(kind)
        _received(len(self.local), len(self.local) - 1, ts[0].nbytes)
        d = ts[0].device
        return functools.reduce(_COMBINE[kind], [t.to(d) for t in ts])

    @traced("mesh.gather_segments")
    def gather_segments(self, ts):
        _received(1, len(ts) - 1, ts[0].nbytes)
        d = ts[0].device
        return torch.cat([t.to(d) for t in ts])

    def gather_objects(self, obj):
        return [obj]

    def __repr__(self):
        return f"LocalMesh({self.shape}, devices={self.devices})"


def _wire(x: torch.Tensor):
    """A tensor the backends take (bool travels as uint8), and the map
    back."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8).contiguous(), lambda y: y.bool()
    return x.contiguous(), lambda y: y


def _reduce_op(kind):
    import torch.distributed as dist
    _check_kind(kind)
    return {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
            "max": dist.ReduceOp.MAX}[kind]


def _single(name: str, old: str):
    """``torch.distributed.<name>`` where torch has it, else its older
    name (the same call): newer torch deprecates ``all_gather_into_tensor``
    and ``reduce_scatter_tensor`` for ``all_gather_single`` and
    ``reduce_scatter_single``."""
    import torch.distributed as dist
    return getattr(dist, name, None) or getattr(dist, old)


class ProcessMesh(Mesh):
    """One tile per rank of ``torch.distributed``: rank ``t`` holds tile
    ``t`` on ``device``.  The process group must be up
    (:func:`graphmat_tpu_torch.parallel.multihost.initialize`); the row
    and column sub-groups are made once, here."""

    def __init__(self, shape: Optional[tuple] = None, device=None):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs torch.distributed; call "
                               "graphmat_tpu_torch.parallel.multihost."
                               "initialize() first")
        world, rank = dist.get_world_size(), dist.get_rank()
        if shape is None:
            shape = factor2d(world)
        r, c = int(shape[0]), int(shape[1])
        if r * c != world:
            raise ValueError(f"a {r}x{c} mesh needs {r * c} processes, the "
                             f"world has {world}")
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl"
                      else torch.device("cpu"))
        device = torch.device(device)
        self.shape = (r, c)
        self.local = [rank]
        self.devices = [device]
        self._dm = init_device_mesh(device.type, (r, c),
                                    mesh_dim_names=(ROW_AXIS, COL_AXIS))
        self._groups = {ROW_AXIS: self._dm.get_group(ROW_AXIS),
                        COL_AXIS: self._dm.get_group(COL_AXIS)}
        self._n = {ROW_AXIS: r, COL_AXIS: c}

    @traced("mesh.all_gather")
    def all_gather(self, ts, axis):
        x, back = _wire(ts[0])
        _received(1, self._n[axis] - 1, x.nbytes)
        out = x.new_empty((self._n[axis] * x.shape[0],) + x.shape[1:])
        _single("all_gather_single", "all_gather_into_tensor")(
            out, x, group=self._groups[axis])
        return [back(out)]

    @traced("mesh.reduce_scatter")
    def reduce_scatter(self, ts, axis, kind):
        x, back = _wire(ts[0])
        _received(1, self._n[axis] - 1, x.nbytes // self._n[axis])
        out = x.new_empty((x.shape[0] // self._n[axis],) + x.shape[1:])
        _single("reduce_scatter_single", "reduce_scatter_tensor")(
            out, x, op=_reduce_op(kind), group=self._groups[axis])
        return [back(out)]

    @traced("mesh.all_to_all")
    def all_to_all(self, ts, axis, concat_dim=0):
        import torch.distributed as dist
        x, back = _wire(ts[0])
        _received(1, self._n[axis] - 1, x.nbytes // self._n[axis])
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._groups[axis])
        if concat_dim != 0:
            s = x.shape[0] // self._n[axis]
            out = torch.cat(out.split(s), dim=concat_dim)
        return [back(out)]

    @traced("mesh.all_reduce")
    def all_reduce(self, ts, kind="sum"):
        import torch.distributed as dist
        x, back = _wire(ts[0])
        _received(1, dist.get_world_size() - 1, x.nbytes)
        x = x.clone()
        dist.all_reduce(x, op=_reduce_op(kind))
        return back(x)

    @traced("mesh.gather_segments")
    def gather_segments(self, ts):
        import torch.distributed as dist
        x, back = _wire(ts[0])
        _received(1, dist.get_world_size() - 1, x.nbytes)
        out = x.new_empty((dist.get_world_size() * x.shape[0],)
                          + x.shape[1:])
        _single("all_gather_single", "all_gather_into_tensor")(out, x)
        return back(out)

    def gather_objects(self, obj):
        import torch.distributed as dist
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out

    def __repr__(self):
        return (f"ProcessMesh({self.shape}, rank {self.local[0]} on "
                f"{self.devices[0]})")
