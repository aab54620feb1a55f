"""The 2D-sharded iteration loop: ``DistEngine``.

Counterpart of ``graphmat_tpu/parallel/dist_runtime.py`` (the reference's
MPI exchange, ``multinode/spmspv.h:41-206``, ``spmspv3.h:41-267``):

==========================================  ===============================
reference (MPI point-to-point)               here (mesh collectives)
==========================================  ===============================
column broadcast of x segments               ``all_gather(x, 'r')``
row broadcast of vertexprop (SpMSpV3)        ``all_gather(vp, 'c')``
row reduction of y partials                  ``reduce_scatter('c')`` with
                                             sum, min or max; an
                                             ``all_to_all('c')`` and a
                                             local fold for a generic ⊕
MPI_Allreduce(LAND) convergence              ``all_reduce`` of the count
==========================================  ===============================

One step, for the tiles this process holds:

1. send on each local segment: ``sent = active & valid [& send_mask]``;
2. all-gather the message and ``sent`` along 'r', giving each tile its
   column block (``R * S`` senders); gather the receiver row block along
   'c' where the kernel reads it (K3's ``vp``, K1's ``recv_final``);
3. per tile, the one-device ``Engine``'s direction loop
   (:class:`graphmat_tpu_torch.core.runtime.Routing`): K3 or its sparse
   mode for a ``VecSemiring``; K1 (with ``recv_final`` on sparse sweeps),
   or the push kernel under ``GRAPHMAT_KERNEL=v2``, for a scalar
   ``Semiring``; else the plain segment reduce, or the concat reduce of a
   vector-message program; the directions combined;
4. reduce-scatter ``y`` and the got count along 'c' (a concat goes
   through an all_to_all);
5. apply where got, then all-reduce the changed count.

The loop reads the count to the host once per iteration, as ``Engine.run``
does, and nothing else: one process driving a host's cards enqueues each
tile's work on its own card, so the cards work at once.  One process
driving several tiles on one card runs their kernels one after another
on one stream.  It records the one-device Engine's ``engine.run`` span,
an ``engine.step`` span and an ``engine.steps`` count a step, and the
read's ``engine.converge`` span and ``copy.dtoh`` count; the mesh records
its collectives (:mod:`.mesh`).

``do_every_iteration`` runs per segment, as under the JAX ``shard_map``:
its ``ctx.all_reduce_sum`` reduces over the whole mesh.  With several
local segments the hook runs once per segment recording its local values,
which are then reduced, and once more on the first segment with the
global values; every segment's state is the same.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from ..core.program import GraphProgram, IterationContext
from ..core.runtime import Routing, _on_device, _read_changed
from ..core.tree import tree_map
from ..core.types import Activity, Monoid, UNTIL_CONVERGENCE
from ..ops.spmv2u import IDENTITY
from ..utils.timing import count, traced
from .dist_graph import DistGraph
from .mesh import COL_AXIS, ROW_AXIS

__all__ = ["DistEngine", "run_graph_program_dist"]


def map_tiles(fn, trees: list) -> list:
    """Apply a list-to-list collective ``fn`` leafwise over per-tile
    trees (dicts, lists and tuples of tensors of one shape)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        parts = {k: map_tiles(fn, [t[k] for t in trees]) for k in t0}
        return [{k: parts[k][p] for k in t0} for p in range(len(trees))]
    if isinstance(t0, (list, tuple)):
        parts = [map_tiles(fn, [t[i] for t in trees])
                 for i in range(len(t0))]
        return [type(t0)(part[p] for part in parts)
                for p in range(len(trees))]
    return fn(trees)


def fold_tiles(fn, trees: list):
    """Reduce per-tile trees to one tree with a list-to-tensor ``fn``."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: fold_tiles(fn, [t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(fold_tiles(fn, [t[i] for t in trees])
                        for i in range(len(t0)))
    return fn(trees)


class _Recording(IterationContext):
    """``do_every_iteration``'s context: records the local values the hook
    reduces and hands them back unchanged, or (``replay``) hands back the
    global values in the same order."""

    def __init__(self, replay=None):
        self.calls = []
        self._replay = replay

    def all_reduce_sum(self, tree):
        self.calls.append(tree)
        if self._replay is None:
            return tree
        return self._replay[len(self.calls) - 1]


def _reduce_scatter_monoid(mesh, monoid, trees):
    """Fold per-tile partial trees across 'c' with the program's ⊕ (one
    Monoid, or a tree of them) and keep each tile's segment.  Sum, min and
    max (and 'any', a min) ride the reduce-scatter; 'or' rides it as a max
    over uint8; a generic ⊕ takes one ``all_to_all`` and folds the ``C``
    chunks of its segment in column order with ``combine_fn``
    (``graphmat_tpu/parallel/dist_runtime.py:70-92``): the reference's
    ``union_received`` with a user ⊕ (``DenseSegment.h:808-830``)."""
    def one(m: Monoid, ts):
        if m.kind == "generic":
            n_chunks = mesh.shape[1]
            out = []
            for x in mesh.all_to_all(ts, COL_AXIS):
                chunks = x.chunk(n_chunks)
                acc = chunks[0]
                for c in chunks[1:]:
                    acc = m.combine(acc, c)
                out.append(acc)
            return out
        kind = {"any": "min", "or": "max"}.get(m.kind, m.kind)
        if ts[0].dtype == torch.bool:
            out = mesh.reduce_scatter([t.to(torch.uint8) for t in ts],
                                      COL_AXIS, kind)
            return [o.bool() for o in out]
        return mesh.reduce_scatter(ts, COL_AXIS, kind)

    if isinstance(monoid, Monoid):
        return map_tiles(lambda ts: one(monoid, ts), trees)
    # a tree of monoids shaped like the reduced message
    keys = list(monoid)
    parts = {k: _reduce_scatter_monoid(mesh, monoid[k], [t[k] for t in trees])
             for k in keys}
    return [{k: parts[k][p] for k in keys} for p in range(len(trees))]


class DistEngine(Routing):
    """Executor for one (program, DistGraph) pair.  Reuse it across runs.

    Every process of a :class:`~graphmat_tpu_torch.parallel.mesh.ProcessMesh`
    builds its engine and runs it in step with the others.  The routing
    and the per-tile direction loops are the one-device Engine's
    (:class:`~graphmat_tpu_torch.core.runtime.Routing`); this class adds
    the collectives around them."""

    def __init__(self, program: GraphProgram, graph: DistGraph):
        super().__init__(program)
        self.graph = graph
        self.mesh = graph.mesh
        for recv in self._receivers:
            graph.csrs(recv)   # raises if the direction was not built
        # a concat row's width per direction: the same on every tile, so
        # the largest receiver degree of any tile (JAX :190-203)
        self._msg_width = {}
        if self._vecmsg:
            for recv in self._receivers:
                if program.max_message_width:
                    self._msg_width[recv] = program.max_message_width
                    continue
                local = [torch.clamp(c.rowptr.diff().max(), min=1)
                         if c.nnz else torch.ones((), dtype=torch.int32,
                                                  device=c.rowptr.device)
                         for c in graph.csrs(recv)]
                self._msg_width[recv] = int(self.mesh.all_reduce(
                    [w.reshape(1).to(torch.int32) for w in local], "max"))
        self.final_state = None

    @property
    def vector_reduced_width(self) -> int:
        """The width of a vector-message program's ``reduced`` rows: the
        directions' widths concatenated, then the C column shards'."""
        return self.graph.C * sum(self._msg_width.values())

    # ----------------------------------------------------------- routes

    def _tile(self, p: int):
        """Tile ``p``'s ``csr_of`` for the shared direction loops."""
        g = self.graph
        return lambda recv, sender_major=False: (
            g.sender_csrs(recv) if sender_major else g.csrs(recv))[p]

    def _sent_cols(self, sents):
        """Each tile's sent flags of its column block (uint8), or Nones on
        a dense sweep."""
        if self._dense:
            return [None] * len(sents)
        return self.mesh.all_gather([s.to(torch.uint8) for s in sents],
                                    ROW_AXIS)

    def _dense_got(self) -> List[torch.Tensor]:
        """got of a dense sweep, from the structure: some tile of the row
        block holds an edge into the receiver (made once per graph and
        set of directions, as a CSR keeps its own)."""
        made = self.graph._got_static
        if self._receivers not in made:
            has = [self._structural_got(self._tile(p)).to(torch.int32)
                   for p in range(len(self.graph.local))]
            made[self._receivers] = [c > 0 for c in self.mesh.reduce_scatter(
                has, COL_AXIS, "sum")]
        return made[self._receivers]

    def _kernel_directions(self, msgs, sents, rfs):
        """Every tile and direction through K1 (or the push kernel):
        (reduced, got) per local segment."""
        mesh = self.mesh
        sem = self._semiring
        kind = sem.reduce_kind
        x_cols = mesh.all_gather([self._scalar_operand(m, s)
                                  for m, s in zip(msgs, sents)], ROW_AXIS)
        sent_cols = self._sent_cols(sents)
        rf_rows = (mesh.all_gather(rfs, COL_AXIS) if rfs is not None
                   else [None] * len(sents))
        parts = [self._kernel_tile(self._tile(p), x_cols[p], sent_cols[p],
                                   rf_rows[p]) for p in range(len(sents))]
        y_segs = mesh.reduce_scatter([y for y, _ in parts], COL_AXIS, kind)
        if self._want_got:
            got = [c > 0 for c in mesh.reduce_scatter(
                [c for _, c in parts], COL_AXIS, "sum")]
        elif kind == "sum":
            got = self._dense_got()
        else:
            got = [y != IDENTITY[kind] for y in y_segs]
        return [sem.decode(y) for y in y_segs], got

    def _vec_directions(self, sts, msgs, sents, vps):
        """Every tile and direction through K3 (ALL_VERTICES) or its sparse
        mode (ACTIVE_ONLY): (reduced, got) per local segment."""
        y_segs, counts = self.vec_partials(sts, msgs, sents, vps)
        got = (self._dense_got() if counts is None
               else [c > 0 for c in counts])
        return [self._vec.decode(y) for y in y_segs], got

    def vec_partials(self, sts, msgs, sents, vps):
        """The K-wide SpMV over the mesh: per local segment the summed
        rows ``y`` and, for an ACTIVE_ONLY program, the int32 count of
        in-edges from senders that sent (else None)."""
        mesh = self.mesh
        ops = [self._vec_operands(*a) for a in zip(sts, msgs, sents, vps)]
        x_cols = mesh.all_gather([x for x, _, _ in ops], ROW_AXIS)
        sent_cols = self._sent_cols(sents)
        vp_rows = (mesh.all_gather([v for _, v, _ in ops], COL_AXIS)
                   if self._vec.needs_vp else [None] * len(ops))
        parts = [self._vec_tile(self._tile(p), x_cols[p], sent_cols[p],
                                vp_rows[p], ops[p][2])
                 for p in range(len(ops))]
        y_segs = mesh.reduce_scatter([y for y, _ in parts], COL_AXIS, "sum")
        return y_segs, (None if self._dense else mesh.reduce_scatter(
            [c for _, c in parts], COL_AXIS, "sum"))

    def _segment_directions(self, sts, msgs, sents, vps):
        """Every tile and direction through the plain segment reduce (or the
        concat reduce): (reduced, got) per local segment."""
        g, mesh, prog = self.graph, self.mesh, self.program
        msg_cols = map_tiles(lambda ts: mesh.all_gather(ts, ROW_AXIS), msgs)
        sent_cols = mesh.all_gather(sents, ROW_AXIS)
        vp_rows = (map_tiles(lambda ts: mesh.all_gather(ts, COL_AXIS), vps)
                   if prog.process_requires_vertexprop
                   else [None] * len(vps))
        partials, gots = [], []
        for p in range(len(g.local)):
            part, got = self._segment_tile(
                self._tile(p), sts[p], msg_cols[p], sent_cols[p],
                vp_rows[p], g.C * g.S, self._msg_width)
            partials.append(part)
            gots.append(got.to(torch.int32))
        if self._vecmsg:
            # the concat across the C column shards: each receiver's lists
            # merged in column order (DenseSegment.h:808-830)
            reduced = map_tiles(
                lambda ts: mesh.all_to_all(ts, COL_AXIS, concat_dim=1),
                partials)
        else:
            reduced = _reduce_scatter_monoid(mesh, prog.reduce, partials)
        got = [c > 0 for c in mesh.reduce_scatter(gots, COL_AXIS, "sum")]
        return reduced, got

    # ------------------------------------------------------------- step

    def _every_iteration(self, sts, vps, it):
        """``do_every_iteration`` over the mesh (see the module comment)."""
        prog = self.program
        rec = _Recording()
        state = prog.do_every_iteration(sts[0], vps[0], it, rec)
        if not rec.calls:
            return state   # no reduce: every segment gives this state
        recs = [rec.calls]
        for p in range(1, len(vps)):
            r = _Recording()
            prog.do_every_iteration(sts[p], vps[p], it, r)
            recs.append(r.calls)
        sums = [fold_tiles(lambda ts: self.mesh.all_reduce(ts, "sum"),
                            [calls[i] for calls in recs])
                for i in range(len(recs[0]))]
        return prog.do_every_iteration(sts[0], vps[0], it,
                                       _Recording(replay=sums))

    @traced("engine.step")
    def _step(self, it: int, state, vps, actives):
        """One iteration; returns (state, vps, actives, nchanged) with the
        global changed count a tensor left on the device."""
        count("engine.steps")
        g = self.graph
        valid = g.valid_vertex
        on_dev = {}
        sts = []
        for d in g.devices:
            if d not in on_dev:
                on_dev[d] = tree_map(
                    lambda a: a.to(d) if isinstance(a, torch.Tensor) else a,
                    state)
            sts.append(on_dev[d])
        sends = [self._send(*a) for a in zip(sts, vps, actives, valid)]
        msgs, sents = [m for m, _ in sends], [s for _, s in sends]
        if self._vec is not None:
            reduced, got = self._vec_directions(sts, msgs, sents, vps)
        elif self._semiring is not None:
            rfs = [self._receiver_final(st, vp, it, v)
                   for st, vp, v in zip(sts, vps, valid)]
            reduced, got = self._kernel_directions(
                msgs, sents, None if rfs[0] is None else rfs)
        else:
            reduced, got = self._segment_directions(sts, msgs, sents, vps)
        new_vps, new_act, counts = [], [], []
        for p in range(len(g.local)):
            vp_new, ch, act = self._apply(sts[p], reduced[p], vps[p], got[p],
                                          valid[p])
            new_vps.append(vp_new)
            new_act.append(act)
            counts.append(ch.sum(dtype=torch.int32).reshape(1))
        nchanged = self.mesh.all_reduce(counts, "sum")
        state = self._every_iteration(sts, new_vps, it)
        return state, new_vps, new_act, nchanged

    @traced("engine.run")
    def run(self, iterations: int = UNTIL_CONVERGENCE,
            max_iterations: int = 1_000_000, state: Any = None) -> int:
        """Run the program, updating ``graph.vp`` and ``graph.active``.
        Returns the number of iterations completed; ``iterations <= 0``
        runs until no vertex of the mesh changes, at most
        ``max_iterations`` (``GraphMatRuntime.h:266-271``)."""
        g = self.graph
        state = (self.program.init_state(g) if state is None
                 else _on_device(state, g.device))
        if self.program.activity == Activity.ALL_VERTICES:
            g.set_all_active()
        vps, active = g.vp, g.active
        it = 0
        if iterations is not None and iterations > 0:
            for it in range(iterations):
                state, vps, active, _ = self._step(it, state, vps, active)
            it = iterations
        else:
            while it < max_iterations:
                state, vps, active, nchanged = self._step(it, state, vps,
                                                          active)
                it += 1
                if not _read_changed(nchanged):
                    break
        g.vp = vps
        g.active = active
        self.final_state = state
        return it

    def step_once(self, state=None):
        """One iteration; returns (state, converged)."""
        g = self.graph
        state = (self.program.init_state(g) if state is None
                 else _on_device(state, g.device))
        state, g.vp, g.active, nchanged = self._step(0, state, g.vp,
                                                     g.active)
        return state, not _read_changed(nchanged)


def run_graph_program_dist(program: GraphProgram, graph: DistGraph,
                           iterations: int = UNTIL_CONVERGENCE,
                           engine: Optional[DistEngine] = None,
                           max_iterations: int = 1_000_000) -> int:
    """Run ``program`` on a DistGraph; returns iterations completed."""
    if engine is None:
        engine = DistEngine(program, graph)
    return engine.run(iterations=iterations, max_iterations=max_iterations)
