"""The iteration loop: ``Engine`` runs a GraphProgram on a Graph.

Counterpart of ``graphmat_tpu/core/runtime.py``.  One iteration (the step
of runtime.py:278-352, after ``include/GraphMatRuntime.h:94-279``):

1. send: every vertex's message; ``sent = active & valid [& send_mask]``;
2. one SpMV per receiver direction: on the kernel
   (:func:`graphmat_tpu_torch.ops.spmv2u.spmv`) for a program with a
   :class:`Semiring`, else the plain segment reduce;
3. apply where a message arrived (``got & valid``);
4. ``changed``, and the convergence test;
5. the next frontier: every valid vertex (ALL_VERTICES) or the changed
   ones (ACTIVE_ONLY).

The loop is a Python loop.  Run to convergence, it reads one bool to the
host per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..ops.segment import (masked_fill_identity, segment_any,
                           segment_reduce_tree)
from ..ops.spmv2u import IDENTITY, spmv
from .graph import Graph
from .program import GraphProgram, IterationContext, Semiring
from .tree import tree_map
from .types import Activity, Direction, Monoid, UNTIL_CONVERGENCE

__all__ = ["Engine", "engine_for", "run_graph_program",
           "graph_program_init"]


def _normalize_semiring(sem: Optional[Semiring]) -> Optional[Semiring]:
    """'or' runs as max (encodings in {0.0, 1.0}), 'any' as min (a
    deterministic pick, like :data:`types.ANY`)."""
    if sem is None or sem.reduce_kind in ("sum", "min", "max"):
        return sem
    return dataclasses.replace(
        sem, reduce_kind="max" if sem.reduce_kind == "or" else "min")


def engine_for(program, graph, **kw):
    """The engine for ``graph``.  Only the one-device :class:`Graph` is
    ported; a sharded graph waits for ROADMAP Queue 1 item 10."""
    if not isinstance(graph, Graph):
        raise NotImplementedError(
            f"graphmat_tpu_torch has no engine for {type(graph).__name__}: "
            "only the one-device Graph is ported (the distributed engine "
            "is ROADMAP Queue 1 item 10)")
    return Engine(program, graph, **kw)


def _direction_receivers(order: Direction):
    if order == Direction.OUT_EDGES:
        return ("dst",)
    if order == Direction.IN_EDGES:
        return ("src",)
    return ("dst", "src")


def _where_tree(mask, new_tree, old_tree):
    def one(new, old):
        if new is old:
            return old   # apply() returned the leaf untouched
        m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
        return torch.where(m, new, old)
    return tree_map(one, new_tree, old_tree)


def _combine_tree(monoid, a, b):
    if isinstance(monoid, Monoid):
        return tree_map(monoid.combine, a, b)
    return tree_map(lambda m, x, y: m.combine(x, y), monoid, a, b)


class Engine:
    """Executor for one (program, graph) pair.  Reuse it across runs."""

    def __init__(self, program: GraphProgram, graph: Graph,
                 ctx: Optional[IterationContext] = None):
        if getattr(program, "vector_message", False):
            raise NotImplementedError(
                "vector messages are not ported yet (ROADMAP Queue 1 "
                "item 7)")
        self.program = program
        self.graph = graph
        self.ctx = ctx if ctx is not None else IterationContext()
        self._semiring = _normalize_semiring(program.semiring())
        self._receivers = _direction_receivers(program.order)
        for recv in self._receivers:
            graph.csr(recv)   # raises if the direction was not built
        self.final_state = None

    def _kernel_directions(self, msg, sent):
        """All directions through the SpMV kernel: (reduced, got)."""
        sem = self._semiring
        kind = sem.reduce_kind
        ident = IDENTITY[kind]
        x = sem.encode(msg).to(torch.float32).masked_fill(~sent, ident)
        dense = self.program.activity == Activity.ALL_VERTICES
        sent_u8 = None if dense else sent.to(torch.uint8)
        read_val = sem.uses_edge_value and sem.process_op != "x"
        y = got = None
        for recv in self._receivers:
            csr = self.graph.csr(recv)
            val = csr.val_f32 if read_val else None
            if dense:
                y_dir = spmv(csr, x, kind, sem.process_op, val=val)
                g_dir = csr.got_static if kind == "sum" else y_dir != ident
            elif kind == "sum":
                y_dir, cnt = spmv(csr, x, kind, sem.process_op, val=val,
                                  sent=sent_u8, want_got=True)
                g_dir = cnt > 0
            else:
                y_dir = spmv(csr, x, kind, sem.process_op, val=val,
                             sent=sent_u8)
                g_dir = y_dir != ident
            if y is None:
                y, got = y_dir, g_dir
            else:
                y = (y + y_dir if kind == "sum" else
                     torch.minimum(y, y_dir) if kind == "min"
                     else torch.maximum(y, y_dir))
                got = got | g_dir
        return sem.decode(y), got

    def _segment_directions(self, state, msg, sent, vp):
        """All directions through the plain segment reduce."""
        prog = self.program
        n_pad = self.graph.n_pad
        reduced = got = None
        for recv in self._receivers:
            csr = self.graph.csr(recv)
            col = csr.col.long()
            row = csr.row.long()
            x_e = tree_map(lambda a: a[col], msg)
            e_ok = sent[col]
            vp_r = (tree_map(lambda a: a[row], vp)
                    if prog.process_requires_vertexprop else None)
            u_e = prog.process_message(state, x_e, csr.val, vp_r)
            u_e = masked_fill_identity(prog.reduce, u_e, e_ok)
            partial = segment_reduce_tree(prog.reduce, u_e, row, n_pad)
            g = segment_any(e_ok, row, n_pad)
            if reduced is None:
                reduced, got = partial, g
            else:
                reduced = _combine_tree(prog.reduce, reduced, partial)
                got = got | g
        return reduced, got

    def _step(self, it: int, state, vp, active):
        """One iteration; returns (state, vp, active, any_changed) with
        ``any_changed`` a bool tensor left on the device."""
        prog = self.program
        valid = self.graph.valid_vertex
        msg, send_mask = prog.send_message(state, vp)
        sent = active & valid
        if send_mask is not None:
            sent = sent & send_mask
        if self._semiring is not None:
            reduced, got = self._kernel_directions(msg, sent)
        else:
            reduced, got = self._segment_directions(state, msg, sent, vp)
        upd = got & valid
        vp_new = _where_tree(upd, prog.apply(state, reduced, vp), vp)
        ch = prog.changed(vp, vp_new) & upd
        state = prog.do_every_iteration(state, vp_new, it, self.ctx)
        active_new = (valid if prog.activity == Activity.ALL_VERTICES
                      else ch)
        return state, vp_new, active_new, ch.any()

    def run(self, iterations: int = UNTIL_CONVERGENCE,
            max_iterations: int = 1_000_000, state: Any = None) -> int:
        """Run the program, updating ``graph.vp`` and ``graph.active``.
        Returns the number of iterations completed.  ``iterations <= 0``
        runs until no vertex changes (``GraphMatRuntime.h:266-271``), at
        most ``max_iterations``."""
        g = self.graph
        if state is None:
            state = self.program.init_state(g)
        if self.program.activity == Activity.ALL_VERTICES:
            g.set_all_active()
        vp, active = g.vp, g.active
        it = 0
        if iterations is not None and iterations > 0:
            for it in range(iterations):
                state, vp, active, _ = self._step(it, state, vp, active)
            it = iterations
        else:
            while it < max_iterations:
                state, vp, active, any_changed = self._step(it, state, vp,
                                                            active)
                it += 1
                if not bool(any_changed):
                    break
        g.vp = vp
        g.active = active
        self.final_state = state
        return it

    def step_once(self, state=None):
        """One iteration; returns (state, converged)."""
        g = self.graph
        if state is None:
            state = self.program.init_state(g)
        state, g.vp, g.active, any_changed = self._step(0, state, g.vp,
                                                        g.active)
        return state, not bool(any_changed)


def graph_program_init(program: GraphProgram, graph: Graph) -> Engine:
    """Name-parity helper for the reference's ``graph_program_init``."""
    return Engine(program, graph)


def run_graph_program(program: GraphProgram, graph: Graph,
                      iterations: int = UNTIL_CONVERGENCE,
                      engine: Optional[Engine] = None,
                      max_iterations: int = 1_000_000) -> int:
    """Run ``program`` on ``graph``; returns iterations completed."""
    if engine is None:
        engine = Engine(program, graph)
    return engine.run(iterations=iterations, max_iterations=max_iterations)
