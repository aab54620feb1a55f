"""The iteration loop: ``Engine`` runs a GraphProgram on a Graph.

Counterpart of ``graphmat_tpu/core/runtime.py``.  One iteration (the step
of runtime.py:278-352, after ``include/GraphMatRuntime.h:94-279``):

1. send: every vertex's message; ``sent = active & valid [& send_mask]``;
2. one SpMV per receiver direction: on the K-wide kernel K3
   (:func:`graphmat_tpu_torch.ops.spmv_vec2.spmv_vec`) for an ALL_VERTICES
   program with a :class:`VecSemiring`; for a program with a
   :class:`Semiring`, on the scalar kernel the JAX package's selector
   ``GRAPHMAT_KERNEL`` names (:func:`legacy_kernel_env`): ``v2u``, the
   default, runs K1 (:func:`graphmat_tpu_torch.ops.spmv2u.spmv`) over the
   receiver CSR, with the program's receiver-finality mask on sparse
   sweeps; ``v2`` runs the push kernel that stands for K6/K7
   (:func:`graphmat_tpu_torch.ops.spmv2.spmv_push`) over the direction's
   sender-major index; else the plain segment reduce;
3. apply where a message arrived (``got & valid``);
4. ``changed``, and the convergence test;
5. the next frontier: every valid vertex (ALL_VERTICES) or the changed
   ones (ACTIVE_ONLY).

The loop is a Python loop.  Run to convergence, it reads one bool to the
host per iteration; run for a fixed count, it reads nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from ..ops.segment import (masked_fill_identity, segment_any,
                           segment_reduce_tree)
from ..ops.spmv2 import spmv_push
from ..ops.spmv2u import IDENTITY, spmv
from ..ops.spmv_vec2 import spmv_vec
from .graph import Graph
from .program import GraphProgram, IterationContext, Semiring, VecSemiring
from .tree import tree_map
from .types import Activity, Direction, Monoid, UNTIL_CONVERGENCE

__all__ = ["Engine", "engine_for", "run_graph_program",
           "graph_program_init", "legacy_kernel_env"]


def legacy_kernel_env() -> bool:
    """Parse ``GRAPHMAT_KERNEL`` as the JAX package does
    (``graphmat_tpu/core/runtime.py:64-74``): ``v2u`` (the default, K1) or
    ``v2`` (the push kernel for K6/K7).  Any other value raises: a typo
    must not silently select a kernel."""
    val = os.environ.get("GRAPHMAT_KERNEL", "v2u")
    if val not in ("v2u", "v2"):
        raise ValueError(
            f"GRAPHMAT_KERNEL={val!r} unrecognized: use 'v2u' (the "
            "default, K1) or 'v2' (the push kernel for K6/K7)")
    return val == "v2"


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


def _on_device(state, device):
    """Program state with numpy leaves (a state carried over from the JAX
    package, whose Engine hands it back as numpy) moved onto ``device``."""
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=device)
                    if isinstance(a, np.ndarray) else a, state)


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
        # K3 takes got from the graph's structure, so only ALL_VERTICES
        # programs run it.  JAX sends a vec semiring on an ACTIVE_ONLY
        # program to its K4 kernel, which is not ported (ROADMAP Queue 2):
        # here such a program runs the plain segment path.
        self._vec: Optional[VecSemiring] = (
            program.vec_semiring()
            if program.activity == Activity.ALL_VERTICES else None)
        self._receivers = _direction_receivers(program.order)
        for recv in self._receivers:
            graph.csr(recv)   # raises if the direction was not built
        # the kernel selector, read when the Engine is built, as in JAX
        self._push = legacy_kernel_env()
        self.final_state = None

    def _kernel_directions(self, msg, sent, recv_final):
        """All directions through a scalar SpMV kernel, K1 or (under
        ``GRAPHMAT_KERNEL=v2``) the push kernel: (reduced, got).
        ``recv_final`` (uint8 per receiver, or None) is given for K1's
        sparse sweeps only."""
        sem = self._semiring
        kind = sem.reduce_kind
        ident = IDENTITY[kind]
        x = sem.encode(msg).to(torch.float32).masked_fill(~sent, ident)
        dense = self.program.activity == Activity.ALL_VERTICES
        sent_u8 = None if dense else sent.to(torch.uint8)
        want_got = kind == "sum" and not dense
        read_val = sem.uses_edge_value and sem.process_op != "x"
        y = got = None
        for recv in self._receivers:
            csr = self.graph.csr(recv)
            if self._push:
                pcsr = self.graph.sender_csr(recv)
                out = spmv_push(pcsr, x, kind, sem.process_op,
                                val=pcsr.val_f32 if read_val else None,
                                sent=sent_u8, want_got=want_got,
                                bits=sem.bits)
            else:
                out = spmv(csr, x, kind, sem.process_op,
                           val=csr.val_f32 if read_val else None,
                           sent=sent_u8, want_got=want_got,
                           recv_final=recv_final,
                           bits=sem.bits)
            if want_got:
                y_dir, cnt = out
                g_dir = cnt > 0
            else:
                y_dir = out
                g_dir = (csr.got_static if kind == "sum"
                         else y_dir != ident)
            if y is None:
                y, got = y_dir, g_dir
            else:
                y = (y + y_dir if kind == "sum" else
                     torch.minimum(y, y_dir) if kind == "min"
                     else torch.maximum(y, y_dir))
                got = got | g_dir
        return sem.decode(y), got

    def _vec_directions(self, state, msg, sent, vp):
        """All directions through the K-wide kernel: (reduced, got)."""
        sem = self._vec
        # the kernel takes the encoded width, as JAX's engine does
        # (runtime.py:529), even where it differs from sem.k
        x = sem.encode(state, msg).to(torch.float32)
        x = x.masked_fill(~sent[:, None], 0.0).contiguous()
        vp_enc = (sem.encode_vp(state, vp).to(torch.float32).contiguous()
                  if sem.needs_vp else None)
        extra = (sem.extra_fn(state).to(torch.float32).reshape(-1)
                 .contiguous() if sem.extra_fn is not None else None)
        y = got = None
        for recv in self._receivers:
            csr = self.graph.csr(recv)
            y_dir = spmv_vec(csr, x, sem.process_op, vp=vp_enc, extra=extra,
                             params=sem.params)
            if y is None:
                y, got = y_dir, csr.got_static
            else:
                y = y + y_dir
                got = got | csr.got_static
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
        if self._vec is not None:
            reduced, got = self._vec_directions(state, msg, sent, vp)
        elif self._semiring is not None:
            recv_final = None
            if not self._push and prog.activity == Activity.ACTIVE_ONLY:
                rf = prog.receiver_final(state, vp, it)
                if rf is not None:
                    # pad vertices can never change: count them final
                    recv_final = (rf | ~valid).to(torch.uint8)
            reduced, got = self._kernel_directions(msg, sent, recv_final)
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
        state = (self.program.init_state(g) if state is None
                 else _on_device(state, g.device))
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
        state = (self.program.init_state(g) if state is None
                 else _on_device(state, g.device))
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
