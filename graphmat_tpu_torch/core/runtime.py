"""The iteration loop: ``Engine`` runs a GraphProgram on a Graph.

Counterpart of ``graphmat_tpu/core/runtime.py``.  One iteration (the step
of runtime.py:278-352, after ``include/GraphMatRuntime.h:94-279``):

1. send: every vertex's message; ``sent = active & valid [& send_mask]``;
2. one SpMV per receiver direction: for a program with a
   :class:`VecSemiring`, on the K-wide kernel, dense K3
   (:func:`graphmat_tpu_torch.ops.spmv_vec2.spmv_vec`, got from the
   graph's structure) for an ALL_VERTICES program, its sparse mode
   (:func:`graphmat_tpu_torch.ops.spmv_vec.spmv_vec_sparse`, which skips
   the senders that did not send and counts the others: K4 with K5's got
   pass) for an ACTIVE_ONLY one; for a program with a
   :class:`Semiring` and ``process_requires_vertexprop = False``, on the
   scalar kernel the JAX package's selector
   ``GRAPHMAT_KERNEL`` names (:func:`legacy_kernel_env`): ``v2u``, the
   default, runs K1 (:func:`graphmat_tpu_torch.ops.spmv2u.spmv`) over the
   receiver CSR, with the program's receiver-finality mask on sparse
   sweeps; ``v2`` runs the push that stands for K6/K7
   (:func:`graphmat_tpu_torch.ops.spmv2.spmv_push`): min and max over the
   direction's sender-major index, a sum as K1 over the receiver CSR
   (after the push's mark pass on a sparse sweep), so that its sums repeat
   exactly; else the plain segment reduce (always, for a program whose
   ⊕ is or holds a generic :class:`Monoid`), or for a
   ``vector_message`` program the concat reduce
   (:func:`graphmat_tpu_torch.ops.segment.segment_concat`), as in JAX
   (runtime.py:158-161, 308-335);
3. apply where a message arrived (``got & valid``);
4. ``changed``, and the convergence test;
5. the next frontier: every valid vertex (ALL_VERTICES) or the changed
   ones (ACTIVE_ONLY).

The loop is a Python loop.  Run to convergence, it reads one bool to the
host per iteration; run for a fixed count, it reads nothing.

The one-device :class:`Engine` records the spans of
:mod:`graphmat_tpu_torch.utils.timing` (the reference's ``__TIMING``
phases, ``GraphMatRuntime.h:125-248``): ``engine.run``, one
``engine.step`` an iteration with its ``engine.send``, ``engine.spmv``
and ``engine.apply``, and ``engine.converge`` around the read; and the
counters ``engine.steps`` and ``copy.dtoh`` (the read).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from ..ops.neighbors import max_degree
from ..ops.segment import (masked_fill_identity, segment_any,
                           segment_concat_tree, segment_reduce_tree)
from ..ops.spmv2 import spmv_push
from ..ops.spmv2u import IDENTITY, spmv
from ..ops.spmv_vec import spmv_vec_sparse
from ..ops.spmv_vec2 import spmv_vec
from ..utils.timing import copied, count, span, traced
from .graph import Graph
from .program import GraphProgram, IterationContext, Semiring, VecSemiring
from .tree import tree_map
from .types import (Activity, Direction, Monoid, UNTIL_CONVERGENCE,
                    has_generic)

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
    """The engine for ``graph``: an :class:`Engine` for a one-device
    :class:`Graph`, a
    :class:`~graphmat_tpu_torch.parallel.dist_runtime.DistEngine` for a
    2D-sharded :class:`~graphmat_tpu_torch.parallel.dist_graph.DistGraph`
    (JAX ``core/runtime.py:98-106``), so every app runner takes either."""
    if isinstance(graph, Graph):
        return Engine(program, graph, **kw)
    from ..parallel.dist_graph import DistGraph
    from ..parallel.dist_runtime import DistEngine
    if isinstance(graph, DistGraph):
        return DistEngine(program, graph, **kw)
    raise TypeError(f"no engine for {type(graph).__name__}: pass a Graph "
                    "or a DistGraph")


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


def _read_changed(any_changed) -> bool:
    """The convergence read: a step's one copy to the host."""
    with span("engine.converge"):
        changed = bool(any_changed)
        copied("dtoh", any_changed)
    return changed


def _combine_tree(monoid, a, b):
    if isinstance(monoid, Monoid):
        return tree_map(monoid.combine, a, b)
    return tree_map(lambda m, x, y: m.combine(x, y), monoid, a, b)


class Routing:
    """A program's route and every direction of one tile through it: the
    part of a step that the one-device :class:`Engine` and the 2D-sharded
    :class:`~graphmat_tpu_torch.parallel.dist_runtime.DistEngine` share.
    The Engine runs it on its one CSR per direction; the DistEngine on
    each tile's, between its collectives.  ``csr_of(recv, sender_major)``
    gives a tile's receiver CSR, or its sender-major index for the push."""

    def __init__(self, program: GraphProgram):
        self.program = program
        self._dense = program.activity == Activity.ALL_VERTICES
        # a concat ⊕ runs the segment path (JAX runtime.py:158-161)
        self._vecmsg = bool(getattr(program, "vector_message", False))
        # so does a generic ⊕, which no kernel has a layout for: its
        # directions fold with combine_fn (_combine_tree), whatever
        # semiring the program declares
        segment_only = self._vecmsg or has_generic(program.reduce)
        # a scalar kernel cannot read the receiver's property: a program
        # whose ⊗ does (the default) runs its own process_message, as the
        # JAX Engine does (graphmat_tpu/core/runtime.py:190-192)
        self._semiring = (None if program.process_requires_vertexprop
                          or segment_only
                          else _normalize_semiring(program.semiring()))
        # dense K3 for ALL_VERTICES, its sparse mode for ACTIVE_ONLY; the
        # JAX package's fallback from K4 past a VMEM budget
        # (graphmat_tpu/core/runtime.py:162-179) has no counterpart: the
        # card's kernel reads its operands from device memory
        self._vec: Optional[VecSemiring] = (
            None if segment_only else program.vec_semiring())
        self._receivers = _direction_receivers(program.order)
        # the kernel selector, read when the engine is built, as in JAX
        self._push = legacy_kernel_env()
        # K1 and the push count a sparse sum's messages: got is a count > 0
        self._want_got = (self._semiring is not None and not self._dense
                          and self._semiring.reduce_kind == "sum")

    def _send(self, state, vp, active, valid):
        """A segment's messages and ``sent = active & valid [&
        send_mask]``."""
        msg, send_mask = self.program.send_message(state, vp)
        sent = active & valid
        if send_mask is not None:
            sent = sent & send_mask
        return msg, sent

    def _receiver_final(self, state, vp, it, valid):
        """The receiver-finality mask (uint8) of a sparse sweep on K1 or
        a push sum (whose K1 sweep honours it), or None."""
        if self._dense or (self._push
                           and self._semiring.reduce_kind != "sum"):
            return None
        rf = self.program.receiver_final(state, vp, it)
        # pad vertices can never change: count them final
        return None if rf is None else (rf | ~valid).to(torch.uint8)

    def _scalar_operand(self, msg, sent):
        """The scalar kernel's x: the encoded message, the identity where
        nothing was sent."""
        sem = self._semiring
        return sem.encode(msg).to(torch.float32).masked_fill(
            ~sent, IDENTITY[sem.reduce_kind])

    def _kernel_tile(self, csr_of, x, sent_u8, recv_final):
        """Every direction of one tile through a scalar SpMV kernel, K1 or
        (under ``GRAPHMAT_KERNEL=v2``) the push: (reduced, count), the
        count of messages a receiver got only for a sparse sum (else
        None).  ``recv_final`` (uint8 per receiver, or None) is given for
        sparse sweeps of K1 and of a push sum only.  A push sum runs K1
        over the tile's own receiver CSR, whose sender-major index the
        push's mark pass reads."""
        sem = self._semiring
        kind = sem.reduce_kind
        read_val = sem.uses_edge_value and sem.process_op != "x"
        y = cnt = None
        for recv in self._receivers:
            csr = csr_of(recv, self._push)
            val = csr.val_f32 if read_val else None
            if self._push:
                kw = (dict(recv_csr=csr_of(recv, False),
                           recv_final=recv_final) if kind == "sum" else {})
                out = spmv_push(csr, x, kind, sem.process_op, val=val,
                                sent=sent_u8, want_got=self._want_got,
                                bits=sem.bits, **kw)
            else:
                out = spmv(csr, x, kind, sem.process_op, val=val,
                           sent=sent_u8, want_got=self._want_got,
                           recv_final=recv_final, bits=sem.bits)
            y_dir, c_dir = out if self._want_got else (out, None)
            if y is None:
                y, cnt = y_dir, c_dir
            else:
                y = (y + y_dir if kind == "sum" else
                     torch.minimum(y, y_dir) if kind == "min"
                     else torch.maximum(y, y_dir))
                cnt = cnt + c_dir if self._want_got else None
        return y, cnt

    def _structural_got(self, csr_of):
        """got of a dense sum, from the structure: some direction holds an
        edge into the receiver."""
        got = None
        for recv in self._receivers:
            g_dir = csr_of(recv, False).got_static
            got = g_dir if got is None else got | g_dir
        return got

    def _vec_operands(self, state, msg, sent, vp):
        """The K-wide kernel's operands of one segment: x (the senders
        that did not send zeroed on a dense sweep), the encoded vertex
        property where the ⊗ reads it, and the program's extra row."""
        sem = self._vec
        # the kernel takes the encoded width, as JAX's engine does
        # (runtime.py:529), even where it differs from sem.k
        x = sem.encode(state, msg).to(torch.float32)
        if self._dense:
            x = x.masked_fill(~sent[:, None], 0.0)
        vp_enc = (sem.encode_vp(state, vp).to(torch.float32).contiguous()
                  if sem.needs_vp else None)
        extra = (sem.extra_fn(state).to(torch.float32).reshape(-1)
                 .contiguous() if sem.extra_fn is not None else None)
        return x.contiguous(), vp_enc, extra

    def _vec_tile(self, csr_of, x, sent_u8, vp_enc, extra):
        """Every direction of one tile through the K-wide kernel: dense K3
        for an ALL_VERTICES program, its sparse mode for an ACTIVE_ONLY
        one, which skips the edges of senders that did not send and counts
        the others: (summed rows, count or None)."""
        sem = self._vec
        y = cnt = None
        for recv in self._receivers:
            csr = csr_of(recv, False)
            if self._dense:
                y_dir = spmv_vec(csr, x, sem.process_op, vp=vp_enc,
                                 extra=extra, params=sem.params)
                c_dir = None
            else:
                y_dir, c_dir = spmv_vec_sparse(csr, x, sem.process_op,
                                               sent_u8, vp=vp_enc,
                                               extra=extra, params=sem.params)
            y = y_dir if y is None else y + y_dir
            cnt = c_dir if cnt is None else cnt + c_dir
        return y, cnt

    def _segment_tile(self, csr_of, state, msg, sent, vp, n_rows,
                      msg_width):
        """Every direction of one tile through the plain segment reduce, or
        the concat reduce of a vector-message program (``msg_width`` per
        direction): (reduced, got).  ``vp`` is the receivers' property, or
        None where the program's ⊗ does not read it."""
        prog = self.program
        reduced = got = None
        for recv in self._receivers:
            csr = csr_of(recv, False)
            col = csr.col.long()
            row = csr.row.long()
            x_e = tree_map(lambda a: a[col], msg)
            e_ok = sent[col]
            vp_r = tree_map(lambda a: a[row], vp) if vp is not None else None
            u_e = prog.process_message(state, x_e, csr.val, vp_r)
            if self._vecmsg:
                partial = segment_concat_tree(u_e, e_ok, row, n_rows,
                                              msg_width[recv],
                                              prog.vector_pad)
            else:
                u_e = masked_fill_identity(prog.reduce, u_e, e_ok)
                partial = segment_reduce_tree(prog.reduce, u_e, row, n_rows)
            g = segment_any(e_ok, row, n_rows)
            if reduced is None:
                reduced, got = partial, g
            elif self._vecmsg:   # concat across directions (ALL_EDGES)
                reduced = tree_map(lambda a, b: torch.cat((a, b), 1),
                                   reduced, partial)
                got = got | g
            else:
                reduced = _combine_tree(prog.reduce, reduced, partial)
                got = got | g
        return reduced, got

    def _apply(self, state, reduced, vp, got, valid):
        """Apply where a message arrived: (vp, changed, next active) of
        one segment."""
        prog = self.program
        upd = got & valid
        vp_new = _where_tree(upd, prog.apply(state, reduced, vp), vp)
        ch = prog.changed(vp, vp_new) & upd
        return vp_new, ch, valid if self._dense else ch


class Engine(Routing):
    """Executor for one (program, graph) pair.  Reuse it across runs."""

    def __init__(self, program: GraphProgram, graph: Graph,
                 ctx: Optional[IterationContext] = None):
        super().__init__(program)
        self.graph = graph
        self.ctx = ctx if ctx is not None else IterationContext()
        for recv in self._receivers:
            graph.csr(recv)   # raises if the direction was not built
        # a concat row's width per receiver direction (JAX :237-243)
        self._msg_width = ({recv: program.max_message_width
                            or max_degree(graph, recv)
                            for recv in self._receivers}
                           if self._vecmsg else {})
        self.final_state = None

    @property
    def vector_reduced_width(self) -> int:
        """The static width D of the ``reduced`` rows a vector-message
        program's ``apply`` receives (directions concat along axis 1)."""
        return sum(self._msg_width.values())

    def _csr(self, recv, sender_major=False):
        g = self.graph
        return g.sender_csr(recv) if sender_major else g.csr(recv)

    @traced("engine.step")
    def _step(self, it: int, state, vp, active):
        """One iteration; returns (state, vp, active, any_changed) with
        ``any_changed`` a bool tensor left on the device."""
        prog = self.program
        valid = self.graph.valid_vertex
        count("engine.steps")
        with span("engine.send"):
            msg, sent = self._send(state, vp, active, valid)
            sent_u8 = None if self._dense else sent.to(torch.uint8)
        with span("engine.spmv"):
            if self._vec is not None:
                x, vp_enc, extra = self._vec_operands(state, msg, sent, vp)
                y, cnt = self._vec_tile(self._csr, x, sent_u8, vp_enc,
                                        extra)
                reduced = self._vec.decode(y)
                got = (self._structural_got(self._csr) if cnt is None
                       else cnt > 0)
            elif self._semiring is not None:
                kind = self._semiring.reduce_kind
                y, cnt = self._kernel_tile(
                    self._csr, self._scalar_operand(msg, sent), sent_u8,
                    self._receiver_final(state, vp, it, valid))
                reduced = self._semiring.decode(y)
                got = (cnt > 0 if self._want_got else
                       self._structural_got(self._csr) if kind == "sum"
                       else y != IDENTITY[kind])
            else:
                reduced, got = self._segment_tile(
                    self._csr, state, msg, sent,
                    vp if prog.process_requires_vertexprop else None,
                    self.graph.n_pad, self._msg_width)
        with span("engine.apply"):
            vp_new, ch, active_new = self._apply(state, reduced, vp, got,
                                                 valid)
            state = prog.do_every_iteration(state, vp_new, it, self.ctx)
            any_changed = ch.any()
        return state, vp_new, active_new, any_changed

    @traced("engine.run")
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
                if not _read_changed(any_changed):
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
        return state, not _read_changed(any_changed)


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
