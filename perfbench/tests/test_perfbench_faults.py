"""The check of each cell comes out false on a broken program and on the
control, and true on the program as it is: the rest of a run, driven on
the CPU at a small size (the look for a card skipped)."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.control import control_readings

CELLS = sorted(p.stem for p in (harness.ROOT / "workloads").glob("*.json"))
SEED = 2 ** 34 + 77


def tiny(name, control=False):
    cell = harness.load_cell(name)
    if name.endswith(".tc"):
        # "auto" takes the bucketed route, whose attribution the reference
        # follows, above an out-degree of 1024, which the permuted labels
        # reach at full size but not here: take that route by name; the
        # int16 control needs counts past 2^15, which the heaviest
        # vertices reach at scale 18
        cell.config["scale"] = 18 if control else 12
        cell.traffic["method"] = "bucketed"
    elif cell.config["generator"] == "kron":
        cell.config["scale"] = 11
    else:
        cell.config.update(users=3000, items=1000, ratings=60000)
        cell.config["assumed"] = dict(cell.config["assumed"], user_floor=5,
                                      user_top=600)
    return cell


def run(name):
    return harness.run_cell(tiny(name), SEED, 0.3, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    out = control_readings(tiny(name, control=True), SEED, "cpu")
    assert out["control_failed"] is True, out


def _state_unchanged(monkeypatch):
    from graphmat_tpu_torch.core import runtime
    from graphmat_tpu_torch.ops import triangles

    def step(self, it, state, vp, active):
        return state, vp, active, torch.tensor(False)
    monkeypatch.setattr(runtime.Engine, "_step", step)
    # the bucketed count's steps are its two kernels
    monkeypatch.setattr(triangles, "core_count", lambda *a: None)
    monkeypatch.setattr(triangles, "tail_count", lambda *a: None)


def _half_left_out(monkeypatch):
    """Every second receiver's row left out and taken from the row before
    it; half the triangle count's edges, the count doubled."""
    from graphmat_tpu_torch.apps import triangle_counting as app
    from graphmat_tpu_torch.core import runtime

    def halve(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            y = out[0] if isinstance(out, tuple) else out
            y[1::2] = y[0:y.shape[0] - 1:2]
            return out
        return wrapped
    for name in ("spmv", "spmv_vec", "spmv_vec_sparse"):
        monkeypatch.setattr(runtime, name, halve(getattr(runtime, name)))
    count = app.count_triangles_bucketed

    def half_count(src0, dst0, n, **kw):
        tri, total = count(src0[::2], dst0[::2], n, **kw)
        return tri * 2, total * 2
    monkeypatch.setattr(app, "count_triangles_bucketed", half_count)


def _answer_altered(monkeypatch):
    """One number of each answer changed where the app returns it."""
    from graphmat_tpu_torch.apps import bfs, pagerank, sgd
    from graphmat_tpu_torch.apps import triangle_counting as tc

    def pr(fn):
        def wrapped(*a, **kw):
            p, n = fn(*a, **kw)
            p = p.copy()
            p[int(np.argmax(p))] *= 1.001
            return p, n
        return wrapped

    def bf(fn):
        def wrapped(*a, **kw):
            d, p, n = fn(*a, **kw)
            p = p.copy()
            p[int(np.argmax(p))] += 1
            return d, p, n
        return wrapped

    def sg(fn):
        def wrapped(*a, **kw):
            lv, r0, r1 = fn(*a, **kw)
            lv = lv.copy()
            lv[0] += 1e-3
            return lv, r0, r1
        return wrapped

    def tr(fn):
        # the check samples vertices by class: alter one middle class of
        # counts only, as a fault in one class pair of the kernels would
        def wrapped(*a, **kw):
            t, total = fn(*a, **kw)
            t = t.copy()
            cls = np.floor(np.log2(np.maximum(t, 1)))
            hit = np.flatnonzero((t > 0) & (cls == np.median(cls[t > 0])))
            t[hit] += 1
            return t, total + hit.size
        return wrapped
    monkeypatch.setattr(pagerank, "run_pagerank", pr(pagerank.run_pagerank))
    monkeypatch.setattr(bfs, "run_bfs", bf(bfs.run_bfs))
    monkeypatch.setattr(sgd, "run_sgd", sg(sgd.run_sgd))
    monkeypatch.setattr(tc, "run_triangle_counting",
                        tr(tc.run_triangle_counting))


def _stops_early(monkeypatch):
    """PageRank's convergence test 100 times looser."""
    from graphmat_tpu_torch.apps import pagerank
    init = pagerank.PageRankProgram.__init__

    def loose(self, alpha=0.3, tol=1e-5, *a, **kw):
        init(self, alpha, 100 * tol, *a, **kw)
    monkeypatch.setattr(pagerank.PageRankProgram, "__init__", loose)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith(
    ".pagerank")])
def test_stopping_early_fails(name, monkeypatch):
    _stops_early(monkeypatch)
    res = run(name)
    assert res["correct"] is False and \
        res["checks"]["steps_early"]["value"] > 0, res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run(name)
    assert res["correct"] is False, (fault, res["checks"])
