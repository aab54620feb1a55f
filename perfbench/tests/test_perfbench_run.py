"""A measurement run without a card fails and prints no result; nothing
the benchmark loads brings in JAX or the JAX package, and the reference
loads nothing of the program."""

import json
import subprocess
import sys

import pytest

from perfbench import harness

REPO = harness.REPO
CELLS = sorted(p.stem for p in (harness.ROOT / "workloads").glob("*.json"))


def _no_card() -> bool:
    import torch
    return not torch.cuda.is_available()


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_without_a_card_fails_with_no_result(cell):
    if not _no_card():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 35 + 1), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def _loaded(code: str) -> set:
    res = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    code = "\n".join([
        "import sys; sys.path.insert(0, '.')",
        "from perfbench import harness, port, control, trace, roofline",
        *[f"c = harness.load_cell({c!r}); harness.driver(c); "
          f"harness.generator(c.config)" for c in CELLS],
        "[harness.module('metrics', p.stem) for p in "
        "(harness.ROOT / 'metrics').glob('*.py')]",
        "import graphmat_tpu_torch.apps.pagerank, "
        "graphmat_tpu_torch.apps.bfs, graphmat_tpu_torch.apps.sgd, "
        "graphmat_tpu_torch.apps.triangle_counting, "
        "graphmat_tpu_torch.core.graph",
    ])
    top = _loaded(code)
    assert "graphmat_tpu_torch" in top and "perfbench" in top
    # whole top-level names: graphmat_tpu_torch begins with graphmat_tpu
    assert not top & {"jax", "jaxlib", "flax", "graphmat_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import sys; sys.path.insert(0, '.')\n"
                  "from perfbench.reference import bfs, pagerank, sgd, tc")
    assert not top & {"jax", "jaxlib", "flax", "graphmat_tpu",
                      "graphmat_tpu_torch"}


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "graphmat_tpu_torch_x", sys)
    assert "graphmat_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.banned_modules() == ["jax"]


@pytest.mark.cuda
def test_on_the_card(card):
    """One short run of the first cell on a card, when there is one."""
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "17", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
