"""The port's twin of the repository's entry points
(``graphmat_tpu_torch/graft_entry.py``) against ``__graft_entry__.py`` on
the CPU: ``entry()``'s PageRank step (K1's plain version) within 1e-6 of
max(1, |pr|) of the JAX step's (float32 sums in another order), and
``dryrun_multichip`` on 4 and 8 CPU tiles, whose checks are exact.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry

from graphmat_tpu_torch import graft_entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_step_matches_jax():
    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 1e-6
    assert torch.equal(got, graft_entry.pagerank_step_reference(*args))
    assert not np.allclose(want, 0.3)   # the step moved the vector


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        graft_entry.entry()


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_tiles(n, capsys):
    graft_entry.dryrun_multichip(n, device="cpu")
    shape = "2x2" if n == 4 else "2x4"
    assert f"dryrun_multichip OK on a {shape} mesh" in capsys.readouterr().out


def test_graft_entry_module_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, GRAPHMAT_PLATFORM="cpu")
    out = subprocess.run([sys.executable, "-m",
                          "graphmat_tpu_torch.graft_entry"], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "entry() ran: (1024,) torch.float32 cpu" in out.stdout
    assert "dryrun_multichip OK on a 2x4 mesh" in out.stdout
