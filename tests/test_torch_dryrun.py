"""The port's entry points against ``__graft_entry__``: ``entry()`` on the
same inputs, and ``dryrun_multichip`` on gloo ranks on the CPU (started by
the function itself, or by ``python -m pydca_tpu_torch.dryrun``), whose
ranks import torch and the port only."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import __graft_entry__ as jentry
from pydca_tpu_torch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def test_entry_matches_jax():
    """One plm loss and gradient at N 256, L 32, q 5: the same inputs as
    JAX's ``entry()``, the loss to rtol 1e-5, the gradient to 1e-4 of its
    largest entry."""
    jfn, jargs = jentry.entry()
    jloss, jgrad = jax.jit(jfn)(*jargs)
    fn, args = dryrun.entry("cpu")
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    loss, grad = fn(*args)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0, atol=1e-4 * np.abs(jgrad).max())


@pytest.mark.parametrize("n,mesh", [(4, "{'data': 2, 'model': 2}"), (2, "{'data': 2, 'model': 1}")])
def test_dryrun_multichip_on_cpu_ranks(n, mesh, capfd):
    """``dryrun_multichip(n, "cpu")`` starts n gloo ranks (a 2 x 2 grid at
    4, JAX's rule): rank 0 prints the OK line with the three checks held."""
    assert dryrun.dryrun_multichip(n, "cpu") is None
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip OK")]
    assert len(lines) == 1, lines
    line = lines[0]
    assert line.startswith(f"dryrun_multichip OK: mesh {mesh}, plm step k=2, streaming k=2, "
                           "mf D=2560 fn_apc (8128,)")
    assert f"{n} gloo rank(s) on the CPU" in line and "weights equal" in line


def test_dryrun_command_four_ranks():
    """``python -m pydca_tpu_torch.dryrun --n 4 --device cpu``: the entry
    line, then the 2 x 2 grid's OK line; exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "pydca_tpu_torch.dryrun", "--n", "4", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("entry OK: loss ")
    assert lines[-1].startswith("dryrun_multichip OK: mesh {'data': 2, 'model': 2}, ")


def test_dryrun_on_cards_that_are_not_there_raises():
    """No fallback: ``cuda`` without a card (or more cards than visible)
    raises, in the function and through the command."""
    with pytest.raises(RuntimeError, match="card"):
        dryrun.dryrun_multichip(2, "cuda")
    with pytest.raises(RuntimeError, match="card"):
        dryrun.dryrun_multichip(4)  # the cards by default
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="card"):
        dryrun.dryrun_multichip(1, "cuda:3")
    proc = subprocess.run(
        [sys.executable, "-m", "pydca_tpu_torch.dryrun", "--n", "2", "--device", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode != 0 and "card" in proc.stderr
    assert "dryrun_multichip OK" not in proc.stdout
