"""The control, the reference put in the program's place at the nearest
precision below the configuration's (TF32 products), comes out as not
correct, where the program is correct: on the card at each one-card cell's
own size (marked ``gpu``; the cells of ``BENCHMARK.json``), and as a
reading above the program's at a size a CPU run holds."""

import json

import pytest
import torch

from dcabench.calibrate import control_output
from dcabench.harness import engine_options, judge_outputs, make_pool
from dcabench.jobs import run_job
from dcabench.spec import ROOT, load_cell

SEED = 2**31 + 77
ONE_CARD_CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                  if w["chips"] == 1]


def _readings(cell, device):
    pool = make_pool(cell, SEED)[:1]
    _, prog = run_job(cell.traffic["engine"], 0, 0, pool[0], cell.config["biomolecule"],
                      device, engine_options(cell))
    control = control_output(cell, pool[0], device)
    return judge_outputs(cell, pool, [prog], device), judge_outputs(cell, pool, [control], device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ONE_CARD_CELLS)
def test_control_fails_the_cell_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the limits were set at the cell's size on the card")
    cell = load_cell(name)
    prog, control = _readings(cell, "cuda")
    assert all(prog[k] <= cell.limits[k] for k in prog), prog
    assert any(control[k] > cell.limits[k] for k in control), control


@pytest.mark.parametrize("engine,n,l,number,factor", [
    ("plm", 1024, 40, "objective_gap", 3.0),
    ("mf", 1024, 60, "couplings_gap", 10.0),
])
def test_control_reads_above_the_program_cpu(toy_root, engine, n, l, number, factor):
    cell = load_cell("toy.plm" if engine == "plm" else "toy.mf", toy_root)
    cell.config = {**cell.config, "num_seqs": n, "seqs_len": l}
    prog, control = _readings(cell, "cpu")
    assert control[number] > factor * prog[number], (prog, control)
