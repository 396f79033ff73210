"""A run whose timed path is broken underneath comes out not correct: the
harness is driven on the CPU (its look for a chip skipped) with each fault
a cell can have planted in the program."""

import functools

import pytest

import pydca_tpu_torch.plm as prog_plm
import pydca_tpu_torch.score as prog_score
import pydca_tpu_torch.stats as prog_stats
from dcabench.calibrate import cut_fit, start_fit
from dcabench.harness import run_cell

from conftest import result_line

SEED = 2**33 + 17


def _run(cell, root, capfd, patch=None):
    assert run_cell(cell, SEED, 0.5, False, device="cpu", root=root, patch=patch) == 0
    return result_line(capfd.readouterr().out)


def _unchanged(fit):
    """Every step leaves the parameters as they were: the fit runs and
    counts its iterations, and returns its start."""
    @functools.wraps(fit)
    def wrapped(msa, weights, lambda_h, lambda_j, l, q, **kwargs):
        res = fit(msa, weights, lambda_h, lambda_j, l, q, **kwargs)
        return res._replace(x=prog_plm.init_params(msa, weights, l, q))
    return wrapped


def _half_rows(fn, weights_at):
    """Half of the sequences left out (weight 0), the rest summed as usual."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args = list(args)
        w = args[weights_at].clone()
        w[w.shape[0] // 2:] = 0
        args[weights_at] = w
        return fn(*args, **kwargs)
    return wrapped


def _swap_first(fn):
    """The ranked list altered where it is produced."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        return [out[1], out[0]] + out[2:]
    return wrapped


def _bump_first_weight(fn):
    """One sequence weight altered where it is produced."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        w = fn(*args, **kwargs).clone()
        w[0] *= 1.5
        return w
    return wrapped


def drop_exchange():
    """The ranks' sums of the loss and gradient left out (run in each rank)."""
    from pydca_tpu_torch.parallel import mesh

    orig = mesh.DataMesh.sum_

    def sum_(self, t, name, axis="data"):
        return t if name in ("grad_allreduce", "nll_allreduce") else orig(self, t, name, axis)

    mesh.DataMesh.sum_ = sum_


FAULTS = {
    "plm_state_unchanged": ("toy.plm", prog_plm, "fit_plm", _unchanged, "objective_gap"),
    "plm_fit_cut_at_10": ("toy.plm", prog_plm, "fit_plm", cut_fit, "stop_gap"),
    "plm_start_no_iterations": ("toy.plm", prog_plm, "fit_plm", start_fit, "stop_gap"),
    "plm_half_rows": ("toy.plm", prog_plm, "fit_plm", lambda f: _half_rows(f, 1), "objective_gap"),
    "plm_list_altered": ("toy.plm", prog_score, "sorted_scores", _swap_first, "list_errors"),
    "plm_weight_altered": ("toy.plm", prog_stats, "sequence_weights", _bump_first_weight,
                           "weights_max_abs"),
    "mf_half_rows": ("toy.mf", prog_stats, "weighted_gram", lambda f: _half_rows(f, 1),
                     "couplings_gap"),
    "mf_list_altered": ("toy.mf", prog_score, "sorted_scores", _swap_first, "list_errors"),
    "mf_weight_altered": ("toy.mf", prog_stats, "sequence_weights", _bump_first_weight,
                          "weights_max_abs"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, toy_root, capfd, monkeypatch):
    cell, module, name, breaker, number = FAULTS[fault]
    monkeypatch.setattr(module, name, breaker(getattr(module, name)))
    res = _run(cell, toy_root, capfd)
    assert res["correct"] is False
    check = res["checks"][number]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("cell", ["toy.plm", "toy.mf"])
def test_sound_run_is_correct(cell, toy_root, capfd):
    assert _run(cell, toy_root, capfd)["correct"] is True


def test_mesh_exchange_left_out_is_not_correct(toy_root, capfd):
    sound = _run("toy.mesh2", toy_root, capfd)
    assert sound["correct"] is True and sound["device"]["count"] == 2
    broken = _run("toy.mesh2", toy_root, capfd, patch="test_bench_faults:drop_exchange")
    assert broken["correct"] is False
    assert broken["checks"]["objective_gap"]["value"] > broken["checks"]["objective_gap"]["limit"]


