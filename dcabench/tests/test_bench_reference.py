"""The plain reference against the program's CPU path at small sizes: the
same weights bit for bit, the plmDCA objective, gradient and start, the
mean-field couplings and FN-APC in float64, and the judge's numbers."""

import numpy as np
import pytest
import torch

from dcabench.planted import planted_family
from dcabench.reference import judge, tf32
from dcabench.reference import meanfield as ref_mf
from dcabench.reference import plm as ref_plm
from dcabench.reference.weights import sequence_weights
from pydca_tpu_torch import MeanFieldDCA, stats
from pydca_tpu_torch import plm as prog_plm
from pydca_tpu_torch.alphabets import get_alphabet
from pydca_tpu_torch.io.fasta import MSA


def _family(n, l, q, seed=1):
    codes, _ = planted_family(n, l, q, seed=seed, n_pairs=6)
    return codes, torch.from_numpy(codes)


def _pair_order(ranked, l):
    scores, errors = judge.ranked_scores(ranked, l)
    assert errors == 0
    return scores


@pytest.mark.parametrize("n,l,q", [(300, 40, 21), (500, 60, 5)])
def test_weights_equal_bit_for_bit(n, l, q):
    _, ct = _family(n, l, q)
    assert torch.equal(sequence_weights(ct, 0.8, q), stats.sequence_weights(ct, 0.8, q))


def test_plm_objective_gradient_and_start():
    l, q = 30, 21
    _, ct = _family(300, l, q)
    w = sequence_weights(ct, 0.8, q)
    lam = 0.2 * (l - 1)
    theta = torch.randn(ref_plm.n_params(l, q), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0)) * 0.05
    f, g = ref_plm.objective(theta, ct, w, lam, lam, l, q, block=64)
    fp, gp = prog_plm.plm_loss_and_grad(theta.float(), ct, w, lam, lam, l, q)
    assert abs(f - float(fp)) / abs(f) < 1e-6
    assert float((g.float() - gp).norm() / g.norm()) < 1e-5
    start = ref_plm.init_theta(ct, w, l, q).float()
    assert torch.allclose(start, prog_plm.init_params(ct, w, l, q), atol=1e-6)


def test_plm_fn_apc_of_given_parameters():
    l, q = 30, 21
    codes, _ = _family(300, l, q)
    theta = np.random.default_rng(0).normal(0, 0.05, ref_plm.n_params(l, q)).astype(np.float32)
    eng = prog_plm.PlmDCA(MSA(data=codes, alphabet=get_alphabet("protein")), "protein",
                          device="cpu")
    eng.set_fields_and_couplings(theta)
    prog = _pair_order(eng.compute_sorted_FN_APC(), l)
    ref = ref_plm.fn_apc(torch.from_numpy(theta).double(), l, q).numpy()
    assert np.abs(prog - ref).max() / np.abs(ref).max() < 1e-5


def test_meanfield_couplings_and_fn_apc_float64():
    l, q = 40, 21
    codes, ct = _family(400, l, q)
    eng = MeanFieldDCA(MSA(data=codes, alphabet=get_alphabet("protein")), "protein",
                       device="cpu", dtype=torch.float64)
    j = ref_mf.couplings(ct, sequence_weights(ct, 0.8, q), q)
    assert float((eng.compute_couplings() - j).abs().max() / j.abs().max()) < 1e-8
    prog = _pair_order(eng.compute_sorted_FN_APC(), l)
    ref = ref_mf.fn_apc(j, l, q).numpy()
    assert np.abs(prog - ref).max() / np.abs(ref).max() < 1e-8


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 3 * 2.0**-12), 3.0e-3])
    r = tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0**-10  # a tie rounds away from zero
    assert r[2] == 1.0 and r[3] == -(1.0 + 2.0**-10)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert float(((r - x) / x).abs().max()) <= 2.0**-11


def test_judge_numbers_of_a_sound_and_altered_list():
    l, q = 30, 21
    codes, ct = _family(300, l, q)
    eng = MeanFieldDCA(MSA(data=codes, alphabet=get_alphabet("protein")), "protein", device="cpu")
    ranked = eng.compute_sorted_FN_APC()
    jd = judge.MeanFieldJudge(l, q, 0.8, 0.5, "cpu")
    sound = jd.numbers(0, codes, eng.get_sequences_weight(), eng.compute_couplings(), ranked)
    assert sound["weights_max_abs"] == 0 and sound["list_errors"] == 0
    assert sound["couplings_gap"] < 1e-4 and sound["fnapc_gap"] < 1e-4
    swapped = [ranked[1], ranked[0]] + ranked[2:]
    assert jd.numbers(0, codes, eng.get_sequences_weight(), eng.compute_couplings(),
                      swapped)["list_errors"] >= 1
    assert jd.numbers(0, codes, eng.get_sequences_weight(), eng.compute_couplings(),
                      ranked[:-1])["list_errors"] == 1
