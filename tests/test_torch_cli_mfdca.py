"""Port's ``mfdca compute_fn`` vs the JAX package's, end to end on the CPU.

The JAX CLI runs at ``mesh="single"``: the tests' JAX backend has 8
virtual CPU devices, where its default ``--mesh auto`` would take the
sharded path.  File names and every header line but Meff must be equal
byte for byte; Meff is a float32 sum taken in another order (rel 1e-6);
the scores are held to the ranking bar.
"""

import os

import numpy as np
import pytest
import torch

from pydca_tpu.cli import mfdca_main as jcli
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch.cli import mfdca_main as tcli
from pydca_tpu_torch.synthetic import (
    PLANTED_MIN_SHARE,
    PLANTED_TOP,
    planted_family,
    planted_recovery,
    spearman,
    top_k_overlap,
    write_family_fasta,
)
from test_torch_cli import read_scores

MEFF = "#      Effective number of sequences: "


def run_both(tmp_path, biomolecule, codes, apc):
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, talph.get_alphabet(biomolecule))
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.execute_from_command_line(
        msa_file=fa, biomolecule=biomolecule, the_command="compute_fn",
        apc=apc, output_dir=out_j, mesh="single",
    )
    argv = ["compute_fn", biomolecule, fa, "--device", "cpu", "--output_dir", out_t]
    tcli.run_meanfield_dca(argv + (["--apc"] if apc else []))
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t))
    name = ("MFDCA_apc_fn_scores_" if apc else "MFDCA_raw_fn_scores_") + "fam.txt"
    return read_scores(os.path.join(out_j, name)), read_scores(os.path.join(out_t, name))


@pytest.mark.parametrize(
    "biomolecule,n,l,q,apc",
    [
        ("rna", 400, 40, 5, True),
        ("rna", 400, 40, 5, False),
        ("protein", 300, 30, 21, True),
        ("protein", 300, 30, 21, False),
    ],
)
def test_compute_fn_matches_jax_cli(tmp_path, biomolecule, n, l, q, apc):
    codes, _ = planted_family(n, l, q, seed=l + q, n_pairs=6, n_ancestors=12)
    (hj, sj), (ht, st) = run_both(tmp_path, biomolecule, codes, apc)
    assert len(ht) == len(hj)
    for a, b in zip(ht, hj):
        if b.startswith(MEFF):
            assert a.startswith(MEFF)
            assert float(a[len(MEFF):]) == pytest.approx(float(b[len(MEFF):]), rel=1e-6)
        else:
            assert a == b  # byte for byte
    assert len(st) == len(sj) == l * (l - 1) // 2
    scores = [s for _, s in st]
    assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
    assert spearman(st, sj, l) >= 0.98
    assert top_k_overlap(st, sj, 20) >= 0.9


def test_planted_pairs_recovered(tmp_path):
    """Calibrates the share ``chip_smoke.py`` asserts on the mean-field
    path: the JAX package and the port both put >= PLANTED_MIN_SHARE of the
    planted pairs in their top PLANTED_TOP FN-APC pairs."""
    codes, pairs = planted_family(1000, 60, 21, seed=0, n_pairs=20)
    (_, sj), (_, st) = run_both(tmp_path, "protein", codes, apc=True)
    assert planted_recovery(sj, pairs, PLANTED_TOP) >= PLANTED_MIN_SHARE
    assert planted_recovery(st, pairs, PLANTED_TOP) >= PLANTED_MIN_SHARE


@pytest.mark.parametrize(
    "extra,match",
    [
        (["warmup"], "Queue 1 #14"),
    ],
)
def test_unported_options_raise(tmp_path, extra, match):
    fa = str(tmp_path / "f.fa")
    write_family_fasta(fa, planted_family(20, 12, 5, n_pairs=1)[0], talph.RNA)
    cmd, flags = extra[0], extra[1:]
    argv = [cmd, "rna", fa, "--device", "cpu", "--output_dir", str(tmp_path)] + flags
    if cmd == "warmup":
        argv = [cmd, "rna", fa]
    with pytest.raises(NotImplementedError, match=match):
        tcli.run_meanfield_dca(argv)
    assert not any(p.endswith(".txt") for p in os.listdir(tmp_path))


def test_mesh_over_several_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 #13"):
        tcli.run_meanfield_dca(["compute_fn", "rna", "x.fa", "--device", "cuda"])


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    """``--device cuda`` never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = str(tmp_path / "f.fa")
    write_family_fasta(fa, planted_family(20, 12, 5, n_pairs=1)[0], talph.RNA)
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.run_meanfield_dca(["compute_fn", "rna", fa, "--mesh", "single"])
