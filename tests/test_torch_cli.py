"""Port's ``plmdca compute_fn`` vs the JAX package's, plus the host copies.

The CLI runs end to end on the CPU on small synthetic FASTA files; the
copied JAX-free modules (alphabets, FASTA reader, writers) are pinned to
the originals byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pydca_tpu import alphabets as jalph
from pydca_tpu.cli import plmdca_main as jcli
from pydca_tpu.io import fasta as jfasta
from pydca_tpu.io import output as joutput
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch.cli import plmdca_main as tcli
from pydca_tpu_torch.io import fasta as tfasta
from pydca_tpu_torch.io import output as toutput
from pydca_tpu_torch.synthetic import (
    PLANTED_MIN_SHARE,
    PLANTED_TOP,
    planted_family,
    planted_recovery,
    spearman,
    top_k_overlap,
    write_family_fasta,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_scores(path):
    """(header lines, [((i, j), score), ...] 0-based) of a ranked-score file."""
    header, scores = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                header.append(line)
            else:
                i, j, s = line.split()
                scores.append(((int(i) - 1, int(j) - 1), float(s)))
    return header, scores


def run_both(tmp_path, biomolecule, codes, apc):
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, talph.get_alphabet(biomolecule))
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.execute_from_command_line(
        msa_file=fa, biomolecule=biomolecule, the_command="compute_fn",
        apc=apc, output_dir=out_j, mesh=None,
    )
    argv = ["compute_fn", biomolecule, fa, "--device", "cpu", "--output_dir", out_t]
    tcli.run_plm_dca(argv + (["--apc"] if apc else []))
    name = ("PLMDCA_apc_fn_scores_" if apc else "PLMDCA_raw_fn_scores_") + "fam.txt"
    return read_scores(os.path.join(out_j, name)), read_scores(os.path.join(out_t, name))


@pytest.mark.parametrize(
    "biomolecule,n,l,q,apc",
    [
        ("rna", 300, 30, 5, True),
        ("rna", 300, 30, 5, False),
        ("protein", 250, 24, 21, True),
    ],
)
def test_compute_fn_matches_jax_cli(tmp_path, biomolecule, n, l, q, apc):
    codes, _ = planted_family(n, l, q, seed=l, n_pairs=6, n_ancestors=12)
    (hj, sj), (ht, st) = run_both(tmp_path, biomolecule, codes, apc)
    assert ht == hj  # identical header block
    assert len(st) == len(sj) == l * (l - 1) // 2
    scores = [s for _, s in st]
    assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
    # two float32 fits of 100 iterations: compared at ranking level, at the
    # JAX package's own bar (tests/test_ref_parity.py:283-284)
    assert spearman(st, sj, l) >= 0.98
    assert top_k_overlap(st, sj, 20) >= 0.9


def test_planted_pairs_recovered(tmp_path):
    """Calibrates the share ``chip_smoke.py`` asserts: the JAX package and
    the port both put >= PLANTED_MIN_SHARE of the planted pairs in their
    top PLANTED_TOP FN-APC pairs (same generator, smaller N and L)."""
    codes, pairs = planted_family(1000, 60, 21, seed=0, n_pairs=20)
    (_, sj), (_, st) = run_both(tmp_path, "protein", codes, apc=True)
    assert planted_recovery(sj, pairs, PLANTED_TOP) >= PLANTED_MIN_SHARE
    assert planted_recovery(st, pairs, PLANTED_TOP) >= PLANTED_MIN_SHARE


def test_alphabets_match_jax():
    seqs = ["ACDEFGHIKLMNPQRSTVWY", "acdxyz-.~BJOUZ*", "ACGU-acgu.NRT"]
    for name in ("protein", "rna"):
        ta, ja = talph.get_alphabet(name), jalph.get_alphabet(name)
        assert (ta.name, ta.letters, ta.q, ta.gap_state) == (ja.name, ja.letters, ja.q, ja.gap_state)
        for s in seqs:
            np.testing.assert_array_equal(ta.encode_str(s), ja.encode_str(s))
        codes = np.arange(ta.q).repeat(3).reshape(-1, 3).T
        assert ta.decode_many(codes) == ja.decode_many(codes)


def test_read_msa_matches_jax(tmp_path):
    """Wrapped lines, comments, lowercase, non-standard residues and
    duplicates (after encoding): same data, ids and first-seen order."""
    rng = np.random.default_rng(0)
    rows = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY-"), 25)) for _ in range(30)]
    rows += [rows[4], rows[17].lower(), rows[2].replace("A", "X"), rows[2].replace("A", "B")]
    order = rng.permutation(len(rows))
    text = ["; a comment line"]
    for k in order:
        r = rows[k]
        text += [f">seq{k} description", r[:10], r[10:], ""]
    path = tmp_path / "msa.fa"
    path.write_text("\n".join(text))
    tm = tfasta.read_msa(str(path), "protein")
    jm = jfasta.read_msa(str(path), "protein")
    assert tm.data.dtype == jm.data.dtype
    np.testing.assert_array_equal(tm.data, jm.data)
    assert tm.ids == jm.ids
    assert tm.num_seqs < len(rows)  # duplicates were dropped
    assert tfasta.parse_fasta(path.read_text()) == jfasta.parse_fasta(path.read_text())


def test_output_writers_byte_identical(tmp_path):
    class Inst:
        biomolecule, num_sequences, sequences_len = "RNA", 123, 45
        sequence_identity, lambda_h, lambda_J, max_iterations = 0.8, 8.8, 8.8, 100
        effective_num_sequences, pseudocount = 97.25, 0.5

    scores = [((0, 5), 0.53125), ((2, 3), 1e-7), ((1, 4), -0.25)]
    files = []
    for mod in (toutput, joutput):
        d = tmp_path / mod.__name__
        mod.create_directories(str(d))
        path = mod.get_dca_output_file_path(str(d), "/x/MSA_fam.fa", prefix="P_", postfix=".txt")
        mod.write_sorted_dca_scores(path, scores, metadata=mod.plmdca_param_metadata(Inst), score_type="FN")
        files.append(open(path, "rb").read())
        mod.write_sorted_dca_scores(path, scores, metadata=mod.mfdca_param_metadata(Inst), score_type="FN")
        files.append(open(path, "rb").read())
        assert os.path.basename(path) == "P_MSA_fam.txt"
    assert files[0] == files[2] and files[1] == files[3]


def test_port_never_imports_jax():
    code = (
        "import sys, pydca_tpu_torch, pydca_tpu_torch.cli.plmdca_main, "
        "pydca_tpu_torch.cli.mfdca_main, pydca_tpu_torch.meanfield, "
        "pydca_tpu_torch.plm, pydca_tpu_torch.score, pydca_tpu_torch.io.output, "
        "pydca_tpu_torch.ops.linalg, pydca_tpu_torch.ops.lbfgs, pydca_tpu_torch.stats, "
        "pydca_tpu_torch.synthetic, pydca_tpu_torch.family, pydca_tpu_torch.align, "
        "pydca_tpu_torch.backmap, pydca_tpu_torch.trim, pydca_tpu_torch.eval, "
        "pydca_tpu_torch.cli.main\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pydca_tpu.')) or m == 'pydca_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "extra,match",
    [
        (["warmup"], "Queue 1 #14"),
        (["compute_fn", "--precision", "bfloat16"], "Queue 1 #6"),
        (["compute_fn", "--param_space", "w2"], "Queue 1 #10"),
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
        tcli.run_plm_dca(argv)


def test_mesh_over_several_cards_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 #13"):
        tcli.run_plm_dca(["compute_fn", "rna", "x.fa", "--device", "cuda"])
