"""Port's ``plmdca compute_fn`` vs the JAX package's, plus the host copies.

The CLI runs end to end on the CPU on small synthetic FASTA files; the
copied JAX-free modules (alphabets, FASTA reader, writers) are pinned to
the originals byte for byte.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

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
    """Every module of the port (walked, so new modules are covered) and
    ``chip_smoke.py``'s imports pull in nothing of JAX or the JAX package."""
    code = (
        "import ast, importlib, pkgutil, sys\n"
        "import pydca_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(pydca_tpu_torch.__path__, 'pydca_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "tree = ast.parse(open('chip_smoke.py').read())\n"
        "imports = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]\n"
        "exec(compile(ast.Module(body=imports, type_ignores=[]), 'chip_smoke.py', 'exec'), {})\n"
        "assert len(names) > 30 and {'pydca_tpu_torch.parallel.spawn', 'pydca_tpu_torch.dryrun'} <= set(names), names\n"
        "assert len(imports) > 20 and 'pydca_tpu_torch.cli.main' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pydca_tpu.')) or m == 'pydca_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "flags,jax_kw",
    [
        (["--precision", "bfloat16"], dict(precision="bfloat16")),
        (["--param_space", "w2"], dict(param_space="w2")),
    ],
    ids=["bfloat16", "w2"],
)
def test_precision_and_space_flags_match_jax_cli(tmp_path, caplog, flags, jax_kw):
    """``--precision bfloat16`` and ``--param_space w2`` through both CLIs'
    ``compute_fn --apc`` (the JAX CLI at ``mesh=None``: the tests' 8
    virtual devices would send its default ``--mesh auto`` to the sharded
    path): the same header, and FN-APC at the JAX package's rank bar.  The
    port's ``--param_space w2`` logs one warning and writes the file of the
    same command without the flag, byte for byte."""
    n, l, q = 300, 30, 5
    codes, _ = planted_family(n, l, q, seed=l, n_pairs=6, n_ancestors=12)
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, talph.RNA)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.execute_from_command_line(
        msa_file=fa, biomolecule="rna", the_command="compute_fn", apc=True, output_dir=out_j,
        mesh=None, **jax_kw,
    )
    argv = ["compute_fn", "rna", fa, "--apc", "--device", "cpu"]
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch"):
        tinst = tcli.run_plm_dca(argv + ["--output_dir", out_t] + flags)
    warned = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert tinst.mm_bf16 == ("precision" in jax_kw)
    name = "PLMDCA_apc_fn_scores_fam.txt"
    (hj, sj), (ht, st) = (read_scores(os.path.join(d, name)) for d in (out_j, out_t))
    assert ht == hj and len(st) == len(sj) == l * (l - 1) // 2
    assert spearman(st, sj, l) >= 0.98
    assert top_k_overlap(st, sj, 20) >= 0.9
    if "param_space" in jax_kw:
        assert len(warned) == 1 and "compact parameter layout" in warned[0]
        out_d = str(tmp_path / "port_default")
        tcli.run_plm_dca(argv + ["--output_dir", out_d])
        with open(os.path.join(out_t, name), "rb") as a, open(os.path.join(out_d, name), "rb") as b:
            assert a.read() == b.read()
