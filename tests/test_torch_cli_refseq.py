"""``--refseq_file`` through the port's ``plmdca`` and ``mfdca`` CLIs, and
the port's ``pydca`` CLI, vs the JAX package's CLIs on the CPU.

- ``plmdca``: both CLIs' fits are given one JAX-fitted parameter vector
  (``fit_plm`` patched in both packages, as in
  ``tests/test_torch_cli_subcommands.py``), so the files compare scoring,
  backmapping and extraction: headers and fields byte for byte, the same
  mapped pairs, scores and couplings within float32 round-off.
- ``mfdca``: both engines run in float64 (the CLIs' engine class patched
  to ``dtype=float64``): headers byte for byte (Meff to rel 1e-6), the
  same mapped pairs, scores, fields and couplings within 1e-6 of the
  file's largest value.
- ``pydca``: ``trim_by_refseq`` (with and without ``--remove_all_gaps``),
  ``trim_by_gap_size``, ``pdb_content`` and the two ``plot_*`` commands
  with ``--no_show`` write the JAX CLI's bytes.

Every reference sequence comes from a row other than the first, with
substitutions and residues added at both ends, so the template search runs.
"""

import functools
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pydca_tpu.plm as jplm_engine
import pydca_tpu_torch.plm as tplm_engine
from pydca_tpu import stats as jstats
from pydca_tpu.cli import main as jmain
from pydca_tpu.cli import mfdca_main as jmf
from pydca_tpu.cli import plmdca_main as jplm
from pydca_tpu.meanfield import MeanFieldDCA as JMeanField
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch.cli import main as tmain
from pydca_tpu_torch.cli import mfdca_main as tmf
from pydca_tpu_torch.cli import plmdca_main as tplm
from pydca_tpu_torch.io.fasta import write_fasta
from pydca_tpu_torch.meanfield import MeanFieldDCA as TMeanField
from pydca_tpu_torch.ops.lbfgs import LBFGSResult
from pydca_tpu_torch.synthetic import planted_family, reference_from_row, write_family_fasta
from test_torch_cli import read_scores
from test_torch_cli_subcommands import assert_headers_equal, split_file
from test_torch_eval import realistic

BIOS = {"rna": talph.RNA, "protein": talph.PROTEIN}


def family_files(tmp_path, bio, n, l, seed, row):
    """A planted family's FASTA file and a reference made from ``row``."""
    codes, _ = planted_family(n, l, BIOS[bio].q, seed=seed, n_pairs=6, n_ancestors=12)
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, BIOS[bio])
    ref = reference_from_row(codes, row, BIOS[bio], seed=seed, ends=(3, 5))
    rf = str(tmp_path / "ref.fa")
    write_fasta(rf, ["ref"], [ref])
    return codes, fa, rf, ref


def run_both(tmp_path, jcli, run, fa, argv, mesh):
    """``argv`` (a subcommand, its positional arguments and flags) through
    the JAX CLI and the port's; returns the two output directories."""
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    args = vars(jcli.build_parser().parse_args(argv))
    for key in ("mesh", "num_threads", "seq_block", "precision", "checkpoint", "param_space",
                "output_dir"):
        args.pop(key, None)
    jcli.execute_from_command_line(output_dir=out_j, mesh=mesh, **args)
    run(argv + ["--device", "cpu", "--output_dir", out_t])
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t))
    return out_j, out_t


PLM_N, PLM_L, PLM_Q = 300, 30, 5


@pytest.fixture(scope="module")
def plm_params():
    """A JAX fit of the plmdca family (float32 parameter vector)."""
    codes, _ = planted_family(PLM_N, PLM_L, PLM_Q, seed=PLM_L, n_pairs=6, n_ancestors=12)
    msa = jnp.asarray(codes.astype(np.int32))
    w = jstats.sequence_weights(msa, 0.8, PLM_Q)
    lam = jnp.float32(0.2 * (PLM_L - 1))
    res = jplm_engine.fit_plm(msa, w, lam, lam, PLM_L, PLM_Q, max_iterations=100)
    return np.asarray(res.x, np.float32)


def patch_fits(monkeypatch, params):
    def jax_fit(*args, **kwargs):
        return jplm_engine.LBFGSResult(
            x=jnp.asarray(params), fx=0.0, gnorm=0.0, num_iters=100, converged=True,
            linesearch_failed=False, n_evals=0,
        )

    def port_fit(msa, *args, **kwargs):
        return LBFGSResult(x=torch.tensor(params, device=msa.device), fx=0.0, gnorm=0.0,
                           num_iters=100, converged=True, linesearch_failed=False, n_evals=0)

    monkeypatch.setattr(jplm_engine, "fit_plm", jax_fit)
    monkeypatch.setattr(tplm_engine, "fit_plm", port_fit)


PLM_CASES = [
    ["compute_fn", "--apc"],
    ["compute_fn"],
    ["compute_di", "--apc"],
    ["compute_params"],
    ["compute_params", "--ranked_by", "di", "--num_site_pairs", "5", "--linear_dist", "3"],
]


def rows_of(path):
    """(header lines, [(key columns, values), ...]) of an output file."""
    name = os.path.basename(path)
    head, body = split_file(path)
    sep, keys = (None, 2) if "_scores_" in name else (",", 1 if name.startswith("fields_") else 2)
    rows = [r.split(sep) for r in body]
    return head, [(tuple(r[:keys]), np.array([float(x) for x in r[keys:]])) for r in rows]


def assert_files_close(path_t, path_j, tol):
    """Headers byte for byte (Meff to rel 1e-6); the same keys (site pairs
    or sites); values within ``tol`` of the file's largest value.  Score
    files may order pairs differently only where their scores lie within
    that tolerance: the port's order is the JAX scores' order."""
    ht, rt = rows_of(path_t)
    hj, rj = rows_of(path_j)
    assert_headers_equal(ht, hj)
    assert len(rt) == len(rj) > 0
    want = dict(rj)
    assert set(want) == {k for k, _ in rt}
    vt = np.array([v for _, v in rt])
    vj = np.array([want[k] for k, _ in rt])
    atol = tol * np.abs(vj).max()
    np.testing.assert_allclose(vt, vj, rtol=0, atol=atol)
    if "_scores_" in path_t:
        assert (np.diff(vj[:, 0]) <= 2 * atol).all()
    else:
        assert [k for k, _ in rt] == [k for k, _ in rj]


@pytest.mark.parametrize("argv", PLM_CASES, ids=lambda x: "-".join(x))
def test_plmdca_refseq_matches_jax_cli(tmp_path, monkeypatch, plm_params, argv):
    """Given one parameter vector: the fields files byte for byte, the
    rest within float32 round-off (FN and the couplings 1e-6 of the
    largest value: the two packages sum a block in another order; DI 1e-4,
    the f32 bar of ``tests/test_torch_di.py``), over the same mapped pairs
    of reference positions."""
    _, fa, rf, ref = family_files(tmp_path, "rna", PLM_N, PLM_L, PLM_L, row=11)
    patch_fits(monkeypatch, plm_params)
    full = [argv[0], "rna", fa, "--refseq_file", rf] + argv[1:]
    out_j, out_t = run_both(tmp_path, jplm, tplm.run_plm_dca, fa, full, None)
    for name in os.listdir(out_j):
        path_t, path_j = os.path.join(out_t, name), os.path.join(out_j, name)
        if name.startswith("fields_"):
            with open(path_j, "rb") as a, open(path_t, "rb") as b:
                assert b.read() == a.read()
            continue
        assert_files_close(path_t, path_j, 1e-4 if "_di_" in name else 1e-6)
        if "_scores_" in name:
            pairs = [p for p, _ in read_scores(path_t)[1]]
            m = len({s for p in pairs for s in p})
            assert len(pairs) == m * (m - 1) // 2 and m > 0.7 * len(ref)
            assert all(0 <= i < j < len(ref) for i, j in pairs)


MF_CASES = [
    ("rna", ["compute_fn", "--apc"]),
    ("rna", ["compute_di"]),
    ("rna", ["compute_params"]),
    ("protein", ["compute_fn"]),
    ("protein", ["compute_di", "--apc"]),
    ("protein", ["compute_params", "--ranked_by", "fn", "--linear_dist", "2"]),
]


@pytest.mark.parametrize("bio,argv", MF_CASES, ids=lambda x: "-".join(x) if isinstance(x, list) else x)
def test_mfdca_refseq_matches_jax_cli(tmp_path, monkeypatch, bio, argv):
    n, l = (400, 40) if bio == "rna" else (300, 30)
    _, fa, rf, ref = family_files(tmp_path, bio, n, l, seed=l, row=23)
    monkeypatch.setattr(jmf, "MeanFieldDCA", functools.partial(JMeanField, dtype=jnp.float64))
    monkeypatch.setattr(tmf, "MeanFieldDCA", functools.partial(TMeanField, dtype=torch.float64))
    full = [argv[0], bio, fa, "--refseq_file", rf] + argv[1:]
    out_j, out_t = run_both(tmp_path, jmf, tmf.run_meanfield_dca, fa, full, "single")
    for name in sorted(os.listdir(out_j)):
        assert_files_close(os.path.join(out_t, name), os.path.join(out_j, name), 1e-6)
        if "_scores_" in name:
            pairs = [p for p, _ in read_scores(os.path.join(out_t, name))[1]]
            m = len({s for p in pairs for s in p})
            assert len(pairs) == m * (m - 1) // 2
            assert all(0 <= i < j < len(ref) for i, j in pairs)


def test_refseq_on_other_mfdca_subcommands(tmp_path):
    """The mean-field subcommands that take ``--refseq_file`` but do not map
    (``pydca_tpu/cli/mfdca_main.py:53``) write what they write without it."""
    _, fa, rf, _ = family_files(tmp_path, "rna", 200, 20, seed=3, row=9)
    for refseq in ([], ["--refseq_file", rf]):
        out = str(tmp_path / f"out{len(refseq)}")
        tmf.run_meanfield_dca(["compute_fi", "rna", fa, "--device", "cpu", "--output_dir", out]
                              + refseq)
    a, b = (open(os.path.join(str(tmp_path / d), "fi_fam.txt")).read() for d in ("out0", "out2"))
    assert a == b


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    """``--device cuda`` never falls back to the CPU: the engines and the
    trimmer raise before they read the card."""
    _, fa, rf, _ = family_files(tmp_path, "rna", 40, 12, seed=1, row=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run, argv in ((tplm.run_plm_dca, ["compute_fn", "rna", fa, "--refseq_file", rf]),
                      (tmf.run_meanfield_dca, ["compute_fn", "rna", fa, "--refseq_file", rf]),
                      (tmain.run_pydca, ["trim_by_refseq", "rna", fa, rf])):
        with pytest.raises(RuntimeError, match="is_available"):
            run(argv + ["--output_dir", str(tmp_path / "out")])
    assert not os.path.exists(str(tmp_path / "out"))


def run_pydca_both(tmp_path, argv, device=True):
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jmain.execute_from_command_line(**vars(jmain.build_parser().parse_args(argv + ["--output_dir", out_j])))
    tmain.run_pydca(argv + (["--device", "cpu"] if device else []) + ["--output_dir", out_t])
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_t))
    return {f: (open(os.path.join(out_j, f), "rb").read(), open(os.path.join(out_t, f), "rb").read())
            for f in files}


@pytest.mark.parametrize("bio", ["rna", "protein"])
@pytest.mark.parametrize("flags", [[], ["--remove_all_gaps"], ["--max_gap", "0.05"]],
                         ids=["default", "remove_all_gaps", "max_gap"])
def test_trim_by_refseq_matches_jax_cli(tmp_path, bio, flags):
    codes, _ = planted_family(120, 36, BIOS[bio].q, seed=4, n_pairs=4, n_ancestors=8)
    codes[:, [3, 17]] = BIOS[bio].gap_state
    codes[:90, 25] = BIOS[bio].gap_state
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, BIOS[bio])
    rf = str(tmp_path / "ref.fa")
    write_fasta(rf, ["ref"], [reference_from_row(codes, 50, BIOS[bio], seed=2)])
    files = run_pydca_both(tmp_path, ["trim_by_refseq", bio, fa, rf] + flags)
    assert list(files) == ["Trimmed_fam.fa"]
    for want, got in files.values():
        assert got == want


@pytest.mark.parametrize("max_gap", [None, "0.3"])
def test_trim_by_gap_size_matches_jax_cli(tmp_path, max_gap):
    codes, _ = planted_family(80, 30, 21, seed=6, n_pairs=3, n_ancestors=8)
    codes[:50, 7] = 20
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, talph.PROTEIN)
    argv = ["trim_by_gap_size", fa] + ([] if max_gap is None else ["--max_gap", max_gap])
    files = run_pydca_both(tmp_path, argv, device=False)
    for want, got in files.values():
        assert got == want


def test_pdb_content_matches_jax_cli(tmp_path, capsys):
    kw = realistic(tmp_path)
    jmain.execute_from_command_line(the_command="pdb_content", pdb_file=kw["pdb_file"])
    want = capsys.readouterr().out
    tmain.run_pydca(["pdb_content", kw["pdb_file"]])
    assert capsys.readouterr().out == want and "chain P [PROTEIN]" in want


@pytest.mark.parametrize("command", ["plot_contact_map", "plot_tp_rate"])
def test_plot_commands_match_jax_cli(tmp_path, command):
    pytest.importorskip("matplotlib")
    kw = realistic(tmp_path)
    argv = [command, "rna", "X", kw["pdb_file"], kw["refseq_file"], kw["dca_file"],
            "--num_dca_contacts", "2", "--no_show"]
    files = run_pydca_both(tmp_path, argv, device=False)
    txt = [f for f in files if f.endswith(".txt")]
    assert len(txt) == 1 and any(f.endswith(".png") for f in files)
    want, got = files[txt[0]]
    assert got == want
