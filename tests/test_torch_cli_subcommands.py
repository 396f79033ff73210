"""Port's ``mfdca`` and ``plmdca`` subcommands beyond ``compute_fn`` vs the
JAX package's CLI, end to end on the CPU.

Each subcommand runs through both CLIs on the same seeded FASTA file (the
JAX one at ``mesh="single"``; see ``tests/test_torch_cli_mfdca.py``).  File
names and every non-numeric line are equal byte for byte; Meff (a float32
sum taken in another order) to rel 1e-6; the weights, which are exact, byte
for byte; scores at the ranking bar; fields, frequencies and couplings
within rtol 1e-4 (float32 on both sides).  The ``plmdca`` cases give both
CLIs' fits the same parameter vector (a JAX fit of the family), so that
they compare scoring and extraction and not two float32 trajectories; the
DI calibration runs the real fits on both sides.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pydca_tpu.plm as jplm_engine
import pydca_tpu_torch.plm as tplm_engine
from pydca_tpu import stats as jstats
from pydca_tpu.cli import mfdca_main as jmf
from pydca_tpu.cli import plmdca_main as jplm
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch.cli import mfdca_main as tmf
from pydca_tpu_torch.cli import plmdca_main as tplm
from pydca_tpu_torch.ops.lbfgs import LBFGSResult
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


def run_both(tmp_path, cli, biomolecule, codes, argv):
    """Run ``argv`` (a subcommand and its flags) through the JAX and the
    port's CLI; returns the two output directories."""
    jcli, tcli, mesh = (jmf, tmf, "single") if cli == "mfdca" else (jplm, tplm, None)
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, talph.get_alphabet(biomolecule))
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    args = vars(jcli.build_parser().parse_args([argv[0], biomolecule, fa] + argv[1:]))
    for key in ("mesh", "num_threads", "seq_block", "precision", "checkpoint", "param_space"):
        args.pop(key, None)
    jcli.execute_from_command_line(output_dir=out_j, mesh=mesh, **{
        k: v for k, v in args.items() if k != "output_dir"
    })
    run = tcli.run_meanfield_dca if cli == "mfdca" else tcli.run_plm_dca
    run([argv[0], biomolecule, fa, "--device", "cpu", "--output_dir", out_t] + argv[1:])
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t))
    return out_j, out_t


def split_file(path):
    with open(path) as fh:
        lines = fh.readlines()
    return [x for x in lines if x.startswith("#")], [x for x in lines if not x.startswith("#")]


def assert_headers_equal(ht, hj):
    assert len(ht) == len(hj)
    for a, b in zip(ht, hj):
        if b.startswith(MEFF):
            assert a.startswith(MEFF)
            assert float(a[len(MEFF):]) == pytest.approx(float(b[len(MEFF):]), rel=1e-6)
        else:
            assert a == b  # byte for byte


def assert_csv_close(bt, bj, n_keys, rtol=1e-4):
    """CSV rows: the first ``n_keys`` integer columns equal, the rest close."""
    assert len(bt) == len(bj)
    rt = [r.rstrip("\n").split(",") for r in bt]
    rj = [r.rstrip("\n").split(",") for r in bj]
    assert [r[:n_keys] for r in rt] == [r[:n_keys] for r in rj]
    vt = np.array([[float(x) for x in r[n_keys:]] for r in rt])
    vj = np.array([[float(x) for x in r[n_keys:]] for r in rj])
    assert np.isfinite(vt).all()
    # the largest value sets the absolute floor for entries near zero
    np.testing.assert_allclose(vt, vj, rtol=rtol, atol=rtol * np.abs(vj).max())


def compare_outputs(out_j, out_t, l):
    for name in sorted(os.listdir(out_j)):
        ht, bt = split_file(os.path.join(out_t, name))
        hj, bj = split_file(os.path.join(out_j, name))
        assert_headers_equal(ht, hj)
        if "_scores_" in name:
            st = read_scores(os.path.join(out_t, name))[1]
            sj = read_scores(os.path.join(out_j, name))[1]
            assert len(st) == len(sj) == l * (l - 1) // 2
            scores = [s for _, s in st]
            assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
            assert spearman(st, sj, l) >= 0.98
            assert top_k_overlap(st, sj, 20) >= 0.9
        elif name.startswith("weights_"):
            assert bt == bj  # exact weights: byte for byte
        else:
            keys = {"fi_": 2, "fij_": 4, "fields_": 1, "couplings_": 2}
            assert_csv_close(bt, bj, next(v for k, v in keys.items() if name.startswith(k)))


MF_CASES = [
    ("rna", ["compute_di", "--apc"]),
    ("rna", ["compute_di"]),
    ("rna", ["compute_fields"]),
    ("rna", ["compute_params"]),
    ("rna", ["compute_params", "--ranked_by", "DI_APC", "--linear_dist", "2",
             "--num_site_pairs", "10"]),
    ("rna", ["compute_fi"]),
    ("rna", ["compute_fij"]),
    ("rna", ["compute_weights"]),
    ("protein", ["compute_di", "--apc"]),
    ("protein", ["compute_fields"]),
    ("protein", ["compute_params", "--ranked_by", "di"]),
    ("protein", ["compute_fij"]),
    ("protein", ["compute_weights"]),
]


@pytest.mark.parametrize("biomolecule,argv", MF_CASES, ids=lambda x: "-".join(x) if isinstance(x, list) else x)
def test_mfdca_subcommand_matches_jax_cli(tmp_path, biomolecule, argv):
    n, l = (400, 40) if biomolecule == "rna" else (300, 30)
    q = 5 if biomolecule == "rna" else 21
    codes, _ = planted_family(n, l, q, seed=l + q, n_pairs=6, n_ancestors=12)
    out_j, out_t = run_both(tmp_path, "mfdca", biomolecule, codes, argv)
    compare_outputs(out_j, out_t, l)


PLM_CASES = [
    ["compute_di", "--apc"],
    ["compute_di"],
    ["compute_params"],
    ["compute_params", "--ranked_by", "di", "--num_site_pairs", "5", "--linear_dist", "3"],
]


PLM_N, PLM_L, PLM_Q = 300, 30, 5


@pytest.fixture(scope="module")
def plm_family():
    """The family and a JAX fit of it (float32 parameter vector)."""
    codes, _ = planted_family(PLM_N, PLM_L, PLM_Q, seed=PLM_L, n_pairs=6, n_ancestors=12)
    msa = jnp.asarray(codes.astype(np.int32))
    w = jstats.sequence_weights(msa, 0.8, PLM_Q)
    lam = jnp.float32(0.2 * (PLM_L - 1))
    res = jplm_engine.fit_plm(msa, w, lam, lam, PLM_L, PLM_Q, max_iterations=100)
    return codes, np.asarray(res.x, np.float32)


@pytest.mark.parametrize("argv", PLM_CASES, ids=lambda x: "-".join(x))
def test_plmdca_subcommand_matches_jax_cli(tmp_path, monkeypatch, plm_family, argv):
    codes, params = plm_family

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
    out_j, out_t = run_both(tmp_path, "plmdca", "rna", codes, argv)
    compare_outputs(out_j, out_t, PLM_L)


@pytest.mark.parametrize("cli", ["mfdca", "plmdca"])
def test_di_planted_pairs_recovered(tmp_path, cli):
    """Calibrates the share ``chip_smoke.py`` asserts on the DI paths
    (phases 8 and 9): the JAX package and the port both put >=
    PLANTED_MIN_SHARE of the planted pairs in their top PLANTED_TOP DI-APC
    pairs (the FN-APC calibration family of tests/test_torch_cli.py)."""
    codes, pairs = planted_family(1000, 60, 21, seed=0, n_pairs=20)
    out_j, out_t = run_both(tmp_path, cli, "protein", codes, ["compute_di", "--apc"])
    name = ("MFDCA" if cli == "mfdca" else "PLMDCA") + "_apc_di_scores_fam.txt"
    for out in (out_j, out_t):
        scores = read_scores(os.path.join(out, name))[1]
        assert planted_recovery(scores, pairs, PLANTED_TOP) >= PLANTED_MIN_SHARE


@pytest.mark.parametrize("biomolecule", ["protein", "rna"])
def test_param_and_frequency_writers_byte_identical(tmp_path, biomolecule):
    """The copied writers of this slice against the originals, on the same
    numpy input."""
    from pydca_tpu.io import output as joutput
    from pydca_tpu_torch.io import output as toutput

    rng = np.random.default_rng(0)
    l, q = 6, 5 if biomolecule == "rna" else 21
    p = l * (l - 1) // 2
    fields = [(i, rng.normal(size=q - 1).astype(np.float32)) for i in range(l)]
    couplings = [((0, 5), rng.normal(size=(q - 1) ** 2).astype(np.float32)), ((1, 3), np.zeros(4))]
    fi = rng.random((l, q)).astype(np.float32)
    fij = rng.random((p, q - 1, q - 1)).astype(np.float32)
    weights = (1.0 / rng.integers(1, 9, size=7)).astype(np.float32)
    files = {}
    for mod in (toutput, joutput):
        d = tmp_path / mod.__name__
        d.mkdir()
        meta = ["# a header line", "#\tanother"] + mod.residue_repr_metadata(biomolecule)
        mod.write_fields_csv(str(d / "fields.txt"), fields, metadata=meta)
        mod.write_fields_csv(str(d / "fields_nometa.txt"), fields)
        mod.write_couplings_csv(str(d / "couplings.txt"), couplings, metadata=meta)
        mod.write_single_site_freqs(str(d / "fi.txt"), fi, l, q, metadata=meta)
        mod.write_pair_site_freqs(str(d / "fij.txt"), fij, l, q, metadata=meta)
        mod.write_sequence_weights(str(d / "w.txt"), weights, ids=["a", "b"], metadata=meta)
        mod.write_sequence_weights(str(d / "w_noids.txt"), weights)
        files[mod] = {f.name: f.read_bytes() for f in sorted(d.iterdir())}
    assert files[toutput] == files[joutput] and len(files[toutput]) == 7
