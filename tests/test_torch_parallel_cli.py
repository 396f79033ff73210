"""Both DCA CLIs of the port under ``torchrun`` with 2 CPU ranks.

``python -m torch.distributed.run --standalone --nproc_per_node=2`` (torchrun
picks a free port on localhost) runs ``plmdca compute_fn --apc --mesh auto
--device cpu`` and ``mfdca compute_fn --apc`` on a planted family; the
ranks form a gloo group, shard the sequences and rank 0 alone writes.  The
file is held to the format ``tests/test_torch_cli.py`` pins and to the JAX
CLI's ranking at ``--mesh auto`` on the 8 virtual devices of
``tests/conftest.py``.
"""

import os
import subprocess
import sys

import pytest
import torch

from pydca_tpu.cli import mfdca_main as jmf
from pydca_tpu.cli import plmdca_main as jplm
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch.cli import plmdca_main as tplm_cli
from pydca_tpu_torch.parallel import fit as tfit
from pydca_tpu_torch.synthetic import planted_family, spearman, top_k_overlap, write_family_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, L, Q = 301, 30, 5  # N odd: the two stripes differ by a pad row
TIMEOUT_S = 120


def read_scores(path):
    header, scores = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                header.append(line)
            else:
                i, j, s = line.split()
                scores.append(((int(i) - 1, int(j) - 1), float(s)))
    return header, scores


def torchrun(cli, fa, out_dir):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", f"pydca_tpu_torch.cli.{cli}_main", "compute_fn", "rna", fa, "--apc",
           "--mesh", "auto", "--device", "cpu", "--output_dir", out_dir]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=TIMEOUT_S,
                          cwd=os.path.dirname(fa))
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchrun")
    codes, _ = planted_family(N, L, Q, seed=L, n_pairs=6, n_ancestors=12)
    fa = str(tmp / "fam.fa")
    write_family_fasta(fa, codes, talph.RNA)
    out = {}
    for cli, jcli, prefix in (("plmdca", jplm, "PLMDCA_apc_fn_scores_"),
                              ("mfdca", jmf, "MFDCA_apc_fn_scores_")):
        port_dir, jax_dir = str(tmp / f"{cli}_port"), str(tmp / f"{cli}_jax")
        torchrun(cli, fa, port_dir)
        jcli.execute_from_command_line(msa_file=fa, biomolecule="rna", the_command="compute_fn",
                                       apc=True, output_dir=jax_dir, mesh="auto")
        out[cli] = (os.listdir(port_dir), prefix + "fam.txt",
                    read_scores(os.path.join(port_dir, prefix + "fam.txt")),
                    read_scores(os.path.join(jax_dir, prefix + "fam.txt")))
    return out


@pytest.mark.parametrize("cli", ["plmdca", "mfdca"])
def test_one_file_in_the_pinned_format(runs, cli):
    """Rank 0 alone writes: one file, the JAX CLI's header, every pair once
    in descending order."""
    written, name, (ht, st), (hj, _) = runs[cli]
    assert written == [name]
    assert ht == hj
    assert len(st) == L * (L - 1) // 2
    assert len({p for p, _ in st}) == len(st)
    vals = [s for _, s in st]
    assert vals == sorted(vals, reverse=True)


@pytest.mark.parametrize("cli", ["plmdca", "mfdca"])
def test_ranking_meets_bar_against_jax_mesh(runs, cli):
    _, _, (_, st), (_, sj) = runs[cli]
    assert spearman(st, sj, L) >= 0.98
    assert top_k_overlap(st, sj, 20) >= 0.9


def test_cuda_card_without_a_card_raises(tmp_path):
    """``--device cuda:0`` never falls back to the CPU."""
    fa = str(tmp_path / "f.fa")
    write_family_fasta(fa, planted_family(20, 12, 5, n_pairs=1)[0], talph.RNA)
    with pytest.raises(RuntimeError, match="is_available"):
        tplm_cli.run_plm_dca(["compute_fn", "rna", fa, "--device", "cuda:0",
                              "--output_dir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_rank_card_that_does_not_exist_raises(monkeypatch):
    """Under torchrun, ``--device cuda`` is ``cuda:LOCAL_RANK``: a rank
    whose card is not there raises instead of sharing another."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="cuda:1 requested, but 1 card"):
        tfit._rank_card(torch.device("cuda"))
    assert tfit._rank_card(torch.device("cuda:0")) == torch.device("cuda", 0)


@pytest.mark.parametrize("n_data,n_model", [(None, 2), (2, 1), (1, 0), (1, 2)])
def test_make_mesh_grid_must_fill_the_group(n_data, n_model):
    """A process without a group is one rank: a (data, model) grid that
    does not hold exactly one rank raises ``ValueError``."""
    from pydca_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError):
        make_mesh(n_data, n_model, device="cpu")


def test_make_mesh_one_process():
    """``make_mesh(n_model=1)`` without a group: one rank, no collectives,
    the grid's leader."""
    from pydca_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1, device="cpu")
    assert (mesh.group, mesh.rank, mesh.world_size) == (None, 0, 1)
    assert (mesh.model_group, mesh.model_rank, mesh.model_size) == (None, 0, 1)
    assert mesh.leader
    t = torch.ones(3)
    assert mesh.sum_(t, "x", axis="model") is t and mesh.gather_rows(t, "x", axis="model") is t
    assert not mesh.collectives