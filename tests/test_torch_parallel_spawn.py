"""One process over every card: the CLIs start their ranks themselves.

``spawn_cli`` with 2 gloo CPU ranks (``torch.multiprocessing``, start
method spawn, a ``FileStore`` in a temporary directory) writes the same
bytes as ``torchrun --nproc_per_node=2`` on the family of
``tests/test_torch_parallel_cli.py``; a failing rank's exit code reaches
the parent.  With ``torch.cuda.device_count`` patched, ``--mesh auto
--device cuda`` asks the spawner for one rank a card on both CLIs, and a
named card ``cuda:K`` runs on card K without a raise (one process) or
under gloo (``torchrun`` ranks sharing it).
"""

import os
import subprocess
import sys

import pytest
import torch

from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch.cli import mfdca_main, plmdca_main
from pydca_tpu_torch.io.fasta import read_msa
from pydca_tpu_torch.meanfield import MeanFieldDCA
from pydca_tpu_torch.parallel import fit as tfit
from pydca_tpu_torch.parallel import mesh as tmesh
from pydca_tpu_torch.parallel import spawn as tspawn
from pydca_tpu_torch.plm import PlmDCA
from pydca_tpu_torch.synthetic import planted_family, write_family_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, L, Q = 301, 30, 5  # tests/test_torch_parallel_cli.py's family
TIMEOUT_S = 120
PREFIX = {"plmdca": "PLMDCA_apc_fn_scores_", "mfdca": "MFDCA_apc_fn_scores_"}
CLIS = {"plmdca": plmdca_main.run_plm_dca, "mfdca": mfdca_main.run_meanfield_dca}


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spawn")
    codes, _ = planted_family(N, L, Q, seed=L, n_pairs=6, n_ancestors=12)
    fa = str(tmp / "fam.fa")
    write_family_fasta(fa, codes, talph.RNA)
    return tmp, fa


def argv_of(fa, out_dir):
    return ["compute_fn", "rna", fa, "--apc", "--mesh", "auto", "--device", "cpu",
            "--output_dir", out_dir]


@pytest.mark.parametrize("cli", ["plmdca", "mfdca"])
def test_spawned_ranks_write_torchruns_bytes(family, cli, monkeypatch):
    tmp, fa = family
    spawned, launched = str(tmp / f"{cli}_spawn"), str(tmp / f"{cli}_torchrun")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", f"pydca_tpu_torch.cli.{cli}_main"] + argv_of(fa, launched),
        capture_output=True, text=True, env=env, timeout=TIMEOUT_S, cwd=str(tmp))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks inherit it, as torchrun's do
    assert tspawn.spawn_cli(CLIS[cli], argv_of(fa, spawned), 2, "cpu") == 0
    name = PREFIX[cli] + "fam.txt"
    assert os.listdir(spawned) == [name]  # rank 0 alone writes
    with open(os.path.join(spawned, name), "rb") as a, open(os.path.join(launched, name), "rb") as b:
        assert a.read() == b.read()


def test_failing_rank_fails_the_parent(family, capsys):
    tmp, _ = family
    # argparse exits 2 on every rank: the parent returns that code
    assert tspawn.spawn_cli(CLIS["mfdca"], ["compute_fn", "rna"], 2, "cpu") == 2
    # a rank that raises exits 1, and its traceback is printed
    missing = str(tmp / "missing.fa")
    assert tspawn.spawn_cli(CLIS["plmdca"], argv_of(missing, str(tmp / "o")), 2, "cpu") == 1
    assert "FileNotFoundError" in capsys.readouterr().err


@pytest.fixture
def cards(monkeypatch):
    """Four visible cards, as far as the launch code can tell."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("WORLD_SIZE", raising=False)


@pytest.mark.parametrize("cli", ["plmdca", "mfdca"])
def test_auto_over_every_card_asks_for_one_rank_a_card(cli, family, cards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    calls = []

    def fake_spawn(run, argv, world, device):
        calls.append((run.__name__, argv, world, device))
        return 0

    monkeypatch.setattr(sys.modules[CLIS[cli].__module__], "spawn_cli", fake_spawn)
    _, fa = family
    argv = ["compute_fn", "rna", fa, "--apc", "--mesh", "auto", "--device", "cuda"]
    assert CLIS[cli](argv) is None
    assert calls == [(CLIS[cli].__name__, argv, 2, "cuda")]
    monkeypatch.setattr(sys.modules[CLIS[cli].__module__], "spawn_cli",
                        lambda *a: 3)  # a failed rank's code becomes the exit code
    with pytest.raises(SystemExit) as exc:
        CLIS[cli](argv)
    assert exc.value.code == 3


@pytest.mark.parametrize("mesh,device,count,world", [
    ("auto", "cuda", 4, 4), ("auto", "cuda", 1, 0), ("auto", "cuda:1", 4, 0),
    ("single", "cuda", 4, 0), ("auto", "cpu", 4, 0),
])
def test_spawn_world(mesh, device, count, world, cards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert tspawn.spawn_world(mesh, device) == world
    monkeypatch.setenv("WORLD_SIZE", "2")  # under torchrun, the ranks exist
    assert tspawn.spawn_world(mesh, device) == 0


def test_named_card_on_a_multi_card_host_is_one_device(cards, family):
    """The fault of ``reject_several_cards``: ``cuda:1`` under ``--mesh
    auto`` raised on any host with more than one card."""
    assert tfit.launch_mesh("auto", "cuda:1") == (None, "cuda:1")
    assert tmesh.resolve_mesh("auto", torch.device("cuda:1")) is None
    _, fa = family
    msa = read_msa(fa, "rna")
    for engine in (PlmDCA, MeanFieldDCA):
        inst = engine(msa, "rna", device="cuda:1", mesh="auto")
        assert inst.mesh is None and inst.device == torch.device("cuda", 1)
        with pytest.raises(NotImplementedError, match="torchrun") as exc:
            engine(msa, "rna", device="cuda", mesh="auto")
        assert "--mesh auto --device cuda" in str(exc.value)
    with pytest.raises(NotImplementedError, match="torchrun"):
        tfit.launch_mesh("auto", "cuda")


class Stop(Exception):
    """Raised by the patched group init: the backend is all the test needs."""


@pytest.mark.parametrize("device,backend,card", [("cuda:1", "gloo", 1), ("cuda", "nccl", 0)])
def test_torchrun_ranks_sharing_a_card_take_gloo(device, backend, card, cards, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    set_to, inits = [], []

    def fake_init(name):
        inits.append(name)
        raise Stop

    monkeypatch.setattr(torch.cuda, "set_device", set_to.append)
    monkeypatch.setattr(tfit, "init_distributed", fake_init)
    with pytest.raises(Stop):
        tfit.launch_mesh("auto", device)
    assert inits == [backend]
    assert set_to == [torch.device("cuda", card)]
